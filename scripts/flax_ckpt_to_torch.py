#!/usr/bin/env python3
"""Convert a vangan_tpu checkpoint into a vangan_torch weights file or checkpoint.

    python scripts/flax_ckpt_to_torch.py --config cfg.yaml --epoch N \\
        [--output-dir DIR] [--out FILE] [--train-state]

Reads ``<output_dir>/checkpoints/checkpoint_e<N>`` (the orbax checkpoint of a
``vangan_tpu`` VanGanState), maps the ``gen_IS``, ``gen_SI``, ``disc_I`` and
``disc_S`` parameter trees with ``vangan_torch.weights.load_flax_networks``
into the port's networks built from the same config, and writes
``<output_dir>/checkpoints/torch_e<N>.pt`` (or ``--out``), which
``python -m vangan_torch predict --epoch N`` (or ``--weights FILE``) serves
and ``VanGan.load_weights`` evaluates. With ``--train-state`` the file is a
whole checkpoint of the port: the networks, and each network's Adam moments
and counts and the step (``vangan_torch.weights.load_flax_train_state``, both
``flatten_opt`` layouts), so ``python -m vangan_torch train --resume-epoch N``
continues the JAX run. Needs both JAX (orbax) and torch.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vangan_torch.config import VanGanConfig  # noqa: E402
from vangan_torch.vangan import VanGan  # noqa: E402
from vangan_torch.weights import load_flax_networks, load_flax_train_state  # noqa: E402


def convert(cfg: VanGanConfig, epoch: int, out: Optional[str] = None,
            train_state: bool = False) -> str:
    """Write the port's weights (or, with ``train_state``, its whole
    checkpoint) for checkpoint ``epoch`` of ``cfg.output_dir``; return the
    path written."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(cfg.output_dir, "checkpoints", f"checkpoint_e{epoch}"))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    stored = ocp.StandardCheckpointer().restore(path)
    gan = VanGan(cfg, device="cpu")
    out = out or gan.weights_path(epoch)
    if not train_state:
        load_flax_networks(gan, stored["params"])
        gan.save_weights(out)
        return out
    load_flax_train_state(gan, stored)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(gan.checkpoint_state(), out)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=None)
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--train-state", action="store_true",
                   help="also carry the optimizer states and step: a checkpoint to resume from")
    args = p.parse_args(argv)
    cfg = VanGanConfig.from_yaml(args.config) if args.config else VanGanConfig()
    if args.output_dir:
        cfg.output_dir = args.output_dir
    print(f"wrote {convert(cfg, args.epoch, args.out, args.train_state)}")


if __name__ == "__main__":
    main()
