#!/usr/bin/env python3
"""Convert the four networks of a vangan_tpu checkpoint into a vangan_torch weights file.

    python scripts/flax_ckpt_to_torch.py --config cfg.yaml --epoch N \\
        [--output-dir DIR] [--out FILE]

Reads ``<output_dir>/checkpoints/checkpoint_e<N>`` (the orbax checkpoint of a
``vangan_tpu`` VanGanState), maps the ``gen_IS``, ``gen_SI``, ``disc_I`` and
``disc_S`` parameter trees with ``vangan_torch.weights.load_flax_networks``
into the port's networks built from the same config, and writes
``<output_dir>/checkpoints/torch_e<N>.pt`` (or ``--out``), which
``python -m vangan_torch predict --epoch N`` (or ``--weights FILE``) serves
and ``VanGan.load_weights`` evaluates. Needs both JAX (orbax) and torch.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vangan_torch.config import VanGanConfig  # noqa: E402
from vangan_torch.vangan import VanGan  # noqa: E402
from vangan_torch.weights import load_flax_networks  # noqa: E402


def convert(cfg: VanGanConfig, epoch: int, out: Optional[str] = None) -> str:
    """Write the port's weights for checkpoint ``epoch`` of ``cfg.output_dir``;
    return the path written."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(cfg.output_dir, "checkpoints", f"checkpoint_e{epoch}"))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    stored = ocp.StandardCheckpointer().restore(path)
    gan = VanGan(cfg, device="cpu")
    load_flax_networks(gan, stored["params"])
    out = out or gan.weights_path(epoch)
    gan.save_weights(out)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=None)
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cfg = VanGanConfig.from_yaml(args.config) if args.config else VanGanConfig()
    if args.output_dir:
        cfg.output_dir = args.output_dir
    print(f"wrote {convert(cfg, args.epoch, args.out)}")


if __name__ == "__main__":
    main()
