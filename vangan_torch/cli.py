"""Command-line interface of the PyTorch port: ``predict``.

    python -m vangan_torch predict --config cfg.yaml --input DIR --output DIR \\
        [--epoch N | --weights FILE] [--fake-imaging] [--stride X Y Z] [--device cuda]

Segments (or, with ``--fake-imaging``, maps to imaging) every ``.npy`` volume
in ``--input`` by sliding-window stitching and writes one TIFF per volume.
The flags are those of ``python -m vangan_tpu predict`` plus ``--weights``
(a weights file of the port) and ``--device`` (default ``cuda``; ``cpu`` runs
the plain torch versions of the kernels).
"""

from __future__ import annotations

import argparse
import os
import sys

from vangan_torch.config import VanGanConfig


def _load_cfg(args) -> VanGanConfig:
    cfg = VanGanConfig.from_yaml(args.config) if args.config else VanGanConfig()
    if args.output_dir:
        cfg.output_dir = args.output_dir
    return cfg


def cmd_predict(args) -> None:
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"predict: --device {args.device} but CUDA is not available on this "
                 "host; pass --device cpu to run the plain torch versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        sys.exit(f"predict: --device must be cuda[:N] or cpu, got {args.device!r}")

    from vangan_torch.inference.mapping import run_mapping
    from vangan_torch.vangan import VanGan

    cfg = _load_cfg(args)
    listing = sorted(os.listdir(args.input))
    if any(f.lower().endswith((".tif", ".tiff")) for f in listing):
        raise NotImplementedError(
            "raw TIFF input is not yet ported (it needs the preprocessing of "
            "ROADMAP.md Queue 1, preprocessing); preprocess to .npy with "
            "`python -m vangan_tpu preprocess` first")
    gan = VanGan(cfg, device=device)
    if args.weights is not None:
        gan.load_weights(args.weights)
    elif args.epoch is not None:
        path = gan.weights_path(args.epoch)
        print(f"Trying to load weights from path: {path}")
        if os.path.exists(path):
            gan.load_weights(path)
        else:
            # the JAX CLI's behaviour (vangan_tpu/checkpoint.py, reference vangan.py:268)
            print("Error: Checkpoint not found!")
    os.makedirs(args.output, exist_ok=True)
    files = [os.path.join(args.input, f) for f in listing if f.endswith(".npy")]
    run_mapping(gan, files, cfg.subvol_size, filetext="VANGAN_", filepath=args.output,
                segmentation=not args.fake_imaging, stride=tuple(args.stride))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="vangan_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("predict", help="sliding-window inference on .npy volumes")
    pr.add_argument("--config", default=None)
    pr.add_argument("--input", required=True, help="directory of .npy volumes")
    pr.add_argument("--output", required=True)
    w = pr.add_mutually_exclusive_group()
    w.add_argument("--epoch", type=int, default=None,
                   help="load <output_dir>/checkpoints/torch_e<N>.pt")
    w.add_argument("--weights", default=None, help="a weights file of the port")
    pr.add_argument("--fake-imaging", action="store_true")
    pr.add_argument("--stride", type=int, nargs=3, default=(25, 25, 25))
    pr.add_argument("--output-dir", default=None)
    pr.add_argument("--device", default="cuda",
                    help="cuda (default) runs the CUDA kernels; cpu the plain versions")
    pr.set_defaults(fn=cmd_predict)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
