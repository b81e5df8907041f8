"""End-to-end VAN-GAN demo on synthetic vascular data, on the PyTorch port.

The counterpart of ``examples/train_synthetic.py`` for ``vangan_torch``: it
generates synthetic "imaging" and "segmentation" volumes (random tube trees),
trains a small VAN-GAN through ``vangan_torch.training.loop.fit``, segments
the held-out imaging volumes by sliding-window stitching and scores them
against their paired truth with Dice and clDice
(``vangan_torch.metrics.evaluate_segmentation``, the skeleton on the card).

    python examples/train_synthetic_torch.py [--epochs 2] [--patch 32] [--volumes 8]
    python examples/train_synthetic_torch.py --preset results    # the RESULTS.md run
    python examples/train_synthetic_torch.py --device cpu ...    # plain torch on the CPU
    python examples/train_synthetic_torch.py --dims 2 --vol-shape 96 96   # 2-D images

The flags are those of the JAX example, but there is no ``--remat``;
``--device`` picks the card (default) or the CPU. ``--dims 2`` trains the
DIMENSIONS=2 mode on 2-D tube images (``make_tube_image``). ``--preset results``
prints the RESULTS.md table row and appends it only to a file named by
``--results-md``. Everything is written under ``--out``, by default a new
directory under ``$TMPDIR``. The last line is a JSON summary: the scores,
the fit's seconds per train step and the total wall time, beside the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_tube_volume(rng: np.random.Generator, shape=(96, 96, 64), n_tubes=12):
    """A random tree of tubes: returns (imaging volume, binary segmentation)."""
    seg = np.zeros(shape, dtype=np.float32)
    xs = np.arange(shape[0])[:, None, None]
    ys = np.arange(shape[1])[None, :, None]
    zs = np.arange(shape[2])[None, None, :]
    for _ in range(n_tubes):
        p0 = rng.uniform(0, 1, 3) * np.asarray(shape)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        radius = rng.uniform(1.5, 4.0)
        # distance of every voxel to the line p0 + t*d
        px, py, pz = xs - p0[0], ys - p0[1], zs - p0[2]
        t = px * d[0] + py * d[1] + pz * d[2]
        dx, dy, dz = px - t * d[0], py - t * d[1], pz - t * d[2]
        dist2 = dx**2 + dy**2 + dz**2
        seg = np.maximum(seg, (dist2 < radius**2).astype(np.float32))
    # imaging: blurred tubes + speckle + background gradient
    img = seg.copy()
    for axis in range(3):  # cheap separable box blur
        img = (np.roll(img, 1, axis) + img + np.roll(img, -1, axis)) / 3.0
    img = img + 0.25 * rng.normal(size=shape).astype(np.float32)
    img = img + np.linspace(0, 0.3, shape[2], dtype=np.float32)[None, None, :]
    return img.astype(np.float32), (2.0 * seg - 1.0).astype(np.float32)


def make_tube_image(rng: np.random.Generator, shape=(96, 96), n_tubes=12):
    """2-D analog of make_tube_volume: random line segments with radius
    (the DIMENSIONS=2 demo input): returns (imaging image, binary segmentation)."""
    seg = np.zeros(shape, dtype=np.float32)
    xs = np.arange(shape[0])[:, None]
    ys = np.arange(shape[1])[None, :]
    for _ in range(n_tubes):
        p0 = rng.uniform(0, 1, 2) * np.asarray(shape)
        d = rng.normal(size=2)
        d /= np.linalg.norm(d)
        radius = rng.uniform(1.5, 4.0)
        px, py = xs - p0[0], ys - p0[1]
        t = px * d[0] + py * d[1]
        dx, dy = px - t * d[0], py - t * d[1]
        seg = np.maximum(seg, (dx**2 + dy**2 < radius**2).astype(np.float32))
    img = seg.copy()
    for axis in range(2):
        img = (np.roll(img, 1, axis) + img + np.roll(img, -1, axis)) / 3.0
    img = img + 0.25 * rng.normal(size=shape).astype(np.float32)
    img = img + np.linspace(0, 0.3, shape[1], dtype=np.float32)[None, :]
    return img.astype(np.float32), (2.0 * seg - 1.0).astype(np.float32)


def main(argv=None) -> None:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--patch", type=int, default=32)
    ap.add_argument("--volumes", type=int, default=8)
    ap.add_argument("--dims", type=int, choices=[2, 3], default=3,
                    help="2: train on 2-D images (DIMENSIONS=2 mode)")
    ap.add_argument("--vol-shape", type=int, nargs="+", default=(96, 96, 64),
                    help="synthetic volume size (x y z; x y for --dims 2)")
    ap.add_argument("--tubes", type=int, default=12)
    ap.add_argument("--filters", type=int, default=8)
    ap.add_argument("--disc-filters", type=int, default=16)
    ap.add_argument("--gen", choices=["resUnet", "vnet", "resnet"], default="resUnet",
                    help="generator family for BOTH directions (BASELINE "
                         "config 4 = vnet; vangan.py:111-162)")
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="override steps/epoch (default: #volumes/batch)")
    ap.add_argument("--cldice-iters", type=int, default=5)
    ap.add_argument("--results-md", default=None,
                    help="append Dice/clDice results to this markdown file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="output directory (default: a new one under $TMPDIR)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) runs the CUDA kernels; cpu the plain versions")
    ap.add_argument(
        "--preset", choices=["results"], default=None,
        help="'results': the RESULTS.md convergence run: full-size config "
             "(128^3 patches, f=16/64, clDice(15), 20 epochs x 150 steps, 16 "
             "volumes of 256x256x128, seed 0); prints the table row")
    args = ap.parse_args(argv)

    if args.preset == "results":
        # explicitly-passed --epochs/--seed win over the preset pins, as in
        # the JAX example
        explicit = {tok[2:].split("=")[0].replace("-", "_")
                    for tok in (sys.argv[1:] if argv is None else argv) if tok.startswith("--")}
        if "epochs" not in explicit:
            args.epochs = 20
        args.patch, args.volumes = 128, 16
        args.vol_shape, args.tubes = (256, 256, 128), 12
        args.filters, args.disc_filters = 16, 64
        args.steps_per_epoch, args.cldice_iters = 150, 15
        if "seed" not in explicit:
            args.seed = 0

    import torch

    from vangan_torch.config import VanGanConfig, save_args
    from vangan_torch.data.pipeline import VanGanDataset
    from vangan_torch.data.preprocess import read_tiff
    from vangan_torch.device import resolve_device
    from vangan_torch.inference.mapping import run_mapping
    from vangan_torch.metrics import evaluate_segmentation
    from vangan_torch.monitor import GanMonitor, TBSummary
    from vangan_torch.training.loop import fit
    from vangan_torch.vangan import VanGan

    device = resolve_device(args.device)
    if args.out is None:
        args.out = tempfile.mkdtemp(prefix="vg_synthetic_torch_")
    os.makedirs(args.out, exist_ok=True)
    print(f"*** Output directory: {args.out} ***")
    data_dir = os.path.join(args.out, "data")
    rng = np.random.default_rng(args.seed)

    print("*** Generating synthetic dataset ***")
    make = make_tube_volume if args.dims == 3 else make_tube_image
    vshape = tuple(args.vol_shape)[:args.dims]
    img_paths, seg_paths, truths = [], [], {}
    for d in ("imgA", "segB"):
        os.makedirs(os.path.join(data_dir, d), exist_ok=True)
    for i in range(args.volumes):
        img, seg = make(rng, shape=vshape, n_tubes=args.tubes)
        # unpaired: imaging volumes and segmentation volumes from separate draws
        img2, seg2 = make(rng, shape=vshape, n_tubes=args.tubes)
        ip = os.path.join(data_dir, "imgA", f"v{i}.npy")
        sp = os.path.join(data_dir, "segB", f"v{i}.npy")
        np.save(ip, img[..., None])
        np.save(sp, seg2[..., None])
        truths[ip] = seg  # paired truth for evaluation only
        img_paths.append(ip)
        seg_paths.append(sp)

    n_val = max(1, args.volumes // 4)
    imaging_partition = {
        "training": img_paths[n_val:],
        "validation": img_paths[:n_val],
        "testing": img_paths[:n_val],
    }
    seg_partition = {
        "training": seg_paths[n_val:],
        "validation": seg_paths[:n_val],
        "testing": seg_paths[:n_val],
    }

    cfg = VanGanConfig(
        output_dir=args.out,
        BATCH_SIZE=1,
        EPOCHS=args.epochs,
        DIMENSIONS=args.dims,
        SUBVOL_PATCH_SIZE=(args.patch,) * 3,
        gen_filters=args.filters,
        disc_filters=args.disc_filters,
        gen_i2s=args.gen,
        gen_s2i=args.gen,
        cldice_iters=args.cldice_iters,
        PERIOD_2D_CALLBACK=2,
        train_steps=args.steps_per_epoch,
    )
    save_args(cfg, os.path.join(args.out, "Args_Settings.txt"))

    dataset = VanGanDataset(cfg, imaging_partition, seg_partition, seed=args.seed,
                            device=device)
    summary = TBSummary(os.path.join(args.out, "TB_Logs"))
    try:
        dataset.plot_sample_dataset(os.path.join(args.out, "GANMonitor"))
        gan = VanGan(cfg, device=device, steps_per_epoch=dataset.train_steps)
        monitor = GanMonitor(
            cfg, dataset=dataset, imaging_val_data=imaging_partition["validation"],
            segmentation_val_data=seg_partition["validation"],
            monitor_dir=os.path.join(args.out, "GANMonitor"),
        )
        print("*** Training ***")
        t_fit = time.perf_counter()
        fit(cfg, gan, dataset, summary, monitor)
        fit_s = time.perf_counter() - t_fit
    finally:
        dataset.close()
        summary.close()

    last = gan.checkpointer.latest_epoch()  # waits for the write in flight
    if last is not None:
        print(f"*** Final checkpoint: {gan.checkpointer.path(last)} ***")

    print("*** Inference + evaluation ***")
    pred_dir = os.path.join(args.out, "predictions")
    os.makedirs(pred_dir, exist_ok=True)
    run_mapping(
        gan, imaging_partition["testing"], cfg.subvol_size,
        segmentation=True, stride=(args.patch // 2,) * 3, filetext="VANGAN_",
        filepath=pred_dir,
    )
    all_scores = []
    for ip in imaging_partition["testing"]:
        name = os.path.splitext(os.path.basename(ip))[0]
        pred = read_tiff(os.path.join(pred_dir, f"VANGAN_{name}.tiff"))
        if args.dims == 3:
            pred = np.transpose(pred, (1, 2, 0, 3))[..., 0]  # (z,x,y,c) -> (x,y,z)
        else:
            pred = pred[0, ..., 0]  # one page (h, w)
        scores = evaluate_segmentation(pred, truths[ip], iters=args.cldice_iters,
                                       device=device)
        all_scores.append((name, scores))
        print(f"{name}: dice={scores['dice']:.3f} cldice={scores['cldice']:.3f}")
    mean_d = float(np.mean([s["dice"] for _, s in all_scores]))
    mean_c = float(np.mean([s["cldice"] for _, s in all_scores]))
    import datetime

    row = (f"| {datetime.date.today()} | vol={tuple(args.vol_shape)} x{args.volumes} "
           f"| patch={args.patch} f={args.filters}"
           f"{'' if args.gen == 'resUnet' else ' gen=' + args.gen}"
           f" | epochs={args.epochs} "
           f"steps/ep={args.steps_per_epoch or 'auto'} seed={args.seed} "
           f"| {mean_d:.3f} | {mean_c:.3f} |")
    print(row)
    if args.results_md:
        with open(args.results_md, "a") as f:
            f.write(row + "\n")
    steps = args.epochs * dataset.train_steps
    print(json.dumps({
        "dice": mean_d, "cldice": mean_c, "per_volume": dict(all_scores),
        "train_steps": steps, "fit_s": fit_s, "fit_s_per_train_step": fit_s / steps,
        "wall_s": time.perf_counter() - t_start,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}))


if __name__ == "__main__":
    main()
