"""Command-line interface of the PyTorch port: ``preprocess``, ``train``,
``predict``, ``sweep``.

    python -m vangan_torch preprocess --config cfg.yaml --imaging-raw RAW_A \\
        --seg-raw RAW_B --data-dir DATA [--resize] [--preprocess rsom|pkg.mod:fn]
    python -m vangan_torch train --config cfg.yaml --data-dir DATA [--output-dir DIR] \\
        [--resume-epoch N] [--semi-supervised-dir DIR] [--predict-after] [--device cuda]
    python -m vangan_torch predict --config cfg.yaml --input DIR --output DIR \\
        [--epoch N | --weights FILE] [--fake-imaging] [--stride X Y Z] \\
        [--resize] [--preprocess rsom|pkg.mod:fn] [--device cuda]
    python -m vangan_torch sweep --config cfg.yaml --input DIR --start 100 --end 200 \\
        [--step 2] [--fake-imaging] [--device cuda]

``preprocess`` turns two directories of raw TIFFs (imaging, segmentation)
into normalised ``.npy`` volumes and the partitions ``dataA_partition.pkl``
and ``dataB_partition.pkl`` in ``DATA``, on the host. ``train`` reads those
partitions (this package's or ``vangan_tpu``'s) and trains, writing
``checkpoints/torch_e{N}.pt``, panels, TensorBoard event files and
``Args_Settings.txt`` under the output dir. ``predict`` segments (or, with
``--fake-imaging``, maps to imaging) every ``.npy`` volume in ``--input`` by
sliding-window stitching and writes one TIFF per volume; given raw TIFFs, it
first preprocesses them into ``<output>/preprocessed_npy``. ``--epoch N``
serves what ``train`` saved at epoch N. ``sweep`` runs that inference from
every ``--step``-th checkpoint. A config with ``DIMENSIONS: 2`` runs each of
them on 2-D ``(H, W, 1)`` images (one-page TIFFs in, one page out; the z of
``--stride`` is not read). With ``N_DEVICES: k`` in the config (0: every
card) ``train``, ``predict`` and ``sweep`` run data-parallel, one process a
card (``--device cpu``: k gloo ranks on the CPU), rank 0 writing the files;
``torchrun --nproc_per_node k -m vangan_torch ...`` starts the same ranks.
The flags are those of ``python -m vangan_tpu`` plus ``--weights`` (a
weights file of the port) and ``--device`` (default ``cuda``, which refuses
to run without CUDA; ``cpu`` runs the plain torch versions of the kernels).
"""

from __future__ import annotations

import argparse
import os
import sys

from vangan_torch.config import VanGanConfig


def _load_cfg(args) -> VanGanConfig:
    cfg = VanGanConfig.from_yaml(args.config) if args.config else VanGanConfig()
    if getattr(args, "output_dir", None):
        cfg.output_dir = args.output_dir
    return cfg


def _device(args):
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{args.cmd}: --device {args.device} but CUDA is not available on this "
                 "host; pass --device cpu to run the plain torch versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        sys.exit(f"{args.cmd}: --device must be cuda[:N] or cpu, got {args.device!r}")
    return device


def _load_partitions(cfg, data_dir):
    from vangan_torch.data.preprocess import DataPreprocessor

    imaging = DataPreprocessor(cfg, partition_id="A", domain="imaging")
    imaging.load_partition(os.path.join(data_dir, "dataA_partition.pkl"))
    seg = DataPreprocessor(cfg, partition_id="B", domain="segmentation")
    seg.load_partition(os.path.join(data_dir, "dataB_partition.pkl"))
    return imaging, seg


def _resolve_preprocess_fn(spec):
    """Resolve the imaging-domain preprocessing hook (``--preprocess``).

    ``rsom`` selects the published RSOM recipe, slice-wise z-score and
    percentile clip (reference main.py:127-161,
    ``vangan_torch.utils.preprocess_rsom_images``); anything else is a dotted
    path ``pkg.mod:fn`` (or ``pkg.mod.fn``) to a module-level ``np.ndarray ->
    np.ndarray`` function. Module-level is required: the preprocessor fans out
    over spawned worker processes, so the hook must pickle.
    """
    if spec is None:
        return None
    if spec == "rsom":
        from vangan_torch.utils import preprocess_rsom_images

        return preprocess_rsom_images
    import importlib

    mod, _, fn = spec.partition(":")
    if not fn:
        mod, _, fn = spec.rpartition(".")
    if not mod or not fn:
        raise SystemExit(f"--preprocess: cannot parse {spec!r} (use 'rsom' or 'pkg.mod:fn')")
    try:
        target = getattr(importlib.import_module(mod), fn)
    except (ImportError, AttributeError) as e:
        raise SystemExit(f"--preprocess: cannot resolve {spec!r}: {e}")
    if not callable(target):
        raise SystemExit(f"--preprocess: {spec!r} is not callable")
    return target


def cmd_preprocess(args) -> None:
    cfg = _load_cfg(args)
    from vangan_torch.data.preprocess import DataPreprocessor

    imaging = DataPreprocessor(
        cfg, raw_path=args.imaging_raw, main_dir=args.data_dir, partition_id="A",
        partition_filename="dataA_partition.pkl", tiff_size=cfg.RAW_IMG_SIZE,
        target_size=cfg.TARG_RAW_IMG_SIZE, domain="imaging", seed=cfg.seed,
    )
    imaging.preprocess(resize=args.resize,
                       preprocess_fn=_resolve_preprocess_fn(args.preprocess))
    seg = DataPreprocessor(
        cfg, raw_path=args.seg_raw, main_dir=args.data_dir, partition_id="B",
        partition_filename="dataB_partition.pkl", tiff_size=cfg.SYNTH_IMG_SIZE,
        target_size=cfg.TARG_SYNTH_IMG_SIZE, domain="segmentation", seed=cfg.seed,
    )
    seg.preprocess(resize=args.resize)


def _run_ranks(args, body) -> None:
    """Run ``body(args, cfg, device, group)`` on every device the config asks
    for, one process each (the JAX CLI's one command over every device):
    ``N_DEVICES`` is capped to the visible cards, 0 meaning all of them
    (``VanGanConfig.cap_devices``); on the CPU each of ``N_DEVICES`` gloo
    ranks is a process. One device runs ``body`` here with no group; more
    spawn one process a device, after the kernels are built. Under
    ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) this process is one of
    its ranks."""
    device = _device(args)
    cfg = _load_cfg(args)
    import torch

    from vangan_torch import parallel

    if parallel.launched_by_torchrun():
        group = parallel.from_env(device)
        try:
            if cfg.cap_devices(group.world) != group.world:
                sys.exit(f"{args.cmd}: torchrun started {group.world} ranks, N_DEVICES asks "
                         f"for {cfg.N_DEVICES}")
            body(args, cfg, group.device, group)
        finally:
            parallel.destroy(group)
        return
    visible = torch.cuda.device_count() if device.type == "cuda" else max(cfg.N_DEVICES, 1)
    world = cfg.cap_devices(visible)
    if world == 1:
        body(args, cfg, device, None)
        return
    if device.type == "cuda":
        from vangan_torch.ops import build

        build.build()  # once, before the ranks load it
    print(f"{args.cmd}: {world} ranks on {device.type}")
    parallel.spawn(_rank, world, (body, args, cfg), device=device)


def _rank(group, body, args, cfg) -> None:
    body(args, cfg, group.device, group)


def cmd_train(args) -> None:
    _run_ranks(args, _train)


def _train(args, cfg, device, group) -> None:
    from vangan_torch.parallel import is_main

    rank0 = is_main(group)
    os.makedirs(cfg.output_dir, exist_ok=True)

    from vangan_torch.config import save_args
    from vangan_torch.data.pipeline import VanGanDataset
    from vangan_torch.monitor import GanMonitor, TBSummary
    from vangan_torch.monitor.profiling import enable_nan_debugging, trace
    from vangan_torch.training.loop import fit
    from vangan_torch.vangan import VanGan

    if cfg.debug_nans:
        enable_nan_debugging()

    imaging, seg = _load_partitions(cfg, args.data_dir)
    dataset = VanGanDataset(cfg, imaging.partition, seg.partition, seed=cfg.seed,
                            semi_supervised_dir=args.semi_supervised_dir, device=device,
                            group=group)
    summary = None
    try:
        if cfg.plot_dataset_samples and rank0:
            dataset.plot_sample_dataset(os.path.join(cfg.output_dir, "GANMonitor"))
        if rank0:  # fit logs on rank 0 only; no event files from the others
            summary = TBSummary(os.path.join(cfg.output_dir, "TB_Logs"))
        gan = VanGan(cfg, device=device, steps_per_epoch=dataset.train_steps, group=group)
        monitor = None
        if rank0:
            monitor = GanMonitor(
                cfg, dataset=dataset, imaging_val_data=imaging.partition["validation"],
                segmentation_val_data=seg.partition["validation"],
                monitor_dir=os.path.join(cfg.output_dir, "GANMonitor"),
            )
            save_args(cfg, os.path.join(cfg.output_dir, "Args_Settings.txt"))

        start_epoch = 0
        if args.resume_epoch is not None:
            gan.load_checkpoint(epoch=args.resume_epoch)
            start_epoch = args.resume_epoch
        with trace(cfg.profile_dir):
            fit(cfg, gan, dataset, summary, monitor, start_epoch=start_epoch)
    finally:
        dataset.close()
        if summary is not None:
            summary.close()

    # inference on the test sets after training (main.py:237-243)
    if args.predict_after:
        from vangan_torch.inference.mapping import run_mapping

        run_mapping(gan, imaging.partition["testing"], cfg.INPUT_IMG_SIZE, filetext="VANGAN_",
                    filepath=cfg.output_dir, segmentation=True, stride=(25, 25, 25))
        run_mapping(gan, seg.partition["testing"], cfg.INPUT_IMG_SIZE, filetext="VANGAN_",
                    filepath=cfg.output_dir, segmentation=False, stride=(25, 25, 25))


def cmd_predict(args) -> None:
    _run_ranks(args, _predict)


def _predict(args, cfg, device, group) -> None:
    from vangan_torch.inference.mapping import run_mapping
    from vangan_torch.parallel import is_main
    from vangan_torch.vangan import VanGan

    rank0 = is_main(group)
    preprocess_fn = _resolve_preprocess_fn(args.preprocess)
    listing = sorted(os.listdir(args.input))
    gan = VanGan(cfg, device=device, group=group)
    if args.weights is not None:
        gan.load_weights(args.weights)
    elif args.epoch is not None:
        path = gan.weights_path(args.epoch)
        if rank0:
            print(f"Trying to load weights from path: {path}")
        if os.path.exists(path):
            gan.load_weights(path)
        elif rank0:
            # the JAX CLI's behaviour (vangan_tpu/checkpoint.py, reference vangan.py:268)
            print("Error: Checkpoint not found!")
    os.makedirs(args.output, exist_ok=True)
    if any(f.lower().endswith((".tif", ".tiff")) for f in listing):
        # the reference's "segment new data" recipe (main.py:255-270):
        # process_new_data on the host (rank 0), then run_mapping on the device
        from vangan_torch.data.preprocess import DataPreprocessor

        npy_dir = os.path.join(args.output, "preprocessed_npy")
        if rank0:
            pre = DataPreprocessor(cfg, partition_id="A", domain="imaging")
            pre.process_new_data(args.input, npy_dir, tiff_size=cfg.RAW_IMG_SIZE,
                                 target_size=cfg.TARG_RAW_IMG_SIZE, resize=args.resize,
                                 preprocess_fn=preprocess_fn)
        if group is not None:
            group.barrier()
        files = [os.path.join(npy_dir, f) for f in sorted(os.listdir(npy_dir))
                 if f.endswith(".npy")]
    else:
        files = [os.path.join(args.input, f) for f in listing if f.endswith(".npy")]
    run_mapping(gan, files, cfg.subvol_size, filetext="VANGAN_", filepath=args.output,
                segmentation=not args.fake_imaging, stride=tuple(args.stride))


def cmd_sweep(args) -> None:
    _run_ranks(args, _sweep)


def _sweep(args, cfg, device, group) -> None:
    from vangan_torch.inference.mapping import epoch_sweep
    from vangan_torch.vangan import VanGan

    gan = VanGan(cfg, device=device, steps_per_epoch=1, group=group)
    epoch_sweep(cfg, gan, args.input, start=args.start, end=args.end, step=args.step,
                segmentation=not args.fake_imaging)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="vangan_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "cuda (default) runs the CUDA kernels; cpu the plain versions"
    hook_help = ("imaging-domain preprocessing hook: 'rsom' (slice-wise z-score + percentile "
                 "clip, reference main.py:127-161) or a dotted path to a "
                 "np.ndarray->np.ndarray function")

    pp = sub.add_parser("preprocess", help="raw TIFFs -> npy + partitions (on the host)")
    pp.add_argument("--config", default=None)
    pp.add_argument("--imaging-raw", required=True)
    pp.add_argument("--seg-raw", required=True)
    pp.add_argument("--data-dir", required=True)
    pp.add_argument("--resize", action="store_true",
                    help="Lanczos-resize to TARG_RAW_IMG_SIZE / TARG_SYNTH_IMG_SIZE")
    pp.add_argument("--preprocess", default=None, metavar="rsom|pkg.mod:fn", help=hook_help)
    pp.set_defaults(fn=cmd_preprocess)

    pt = sub.add_parser("train", help="train VAN-GAN")
    pt.add_argument("--config", default=None)
    pt.add_argument("--data-dir", required=True)
    pt.add_argument("--output-dir", default=None)
    pt.add_argument("--resume-epoch", type=int, default=None)
    pt.add_argument("--semi-supervised-dir", default=None)
    pt.add_argument("--predict-after", action="store_true")
    pt.add_argument("--device", default="cuda", help=device_help)
    pt.set_defaults(fn=cmd_train)

    pr = sub.add_parser("predict",
                        help="sliding-window inference on .npy volumes or raw TIFFs")
    pr.add_argument("--config", default=None)
    pr.add_argument("--input", required=True,
                    help="directory of .npy volumes, or of raw .tiff files (preprocessed "
                         "into <output>/preprocessed_npy first, main.py:255-270)")
    pr.add_argument("--output", required=True)
    w = pr.add_mutually_exclusive_group()
    w.add_argument("--epoch", type=int, default=None,
                   help="load <output_dir>/checkpoints/torch_e<N>.pt")
    w.add_argument("--weights", default=None, help="a weights file of the port")
    pr.add_argument("--fake-imaging", action="store_true")
    pr.add_argument("--stride", type=int, nargs=3, default=(25, 25, 25))
    pr.add_argument("--resize", action="store_true",
                    help="Lanczos-resize raw TIFFs to TARG_RAW_IMG_SIZE")
    pr.add_argument("--preprocess", default=None, metavar="rsom|pkg.mod:fn",
                    help=hook_help + ", applied to raw TIFF inputs")
    pr.add_argument("--output-dir", default=None)
    pr.add_argument("--device", default="cuda", help=device_help)
    pr.set_defaults(fn=cmd_predict)

    ps = sub.add_parser("sweep", help="epoch sweep over checkpoints")
    ps.add_argument("--config", default=None)
    ps.add_argument("--input", required=True)
    ps.add_argument("--start", type=int, default=100)
    ps.add_argument("--end", type=int, default=200)
    ps.add_argument("--step", type=int, default=2)
    ps.add_argument("--fake-imaging", action="store_true")
    ps.add_argument("--output-dir", default=None)
    ps.add_argument("--device", default="cuda", help=device_help)
    ps.set_defaults(fn=cmd_sweep)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
