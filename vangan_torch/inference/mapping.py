"""Batch inference over test-set file lists and the checkpoint epoch sweep:
counterpart of ``vangan_tpu.inference.mapping`` (``GanMonitor.run_mapping``,
custom_callback.py:466-509; ``post_training.epoch_sweep``,
post_training.py:4-39)."""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from vangan_torch.inference.stitcher import stitch_subvolumes
from vangan_torch.parallel import is_main


def run_mapping(
    vangan,
    test_set: Sequence[str],
    sub_img_size: Sequence[int] = (64, 64, 512, 1),
    segmentation: bool = True,
    stride: Tuple[int, int, int] = (25, 25, 1),
    padFactor: float = 0.25,
    filetext: Optional[str] = None,
    filepath: str = "",
    batch_size: Optional[int] = None,
    blend: str = "uniform",
) -> None:
    """Map every ``.npy`` volume (or, in the 2-D mode, image) in ``test_set``
    through gen_IS (segmentation) or gen_SI (fake imaging, with per-patch
    min-max) and save stitched TIFFs into ``filepath``. A ``vangan`` of data
    parallelism (``vangan.group``, ``cfg.N_DEVICES > 1``; the JAX package's
    mesh, mapping.py:42-48) splits each volume's patches over the ranks, and
    rank 0 writes the TIFFs; every rank calls this."""
    gen = vangan.gen_IS_batched if segmentation else vangan.gen_SI_batched
    group = getattr(vangan, "group", None)
    verb = "Segmenting" if segmentation else "Mapping"
    for n, path in enumerate(test_set):
        img = np.load(str(path))
        filename = os.path.splitext(os.path.basename(str(path)))[0]
        if is_main(group):
            print(f"{verb} {filename} ... ({n + 1} / {len(test_set)})")
        stitch_subvolumes(
            gen,
            img,
            sub_img_size,
            name=(filetext or "") + filename,
            output_path=filepath,
            complete=True,
            stride=stride,
            padFactor=padFactor,
            process_img=not segmentation,
            batch_size=batch_size or vangan.cfg.stitcher_batch,
            blend=blend,
            device=vangan.device,
            group=group,
        )


def epoch_sweep(
    cfg,
    vangan,
    test_path,
    start: int = 100,
    end: int = 200,
    step: int = 2,
    segmentation: bool = True,
    sub_img_size: Optional[Sequence[int]] = None,
) -> None:
    """Inference from every ``step``-th checkpoint in [start, end], for model
    selection (post_training.py:4-39): outputs go to
    ``<output_dir>/Epoch_Sampling/e{N}/``."""
    if isinstance(test_path, (list, tuple, np.ndarray)):
        test_files = [str(p) for p in test_path]
    else:
        test_files = [os.path.join(test_path, f) for f in sorted(os.listdir(test_path))]

    sweep_dir = os.path.join(cfg.output_dir, "Epoch_Sampling")
    os.makedirs(sweep_dir, exist_ok=True)
    for epoch in range(start, end + 1, step):
        vangan.load_checkpoint(epoch=epoch)
        out_dir = os.path.join(sweep_dir, f"e{epoch}")
        os.makedirs(out_dir, exist_ok=True)
        run_mapping(vangan, test_files, sub_img_size or cfg.INPUT_IMG_SIZE,
                    segmentation=segmentation, stride=(50, 50, 50), padFactor=0.1,
                    filetext="VANGAN_", filepath=out_dir)
