"""Batch inference over test-set file lists (``GanMonitor.run_mapping``,
custom_callback.py:466-509): counterpart of ``vangan_tpu.inference.mapping``."""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from vangan_torch.inference.stitcher import stitch_subvolumes


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
    """Map every ``.npy`` volume in ``test_set`` through gen_IS (segmentation)
    or gen_SI (fake imaging, with per-patch min-max) and save stitched TIFFs
    into ``filepath``."""
    gen = vangan.gen_IS_batched if segmentation else vangan.gen_SI_batched
    verb = "Segmenting" if segmentation else "Mapping"
    for n, path in enumerate(test_set):
        img = np.load(str(path))
        filename = os.path.splitext(os.path.basename(str(path)))[0]
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
        )
