"""Per-epoch monitoring: schedules, sample panels, model export.

Counterpart of ``vangan_tpu.monitor.gan_monitor.GanMonitor`` (the
reference's ``GanMonitor``, custom_callback.py:12-464). The LR schedule is
indexed by the update count inside the train state and the discriminator
noise σ is an argument of the step, so the epoch hooks report and return
values. Panels are drawn with Pillow (``monitor.panels``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from vangan_torch.data.pipeline import random_crop
from vangan_torch.inference.stitcher import stitch_subvolumes
from vangan_torch.monitor.panels import grey_tile, histogram_tile, save_grid
from vangan_torch.training.optimizers import lr_schedule


class GanMonitor:
    """Schedules at epoch start, panels at epoch end (custom_callback.py:12-31)."""

    def __init__(
        self,
        cfg,
        dataset=None,
        imaging_val_data: Optional[Sequence[str]] = None,
        segmentation_val_data: Optional[Sequence[str]] = None,
        process_imaging_domain: Optional[Callable] = None,
        monitor_dir: str = "GANMonitor",
    ):
        self.cfg = cfg
        self.imgSize = cfg.INPUT_IMG_SIZE
        self.dataset = dataset
        self.imaging_val_data = imaging_val_data
        self.segmentation_val_data = segmentation_val_data
        self.process_imaging_domain = process_imaging_domain
        self.period = cfg.PERIOD_2D_CALLBACK
        self.period3D = cfg.PERIOD_3D_CALLBACK
        self.model_path = cfg.output_dir
        self.monitor_dir = monitor_dir
        os.makedirs(monitor_dir, exist_ok=True)
        self._rng = np.random.default_rng(cfg.seed + 77)
        self._img_iter = self._seg_iter = None

    # --- schedules (custom_callback.py:326-424) ---

    def noise_std(self, epoch: int) -> float:
        return self.cfg.noise_std_at_epoch(epoch)

    def current_lr(self, epoch: int, steps_per_epoch: int) -> float:
        return float(lr_schedule(self.cfg, steps_per_epoch)(epoch * steps_per_epoch))

    def on_epoch_start(self, model, epoch: int, steps_per_epoch: Optional[int] = None) -> float:
        """Print σ(epoch) and the LR; return σ for the train step."""
        std = self.noise_std(epoch)
        print(f"Noise std: {std:.5f}")
        if steps_per_epoch:
            print(f"Learning rate: {self.current_lr(epoch, steps_per_epoch):.8f}")
        return std

    # --- model export (custom_callback.py:33-45) ---

    def save_model(self, model, epoch: int) -> str:
        """The standalone bundle of ``checkpoint.export_models``."""
        from vangan_torch.checkpoint import export_models

        return export_models(self.cfg, model.nets, epoch, out_dir=self.model_path)

    # --- sample panels (custom_callback.py:225-324) ---

    def imagePlotter(self, model, epoch: int, filename: str, setlist: Sequence[str],
                     dataset_iter, genX: Callable, genY: Callable, nfig: int = 6,
                     outputFull: bool = False, process_img: bool = False) -> None:
        """``{epoch+1}_{filename}.png``: ``nfig`` z-slices of a random
        validation crop, its translation by ``genX``, the cycle back by
        ``genY`` and ``genY``'s identity map, over a histogram row (a 2-D
        crop: one image row over the histogram row); and the stitched volume
        on the ``PERIOD_3D_CALLBACK`` cadence after epoch 160."""
        sample_full, idx = next(dataset_iter)
        sample_name = os.path.splitext(os.path.basename(str(setlist[idx])))[0]
        sample = random_crop(sample_full, self.imgSize[1:], self._rng)[None]
        if process_img and self.process_imaging_domain is not None:
            sample = self.process_imaging_domain(sample)

        def apply(gen, x):
            return gen(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(model.device)
                       ).float().cpu().numpy()

        prediction = apply(genX, sample)
        cycled = apply(genY, prediction)
        identity = apply(genY, sample)
        panels = (sample[0], prediction[0], cycled[0], identity[0])
        titles = ("Input image", "Translated image", "Cycled image", "Identity image")
        if panels[0].ndim == 3:  # DIMENSIONS=2 (gan_monitor.py:115-117 of the JAX package)
            columns = [[grey_tile(arr[:, :, 0], title), histogram_tile(arr)]
                       for arr, title in zip(panels, titles)]
        else:
            depth = panels[0].shape[2]
            columns = [[grey_tile(arr[:, :, j * int(depth / nfig), 0], title)
                        for j in range(nfig)] + [histogram_tile(arr)]
                       for arr, title in zip(panels, titles)]
        save_grid(os.path.join(self.monitor_dir, f"{epoch + 1}_{filename}.png"), columns)

        # the 3-D dump's cadence (custom_callback.py:322-324)
        if epoch % self.period3D == 1 and outputFull and epoch > 160:
            stitch_subvolumes(genX, sample_full, self.imgSize, epoch=epoch, name=sample_name,
                              process_img=process_img, model_path=self.model_path,
                              batch_size=self.cfg.stitcher_batch, device=model.device)

    def on_epoch_end(self, model, epoch: int) -> None:
        """Panels of both generators (custom_callback.py:446-464)."""
        if self.dataset is None:
            return
        if self._img_iter is None:
            self._img_iter = self.dataset.imaging_val_full()
            self._seg_iter = self.dataset.segmentation_val_full()
        self.imagePlotter(model, epoch, "genIS", self.imaging_val_data, self._img_iter,
                          model.gen_IS_batched, model.gen_SI_batched, process_img=True)
        self.imagePlotter(model, epoch, "genSI", self.segmentation_val_data, self._seg_iter,
                          model.gen_SI_batched, model.gen_IS_batched, outputFull=True)
