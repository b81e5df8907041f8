"""The serving side of the ``VanGan`` facade: both generators on one device.

Counterpart of the inference surface of ``vangan_tpu.vangan.VanGan``
(``gen_IS_batched``, ``gen_SI_batched``, weights by epoch). The
discriminators, optimizers and train step come with the training slice.
"""

from __future__ import annotations

import os

import torch

from vangan_torch.config import VanGanConfig
from vangan_torch.models.factory import build_generator


class VanGan:
    """gen_IS (imaging -> segmentation) and gen_SI (segmentation -> imaging)
    on ``device``, initialised from ``cfg.seed``."""

    def __init__(self, cfg: VanGanConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        g = torch.Generator().manual_seed(cfg.seed)
        self.gen_IS = build_generator(cfg.gen_i2s, cfg, role="i2s", generator=g)
        self.gen_SI = build_generator(cfg.gen_s2i, cfg, role="s2i", generator=g)
        self.gen_IS.to(self.device).eval()
        self.gen_SI.to(self.device).eval()

    def gen_IS_batched(self, x: torch.Tensor) -> torch.Tensor:
        """gen_IS on a (B, X, Y, Z, 1) batch on the device; float32 out."""
        with torch.inference_mode():
            return self.gen_IS(x)

    def gen_SI_batched(self, x: torch.Tensor) -> torch.Tensor:
        """gen_SI on a (B, X, Y, Z, 1) batch on the device; float32 out."""
        with torch.inference_mode():
            return self.gen_SI(x)

    def weights_path(self, epoch: int) -> str:
        """Where weights of ``epoch`` live: ``<output_dir>/checkpoints/torch_e{epoch}.pt``."""
        return os.path.join(self.cfg.output_dir, "checkpoints", f"torch_e{epoch}.pt")

    def save_weights(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({"gen_IS": self.gen_IS.state_dict(), "gen_SI": self.gen_SI.state_dict()},
                   path)

    def load_weights(self, path: str) -> None:
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.gen_IS.load_state_dict(state["gen_IS"], strict=True)
        self.gen_SI.load_state_dict(state["gen_SI"], strict=True)
