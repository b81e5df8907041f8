"""The configuration fields the port reads.

A subset of ``vangan_tpu.config.VanGanConfig`` with the same names and
defaults, read from the same YAML files: fields the port does not use yet are
ignored on load. It is a copy rather than an import so that the port, and
anything that imports it, runs without the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import yaml


@dataclass
class VanGanConfig:
    output_dir: str = "./VG_Output"
    N_DEVICES: int = 1
    BATCH_SIZE: int = 3  # per-device batch
    GLOBAL_BATCH_SIZE: Optional[int] = None  # derived: N_DEVICES * BATCH_SIZE
    DIMENSIONS: int = 3
    SUBVOL_PATCH_SIZE: Tuple[int, ...] = (128, 128, 128)

    # loss weights and types (vangan.py:25-34, loss_functions.py defaults)
    lambda_cycle: float = 10.0
    lambda_identity: float = 5.0
    lambda_reconstruction: float = 5.0
    lambda_topology: float = 5.0
    gen_i2s: str = "resUnet"
    gen_s2i: str = "resUnet"
    wasserstein: bool = False
    cldice_iters: int = 15
    cldice_alpha: float = 0.5
    cycle_loss_I_type: str = "bce"  # seg cycle
    cycle_loss_S_type: str = "mse"  # imaging cycle
    use_identity_loss: bool = False
    identity_loss_IS_type: str = "cldice"
    identity_loss_SI_type: str = "mae"
    layer_noise: float = 0.1  # discriminator noise sigma

    gen_filters: int = 16
    disc_filters: int = 64
    seed: int = 0
    compute_dtype: str = "bfloat16"  # conv compute dtype; params always float32
    cldice_groups: Optional[int] = None  # derived: N_DEVICES
    # clDice skeleton on the CUDA kernel (a CUDA tensor) or on the plain torch
    # version; a CPU tensor always takes the plain version
    use_pallas_skeleton: bool = True
    stitcher_batch: int = 8  # patches per generator batch in sliding-window inference

    def __post_init__(self) -> None:
        if self.GLOBAL_BATCH_SIZE is None:
            self.GLOBAL_BATCH_SIZE = self.N_DEVICES * self.BATCH_SIZE
        if self.cldice_groups is None:
            self.cldice_groups = self.N_DEVICES
        self.SUBVOL_PATCH_SIZE = tuple(self.SUBVOL_PATCH_SIZE)
        if self.DIMENSIONS != 3:
            raise NotImplementedError("DIMENSIONS=2 is not ported yet "
                                      "(ROADMAP.md Queue 1, other families and modes)")
        if self.wasserstein:
            raise NotImplementedError("wasserstein=True (WGAN-GP) is not ported yet "
                                      "(ROADMAP.md Queue 1, other families and modes)")

    @property
    def subvol_size(self) -> Tuple[int, ...]:
        """The stitcher's ``(GB, kx, ky, kz, C)`` patch spec (the reference's
        INPUT_IMG_SIZE convention; the stitcher reads kx, ky, kz)."""
        return (self.stitcher_batch, *self.SUBVOL_PATCH_SIZE[:3], 1)

    @classmethod
    def from_dict(cls, d: dict) -> "VanGanConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml(cls, path: str) -> "VanGanConfig":
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f, sort_keys=False)
