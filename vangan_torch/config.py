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
    EPOCHS: int = 200
    BATCH_SIZE: int = 3  # per-device batch
    GLOBAL_BATCH_SIZE: Optional[int] = None  # derived: N_DEVICES * BATCH_SIZE
    INITIAL_LR: float = 2e-4
    INITIATE_LR_DECAY: Optional[float] = None  # derived: 0.5 * EPOCHS
    NO_NOISE: Optional[int] = None  # derived: EPOCHS (epoch when disc noise hits 0)
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
    ncritic: int = 5  # generator update every ncritic steps (WGAN only)
    train_steps: Optional[int] = None  # steps per epoch of the LR schedule, if known

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
        if self.INITIATE_LR_DECAY is None:
            self.INITIATE_LR_DECAY = 0.5 * self.EPOCHS
        if self.NO_NOISE is None:
            self.NO_NOISE = self.EPOCHS
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

    def decay_start_step(self, steps_per_epoch: int) -> int:
        return int(self.INITIATE_LR_DECAY * steps_per_epoch)

    def total_steps(self, steps_per_epoch: int) -> int:
        return int(self.EPOCHS * steps_per_epoch)

    def noise_std_at_epoch(self, epoch: int) -> float:
        """σ(epoch) of the discriminator noise (custom_callback.py:399-424):
        linear from ``layer_noise`` to 0 at epoch NO_NOISE, clamped at 0."""
        decay_rate = 1.0 if self.NO_NOISE == 0 else epoch / self.NO_NOISE
        return max(0.0, self.layer_noise * (1.0 - decay_rate))

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
