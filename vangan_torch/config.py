"""The configuration fields the port reads.

A subset of ``vangan_tpu.config.VanGanConfig`` with the same names and
defaults, read from the same YAML files: fields the port does not use yet are
ignored on load. It is a copy rather than an import so that the port, and
anything that imports it, runs without the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
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
    PREFETCH_SIZE: int = 4  # batches the data feed's prefetch thread holds
    # host sampler threads per split: 1 is the serial stream; W > 1 gives
    # each worker its own seeded sampler pair (deterministic per seed and W)
    DATA_WORKERS: int = 1
    INITIAL_LR: float = 2e-4
    INITIATE_LR_DECAY: Optional[float] = None  # derived: 0.5 * EPOCHS
    NO_NOISE: Optional[int] = None  # derived: EPOCHS (epoch when disc noise hits 0)
    CHANNELS: int = 1
    DIMENSIONS: int = 3
    # raw TIFF sizes and the sizes ``preprocess --resize`` makes of them, per
    # domain (main.py:79-86): imaging (x, y, z, c), segmentation (x, y, z)
    RAW_IMG_SIZE: Tuple[int, ...] = (512, 512, 140, 1)
    TARG_RAW_IMG_SIZE: Tuple[int, ...] = (512, 512, 128, 1)
    SYNTH_IMG_SIZE: Tuple[int, ...] = (512, 512, 128)
    TARG_SYNTH_IMG_SIZE: Tuple[int, ...] = (512, 512, 128)
    SUBVOL_PATCH_SIZE: Tuple[int, ...] = (128, 128, 128)

    # epoch-end panels and checkpoint every PERIOD_2D_CALLBACK epochs; the
    # stitched 3-D dump on PERIOD_3D_CALLBACK (main.py:104-105)
    PERIOD_2D_CALLBACK: int = 2
    PERIOD_3D_CALLBACK: int = 2

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
    gp_weight: float = 10.0  # WGAN-GP penalty weight, from the second step

    # data feed (dataset.py:48-49, 235)
    SEG_THRESH: float = 0.8  # a segmentation crop is kept when its max reaches this
    REJECTION_MAX_TRIES: int = 200

    # steps per epoch; None: from the partitions (main.py:189-193)
    train_steps: Optional[int] = None
    val_steps: Optional[int] = None

    gen_filters: int = 16
    disc_filters: int = 64
    seed: int = 0
    # gradient accumulation: each step runs the batch as ``micro_batches``
    # interleaved slices, one forward and backward each, the gradients summed
    # and ONE optimizer update (``training.step``); BATCH_SIZE % micro_batches
    # must be 0
    micro_batches: int = 1
    compute_dtype: str = "bfloat16"  # conv compute dtype; params always float32
    cldice_groups: Optional[int] = None  # derived: N_DEVICES
    # clDice skeleton on the CUDA kernel (a CUDA tensor) or on the plain torch
    # version; a CPU tensor always takes the plain version
    use_pallas_skeleton: bool = True
    stitcher_batch: int = 8  # patches per generator batch in sliding-window inference
    profile_dir: Optional[str] = None  # torch.profiler trace of the fit (None = off)
    debug_nans: bool = False  # autograd anomaly detection (vangan.py:290-292)
    plot_dataset_samples: bool = True  # the feed's sample panels at the start of train

    def __post_init__(self) -> None:
        if self.GLOBAL_BATCH_SIZE is None:
            self.GLOBAL_BATCH_SIZE = self.N_DEVICES * self.BATCH_SIZE
        if self.INITIATE_LR_DECAY is None:
            self.INITIATE_LR_DECAY = 0.5 * self.EPOCHS
        if self.NO_NOISE is None:
            self.NO_NOISE = self.EPOCHS
        if self.cldice_groups is None:
            self.cldice_groups = self.N_DEVICES
        if self.micro_batches < 1:
            # JAX runs its one-batch step for 0 or less; the port asks for 1
            raise ValueError(f"micro_batches ({self.micro_batches}) must be at least 1")
        if self.BATCH_SIZE % self.micro_batches:
            raise ValueError(f"micro_batches ({self.micro_batches}) must divide "
                             f"BATCH_SIZE ({self.BATCH_SIZE})")
        self.RAW_IMG_SIZE = tuple(self.RAW_IMG_SIZE)
        self.TARG_RAW_IMG_SIZE = tuple(self.TARG_RAW_IMG_SIZE)
        self.SYNTH_IMG_SIZE = tuple(self.SYNTH_IMG_SIZE)
        self.TARG_SYNTH_IMG_SIZE = tuple(self.TARG_SYNTH_IMG_SIZE)
        self.SUBVOL_PATCH_SIZE = tuple(self.SUBVOL_PATCH_SIZE)
        if self.DIMENSIONS not in (2, 3):
            raise ValueError(f"DIMENSIONS must be 2 or 3, got {self.DIMENSIONS}")

    # The patch geometry of both ranks (main.py:87-101): DIMENSIONS=2 takes
    # the first two sizes of SUBVOL_PATCH_SIZE, images (H, W, C).

    @property
    def _patch(self) -> Tuple[int, ...]:
        return self.SUBVOL_PATCH_SIZE[:self.DIMENSIONS]

    @property
    def subvol_size(self) -> Tuple[int, ...]:
        """The stitcher's ``(GB, kx, ky, kz, C)`` patch spec (the reference's
        INPUT_IMG_SIZE convention; the stitcher reads kx, ky, kz), in 2-D
        ``(GB, kH, kW, C)``."""
        return (self.stitcher_batch, *self._patch, 1)

    @property
    def INPUT_IMG_SIZE(self) -> Tuple[int, ...]:
        """The global batch's shape ``(GB, X, Y, Z, 1)``, in 2-D ``(GB, H, W, 1)``."""
        return (self.GLOBAL_BATCH_SIZE, *self._patch, 1)

    @property
    def subvol_patch_shape(self) -> Tuple[int, ...]:
        """Per-sample imaging patch shape with channels (vangan.py:53-54)."""
        return (*self._patch, self.CHANNELS)

    @property
    def seg_subvol_patch_shape(self) -> Tuple[int, ...]:
        """Per-sample segmentation patch shape (vangan.py:55-56)."""
        return (*self._patch, 1)

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

    def cap_devices(self, visible: int) -> int:
        """Cap ``N_DEVICES`` to the ``visible`` devices, 0 meaning all of them,
        as ``vangan_tpu``'s ``cmd_train`` does after ``__post_init__``:
        ``GLOBAL_BATCH_SIZE`` and ``cldice_groups`` keep the values derived
        from the requested count (a 0 derives them from the count used).
        Returns the count used; prints the cap where it cut a request."""
        requested = self.N_DEVICES
        self.N_DEVICES = min(requested or visible, visible)
        if self.GLOBAL_BATCH_SIZE == 0:
            self.GLOBAL_BATCH_SIZE = self.N_DEVICES * self.BATCH_SIZE
        if self.cldice_groups == 0:
            self.cldice_groups = self.N_DEVICES
        if requested > self.N_DEVICES:
            print(f"N_DEVICES={requested}: {visible} visible, running on {self.N_DEVICES}")
        return self.N_DEVICES

    def rank_batch(self, world: int) -> int:
        """Each of ``world`` ranks' share of the global batch,
        ``GLOBAL_BATCH_SIZE / world``; raises unless ``world`` is
        ``N_DEVICES`` and divides the global batch and ``cldice_groups``
        (each rank takes ``cldice_groups / world`` of the groups)."""
        if world != self.N_DEVICES:
            raise ValueError(f"{world} ranks for N_DEVICES={self.N_DEVICES}: data parallelism "
                             "runs one rank per device")
        for what, n in (("GLOBAL_BATCH_SIZE", self.GLOBAL_BATCH_SIZE),
                        ("cldice_groups", self.cldice_groups)):
            if n % world:
                raise ValueError(f"{what}={n} does not split over {world} ranks")
        return self.GLOBAL_BATCH_SIZE // world


def save_args(cfg, filename: str) -> None:
    """Dump every config field to a text file (utils.py:396-409 ``Args_Settings.txt``)."""

    def format_value(value):
        if isinstance(value, (tuple, list)):
            return f"({', '.join(map(str, value))})"
        return str(value)

    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        f.write("Command line arguments:\n")
        for arg, value in dataclasses.asdict(cfg).items():
            f.write(f"{arg}: {format_value(value)}\n")
