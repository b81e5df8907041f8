"""The configuration fields the port reads.

A subset of ``vangan_tpu.config.VanGanConfig`` with the same names and
defaults, read from the same YAML files: fields the port does not use yet are
ignored on load. It is a copy rather than an import so that the port, and
anything that imports it, runs without the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import yaml


@dataclass
class VanGanConfig:
    output_dir: str = "./VG_Output"
    DIMENSIONS: int = 3
    SUBVOL_PATCH_SIZE: Tuple[int, ...] = (128, 128, 128)
    gen_i2s: str = "resUnet"
    gen_s2i: str = "resUnet"
    gen_filters: int = 16
    seed: int = 0
    compute_dtype: str = "bfloat16"  # conv compute dtype; params always float32
    stitcher_batch: int = 8  # patches per generator batch in sliding-window inference

    def __post_init__(self) -> None:
        self.SUBVOL_PATCH_SIZE = tuple(self.SUBVOL_PATCH_SIZE)
        if self.DIMENSIONS != 3:
            raise NotImplementedError("DIMENSIONS=2 is not ported yet "
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
