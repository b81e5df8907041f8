"""The random draws of a train step, taken from a ``torch.Generator`` in the
order the step makes them, and kept so that a recomputation gets them again.

A ``Segment`` belongs to one network call. Its first pass draws from the
shared generator and keeps each tensor; after ``rewind`` the same tensors
come back in the same order, with no new draw. So a call that
``torch.utils.checkpoint`` recomputes during the backward, or a fake that is
judged twice with the same noise, draws once. Gaussian noise is drawn in
``noise_dtype`` (the configuration's compute dtype, in which the measured
program adds it) and returned as float32; dropout's uniforms are float32.
Without a generator (shape-only work counts on the ``meta`` device) the
draws are zeros.
"""

from __future__ import annotations

from typing import Optional

import torch


class Draws:
    def __init__(self, generator: Optional[torch.Generator], device, noise_dtype: torch.dtype):
        self.generator = generator
        self.device = device
        self.noise_dtype = noise_dtype

    def segment(self) -> "Segment":
        return Segment(self)


class Segment:
    def __init__(self, draws: Draws):
        self.draws = draws
        self.kept = []
        self.i = 0

    def rewind(self) -> "Segment":
        self.i = 0
        return self

    def _next(self, make):
        if self.i == len(self.kept):
            self.kept.append(make())
        t = self.kept[self.i]
        self.i += 1
        return t

    def randn(self, shape) -> torch.Tensor:
        d = self.draws
        if d.generator is None:
            return self._next(lambda: torch.zeros(shape, device=d.device))
        return self._next(lambda: torch.randn(shape, dtype=d.noise_dtype, device=d.device,
                                              generator=d.generator).float())

    def rand(self, shape) -> torch.Tensor:
        d = self.draws
        if d.generator is None:
            return self._next(lambda: torch.zeros(shape, device=d.device))
        return self._next(lambda: torch.rand(shape, device=d.device, generator=d.generator))
