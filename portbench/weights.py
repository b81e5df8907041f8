"""Seeded weights of the four networks, made on the device in a few large
calls: one truncated-normal draw (at +-2 standard deviations) for every
conv weight and he-normal gamma of all four networks together, from a
``torch.Generator`` on the device seeded with the run's seed, then scaled
per leaf to variance 2 / fan_in (flax's truncated ``variance_scaling``:
std sqrt(2 / fan_in) / 0.8796); ones and zeros as the spec says. The same
float32 state dicts go to the program and to the reference. A network's
state (its buffers, ``state``) is ones and zeros, made apart and with no
draw, so the draw covers the same leaves whatever state a network holds."""

from __future__ import annotations

from typing import Dict

import torch

TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def make(specs: Dict[str, dict], seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """network -> name -> float32 tensor on ``device``, for ``specs``
    (network -> name -> (shape, init))."""
    drawn = [(n, k, shape, init[1]) for n in sorted(specs) for k, (shape, init)
             in sorted(specs[n].items()) if isinstance(init, tuple)]
    total = sum(_numel(shape) for _, _, shape, _ in drawn)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    out = {n: {} for n in specs}
    at = 0
    for n, k, shape, fan in drawn:
        size = _numel(shape)
        out[n][k] = (flat[at:at + size] * ((2.0 / fan) ** 0.5 / TRUNC_STD)).view(shape)
        at += size
    for n in specs:
        for k, (shape, init) in specs[n].items():
            if not isinstance(init, tuple):
                out[n][k] = _constant(shape, init, device)
    return out


def state(specs: Dict[str, dict], device) -> Dict[str, Dict[str, torch.Tensor]]:
    """network -> name -> float32 tensor on ``device`` of each network's state
    (``reference.step.state_specs``): ones or zeros, with no draw."""
    return {n: {k: _constant(shape, init, device) for k, (shape, init) in s.items()}
            for n, s in specs.items()}


def _constant(shape, init: str, device) -> torch.Tensor:
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    raise ValueError(f"unknown init {init!r}")


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
