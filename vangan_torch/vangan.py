"""The ``VanGan`` facade of the port: the four networks on one device.

Counterpart of ``vangan_tpu.vangan.VanGan`` and its free ``train`` loop
(vangan.py:20-550) as far as the port goes: serving (``gen_IS_batched``,
``gen_SI_batched``, weights by epoch), training (``distributed_train_step``,
``train(..., training=True)``) and evaluation (``distributed_test_step``,
``train(..., training=False)``). The data feed, checkpoints of the optimizer
state and the epoch loop are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from vangan_torch.config import VanGanConfig
from vangan_torch.device import resolve_device
from vangan_torch.losses import LossScales
from vangan_torch.models.factory import build_discriminator, build_generator
from vangan_torch.training import step
from vangan_torch.training.state import NETWORKS, make_train_state


def append_dict(dict1: dict, dict2: dict) -> dict:
    """Accumulate per-step loss dicts into lists (utils.py:319-350)."""
    for key, value in dict2.items():
        dict1.setdefault(key, []).append(value)
    return dict1


class VanGan:
    """gen_IS (imaging -> segmentation), gen_SI (segmentation -> imaging),
    disc_I and disc_S on ``device`` (the card unless ``device="cpu"``; without
    CUDA a CUDA device raises), initialised from ``cfg.seed``, or the networks
    of ``models`` (a dict keyed by ``NETWORKS``), with one optimizer each whose
    LR schedule counts ``steps_per_epoch`` (default ``cfg.train_steps``, else
    1) steps to an epoch."""

    def __init__(self, cfg: VanGanConfig, device="cuda",
                 models: Optional[Dict[str, torch.nn.Module]] = None,
                 steps_per_epoch: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.steps_per_epoch = steps_per_epoch or cfg.train_steps or 1
        if models is None:
            g = torch.Generator().manual_seed(cfg.seed)
            models = {"gen_IS": build_generator(cfg.gen_i2s, cfg, role="i2s", generator=g),
                      "gen_SI": build_generator(cfg.gen_s2i, cfg, role="s2i", generator=g),
                      "disc_I": build_discriminator(cfg, generator=g),
                      "disc_S": build_discriminator(cfg, generator=g)}
        self.nets = {name: models[name].to(self.device).eval() for name in NETWORKS}
        self.scales = LossScales.from_config(cfg)
        self.state = make_train_state(self.nets, cfg, self.steps_per_epoch)
        # noise and dropout draws of the train step
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

    gen_IS = property(lambda self: self.nets["gen_IS"])
    gen_SI = property(lambda self: self.nets["gen_SI"])
    disc_I = property(lambda self: self.nets["disc_I"])
    disc_S = property(lambda self: self.nets["disc_S"])

    def set_use_kernels(self, enabled: bool) -> None:
        """Every network's convs and InstanceNorms, and the clDice skeleton, on
        the hand-written kernels (True, the default) or on the plain torch
        versions (False)."""
        for net in self.nets.values():
            net.set_use_kernels(enabled)
        self.scales = dataclasses.replace(self.scales, use_pallas_skeleton=enabled)

    def gen_IS_batched(self, x: torch.Tensor) -> torch.Tensor:
        """gen_IS on a (B, X, Y, Z, 1) batch on the device; float32 out."""
        with torch.inference_mode():
            return self.gen_IS(x)

    def gen_SI_batched(self, x: torch.Tensor) -> torch.Tensor:
        """gen_SI on a (B, X, Y, Z, 1) batch on the device; float32 out."""
        with torch.inference_mode():
            return self.gen_SI(x)

    def distributed_train_step(self, real_I, real_S, noise_std: float,
                               update_gen: bool) -> Dict[str, torch.Tensor]:
        """One optimisation step of the four networks on a (B, X, Y, Z, 1)
        imaging and segmentation batch (numpy or torch), discriminator noise
        σ ``noise_std``, the generators updated only with ``update_gen``:
        the losses as a dict of 0-d tensors on the device."""
        x = torch.as_tensor(real_I, dtype=torch.float32).to(self.device)
        y = torch.as_tensor(real_S, dtype=torch.float32).to(self.device)
        return step.train_step(self.nets, self.cfg, self.scales, self.state, x, y,
                               float(noise_std), bool(update_gen), self.generator)

    def distributed_test_step(self, real_I, real_S) -> Dict[str, torch.Tensor]:
        """The losses of one (B, X, Y, Z, 1) imaging and segmentation batch
        (numpy or torch), without gradients: a dict of 0-d tensors on the device."""
        x = torch.as_tensor(real_I, dtype=torch.float32).to(self.device)
        y = torch.as_tensor(real_S, dtype=torch.float32).to(self.device)
        return step.test_step(self.nets, self.cfg, self.scales, x, y)

    def weights_path(self, epoch: int) -> str:
        """Where weights of ``epoch`` live: ``<output_dir>/checkpoints/torch_e{epoch}.pt``."""
        return os.path.join(self.cfg.output_dir, "checkpoints", f"torch_e{epoch}.pt")

    def save_weights(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({name: net.state_dict() for name, net in self.nets.items()}, path)

    def load_weights(self, path: str) -> None:
        """Load each network the file holds (strictly); both generators are
        required, so a generators-only file loads for serving."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        missing = [n for n in ("gen_IS", "gen_SI") if n not in state]
        if missing:
            raise KeyError(f"{path} holds no {', '.join(missing)}")
        for name, net in self.nets.items():
            if name in state:
                net.load_state_dict(state[name], strict=True)


def train(ds: Iterable[Tuple[np.ndarray, np.ndarray]], gan: VanGan, summary, epoch: int,
          steps: Optional[int] = None, desc: Optional[str] = None, training: bool = False,
          noise_std: float = 0.0) -> Dict[str, list]:
    """One epoch (vangan.py:510-550): on each batch of ``ds`` (at most
    ``steps``) the train step with noise σ ``noise_std`` (``training``) or
    the test step, then ``summary.scalar(key, mean, epoch=, training=)`` for
    each loss; returns the per-step values by key. Results stay on the device
    and are fetched 32 steps at a time. Every step updates the generators:
    the ncritic bookkeeping of vangan.py:535-544 acts only on the WGAN path,
    which the config refuses."""
    results: Dict[str, list] = {}
    pending: list = []

    def drain() -> None:
        if pending:
            keys = list(pending[0])
            rows = torch.stack([torch.stack([r[k] for k in keys]) for r in pending])
            for row in rows.cpu().tolist():  # one device-to-host copy per chunk
                append_dict(results, dict(zip(keys, row)))
            pending.clear()

    cntr = 0
    iterator = iter(ds)  # a shared iterator: take no batch beyond ``steps``
    while steps is None or cntr < steps:
        try:
            x, y = next(iterator)
        except StopIteration:
            break
        cntr += 1
        if training:
            pending.append(gan.distributed_train_step(x, y, noise_std, True))
        else:
            pending.append(gan.distributed_test_step(x, y))
        if len(pending) >= 32:
            drain()
    drain()
    if desc:
        print(f"{desc}: {cntr} steps")
    for key, value in results.items():
        summary.scalar(key, float(np.mean(value)), epoch=epoch, training=training)
    return results
