"""The four networks of the VAN-GAN system, in the JAX package's order, and
the train step's state."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from vangan_torch.training.optimizers import apply_gradients, lr_schedule, make_optimizer

NETWORKS = ("gen_IS", "gen_SI", "disc_I", "disc_S")


@dataclass
class TrainState:
    """The step counter, one optimizer per network and the updates each has
    taken (the LR schedule's index): the counterpart of
    ``vangan_tpu.training.state.VanGanState`` less the parameters, which the
    networks hold."""

    step: int
    opt: Dict[str, torch.optim.Adam]
    lr: Callable[[int], float]
    counts: Dict[str, int]
    clipnorm: Optional[float] = 100.0  # per-tensor clip (None on the WGAN path)

    def apply(self, name: str, grads: List[torch.Tensor]) -> None:
        """One Adam update of network ``name`` at its scheduled LR."""
        apply_gradients(self.opt[name], grads, self.lr(self.counts[name]), self.clipnorm)
        self.counts[name] += 1

    def state_dict(self) -> dict:
        """The four optimizers' state_dicts, ``counts`` and ``step``: the
        ``train_state`` entry of a checkpoint."""
        return {"opt": {name: self.opt[name].state_dict() for name in NETWORKS},
                "counts": dict(self.counts), "step": self.step}

    def init_moments(self) -> None:
        """Give every parameter its Adam state (see ``init_adam_state``).
        Only checkpoints need it, as the layout a file is checked against,
        so serving and evaluation, which never update, hold no moments."""
        for o in self.opt.values():
            init_adam_state(o)

    def load_state_dict(self, state: dict) -> None:
        for name in NETWORKS:
            self.opt[name].load_state_dict(state["opt"][name])
        self.counts = {name: int(state["counts"][name]) for name in NETWORKS}
        self.step = int(state["step"])


def init_adam_state(opt: torch.optim.Adam) -> None:
    """Give every parameter that has none the state that ``torch.optim.Adam``
    creates at its first update (step 0, zero moments), as optax's ``init``
    does."""
    for group in opt.param_groups:
        for p in group["params"]:
            if not opt.state[p]:
                opt.state[p] = {"step": torch.zeros((), dtype=torch.float32, device=p.device),
                                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                                "exp_avg_sq": torch.zeros_like(
                                    p, memory_format=torch.preserve_format)}


def make_train_state(nets: Dict[str, nn.Module], cfg, steps_per_epoch: int) -> TrainState:
    opt = {name: make_optimizer(cfg, nets[name].parameters()) for name in NETWORKS}
    return TrainState(step=0, opt=opt, lr=lr_schedule(cfg, steps_per_epoch),
                      counts={name: 0 for name in NETWORKS},
                      clipnorm=None if cfg.wasserstein else 100.0)
