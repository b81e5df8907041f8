"""The four networks of the VAN-GAN system, in the JAX package's order, and
the train step's state."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

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

    def apply(self, name: str, grads: List[torch.Tensor]) -> None:
        """One clipped Adam update of network ``name`` at its scheduled LR."""
        apply_gradients(self.opt[name], grads, self.lr(self.counts[name]))
        self.counts[name] += 1


def make_train_state(nets: Dict[str, nn.Module], cfg, steps_per_epoch: int) -> TrainState:
    return TrainState(step=0, opt={name: make_optimizer(cfg, nets[name].parameters())
                                   for name in NETWORKS},
                      lr=lr_schedule(cfg, steps_per_epoch),
                      counts={name: 0 for name in NETWORKS})
