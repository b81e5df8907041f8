"""The train step's optimizers, one per network, and the step-indexed LR
schedule.

Counterpart of ``vangan_tpu.training.optimizers`` (optimizers.py:23-88):

- LSGAN: Keras Adam with per-tensor clipnorm: each gradient tensor is
  clipped to L2 norm <= 100 on its own (``g * min(1, 100 / max(||g||,
  1e-12))``), then ``torch.optim.Adam`` with b1 0.5, b2 0.9 and eps 1e-7,
  whose update is optax's: ``m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) +
  eps)``, eps outside the square root. The LR is ``INITIAL_LR`` until step
  ``int(INITIATE_LR_DECAY * steps_per_epoch)``, then linear to 0 at ``EPOCHS
  * steps_per_epoch`` (``optax.join_schedules`` indexing: step n of the
  optimizer uses lr(n), counted from 0).
- WGAN: Adam with b1 0, b2 0.9 and eps 1e-7 at a constant 1e-4 (the JAX
  package's ``make_lr_schedule``, from the reference's vangan.py:197-204),
  without clipping.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch


WGAN_LR = 1e-4


def lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Constant ``INITIAL_LR``, then linear decay to 0; WGAN: constant
    ``WGAN_LR`` (make_lr_schedule)."""
    if cfg.wasserstein:
        return lambda step: WGAN_LR
    decay_start = cfg.decay_start_step(steps_per_epoch)
    transition = max(1, cfg.total_steps(steps_per_epoch) - decay_start)

    def lr(step: int) -> float:
        if step < decay_start:
            return cfg.INITIAL_LR
        done = min(max(step - decay_start, 0), transition)
        return cfg.INITIAL_LR * (1.0 - done / transition)

    return lr


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    """Adam(b1 .5, b2 .9, eps 1e-7) of one network, b1 0 for WGAN;
    ``apply_gradients`` sets the LR of each update."""
    b1 = 0.0 if cfg.wasserstein else 0.5
    return torch.optim.Adam(list(params), lr=cfg.INITIAL_LR, betas=(b1, 0.9), eps=1e-7,
                            fused=True)


@torch.no_grad()
def clip_per_tensor_(grads: List[torch.Tensor], clipnorm: float = 100.0) -> None:
    """Scale each gradient tensor in place to L2 norm <= ``clipnorm``."""
    scales = torch._foreach_norm(grads)
    torch._foreach_clamp_min_(scales, 1e-12)
    torch._foreach_reciprocal_(scales)
    torch._foreach_mul_(scales, clipnorm)
    torch._foreach_clamp_max_(scales, 1.0)
    torch._foreach_mul_(grads, scales)


def apply_gradients(opt: torch.optim.Adam, grads: List[torch.Tensor], lr: float,
                    clipnorm: Optional[float] = 100.0) -> None:
    """One update of ``opt``'s parameters from ``grads`` (one per parameter,
    clipped here in place to ``clipnorm``, unless None) at learning rate ``lr``."""
    if clipnorm is not None:
        clip_per_tensor_(grads, clipnorm)
    group = opt.param_groups[0]
    for p, g in zip(group["params"], grads):
        p.grad = g
    group["lr"] = lr
    opt.step()
    opt.zero_grad(set_to_none=True)
