"""The port's optimizer (``vangan_torch.training.optimizers``) against the JAX
package's ``make_optimizer`` (optax: per-leaf clipnorm 100, then Adam b1 0.5,
b2 0.9, eps 1e-7 with the LR schedule, ``flatten_opt`` on) on the same
gradient sequence from the same parameters.

Six steps with ``steps_per_epoch=2`` and ``EPOCHS=4``: the LR is constant for
steps 0-3 and decays linearly from step 4 (``INITIATE_LR_DECAY`` = 2 epochs),
so the decay boundary is crossed; one leaf's gradients have norm > 100, so
the clip acts. Tolerance: rtol 1e-6 on the parameters (float32 elementwise
math in another order).
"""

import jax.numpy as jnp
import numpy as np
import optax
import torch

from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.training.optimizers import make_lr_schedule, make_optimizer
from vangan_torch.config import VanGanConfig
from vangan_torch.training.optimizers import (
    apply_gradients,
    clip_per_tensor_,
    lr_schedule,
)
from vangan_torch.training.optimizers import make_optimizer as make_torch_optimizer

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}


def test_lr_schedule_matches_optax():
    for epochs, spe in ((4, 2), (200, 7), (3, 1)):
        want = make_lr_schedule(JaxConfig(EPOCHS=epochs), spe)
        got = lr_schedule(VanGanConfig(EPOCHS=epochs), spe)
        for step in range(epochs * spe + 3):
            # optax computes the fraction in float32: 1e-6 of the peak LR
            np.testing.assert_allclose(got(step), float(want(step)), rtol=0, atol=2e-10)


def test_optimizer_matches_optax_over_six_steps(rng):
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for step in range(6):
        g = {k: (rng.normal(size=s) * 1e-2).astype(np.float32) for k, s in SHAPES.items()}
        g["a"] = g["a"] * 1e5  # norm ~ 1e3 > 100: the clip acts
        if step == 3:
            g["b"][:] = 0.0  # a zero gradient: the moments decay alone
        grads.append(g)
    assert all(np.linalg.norm(g["a"]) > 100 for g in grads)

    tx = make_optimizer(JaxConfig(EPOCHS=4), steps_per_epoch=2)
    want = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(want)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, want)
        want = optax.apply_updates(want, updates)

    leaves = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in SHAPES]
    opt = make_torch_optimizer(VanGanConfig(EPOCHS=4), leaves)
    lr = lr_schedule(VanGanConfig(EPOCHS=4), 2)
    for step, g in enumerate(grads):
        apply_gradients(opt, [torch.from_numpy(g[k].copy()) for k in SHAPES], lr(step))
    assert all(int(opt.state[p]["step"]) == 6 for p in leaves)
    for k, p in zip(SHAPES, leaves):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)


def test_clip_is_per_tensor():
    g = [torch.tensor([300.0, 400.0]), torch.tensor([1.0, 2.0, 2.0]), torch.zeros(2)]
    clip_per_tensor_(g)
    np.testing.assert_allclose(torch.cat(g).numpy(), [60.0, 80.0, 1.0, 2.0, 2.0, 0.0, 0.0],
                               rtol=1e-6)
