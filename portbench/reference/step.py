"""The reference CycleGAN train step in plain PyTorch: the losses of one
forward of the whole graph, one backward, per-tensor clipping and Adam.

Its graph follows VAN-GAN's train step (psweens/VAN-GAN ``vangan.py``
``train_step``) as the JAX package restricts each optimizer's gradient, in
one backward of the sum of the four totals:

- fake_S = G_IS(real_I), fake_I = G_SI(real_S); the cycles run the other
  generator on the *detached* fakes;
- each discriminator judges its real batch, and each fake twice with the
  same noise and dropout: with its parameters detached (the generator's
  adversarial loss) and on the detached fake (its own loss);
- totals: G_IS: LSGAN + seg cycle BCE + Dice/clDice; G_SI: LSGAN + imaging
  cycle MSE + SSIM reconstruction; each D: 0.5 (MSE(1, real) + MSE(0, fake)).

Each network call runs under ``torch.utils.checkpoint`` when ``ckpt`` is set,
so an f32 step at 3 x 128^3 holds one network's activations at a time; the
random draws (``draws.Segment``) come back unchanged in the recomputation.
The update: each gradient tensor clipped to L2 norm 100 on its own, then
Adam (b1 0.5, b2 0.9, eps 1e-7 outside the square root) at the scheduled
learning rate.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import losses
from portbench.reference.draws import Draws
from portbench.reference.layers import Ctx
from portbench.reference.nets import kind

NETWORKS = ("gen_IS", "gen_SI", "disc_I", "disc_S")
RESULT_KEYS = ("total_IS_loss", "total_SI_loss", "D_I_loss", "D_S_loss", "gen_IS_loss",
               "gen_SI_loss", "cycle_gen_SIS_loss", "cycle_gen_ISI_loss", "seg_loss",
               "reconstruction_loss_I")
CLIPNORM = 100.0
B1, B2, EPS = 0.5, 0.9, 1e-7


def network_kinds(fields: dict) -> Dict[str, object]:
    return {"gen_IS": kind(fields["gen_i2s"]), "gen_SI": kind(fields["gen_s2i"]),
            "disc_I": kind("patchgan"), "disc_S": kind("patchgan")}


def _specs(fields: dict) -> Dict[str, object]:
    roles = {"gen_IS": "i2s", "gen_SI": "s2i", "disc_I": "disc", "disc_S": "disc"}
    return {n: k.spec(fields, roles[n]) for n, k in network_kinds(fields).items()}


def specs(fields: dict) -> Dict[str, dict]:
    """Every network's leaves (its parameters): name -> (shape, init)."""
    return {n: s.leaves for n, s in _specs(fields).items()}


def state_specs(fields: dict) -> Dict[str, dict]:
    """Every network's state (the program's buffers): name -> (shape, init)."""
    return {n: s.state for n, s in _specs(fields).items()}


def compute_losses(fields: dict, P: Dict[str, dict], real_I: torch.Tensor, real_S: torch.Tensor,
                   draws: Draws, noise_std: float, ctx: Ctx, ckpt: bool = True):
    """(the sum of the four totals, the loss dict) of one training forward."""
    nets = network_kinds(fields)
    gb = real_I.shape[0]

    def call(name, x, seg, frozen=False, train=True):
        params = P[name]
        keys = list(params)
        values = [v.detach() if frozen else v for v in params.values()]

        def fn(x, *vals):
            return nets[name].forward(dict(zip(keys, vals)), x, ctx, seg.rewind(), train,
                                      noise_std)

        if ckpt:
            return checkpoint(fn, x, *values, use_reentrant=False)
        return fn(x, *values)

    fake_S = call("gen_IS", real_I, draws.segment())
    fake_I = call("gen_SI", real_S, draws.segment())
    cycled_S = call("gen_IS", fake_I.detach(), draws.segment())
    cycled_I = call("gen_SI", fake_S.detach(), draws.segment())
    cycle_I, seg, cycle_S, recon = losses.cycle_losses(fields, gb, real_I, real_S, cycled_I,
                                                       cycled_S)
    d_real_S = call("disc_S", real_S, draws.segment())
    d_real_I = call("disc_I", real_I, draws.segment())
    judged = {}
    for d, fake in (("disc_S", fake_S), ("disc_I", fake_I)):
        seg_ = draws.segment()  # one set of draws for both judgements
        judged[d] = (call(d, fake, seg_, frozen=True), call(d, fake.detach(), seg_))
    gen_IS = losses.lsgan_generator(judged["disc_S"][0], gb)
    gen_SI = losses.lsgan_generator(judged["disc_I"][0], gb)
    d_I = losses.lsgan_discriminator(d_real_I, judged["disc_I"][1], gb)
    d_S = losses.lsgan_discriminator(d_real_S, judged["disc_S"][1], gb)
    total_I = gen_IS + cycle_I + seg
    total_S = gen_SI + cycle_S + recon
    result = dict(zip(RESULT_KEYS, (total_I, total_S, d_I, d_S, gen_IS, gen_SI, cycle_I,
                                    cycle_S, seg, recon)))
    return total_I + total_S + d_I + d_S, result


def lr_at(fields: dict, count: int, steps_per_epoch: int) -> float:
    """Constant INITIAL_LR, then linear to 0 from INITIATE_LR_DECAY epochs
    (default EPOCHS / 2) to EPOCHS."""
    epochs = fields.get("EPOCHS", 200)
    decay_epochs = fields.get("INITIATE_LR_DECAY") or 0.5 * epochs
    start = int(decay_epochs * steps_per_epoch)
    span = max(1, int(epochs * steps_per_epoch) - start)
    lr = fields.get("INITIAL_LR", 2e-4)
    if count < start:
        return lr
    return lr * (1.0 - min(count - start, span) / span)


class Readings:
    """What the comparison reads of the first steps: each step's losses, each
    leaf's first gradient norm as the optimizer gets it (clipped), and each
    leaf's change after the steps."""

    def __init__(self, losses: List[Dict[str, float]], grad1: Dict[str, float],
                 change: Dict[str, float]):
        self.losses = losses
        self.grad1 = grad1
        self.change = change


def run_steps(fields: dict, P0: Dict[str, dict], batches, generator: Optional[torch.Generator],
              noise_std: float, steps_per_epoch: int, quant: Optional[torch.dtype] = None,
              ckpt: bool = True) -> Readings:
    """Train a copy of the float32 parameters ``P0`` (network -> name ->
    tensor) for ``len(batches)`` steps; the draws come from ``generator``."""
    device = batches[0][0].device
    noise_dtype = (torch.bfloat16 if fields.get("compute_dtype", "float32")
                   in ("bfloat16", "bf16") else torch.float32)
    draws = Draws(generator, device, noise_dtype)
    ctx = Ctx(quant=quant)
    P = {n: {k: v.detach().clone().float().requires_grad_() for k, v in p.items()}
         for n, p in P0.items()}
    m = {n: {k: torch.zeros_like(v) for k, v in p.items()} for n, p in P.items()}
    v2 = {n: {k: torch.zeros_like(v) for k, v in p.items()} for n, p in P.items()}
    step_losses, grad1 = [], {}
    for t, (real_I, real_S) in enumerate(batches, start=1):
        total, result = compute_losses(fields, P, real_I.float(), real_S.float(), draws,
                                       noise_std, ctx, ckpt)
        total.backward()
        step_losses.append({k: float(v.detach()) for k, v in result.items()})
        lr = lr_at(fields, t - 1, steps_per_epoch)
        with torch.no_grad():
            for n in NETWORKS:
                for k, p in P[n].items():
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    g = g * min(1.0, CLIPNORM / max(float(g.norm()), 1e-12))
                    if t == 1:
                        grad1[f"{n}/{k}"] = float(g.norm())
                    m[n][k].mul_(B1).add_(g, alpha=1 - B1)
                    v2[n][k].mul_(B2).addcmul_(g, g, value=1 - B2)
                    mhat = m[n][k] / (1 - B1 ** t)
                    vhat = v2[n][k] / (1 - B2 ** t)
                    p.sub_(lr * mhat / (vhat.sqrt() + EPS))
                    p.grad = None
        del total, result
    change = {f"{n}/{k}": float((P[n][k].detach() - P0[n][k].float()).norm())
              for n in NETWORKS for k in P[n]}
    return Readings(step_losses, grad1, change)
