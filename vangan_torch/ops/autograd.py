"""``once_differentiable`` for the kernels' ``autograd.Function`` backwards
that have no derivative of their own.

torch's ``torch.autograd.function.once_differentiable`` hangs its error node
on detached copies of the backward's results, so ``autograd.grad(..., inputs=
x)`` never reaches it and returns a derivative with that backward's terms
silently left out. Here the error node takes the backward's results together
with the tensors they depend on (the cotangents and the saved tensors that
require grad): any derivative through them raises, whatever autograd is
asked for.
"""

from __future__ import annotations

import functools

import torch


class _NoDerivative(torch.autograd.Function):
    @staticmethod
    def forward(ctx, what, n, *tensors):
        ctx.what = what
        return tuple(t.detach() for t in tensors[:n])

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(f"{ctx.what} is once_differentiable: it has no derivative")


def once_differentiable(backward):
    """Run ``backward`` without grad; when autograd records it (under
    ``create_graph``), tie its tensor results to an error node."""

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        with torch.no_grad():
            outputs = backward(ctx, *grads)
        if not torch.is_grad_enabled():
            return outputs
        sources = [t for t in (*grads, *ctx.saved_tensors)
                   if isinstance(t, torch.Tensor) and t.requires_grad]
        single = not isinstance(outputs, tuple)
        outs = (outputs,) if single else outputs
        idx = [i for i, t in enumerate(outs) if isinstance(t, torch.Tensor)]
        if not sources or not idx:
            return outputs
        tied = _NoDerivative.apply(backward.__qualname__, len(idx),
                                   *(outs[i] for i in idx), *sources)
        outs = list(outs)
        for i, t in zip(idx, tied):
            outs[i] = t
        return outs[0] if single else tuple(outs)

    return wrapper
