"""Map network parameters between a flax tree and a torch ``state_dict``.

The torch modules carry the flax module names, so the mapping is a rename of
the leaf and a transpose of conv kernels:

- conv ``kernel`` (kx, ky, kz, Ci, Co) <-> ``weight`` (Co, Ci, kx, ky, kz);
- InstanceNorm ``scale`` <-> ``weight``;
- ``bias`` <-> ``bias``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from vangan_torch.training.state import NETWORKS


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax ``params`` (arrays) -> a ``state_dict`` of float32 tensors."""
    sd = {}
    for (*mods, leaf), arr in _flatten(params).items():
        if leaf == "kernel":
            name, arr = "weight", np.transpose(arr, (4, 3, 0, 1, 2))
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unexpected flax leaf {'/'.join((*mods, leaf))}")
        sd[".".join((*mods, name))] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def torch_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`flax_to_torch`: a nested dict of numpy arrays."""
    tree: dict = {}
    for key, t in state_dict.items():
        *mods, name = key.split(".")
        arr = t.detach().cpu().float().numpy()
        if name == "weight" and arr.ndim == 5:
            leaf, arr = "kernel", np.transpose(arr, (2, 3, 4, 1, 0))
        elif name == "weight":
            leaf = "scale"
        elif name == "bias":
            leaf = "bias"
        else:
            raise KeyError(f"unexpected torch parameter {key}")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def load_flax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a flax parameter tree into ``model``; every leaf must match one
    parameter of the same shape, and vice versa (``strict`` loading)."""
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model


def load_flax_networks(gan, params: Mapping) -> None:
    """Copy the four-network ``params`` of the JAX package (``{gen_IS, gen_SI,
    disc_I, disc_S}``, as ``make_step_fns(...).init(rng).params`` or a
    checkpoint's ``params`` holds them) into the networks of a ``VanGan``."""
    for name in NETWORKS:
        load_flax_params(gan.nets[name], params[name])
