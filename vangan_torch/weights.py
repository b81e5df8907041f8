"""Map network parameters between a flax tree and a torch ``state_dict``.

The torch modules carry the flax module names, so the mapping is a rename of
the leaf and a transpose of kernels, chosen by the type of the torch module
the leaf belongs to:

- conv ``kernel`` (kx, ky, kz, Ci, Co) <-> ``weight`` (Co, Ci, kx, ky, kz);
- ``ConvTranspose`` ``kernel`` (kx, ky, kz, Ci, Co) <-> ``weight``
  (Ci, Co, kx, ky, kz), flipped on the three spatial axes (flax's transposed
  conv does not flip its kernel, torch's does);
- InstanceNorm and BatchNorm ``scale`` <-> ``weight``;
- ``bias`` <-> ``bias``;
- BatchNorm's ``batch_stats`` ``mean`` / ``var`` <-> the buffers ``mean`` /
  ``var``.

:func:`load_flax_train_state` carries a whole JAX ``VanGanState`` (the
parameters, the batch statistics, each network's Adam moments and counts,
and the step) into a ``VanGan``, so a run started with the JAX package
resumes in the port.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vangan_torch.training.state import NETWORKS

STATS = ("mean", "var")  # BatchNorm's batch_stats leaves, and its buffers


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _transposed_convs(model: torch.nn.Module) -> set:
    """The module paths of ``model``'s ``ConvTranspose`` layers."""
    from vangan_torch.models.layers import ConvTranspose

    return {name for name, m in model.named_modules() if isinstance(m, ConvTranspose)}


def flax_to_torch(params: Mapping, model: torch.nn.Module,
                  batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Nested flax ``params`` (arrays), and ``batch_stats`` if given, -> a
    ``state_dict`` of float32 tensors for ``model`` (or one of its
    submodules: the module types pick each kernel's layout)."""
    deconvs = _transposed_convs(model)
    sd = {}
    for (*mods, leaf), arr in _flatten(params).items():
        if leaf == "kernel" and ".".join(mods) in deconvs:
            name, arr = "weight", np.transpose(np.flip(arr, (0, 1, 2)), (3, 4, 0, 1, 2))
        elif leaf == "kernel":
            name, arr = "weight", np.transpose(arr, (4, 3, 0, 1, 2))
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unexpected flax leaf {'/'.join((*mods, leaf))}")
        sd[".".join((*mods, name))] = torch.from_numpy(np.array(arr, np.float32))
    for (*mods, leaf), arr in _flatten(batch_stats or {}).items():
        if leaf not in STATS:
            raise KeyError(f"unexpected flax batch_stats leaf {'/'.join((*mods, leaf))}")
        sd[".".join((*mods, leaf))] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def torch_to_flax_variables(state_dict: Mapping[str, torch.Tensor],
                            model: torch.nn.Module) -> dict:
    """The inverse of :func:`flax_to_torch`: ``{"params": tree}``, plus
    ``"batch_stats"`` when the state_dict holds BatchNorm buffers; nested
    dicts of numpy arrays."""
    deconvs = _transposed_convs(model)
    out: dict = {}
    for key, t in state_dict.items():
        *mods, name = key.split(".")
        arr = t.detach().cpu().float().numpy()
        collection = "params"
        if name == "weight" and arr.ndim == 5 and ".".join(mods) in deconvs:
            leaf, arr = "kernel", np.flip(np.transpose(arr, (2, 3, 4, 0, 1)), (0, 1, 2))
        elif name == "weight" and arr.ndim == 5:
            leaf, arr = "kernel", np.transpose(arr, (2, 3, 4, 1, 0))
        elif name == "weight":
            leaf = "scale"
        elif name == "bias":
            leaf = "bias"
        elif name in STATS:
            collection, leaf = "batch_stats", name
        else:
            raise KeyError(f"unexpected torch parameter {key}")
        node = out.setdefault(collection, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(arr, order="C")  # a copy: never a view of the parameter
    out.setdefault("params", {})
    return out


def torch_to_flax(state_dict: Mapping[str, torch.Tensor], model: torch.nn.Module) -> dict:
    """The flax ``params`` tree of a ``state_dict`` (:func:`torch_to_flax_variables`
    less its ``batch_stats``)."""
    return torch_to_flax_variables(state_dict, model)["params"]


def load_flax_params(model: torch.nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None) -> torch.nn.Module:
    """Copy a flax parameter tree (and the ``batch_stats`` of a BatchNorm
    network) into ``model``; every leaf must match one parameter or buffer
    of the same shape, and vice versa (``strict`` loading)."""
    model.load_state_dict(flax_to_torch(params, model, batch_stats), strict=True)
    return model


def _batch_stats(model_state: Optional[Mapping], name: str) -> Optional[Mapping]:
    """One network's ``batch_stats`` in a JAX ``model_state`` (None if none)."""
    return ((model_state or {}).get(name) or {}).get("batch_stats")


def load_flax_networks(gan, params: Mapping, model_state: Optional[Mapping] = None) -> None:
    """Copy the four-network ``params`` of the JAX package (``{gen_IS, gen_SI,
    disc_I, disc_S}``, as ``make_step_fns(...).init(rng).params`` or a
    checkpoint's ``params`` holds them), and the ``batch_stats`` of its
    ``model_state``, into the networks of a ``VanGan``."""
    for name in NETWORKS:
        load_flax_params(gan.nets[name], params[name], _batch_stats(model_state, name))


def _get(node: Any, key: str) -> Any:
    """``node[key]`` of a dict (a restored checkpoint) or ``node.key`` of a
    state object or NamedTuple (a live JAX state)."""
    return node[key] if isinstance(node, Mapping) else getattr(node, key)


def _find_adam(node: Any) -> Any:
    """The ``ScaleByAdamState`` (count, mu, nu) inside one network's optax
    state: a chain's tuple, its NamedTuples, or their dict forms."""
    fields = ("count", "mu", "nu")
    if isinstance(node, Mapping) and all(f in node for f in fields):
        return node
    if not isinstance(node, Mapping) and all(hasattr(node, f) for f in fields):
        return node
    children = node.values() if isinstance(node, Mapping) else (
        node if isinstance(node, (tuple, list)) else ())
    for child in children:
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def _unravel_like(moment: Any, params: Mapping) -> dict:
    """One network's Adam moment as a tree shaped like ``params``. Under
    ``flatten_opt`` (``optax.flatten``) the moment is ONE vector in
    ``ravel_pytree`` order: the leaves of the param tree in depth-first order
    of sorted keys, each raveled in C order; else it is already such a tree."""
    if isinstance(moment, Mapping):
        return _flatten_to_tree(_flatten(moment))
    vec = np.asarray(moment).ravel()
    leaves = sorted(_flatten(params).items())  # tuple keys sort as depth-first, by key
    sizes = [a.size for _, a in leaves]
    if vec.size != sum(sizes):
        raise ValueError(f"a flat moment of {vec.size} values for a tree of {sum(sizes)}")
    out, offset = {}, 0
    for (path, a), n in zip(leaves, sizes):
        out[path] = vec[offset:offset + n].reshape(a.shape)
        offset += n
    return _flatten_to_tree(out)


def _flatten_to_tree(flat: Dict[tuple, np.ndarray]) -> dict:
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree


def load_flax_train_state(gan, state: Any) -> None:
    """Copy a JAX ``VanGanState`` (a live one, or the dict a checkpoint
    restores to) into ``gan``: the parameters and the ``batch_stats`` of its
    ``model_state``; each network's Adam ``mu``, ``nu`` and ``count`` into
    its ``torch.optim.Adam`` state (``exp_avg``, ``exp_avg_sq``, ``step``;
    kernel moments transposed, and a ``ConvTranspose``'s flipped, like the
    kernels) and into ``TrainState.counts``; ``step`` into
    ``TrainState.step``. Both of the JAX optimizer layouts load
    (``flatten_opt`` True or False)."""
    params, opt_state = _get(state, "params"), _get(state, "opt_state")
    model_state = state.get("model_state") if isinstance(state, Mapping) else \
        getattr(state, "model_state", None)  # a restore may drop a tree of empty dicts
    load_flax_networks(gan, params, model_state)
    gan.state.init_moments()
    for name in NETWORKS:
        adam = _find_adam(opt_state[name])
        if adam is None:
            raise KeyError(f"no Adam state (count, mu, nu) in the optimizer state of {name}")
        count = int(np.asarray(_get(adam, "count")))
        net = gan.nets[name]
        mu = flax_to_torch(_unravel_like(_get(adam, "mu"), params[name]), net)
        nu = flax_to_torch(_unravel_like(_get(adam, "nu"), params[name]), net)
        opt = gan.state.opt[name]
        with torch.no_grad():
            for pname, p in net.named_parameters():
                st = opt.state[p]
                st["exp_avg"].copy_(mu[pname])
                st["exp_avg_sq"].copy_(nu[pname])
                st["step"].fill_(count)
        gan.state.counts[name] = count
    gan.state.step = int(np.asarray(_get(state, "step")))
