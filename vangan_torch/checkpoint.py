"""Checkpoints by epoch, and the standalone export bundle.

Counterpart of ``vangan_tpu.checkpoint`` (orbax there, ``torch.save`` here;
the reference's ``tf.train.Checkpoint`` over 4 models and 4 optimizers,
vangan.py:238-268). A checkpoint is one file,
``<output_dir>/checkpoints/torch_e{N}.pt``, holding a nested dict:

- the four networks' state_dicts under their names (``VanGan.load_weights``
  and ``predict --epoch N`` read these and nothing else);
- ``train_state``: the four ``torch.optim.Adam`` state_dicts, the update
  counts of the LR schedules and the step (``TrainState.state_dict``).

Saves are asynchronous, like orbax's: ``save`` copies every tensor to host
memory on the current stream and waits for that copy (the fused Adam updates
moments and parameters in place, so the next step must not start before it
ends), then writes the file on a thread, to a temporary name that it renames.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vangan_torch.training.state import NETWORKS


def _snapshot(tree: Any) -> Any:
    """A host copy of every tensor of ``tree`` (pinned for CUDA tensors,
    copied without blocking); other leaves as they are."""
    if isinstance(tree, Mapping):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_snapshot(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.device.type == "cuda":
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return out.copy_(t, non_blocking=True)
        return t.clone()
    return tree


class _Merge:
    """Merge a stored tree into a template's structure (``load``)."""

    def __init__(self, expect_partial: bool):
        self.expect_partial = expect_partial
        self.missing, self.extra, self.kept = [], [], []

    def __call__(self, t: Any, s: Any, path: str) -> Any:
        if isinstance(t, Mapping) or isinstance(t, list):
            keys = list(t) if isinstance(t, Mapping) else range(len(t))
            if not isinstance(s, type(t) if isinstance(t, list) else Mapping):
                self.missing.append(path)
                return t
            skeys = list(s) if isinstance(s, Mapping) else range(len(s))
            out = {k: (self(t[k], s[k], f"{path}/{k}") if k in skeys
                       else self._missing(t[k], f"{path}/{k}")) for k in keys}
            self.extra += [f"{path}/{k}" for k in skeys if k not in out]
            return out if isinstance(t, Mapping) else [out[k] for k in keys]
        if isinstance(t, torch.Tensor):
            if not isinstance(s, torch.Tensor) or s.shape != t.shape or (
                    not self.expect_partial and s.dtype != t.dtype):
                got = (tuple(s.shape), s.dtype) if isinstance(s, torch.Tensor) else type(s)
                if not self.expect_partial:
                    raise ValueError(f"checkpoint leaf {path} has shape/dtype {got}, model "
                                     f"expects {(tuple(t.shape), t.dtype)}")
                self.kept.append(path)
                return t
            return s.to(t.dtype)
        return s

    def _missing(self, t: Any, path: str) -> Any:
        self.missing.append(path)
        return t


class VanGanCheckpointer:
    """Save and load a state tree by epoch number (vangan.py:247-268)."""

    def __init__(self, output_dir: str):
        self.checkpoint_dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the last save: ms to snapshot on the step's stream, s to write, bytes
        self.last_snapshot_ms = self.last_write_s = None
        self.last_bytes = None

    def path(self, epoch: int, newpath: Optional[str] = None) -> str:
        base = os.path.abspath(newpath) if newpath else self.checkpoint_dir
        return os.path.join(base, f"torch_e{epoch}.pt")

    def save(self, state: Mapping, epoch: int) -> None:
        """Write ``torch_e{epoch+1}.pt`` (vangan.py:247-250), overwriting one
        that is there. Returns once the state is in host memory; the file is
        written on a thread (see :meth:`wait_until_finished`)."""
        self.wait_until_finished()  # one write in flight at a time
        path = self.path(epoch + 1)
        t0 = time.perf_counter()
        snap = _snapshot(state)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        self.last_snapshot_ms = (time.perf_counter() - t0) * 1e3

        def write() -> None:
            try:
                t1 = time.perf_counter()
                tmp = f"{path}.tmp"
                torch.save(snap, tmp)
                os.replace(tmp, path)
                self.last_write_s = time.perf_counter() - t1
                self.last_bytes = os.path.getsize(path)
            except BaseException as e:  # noqa: BLE001 -- raised by wait_until_finished
                self._error = e

        self._thread = threading.Thread(target=write, daemon=False)
        self._thread.start()
        print(f"\nSaving checkpoint to {path} (async)\n")

    def wait_until_finished(self) -> None:
        """Block until the write in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write failed: {err!r}") from err

    def load(self, template: Mapping, epoch: int, newpath: Optional[str] = None,
             expect_partial: bool = False) -> Optional[dict]:
        """``torch_e{epoch}.pt`` merged into the structure of ``template``
        (vangan.py:252-268); None, after "Error: Checkpoint not found!", if
        there is no such file. Without ``expect_partial`` a stored tree that
        does not match ``template`` raises, naming the paths that differ;
        with it, the template keeps what the file lacks or holds in another
        shape, and a tensor of another dtype is cast."""
        path = self.path(epoch, newpath)
        print(f"Trying to load checkpoint from path: {path}")
        self.wait_until_finished()  # the file may still be in flight
        if not os.path.isfile(path):
            print("Error: Checkpoint not found!")
            return None
        stored = torch.load(path, map_location="cpu", weights_only=True)
        merge = _Merge(expect_partial)
        state = merge(template, stored, "")
        if not expect_partial and (merge.missing or merge.extra):
            raise ValueError(
                f"checkpoint {path} does not match the model/optimizer tree "
                f"(pass expect_partial=True to merge the intersection).\n"
                f"  missing from checkpoint: {merge.missing[:8]}"
                f"{'...' if len(merge.missing) > 8 else ''}\n"
                f"  extra in checkpoint: {merge.extra[:8]}{'...' if len(merge.extra) > 8 else ''}")
        if merge.missing or merge.extra or merge.kept:
            print(f"expect_partial: kept template values for {len(merge.missing + merge.kept)} "
                  f"leaves; ignored {len(merge.extra)} checkpoint-only leaves")
        print(f"Loaded checkpoint from {path}\n")
        return state

    def latest_epoch(self) -> Optional[int]:
        self.wait_until_finished()
        epochs = [int(m.group(1)) for f in os.listdir(self.checkpoint_dir)
                  if (m := re.fullmatch(r"torch_e(\d+)\.pt", f))]
        return max(epochs) if epochs else None


# --- the standalone export bundle (custom_callback.py:33-45) ---
#
# The JAX package's layout: ``exports/e{epoch+1}/`` holds config.yaml,
# manifest.json and one ``{name}.npz`` per network whose keys are
# ``params`` + the flax keystr of each leaf (``['enc1']['conv']['kernel']``)
# and ``state`` + the keystr of each leaf of its mutable collections
# (``['batch_stats']['down0']['bn0']['mean']``), so a bundle written by
# either package loads in the other.

_KEY_RE = re.compile(r"\['([^']*)'\]")


def _keystr_leaves(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k in sorted(tree):
        v, key = tree[k], f"{prefix}['{k}']"
        out.update(_keystr_leaves(v, key) if isinstance(v, Mapping) else {key: v})
    return out


def export_models(cfg, nets: Mapping[str, torch.nn.Module], epoch: int,
                  out_dir: Optional[str] = None) -> str:
    """Write the four networks and the config as a bundle,
    ``{out_dir or cfg.output_dir}/exports/e{epoch+1}/``; returns its path."""
    from vangan_torch.weights import torch_to_flax_variables

    path = os.path.join(out_dir or cfg.output_dir, "exports", f"e{epoch + 1}")
    os.makedirs(path, exist_ok=True)
    cfg.to_yaml(os.path.join(path, "config.yaml"))
    roles = {"gen_IS": ("generator", cfg.gen_i2s, "i2s"),
             "gen_SI": ("generator", cfg.gen_s2i, "s2i"),
             "disc_I": ("discriminator", None, None),
             "disc_S": ("discriminator", None, None)}
    manifest = {"format": 1, "epoch": epoch + 1, "networks": {}}
    for name in NETWORKS:
        builder, kind, role = roles[name]
        variables = torch_to_flax_variables(nets[name].state_dict(), nets[name])
        params = variables.pop("params")
        np.savez(os.path.join(path, f"{name}.npz"),
                 **{f"params{k}": v for k, v in _keystr_leaves(params).items()},
                 **{f"state{k}": v for k, v in _keystr_leaves(variables).items()})
        manifest["networks"][name] = {"builder": builder, "kind": kind, "role": role,
                                      "file": f"{name}.npz"}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def load_exported(path: str, device="cuda") -> Tuple[Any, Dict[str, torch.nn.Module]]:
    """A bundle of :func:`export_models` (or of the JAX package's): the
    config and ``{name: network}``, each rebuilt by the port's factory from
    the bundled config, loaded, in eval mode on ``device`` (the card unless
    ``device="cpu"``)."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.device import resolve_device
    from vangan_torch.models.factory import build_discriminator, build_generator
    from vangan_torch.weights import load_flax_params

    device = resolve_device(device)
    cfg = VanGanConfig.from_yaml(os.path.join(path, "config.yaml"))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    nets = {}
    for name, meta in manifest["networks"].items():
        if meta["builder"] == "generator":
            module = build_generator(meta["kind"], cfg, role=meta["role"])
        else:
            module = build_discriminator(cfg)
        trees: dict = {"params": {}, "state": {}}
        with np.load(os.path.join(path, meta["file"])) as data:
            for key in data.files:
                prefix = "params" if key.startswith("params") else "state"
                *mods, leaf = _KEY_RE.findall(key[len(prefix):])
                node = trees[prefix]
                for m in mods:
                    node = node.setdefault(m, {})
                node[leaf] = data[key]
        unknown = set(trees["state"]) - {"batch_stats"}
        if unknown:
            raise ValueError(f"{path}/{meta['file']}: mutable collections {sorted(unknown)}, "
                             "which no network of the port has")
        nets[name] = load_flax_params(module, trees["params"],
                                      trees["state"].get("batch_stats")).to(device).eval()
    return cfg, nets
