"""The ``VanGan`` facade of the port: the four networks on one device.

Counterpart of ``vangan_tpu.vangan.VanGan`` and its free ``train`` loop
(vangan.py:20-550): serving (``gen_IS_batched``, ``gen_SI_batched``, weights
by epoch), training (``distributed_train_step``, ``train(...,
training=True)``), evaluation (``distributed_test_step``, ``train(...,
training=False)``) and checkpoints of the whole training state by epoch
(``save_checkpoint``, ``load_checkpoint``). ``training.loop.fit`` runs the
epochs.

Given a ``parallel.Group``, a ``VanGan`` is one rank of data-parallel
training on the group's device (the counterpart of the JAX package's data
mesh): it steps on its share of the global batch and averages gradients
and losses with the other ranks (``training.step``), holds the same
parameters as every rank (broadcast from rank 0 after construction and
after every load), draws its noise and dropout from its own generator, and
writes files on rank 0 only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from vangan_torch.checkpoint import VanGanCheckpointer
from vangan_torch.config import VanGanConfig
from vangan_torch.device import resolve_device
from vangan_torch.losses import LossScales
from vangan_torch.models.factory import build_discriminator, build_generator
from vangan_torch.models.layers import BatchNorm
from vangan_torch.monitor.profiling import span
from vangan_torch.parallel import Group, broadcast_state, is_main, rows
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
    1) steps to an epoch. With ``group`` it is that rank of data-parallel
    training (see the module note) on the group's device, ``device``
    unread; the group's world must be ``cfg.N_DEVICES`` and divide the
    global batch and the clDice groups."""

    def __init__(self, cfg: VanGanConfig, device="cuda",
                 models: Optional[Dict[str, torch.nn.Module]] = None,
                 steps_per_epoch: Optional[int] = None, group: Optional[Group] = None):
        self.cfg = cfg
        self.group = group
        self.device = resolve_device(device if group is None else group.device)
        self.steps_per_epoch = steps_per_epoch or cfg.train_steps or 1
        if models is None:
            g = torch.Generator().manual_seed(cfg.seed)
            models = {"gen_IS": build_generator(cfg.gen_i2s, cfg, role="i2s", generator=g),
                      "gen_SI": build_generator(cfg.gen_s2i, cfg, role="s2i", generator=g),
                      "disc_I": build_discriminator(cfg, generator=g),
                      "disc_S": build_discriminator(cfg, generator=g)}
        self.nets = {name: models[name].to(self.device).eval() for name in NETWORKS}
        self.scales = LossScales.from_config(cfg)
        rank = 0
        if group is not None:
            cfg.rank_batch(group.world)  # raises unless the world splits the batch
            self.scales = self.scales.for_rank(group.world)
            rank = group.rank
            for net in self.nets.values():
                for m in net.modules():
                    if isinstance(m, BatchNorm):
                        m.group = group
        self.state = make_train_state(self.nets, cfg, self.steps_per_epoch)
        # noise and dropout draws of the train step: restarted from seed + 1
        # by every construction and not checkpointed, as the JAX package's
        # _step_rng (vangan.py:96); rank r > 0 of data parallelism draws from
        # a seed of its own, since JAX draws over the whole global batch and
        # equal draws on two shards would be another function
        seed = cfg.seed + 1
        if rank:
            seed = int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.current_epoch = 0
        self.checkpoint_loaded = False
        self._checkpointer: Optional[VanGanCheckpointer] = None
        # the generators' update every ncritic-th train step of the WGAN
        # path, counted by ``train`` (vangan.py:64-67 of the JAX package)
        self.wasserstein = cfg.wasserstein
        self.ncritic = cfg.ncritic
        self.icritic = 1
        self.updateGen = True
        broadcast_state(group, self.nets.values())

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

    def _on_device(self, batch) -> torch.Tensor:
        """A batch (numpy, or a torch tensor: pinned host memory from the
        data feed is copied without blocking the host) on the device; of a
        global batch, the rank's rows (``parallel.rows``), and a batch of
        the rank's share as it is."""
        if self.group is not None and len(batch) == self.cfg.GLOBAL_BATCH_SIZE:
            batch = batch[rows(self.group, len(batch))]
        return torch.as_tensor(batch, dtype=torch.float32).to(self.device, non_blocking=True)

    def distributed_train_step(self, real_I, real_S, noise_std: float,
                               update_gen: bool) -> Dict[str, torch.Tensor]:
        """One optimisation step of the four networks on a (B, X, Y, Z, 1)
        imaging and segmentation batch (numpy or torch), discriminator noise
        σ ``noise_std``, the generators updated only with ``update_gen``:
        the losses as a dict of 0-d tensors on the device. A rank of data
        parallelism takes the global batch, or its own share of it as the
        feed gives it, and returns the losses averaged over the ranks. With
        ``cfg.micro_batches`` > 1 the step accumulates the gradients of that
        many slices of the (rank's) batch, at ``self.scales.for_micro``, before
        its one update (``training.step``). The whole call, uploads included,
        is the span ``step``."""
        with span("step"):
            return step.train_step(self.nets, self.cfg, self.scales, self.state,
                                   self._on_device(real_I), self._on_device(real_S),
                                   float(noise_std), bool(update_gen), self.generator,
                                   group=self.group)

    def distributed_test_step(self, real_I, real_S) -> Dict[str, torch.Tensor]:
        """The losses of one (B, X, Y, Z, 1) imaging and segmentation batch
        (numpy or torch), without gradients: a dict of 0-d tensors on the
        device (a rank of data parallelism: as ``distributed_train_step``)."""
        return step.test_step(self.nets, self.cfg, self.scales, self._on_device(real_I),
                              self._on_device(real_S), self.group)

    def weights_path(self, epoch: int) -> str:
        """Where weights of ``epoch`` live: ``<output_dir>/checkpoints/torch_e{epoch}.pt``."""
        return os.path.join(self.cfg.output_dir, "checkpoints", f"torch_e{epoch}.pt")

    def save_weights(self, path: str) -> None:
        """The four networks' state_dicts to ``path`` (on rank 0 only)."""
        if not is_main(self.group):
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({name: net.state_dict() for name, net in self.nets.items()}, path)

    def load_weights(self, path: str) -> None:
        """Load each network the file holds (strictly); both generators are
        required, so a generators-only file loads for serving. Every rank
        loads, after a barrier, and takes rank 0's tensors."""
        if self.group is not None:
            self.group.barrier()
        state = torch.load(path, map_location=self.device, weights_only=True)
        missing = [n for n in ("gen_IS", "gen_SI") if n not in state]
        if missing:
            raise KeyError(f"{path} holds no {', '.join(missing)}")
        for name, net in self.nets.items():
            if name in state:
                net.load_state_dict(state[name], strict=True)
        broadcast_state(self.group, self.nets.values())

    # --- checkpoints of the whole training state (vangan.py:247-268) ---

    @property
    def checkpointer(self) -> VanGanCheckpointer:
        """The checkpointer of ``<output_dir>/checkpoints``, made at first use."""
        if self._checkpointer is None:
            self._checkpointer = VanGanCheckpointer(self.cfg.output_dir)
        return self._checkpointer

    def checkpoint_state(self) -> dict:
        """The four networks' state_dicts under their names and ``train_state``
        (the optimizers, update counts and step): what a checkpoint holds.
        Makes the Adam moments of networks not yet updated."""
        self.state.init_moments()
        return {**{name: net.state_dict() for name, net in self.nets.items()},
                "train_state": self.state.state_dict()}

    def save_checkpoint(self, epoch: int) -> None:
        """Write ``torch_e{epoch+1}.pt`` asynchronously (the checkpointer's
        ``save``), on rank 0 only."""
        if is_main(self.group):
            self.checkpointer.save(self.checkpoint_state(), epoch)

    def load_checkpoint(self, epoch: Optional[int] = None, expect_partial: bool = False,
                        newpath: Optional[str] = None) -> None:
        """Restore ``torch_e{epoch}.pt`` (of ``newpath`` if given): the
        networks, optimizers, counts and step; a missing file leaves the
        state as it is, after "Error: Checkpoint not found!". Every rank
        loads, once rank 0's write in flight is on disk, and takes rank 0's
        tensors."""
        self.checkpointer.wait_until_finished()
        if self.group is not None:
            self.group.barrier()
        restored = self.checkpointer.load(self.checkpoint_state(), epoch, newpath=newpath,
                                          expect_partial=expect_partial)
        if restored is None:
            return
        for name, net in self.nets.items():
            net.load_state_dict(restored[name], strict=True)
        self.state.load_state_dict(restored["train_state"])
        broadcast_state(self.group, self.nets.values(), self.state.opt.values())
        self.checkpoint_loaded = True


def train(ds: Iterable[Tuple[np.ndarray, np.ndarray]], gan: VanGan, summary, epoch: int,
          steps: Optional[int] = None, desc: Optional[str] = None, training: bool = True,
          noise_std: float = 0.0) -> Dict[str, list]:
    """One epoch (vangan.py:510-550): on each batch of ``ds`` (at most
    ``steps``) the train step with noise σ ``noise_std`` (``training``) or
    the test step, then ``summary.scalar(key, mean, epoch=, training=)`` for
    each loss; returns the per-step values by key. Results stay on the device
    and are fetched 32 steps at a time (the span ``train.drain``). On the
    WGAN path the generators are updated every ``ncritic``-th train step, by
    the bookkeeping of vangan.py:535-544 (the JAX package's
    vangan.py:224-230): the flag is raised when ``icritic`` reaches
    ``ncritic`` and lowered after every step; on the LSGAN path every train
    step updates them."""
    results: Dict[str, list] = {}
    pending: list = []

    def drain() -> None:
        if pending:
            with span("train.drain"):
                keys = sorted(pending[0])  # the JAX package's order: device_get sorts keys
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
            if gan.icritic % gan.ncritic == 0:
                gan.updateGen, gan.icritic = True, 1
            else:
                gan.icritic += 1
            update_gen = gan.updateGen if gan.wasserstein else True
            pending.append(gan.distributed_train_step(x, y, noise_std, update_gen))
        else:
            pending.append(gan.distributed_test_step(x, y))
        gan.updateGen = False
        if len(pending) >= 32:
            drain()
    drain()
    if desc:
        print(f"{desc}: {cntr} steps")
    for key, value in results.items():
        summary.scalar(key, float(np.mean(value)), epoch=epoch, training=training)
    return results
