"""Data parallelism over processes, one a card.

Counterpart of ``vangan_tpu.parallel``. The JAX package runs one global-batch
program that GSPMD shards over a 1-D device mesh, so its collectives are
implicit. The port runs one process per card (the reference's
``MirroredStrategy`` replicas), each on its share of the global batch, and
writes every collective out:

- ``broadcast_state``: parameters, buffers and optimizer state from rank 0,
  after construction and after every load;
- ``all_reduce_grads``: each network's gradients as one flat buffer,
  averaged over the ranks, between the backward and the optimizer;
- ``all_reduce_mean``: the loss dict, averaged;
- ``Group.sum_``: the cross-rank BatchNorm's per-channel sums
  (``models.layers``) and the split stitch's accumulators.

Averaging is the JAX loss contract when each rank computes its losses with
``LossScales.for_rank``: every term of the global program is then the mean
over the ranks of the rank's term (``losses.vangan_losses``).

Only ``broadcast``, ``all_reduce`` and ``barrier`` are called, the two
collectives that gloo also takes on CUDA tensors, so two ranks that share one
card (gloo; NCCL refuses them) run the code of one rank per card (NCCL). A
world of 1 makes no collective call.

Processes: ``spawn`` starts ``world`` of them (rendezvous through a file store
in a new temporary directory) and ``from_env`` joins the ranks ``torchrun``
started (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).
"""

from __future__ import annotations

import datetime
import os
import shutil
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Group:
    """A rank's place in the data-parallel world: ``rank``, ``world``, its
    ``device`` and the process group (None for a world of 1, whose
    collectives are no calls)."""

    def __init__(self, rank: int, world: int, device, pg=None):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.pg = pg
        if self.world > 1 and pg is None:
            raise ValueError(f"a world of {self.world} needs a process group")

    @property
    def main(self) -> bool:
        """Rank 0, the rank that prints, logs and writes files."""
        return self.rank == 0

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place."""
        if self.world > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of rank 0 on every rank, in place."""
        if self.world > 1:
            dist.broadcast(t, 0, group=self.pg)
        return t

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.pg)

    def __repr__(self) -> str:
        return f"Group(rank={self.rank}, world={self.world}, device={self.device})"


def is_main(group: Optional[Group]) -> bool:
    """No group, or rank 0."""
    return group is None or group.main


def rows(group: Optional[Group], n: int) -> slice:
    """The rank's rows of a global batch of ``n``: ``[r n / k, (r + 1) n / k)``."""
    if group is None:
        return slice(0, n)
    if n % group.world:
        raise ValueError(f"a global batch of {n} does not split over {group.world} ranks")
    b = n // group.world
    return slice(group.rank * b, (group.rank + 1) * b)


# --- the collectives of the train step ---


def broadcast_state(group: Optional[Group], nets: Iterable[torch.nn.Module],
                    optimizers: Iterable[torch.optim.Optimizer] = ()) -> None:
    """Every parameter and buffer of ``nets`` and every tensor of the
    optimizers' states, as rank 0 holds them (the ranks hold the same
    structure: the same construction and the same loads)."""
    if group is None or group.world == 1:
        return
    with torch.no_grad():
        for net in nets:
            for t in (*net.parameters(), *net.buffers()):
                group.broadcast_(t.data)
        for opt in optimizers:
            for pgroup in opt.param_groups:
                for p in pgroup["params"]:
                    for _, v in sorted(opt.state.get(p, {}).items()):
                        if isinstance(v, torch.Tensor):
                            group.broadcast_(v)


def all_reduce_grads(group: Optional[Group], grads: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """One network's gradients averaged over the ranks, through one flat
    buffer: views of it, in the order given. A world of 1 returns them as
    they are."""
    if group is None or group.world == 1:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    group.sum_(flat).div_(group.world)
    return [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]


def all_reduce_mean(group: Optional[Group], values: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """A dict of 0-d tensors averaged over the ranks (one collective)."""
    if group is None or group.world == 1:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach() for k in keys])
    group.sum_(stacked).div_(group.world)
    return {k: v.to(values[k].dtype) for k, v in zip(keys, stacked.unbind())}


# --- process groups and launchers ---


def _backend(device: torch.device, shared_card: bool) -> str:
    return "gloo" if device.type == "cpu" or shared_card else "nccl"


# how long a rank waits in a collective: rank 0 alone draws the panels and
# writes the checkpoints (and, after epoch 160, stitches a volume) while the
# others wait in the next step's all-reduce; NCCL's default is 10 minutes
TIMEOUT = datetime.timedelta(minutes=30)


def init_group(rank: int, world: int, init_method: str, device="cuda",
               shared_card: bool = False, local_rank: Optional[int] = None) -> Group:
    """Join a process group of ``world`` ranks through ``init_method``. A
    CUDA ``device`` gives rank ``r`` the card ``cuda:{local_rank}`` (default
    ``rank``) and NCCL; with ``shared_card`` every rank takes ``cuda:0`` and
    gloo (NCCL refuses two ranks on one card); a CPU device takes gloo."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: CUDA is not available on this host; pass "
                               "device=\"cpu\" for ranks on the CPU")
        device = torch.device("cuda", 0 if shared_card else
                              (rank if local_rank is None else local_rank))
        torch.cuda.set_device(device)
    dist.init_process_group(_backend(device, shared_card), init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return Group(rank, world, device, dist.group.WORLD)


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def from_env(device="cuda") -> Group:
    """The group of the ranks ``torchrun`` (or another launcher setting
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``) started."""
    return init_group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
                      device, local_rank=int(os.environ.get("LOCAL_RANK", 0)))


def destroy(group: Optional[Group]) -> None:
    if group is not None and group.pg is not None and dist.is_initialized():
        dist.destroy_process_group()


def _child(rank: int, fn: Callable, world: int, init_method: str, device, shared_card: bool,
           args: tuple, out_dir: str) -> None:
    group = None
    try:
        group = init_group(rank, world, init_method, device, shared_card)
        result = fn(group, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        # when the rank failed, written before its group closes: a rank that
        # raises makes the others fail in their next collective, and
        # ``spawn`` reports the ranks' errors in this order. The text is
        # formatted first and renamed into place, so a rank stopped while it
        # writes leaves no partial file
        text = f"{time.monotonic()!r}\n{traceback.format_exc()}"
        path = os.path.join(out_dir, f"rank{rank}.err")
        with open(path + ".tmp", "w") as f:
            f.write(text)
        os.replace(path + ".tmp", path)
        raise
    finally:
        destroy(group)


def _rank_errors(out_dir: str, world: int) -> List[Tuple[float, int, str]]:
    """(when, rank, traceback) of each rank that wrote an error, earliest
    first; a file that cannot be read as one is skipped."""
    errors = []
    for r in range(world):
        try:
            with open(os.path.join(out_dir, f"rank{r}.err")) as f:
                stamp, _, trace = f.read().partition("\n")
            errors.append((float(stamp), r, trace))
        except (OSError, ValueError):
            continue
    return sorted(errors)


class RankError(RuntimeError):
    """A rank of ``spawn`` failed: the message holds the earliest rank's
    traceback first, then those of the ranks that failed after it."""


def _join(ctx, out_dir: str, world: int, timeout: Optional[float]) -> bool:
    """``ctx.join(timeout)``; a failed rank raises the ranks' errors in the
    order they happened (``join`` has stopped the other ranks by then)."""
    try:
        return ctx.join(timeout=timeout)
    except (torch.multiprocessing.ProcessRaisedException,
            torch.multiprocessing.ProcessExitedException):
        for p in ctx.processes:
            p.join(10)
        errors = _rank_errors(out_dir, world)
        if not errors:
            raise
        text = "\n".join(f"rank {r} failed{' first' if i == 0 else ' after it'}:\n{trace}"
                         for i, (_, r, trace) in enumerate(errors))
        # a rank that died without raising (killed, out of memory, a crash)
        # wrote no file and may have been the first to fail, so it goes
        # first; a rank ``join`` stopped with SIGTERM goes last
        wrote = {r for _, r, _ in errors}
        died, stopped = [], []
        for r, p in enumerate(ctx.processes):
            if r not in wrote and p.exitcode not in (None, 0):
                (stopped if p.exitcode == -signal.SIGTERM else died).append(
                    f"rank {r} exited with code {p.exitcode} and left no error")
        raise RankError("\n".join(died + [text] + stopped)) from None


def spawn(fn: Callable, world: int, args: tuple = (), device="cuda", shared_card: bool = False,
          timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world`` new processes (started by
    ``spawn``: ``fn`` and ``args`` are pickled, ``fn`` by its import path),
    rank ``r`` on the device ``init_group`` gives it, and return what each
    rank's ``fn`` returned (saved with ``torch.save``: CPU tensors and plain
    values), in rank order. A rank that raises or exits stops the others and
    raises here, a ``RankError`` whose message starts with the error of the
    rank that failed first (a rank's error makes the others fail in their
    next collective, and ``torch.multiprocessing`` reports whichever failure
    it sees first); past ``timeout`` seconds every rank is killed and
    ``TimeoutError`` raised."""
    tmp = tempfile.mkdtemp(prefix="vangan_ranks_")
    try:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = torch.multiprocessing.start_processes(
            _child, args=(fn, world, init_method, device, shared_card, args, tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not _join(ctx, tmp, world, None if deadline is None else
                        max(0.0, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} did not "
                                   f"finish in {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
