"""Tensor-parallel process groups over torch.distributed (port of
genrec_tpu/parallel/mesh.py: ``distributed_init`` :33, ``metric_allreduce``
:237, ``barrier``, ``allgather_host_ints`` :259 and
``any_across_processes`` :277).

The JAX package lays a named device mesh over the chips of one program
and lets GSPMD insert the collectives. The port runs one process per
tensor-parallel rank instead, each holding its shard of the parameters,
and issues every collective itself through a ``TPGroup``.

- ``init_group`` joins the group (torch.distributed keeps one process
  group per process; ``distributed_init`` hands back the one joined): from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
  a ``FileStore`` path (tests, the smoke). Each rank takes
  ``cuda:LOCAL_RANK`` when the host has a card per rank, else every rank
  takes ``cuda:0``; NCCL carries the collectives when every rank has its
  own card (NCCL refuses two ranks on one device), gloo otherwise and on
  the CPU.
- Over gloo every collective is staged through a host buffer (pinned when
  the tensor is on the card), always, by design: gloo's own CUDA support
  is not relied on. The host buffer of a bfloat16 tensor is float32, so
  every bfloat16 all_reduce and all_gather over gloo reduces or moves in
  float32 and rounds back once (for two ranks the same sum as bfloat16
  arithmetic would give). Over NCCL collectives run on the tensors.
- ``spawn(fn, world)`` runs ``fn(group, *args)`` in ``world`` fresh
  processes joined by a ``FileStore`` and returns their results; it joins
  with a time limit and raises if any rank fails or hangs.

``TPGroup`` counts its collectives and their bytes (``calls``,
``bytes``), which the smoke reads per train step.

The fault-tolerance layer agrees across ranks through three small
collectives over the joined group (the JAX package's run across hosts):
``allgather_host_ints`` (checkpoint consensus, goodput sums),
``any_across_processes`` (the preemption OR) and a named ``barrier``.
Each is a plain return without a collective in a single process.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from genrec_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 300
_JOINED: list = []  # the TPGroup over torch.distributed's (process-wide) group
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class TPGroup:
    """One tensor-parallel group of ``size`` ranks; this process is
    ``rank``. Collectives are out of place and return new tensors on the
    input's device and dtype. Every rank must issue the same collectives
    in the same order."""

    def __init__(self, rank: int, size: int, backend: str, device: torch.device,
                 pg=None):
        self.rank, self.size, self.backend = rank, size, backend
        self.device = torch.device(device)
        self.pg = pg
        self.calls = 0
        self.bytes = 0

    def __repr__(self):
        return (f"TPGroup(rank={self.rank}, size={self.size}, backend={self.backend}, "
                f"device={self.device})")

    def _count(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A float32 (for bfloat16) or same-dtype host copy of ``t``. The
        dtype changes on t's device, so that the copy itself goes straight
        into the pinned buffer (a copy that also converts stages through a
        pageable temporary)."""
        src = t.detach().float() if t.dtype == torch.bfloat16 else t.detach()
        h = torch.empty(src.shape, dtype=src.dtype, pin_memory=t.is_cuda)
        h.copy_(src)
        return h

    @staticmethod
    def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """The host buffer on ``like``'s device, then in its dtype."""
        return h.to(like.device).to(like.dtype)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum or max of ``t`` over the group."""
        self._count(t)
        if self.backend == "nccl":
            out = t.detach().clone()
            dist.all_reduce(out, _OPS[op], group=self.pg)
            return out
        h = self._host(t)
        dist.all_reduce(h, _OPS[op], group=self.pg)
        return self._back(h, t)

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        self._count(t)
        src = t.detach().contiguous() if self.backend == "nccl" else self._host(t)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.pg)
        return self._back(torch.cat(parts, dim=dim), t)


def rank_device(local_rank: int, world: int, device="cuda") -> torch.device:
    """The card of a rank: ``cuda:local_rank`` when the host has one per
    rank, else ``cuda:0`` for every rank; a CPU request stays the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    resolve_device(dev)  # raises without a card
    return torch.device("cuda", local_rank if torch.cuda.device_count() >= world else 0)


def choose_backend(dev: torch.device, world: int) -> str:
    """NCCL when every rank has its own card, gloo otherwise."""
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_group(rank: int | None = None, world: int | None = None, *, store_path=None,
               device="cuda") -> TPGroup:
    """Join the process group and return it as a ``TPGroup``.

    With ``store_path`` the ranks meet in a ``FileStore`` at that path
    (``rank`` and ``world`` given); without it, torchrun's environment
    names them. DEFAULT_TIMEOUT_S bounds every collective and the
    meeting."""
    if store_path is None:
        rank = int(os.environ["RANK"]) if rank is None else rank
        world = int(os.environ["WORLD_SIZE"]) if world is None else world
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
        local_rank = rank
    dev = rank_device(local_rank, world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, world)
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    if store_path is None:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                timeout=timeout)
    else:
        store = dist.FileStore(str(store_path), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timeout)
    group = TPGroup(rank, world, backend, dev, pg=dist.group.WORLD)
    _JOINED[:] = [group]
    log.info("tensor-parallel group: rank %d of %d on %s over %s", rank, world, dev, backend)
    return group


def distributed_init(device="cuda") -> TPGroup | None:
    """The trainers' entry (JAX ``distributed_init``): join torchrun's group
    when ``WORLD_SIZE`` > 1 and return it (or the group already joined),
    else None for a single process."""
    if dist.is_initialized():
        return _JOINED[0]
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return init_group(device=device)
    return None


def joined_group() -> TPGroup | None:
    """The group this process joined (`init_group`), or None."""
    return _JOINED[0] if _JOINED and dist.is_initialized() else None


def allgather_host_ints(values, group: TPGroup | None = None) -> np.ndarray:
    """Gather a small int vector from every rank: a ``(world, len(values))``
    int64 array whose row r is rank r's vector. Every rank calls it in
    lockstep with a vector of the same length. ``group`` defaults to the
    joined one; without one, a (1, N) reshape and no collective."""
    row = np.asarray(list(values), np.int64).reshape(-1)
    group = group if group is not None else joined_group()
    if group is None or group.size == 1:
        return row[None, :]
    t = torch.as_tensor(row, device=group.device)[None]
    return group.all_gather(t, dim=0).cpu().numpy()


def any_across_processes(flag: bool, group: TPGroup | None = None) -> bool:
    """True iff ``flag`` is True on at least one rank: every rank polls its
    own PreemptionGuard and acts on the OR, so all save their resume point
    at the same global step. A single process returns ``flag``."""
    return bool(allgather_host_ints([1 if flag else 0], group).max())


def barrier(name: str = "barrier", group: TPGroup | None = None) -> None:
    """Every rank waits here for the others (a one-int all-gather, so the
    same on gloo and NCCL). ``name`` labels the point in the debug log."""
    log.debug("barrier %s", name)
    allgather_host_ints([0], group)


def metric_allreduce(values: dict, group: TPGroup | None) -> dict:
    """Sum float metric values (numbers or lists of numbers) over
    ``group`` (JAX ``metric_allreduce``); None returns them unchanged."""
    if group is None or group.size == 1:
        return values
    keys = sorted(values)
    flat = [(k, i) for k in keys
            for i in range(len(values[k]) if isinstance(values[k], (list, tuple)) else 1)]
    vec = torch.tensor(
        [float(values[k][i] if isinstance(values[k], (list, tuple)) else values[k])
         for k, i in flat], dtype=torch.float64, device=group.device)
    summed = group.all_reduce(vec, "sum").tolist()
    out: dict = {}
    for (k, i), v in zip(flat, summed):
        if isinstance(values[k], (list, tuple)):
            out.setdefault(k, []).append(v)
        else:
            out[k] = v
    return out


def _spawn_entry(rank, world, store_path, device, threads, fn, args, queue):
    try:
        if threads:
            torch.set_num_threads(threads)
        group = init_group(rank, world, store_path=store_path, device=device)
        try:
            # Plain pickle bytes: torch's queue pickler would share a
            # tensor's memory with a process that is about to exit.
            queue.put((rank, True, pickle.dumps(fn(group, *args))))
        finally:
            dist.destroy_process_group()
            _JOINED.clear()
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, args=(), *, device="cuda", timeout_s: float = 120.0,
          store_dir=None, threads: int | None = None) -> list:
    """Run ``fn(group, *args)`` on ``world`` ranks in fresh processes (the
    spawn start method) and return their results in rank order.

    ``fn`` must be importable by name and its results picklable. The ranks
    meet in a ``FileStore`` under ``store_dir`` (a new temporary directory
    by default). Raises if a rank raises, exits without a result, or the
    ranks have not all finished within ``timeout_s``; every process is
    stopped before it returns or raises. ``threads`` sets each rank's
    torch CPU threads."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_spawn_entry, daemon=True,
                             args=(r, world, store_path, str(device), threads, fn, args, queue))
                 for r in range(world)]
        for p in procs:
            p.start()
        results: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"spawn: {world - len(results)} of {world} ranks "
                                       f"unfinished after {timeout_s} s")
                try:
                    rank, ok, value = queue.get(timeout=min(left, 1.0))
                except queue_mod.Empty:  # see whether a rank died without a word
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in results]
                    if dead:
                        raise RuntimeError(f"spawn: rank(s) {dead} exited with "
                                           f"{[procs[r].exitcode for r in dead]} and no "
                                           "result") from None
                    continue
                if not ok:  # the other ranks may wait on it in a collective: stop now
                    raise RuntimeError(f"spawn: rank {rank} failed\n{value}")
                results[rank] = pickle.loads(value)
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
            return [results[r] for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
