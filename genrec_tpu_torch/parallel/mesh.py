"""Process groups and the process mesh over torch.distributed (port of
genrec_tpu/parallel/mesh.py: ``distributed_init`` :33, ``make_mesh`` :168,
``shard_batch`` :192, ``to_host`` :222, ``metric_allreduce`` :237,
``barrier``, ``allgather_host_ints`` :259 and ``any_across_processes``
:277).

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
``bytes``), which the smoke reads per train step and per mesh axis.

``ProcessMesh`` lays named axes (``data``, ``model``, ``expert``) over the
world's ranks row-major, as JAX's ``make_mesh`` reshapes its devices: the
last axis varies fastest. Each axis slice this rank lies in is a
``TPGroup`` over ``dist.new_group``; every rank creates every slice's
group, in the same order, including those it is not in.

Data parallelism keeps JAX's semantics: every rank builds the same global
batch and keeps its contiguous block of rows (``shard_batch``), and the
step computes the one-device math on the global batch. While a step runs
under ``data_parallel(group, rows)`` (``core.harness`` enters it), the
models read the data group through ``step_data_group`` and its helpers:
``global_count`` (a loss's denominator over the whole batch),
``draw_rows`` (random draws at the global batch's shape, this rank's rows
kept), ``data_sum`` / ``data_share`` (a statistic over the whole batch
whose gradient each rank takes for its own rows) and ``data_gather``.
Outside a step they are the one-process identities.

The fault-tolerance layer agrees across ranks through three small
collectives over the joined group (the JAX package's run across hosts):
``allgather_host_ints`` (checkpoint consensus, goodput sums),
``any_across_processes`` (the preemption OR) and a named ``barrier``.
Each is a plain return without a collective in a single process.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import math
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


def distributed_init(device="cuda", shape=None) -> "ProcessMesh":
    """The trainers' entry (JAX ``distributed_init`` then ``make_mesh``):
    join torchrun's group when ``WORLD_SIZE`` > 1 (or take the group
    already joined) and lay ``shape`` (axis name -> size, one axis may be
    -1; default every rank on ``data``) over it. A single process gets a
    mesh of one rank, whose axes have no group."""
    group = None
    if dist.is_initialized():
        group = _JOINED[0]
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        group = init_group(device=device)
    return make_mesh(shape, group, device=device)


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


class ProcessMesh:
    """Named axes over the world's ranks, row-major (JAX ``make_mesh``).
    ``group(name)`` is the ``TPGroup`` of this rank's slice along ``name``
    (None where the axis has one rank or is absent); ``rank(name)`` and
    ``size(name)`` its coordinate and length. ``shard`` is this rank's
    index among the model shards (the slices of the non-data axes, in
    row-major order), ``n_shards`` their count."""

    def __init__(self, names, sizes, world_group: TPGroup | None, groups: dict):
        self.names, self.sizes = tuple(names), tuple(sizes)
        self.world_group = world_group
        rank = 0 if world_group is None else world_group.rank
        self.world = math.prod(self.sizes)
        self.coords = dict(zip(self.names, np.unravel_index(rank, self.sizes)))
        self.coords = {k: int(v) for k, v in self.coords.items()}
        self._groups = groups
        other = [(n, s) for n, s in zip(self.names, self.sizes) if n != "data"]
        self.n_shards = math.prod(s for _, s in other)
        self.shard = 0
        for n, s in other:
            self.shard = self.shard * s + self.coords[n]

    def __repr__(self):
        return f"ProcessMesh({dict(zip(self.names, self.sizes))}, coords={self.coords})"

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    def size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def rank(self, name: str) -> int:
        return self.coords.get(name, 0)

    def group(self, name: str) -> TPGroup | None:
        return self._groups.get(name)

    @property
    def device(self) -> torch.device | None:
        """The ranks' device (None for a single process)."""
        return None if self.world_group is None else self.world_group.device

    @property
    def lead(self) -> bool:
        """True on world rank 0, which writes the run's log files."""
        return self.world_group is None or self.world_group.rank == 0

    @property
    def data(self) -> TPGroup | None:
        """The data-parallel group of this rank (None at dp = 1)."""
        return self.group("data")

    @property
    def writer(self) -> bool:
        """True on data rank 0: the rank that writes its model shard's
        files (data-replicated state is written once per shard)."""
        return self.rank("data") == 0

    def counters(self) -> dict:
        """``{axis: (calls, bytes)}`` of this rank's groups."""
        return {n: (g.calls, g.bytes) for n, g in self._groups.items()}


_MESH: list = []  # the mesh the last make_mesh laid over the joined group


def make_mesh(shape=None, group: TPGroup | None = None, device="cuda") -> ProcessMesh:
    """Lay ``shape`` (axis name -> size; one axis may be -1, inferred) over
    ``group``'s ranks (default: the joined group; none = one process).
    Every rank must call it with the same shape: each creates every
    slice's group in the same order. Raises when the sizes do not
    multiply to the world size. The mesh becomes ``joined_mesh()``."""
    group = group if group is not None else joined_group()
    world = 1 if group is None else group.size
    shape = dict(shape) if shape else {"data": world}
    names, sizes = list(shape), list(shape.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh shape {shape}: at most one axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if known <= 0 or world % known:
            raise ValueError(f"mesh shape {shape} does not divide {world} ranks")
        sizes[sizes.index(-1)] = world // known
    if math.prod(sizes) != world or min(sizes) < 1:
        raise ValueError(f"mesh shape {dict(zip(names, sizes))} != {world} ranks")
    groups: dict = {}
    if group is not None and world > 1:
        grid = np.arange(world).reshape(sizes)
        for ax, name in enumerate(names):
            if sizes[ax] == 1:
                continue
            if sizes[ax] == world:
                groups[name] = group
                continue
            for ranks in np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax]).tolist():
                pg = dist.new_group(ranks)  # collective: every rank, every slice
                if group.rank in ranks:
                    groups[name] = TPGroup(ranks.index(group.rank), sizes[ax], group.backend,
                                           group.device, pg=pg)
    mesh = ProcessMesh(names, sizes, group, groups)
    _MESH[:] = [mesh]
    log.info("process mesh %s", mesh)
    return mesh


def joined_mesh() -> ProcessMesh | None:
    """The mesh last laid over the joined group, or None."""
    return _MESH[0] if _MESH and dist.is_initialized() else None


def shard_batch(batch: dict, group: TPGroup | None, accum_steps: int = 1) -> dict:
    """This data rank's contiguous block of rows of a global batch (JAX
    ``shard_batch``: every rank holds the same global batch). With
    ``accum_steps`` microbatches the block is taken from each microbatch,
    so that the harness's split of the local rows gives each global
    microbatch's block. Raises when the group does not divide the rows
    (JAX's ``device_put`` refuses such a batch too)."""
    if group is None or group.size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % (group.size * accum_steps):
            raise ValueError(f"batch of {n} rows ({k!r}) does not split over {group.size} "
                             f"data ranks x {accum_steps} microbatches")
        m = n // (accum_steps * group.size)
        out[k] = v.reshape(accum_steps, group.size, m, *v.shape[1:])[:, group.rank].reshape(
            accum_steps * m, *v.shape[1:])
    return out


def to_host(x: torch.Tensor, group: TPGroup | None) -> np.ndarray:
    """The global value of a row-sharded tensor on every rank (JAX
    ``to_host``): the data ranks' rows gathered in rank order."""
    if group is None or group.size == 1:
        return x.detach().cpu().numpy()
    return group.all_gather(x, dim=0).cpu().numpy()


class _DataStep:
    """The data-parallel context of a running step: ``group``, this
    rank's ``rows`` of a global microbatch of ``total`` rows, starting at
    ``offset``."""

    def __init__(self, group: TPGroup, rows: int):
        self.counts = [int(c) for c in allgather_host_ints([rows], group)[:, 0]]
        self.group, self.rows = group, rows
        self.offset = sum(self.counts[:group.rank])
        self.total = sum(self.counts)

    def block(self, n: int) -> tuple[int, int, int]:
        """(global length, start, stop) of this rank's block of a leading
        axis of ``n`` = a whole multiple of its batch rows."""
        if self.rows == 0 or n % self.rows:
            raise ValueError(f"a leading axis of {n} is no multiple of the step's "
                             f"{self.rows} rows a rank")
        per = n // self.rows
        return self.total * per, self.offset * per, (self.offset + self.rows) * per


_STEP: list = []


@contextlib.contextmanager
def data_parallel(group: TPGroup | None, rows: int):
    """Run the enclosed forward as this rank's ``rows`` of a global batch
    over ``group`` (one all-gather of the row counts: the split may be
    uneven). No-op without a group of more than one rank."""
    if group is None or group.size == 1:
        yield
        return
    _STEP.append(_DataStep(group, rows))
    try:
        yield
    finally:
        _STEP.pop()


def step_data_group() -> TPGroup | None:
    """The data group of the running step, or None."""
    return _STEP[-1].group if _STEP else None


def global_count(n: torch.Tensor) -> torch.Tensor:
    """``n`` (a count over this rank's rows) summed over the step's data
    group, without gradient: a loss divided by it is this rank's share of
    the global mean. ``n`` itself outside a data-parallel step."""
    if not _STEP:
        return n
    return _STEP[-1].group.all_reduce(n.detach().to(torch.float64)).to(n.dtype)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x``'s elements over the global
    batch (``x.mean()`` outside a data-parallel step)."""
    if not _STEP:
        return x.mean()
    return x.sum() / global_count(x.new_tensor(float(x.numel())))


def step_row_offset() -> int:
    """The global index of this rank's first row in the running step (0
    outside one)."""
    return _STEP[-1].offset if _STEP else 0


def global_rows() -> int | None:
    """The global batch's rows of the running step (None outside one)."""
    return _STEP[-1].total if _STEP else None


def draw_rows(draw, shape, **kw) -> torch.Tensor:
    """``draw(shape, **kw)`` (``torch.rand``, ...) at the global batch's
    leading size, this rank's rows kept: every rank consumes its generator
    as one rank drawing for the whole batch does."""
    if not _STEP:
        return draw(tuple(shape), **kw)
    total, a, b = _STEP[-1].block(shape[0])
    return draw((total, *shape[1:]), **kw)[a:b]


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return group.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the step's data group; the gradient of the sum
    flows to this rank's own ``t`` only (each rank back-propagates its own
    rows' part, and the harness sums the parameters' gradients)."""
    return _DataSum.apply(t, _STEP[-1].group) if _STEP else t


def data_share(x: torch.Tensor) -> torch.Tensor:
    """A loss term computed alike on every data rank (from ``data_sum``
    statistics), as this rank's part of the step's loss: the value
    ``x / ranks`` (the ranks' parts sum to ``x``), the gradient ``x``'s
    (through this rank's own rows)."""
    if not _STEP:
        return x
    return x.detach() / _STEP[-1].group.size + (x - x.detach())


def _gather_rows(t: torch.Tensor, step: _DataStep) -> torch.Tensor:
    """The ranks' ``t`` in rank order; their leading sizes may differ in
    proportion to the step's row counts (padded to the largest for the
    collective)."""
    per = t.shape[0] // step.rows if step.rows else 0
    sizes = [c * per for c in step.counts]
    pad = max(sizes) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    parts = step.group.all_gather(t, dim=0).split(max(sizes))
    return torch.cat([p[:n] for p, n in zip(parts, sizes)])


class _DataGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, step):
        ctx.step, ctx.n = step, t.shape[0]
        return _gather_rows(t, step)

    @staticmethod
    def backward(ctx, g):
        step = ctx.step
        start = step.offset * (ctx.n // step.rows)
        return step.group.all_reduce(g.contiguous())[start:start + ctx.n], None


def data_gather(t: torch.Tensor, grad: bool = False) -> torch.Tensor:
    """The data ranks' ``t`` (leading axis a multiple of the step's rows)
    concatenated in rank order. With ``grad`` the backward sums the
    gradient over the group and keeps this rank's rows (each rank's loss
    reads every rank's rows); without it the result is detached. ``t``
    outside a step."""
    if not _STEP:
        return t
    step = _STEP[-1]
    return _DataGather.apply(t, step) if grad else _gather_rows(t.detach(), step)


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


def _spawn_entry(rank, world, store_path, device, threads, payload, queue):
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
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
    torch CPU threads. ``fn`` and ``args`` reach the ranks through a file:
    a process argument past the pipe's buffer would hold each ``start()``
    until that rank had imported its main module, one rank after another."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store_path = os.path.join(tmp, "store")
        payload = os.path.join(tmp, "payload")
        with open(payload, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_spawn_entry, daemon=True,
                             args=(r, world, store_path, str(device), threads, payload, queue))
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
