"""Static-shape batching over in-memory numpy datasets (port of
genrec_tpu/data/batching.py, the part the HSTU slice runs).

``PackingReport``, ``first_fit_decreasing``, ``pack_examples``,
``pad_to_batch``, ``batch_iterator`` and ``fold_valid`` are numpy only and
copied as they are. ``prefetch_to_device`` is the torch side: a
background thread assembles numpy batches ahead, and the main thread
copies them to the device from pinned host memory without blocking.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch


def prefetch_to_device(iterator, device, size: int = 2):
    """Overlap host batching with device compute.

    Wraps a (batch, valid) iterator of numpy dicts: a background thread
    assembles batches ``size`` steps ahead (the fancy-index gather and
    padding); the main thread turns each array into a tensor on
    ``device``. For a CUDA device the copy goes from pinned memory with
    ``non_blocking=True``, so it queues behind the running step instead of
    waiting for it. Yields (batch of tensors, valid mask as numpy)."""
    import queue
    import threading

    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()
    _ERR = object()
    stop = threading.Event()

    def _put(item) -> bool:
        # Bounded-wait put so the thread can't block forever if the
        # consumer abandons the loop (e.g. an iteration-cap break).
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch, valid in iterator:
                if not _put((batch, valid)):
                    return
        except BaseException as e:  # data-pipeline failures must CRASH the
            _put((_ERR, e))  # train loop, not truncate the epoch silently
            return
        _put(_END)

    def to_device(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if pin:
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and item[0] is _ERR:
                raise item[1]
            batch, valid = item
            yield {k: to_device(v) for k, v in batch.items()}, valid
    finally:
        stop.set()  # unblocks + retires the producer on early exit


def fold_valid(iterator):
    """Fold the valid mask into the batch (int32 key "valid") so it ships
    to device with the prefetching iterator — for eval steps that consume
    the mask on device."""
    for batch, valid in iterator:
        yield {**batch, "valid": valid.astype(np.int32)}, valid


def pad_to_batch(arrays: Mapping[str, np.ndarray], batch_size: int):
    """Pad dict-of-arrays (same leading dim) up to batch_size; returns
    (padded, valid_mask)."""
    n = next(iter(arrays.values())).shape[0]
    pad = batch_size - n
    out = {}
    for k, v in arrays.items():
        if pad > 0:
            padding = np.zeros((pad,) + v.shape[1:], v.dtype)
            out[k] = np.concatenate([v, padding], axis=0)
        else:
            out[k] = v
    valid = np.zeros((batch_size,), bool)
    valid[:n] = True
    return out, valid


@dataclasses.dataclass(frozen=True)
class PackingReport:
    """Occupancy accounting for one packing pass.

    ``occupancy`` = real tokens / total slots; ``padded_rows`` is what the
    pre-packing layout would have used (one row per example), so
    ``padded_rows / n_rows`` is the step-count (and FLOP) reduction."""

    n_examples: int
    n_rows: int
    row_len: int
    real_tokens: int
    max_segments: int

    @property
    def slot_tokens(self) -> int:
        return self.n_rows * self.row_len

    @property
    def occupancy(self) -> float:
        return self.real_tokens / max(self.slot_tokens, 1)

    @property
    def padded_rows(self) -> int:
        return self.n_examples

    def as_dict(self) -> dict:
        return {
            "n_examples": self.n_examples,
            "n_rows": self.n_rows,
            "row_len": self.row_len,
            "real_tokens": self.real_tokens,
            "max_segments": self.max_segments,
            "occupancy": round(self.occupancy, 4),
            "rows_vs_padded": round(self.n_rows / max(self.padded_rows, 1), 4),
        }

    def __str__(self) -> str:
        return (
            f"packed {self.n_examples} examples into {self.n_rows} rows of "
            f"{self.row_len} (was {self.padded_rows} padded rows): "
            f"occupancy {self.occupancy:.1%}, "
            f"<= {self.max_segments} segments/row"
        )


def first_fit_decreasing(
    lengths: Sequence[int], capacity: int, max_segments: int | None = None,
) -> list[list[int]]:
    """Greedy FFD bin packing: example indices binned into rows of
    ``capacity`` slots. Deterministic (stable sort by decreasing length);
    raises if any example exceeds the row capacity — producers truncate to
    the model window before packing.

    ``max_segments`` caps examples per row: many tiny examples in one row
    would otherwise drive the GLOBAL max-segments-per-row up, and packed
    consumers that allocate per-segment work (TIGER's per-example
    decoders) pay for that max on every row.

    The first-fit scan runs in numpy (one C-speed pass over open bins per
    example) — the pure-Python scan was minutes of startup at Amazon
    scale (~1e5 examples, ~2e4 bins)."""
    lengths = np.asarray(lengths, np.int64)
    if lengths.size and int(lengths.max()) > capacity:
        raise ValueError(
            f"example length {int(lengths.max())} exceeds row capacity {capacity}"
        )
    if (lengths <= 0).any():
        raise ValueError("every example must have at least one token")
    order = np.argsort(-lengths, kind="stable")
    bins: list[list[int]] = []
    n_bins = 0
    remaining = np.empty(len(lengths), np.int64)  # at most one bin/example
    for idx in order:
        n = int(lengths[idx])
        fits = np.nonzero(remaining[:n_bins] >= n)[0]
        if fits.size:
            b = int(fits[0])
            bins[b].append(int(idx))
            remaining[b] -= n
            if max_segments is not None and len(bins[b]) == max_segments:
                remaining[b] = -1  # full: no further examples
        else:
            bins.append([int(idx)])
            remaining[n_bins] = capacity - n
            if max_segments == 1:
                remaining[n_bins] = -1
            n_bins += 1
    return bins


def pack_examples(
    examples: Sequence[Mapping[str, np.ndarray]],
    row_len: int,
    *,
    segment_keys: Sequence[str] = (),
    max_segments: int | None = None,
    seed=None,
) -> tuple[dict[str, np.ndarray], PackingReport]:
    """Bin variable-length examples into fixed-width packed rows.

    Each example is a dict of equal-length 1-D token arrays (e.g.
    ``input_ids``/``targets``/``timestamps``) plus, optionally, per-example
    fixed-shape values named in ``segment_keys`` (e.g. TIGER's
    ``target_ids``). Returns ``(arrays, report)`` where arrays hold:

    - one ``(n_rows, row_len)`` array per token key, segments laid out
      contiguously from slot 0, pad value 0;
    - ``segment_ids`` ``(n_rows, row_len)`` int32 — 1-based per segment,
      0 at padding slots (the attention-mask and loss-mask source);
    - ``positions`` ``(n_rows, row_len)`` int32 — within-segment 0-based
      positions (for learned/relative position lookups);
    - per ``segment_keys`` key a ``(n_rows, max_segments, ...)`` array plus
      ``segment_valid`` ``(n_rows, max_segments)`` int32 marking real
      segments.

    ``max_segments`` (optional) caps segments per row — consumers that do
    per-segment work sized by the row MAXIMUM (TIGER's decoder batch is
    rows x max_segments) trade a little occupancy for a bounded max.

    ``seed`` (optional, any numpy Generator seed) pre-permutes the
    examples before the length-stable FFD sort, re-mixing which
    SAME-LENGTH examples co-locate in a row. Trainers re-pack each epoch
    with an epoch-varying seed so example co-batching is reshuffled like
    the padded layout's per-epoch permutation; None keeps input order
    (deterministic layout for parity tests).
    """
    if not examples:
        raise ValueError("pack_examples needs at least one example")
    if seed is not None:
        perm = np.random.default_rng(seed).permutation(len(examples))
        examples = [examples[int(i)] for i in perm]
    seg_keys = tuple(segment_keys)
    token_keys = [k for k in examples[0].keys() if k not in seg_keys]
    if not token_keys:
        raise ValueError("examples carry no token arrays")
    lengths = [len(np.asarray(ex[token_keys[0]])) for ex in examples]
    for ex, n in zip(examples, lengths):
        for k in token_keys:
            if len(np.asarray(ex[k])) != n:
                raise ValueError(f"token key {k!r} length mismatch within example")
    bins = first_fit_decreasing(lengths, row_len, max_segments)
    R = len(bins)
    # With a cap, the segment axis is pinned to it so re-packs (per-epoch
    # seeds) keep a STATIC shape — no jit recompile when the realized
    # max shifts between epochs.
    S = max_segments if max_segments is not None else max(len(b) for b in bins)

    out: dict[str, np.ndarray] = {
        k: np.zeros((R, row_len), np.asarray(examples[0][k]).dtype)
        for k in token_keys
    }
    out["segment_ids"] = np.zeros((R, row_len), np.int32)
    out["positions"] = np.zeros((R, row_len), np.int32)
    for k in seg_keys:
        proto = np.asarray(examples[0][k])
        out[k] = np.zeros((R, S) + proto.shape, proto.dtype)
    out["segment_valid"] = np.zeros((R, S), np.int32)

    real_tokens = 0
    for r, bin_idx in enumerate(bins):
        cursor = 0
        for s, idx in enumerate(bin_idx):
            n = lengths[idx]
            sl = slice(cursor, cursor + n)
            for k in token_keys:
                out[k][r, sl] = np.asarray(examples[idx][k])
            out["segment_ids"][r, sl] = s + 1
            out["positions"][r, sl] = np.arange(n)
            for k in seg_keys:
                out[k][r, s] = np.asarray(examples[idx][k])
            out["segment_valid"][r, s] = 1
            cursor += n
            real_tokens += n
    report = PackingReport(
        n_examples=len(examples), n_rows=R, row_len=row_len,
        real_tokens=real_tokens, max_segments=S,
    )
    return out, report


def batch_iterator(
    arrays: Mapping[str, np.ndarray],
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    epoch: int = 0,
    start_batch: int = 0,
) -> Iterator[tuple[dict, np.ndarray]]:
    """Yield (batch_dict, valid_mask) of fixed shape (batch_size, ...).

    Shuffling is deterministic in (seed, epoch) so every data-parallel
    process draws the same permutation and shards it consistently.

    ``start_batch`` skips the first N batches WITHOUT gathering them —
    the mid-epoch resume cursor (core.fault_tolerance): the permutation
    is drawn in full, so batch i of a resumed epoch is bit-identical to
    batch i of the uninterrupted one.
    """
    n = next(iter(arrays.values())).shape[0]
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng((seed, epoch)).permutation(n)
    for start in range(start_batch * batch_size, n, batch_size):
        sel = idx[start : start + batch_size]
        if len(sel) < batch_size and drop_last:
            return
        chunk = {k: v[sel] for k, v in arrays.items()}
        yield pad_to_batch(chunk, batch_size)
