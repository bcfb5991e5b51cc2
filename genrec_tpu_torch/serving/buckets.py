"""Bucket ladder for the serving prefill (port of
genrec_tpu/serving/buckets.py).

Prefill micro-batches are padded UP to a small fixed set of (batch,
history) buckets. PyTorch runs eagerly, so a bucket is not a compiled
executable here; it bounds the shapes the prefill runs at, so the padding
and the per-bucket counters match the JAX engine's and a later CUDA-graph
capture has a finite shape set to cover.
"""

from __future__ import annotations

from typing import Sequence


def _validated(name: str, buckets: Sequence[int]) -> tuple[int, ...]:
    out = tuple(int(b) for b in buckets)
    if not out or any(b <= 0 for b in out) or list(out) != sorted(set(out)):
        raise ValueError(
            f"{name} must be strictly increasing positive ints, got {buckets}"
        )
    return out


class BucketLadder:
    """Fixed (batch, history) bucket grids shared by every head."""

    def __init__(
        self,
        batch_buckets: Sequence[int] = (1, 2, 4, 8, 16),
        history_buckets: Sequence[int] = (8, 16, 32, 64),
    ):
        self.batch_buckets = _validated("batch_buckets", batch_buckets)
        self.history_buckets = _validated("history_buckets", history_buckets)

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def batch_bucket(self, n: int) -> int:
        """Smallest bucket >= n."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        raise ValueError(f"micro-batch of {n} exceeds largest bucket {self.max_batch}")

    def history_bucket(self, length: int) -> int:
        """Smallest bucket >= length; longer histories are truncated to
        their NEWEST max-bucket items by the heads."""
        for b in self.history_buckets:
            if length <= b:
                return b
        return self.history_buckets[-1]


def default_ladder(max_batch: int = 16, max_history: int = 64) -> BucketLadder:
    """Powers-of-two ladders capped at the engine's limits."""
    batches = []
    b = 1
    while b < max_batch:
        batches.append(b)
        b *= 2
    batches.append(max_batch)
    hists = []
    h = 8
    while h < max_history:
        hists.append(h)
        h *= 2
    hists.append(max_history)
    return BucketLadder(tuple(sorted(set(batches))), tuple(sorted(set(hists))))
