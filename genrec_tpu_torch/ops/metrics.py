"""Recall@K / NDCG@K rank metrics (port of genrec_tpu/ops/metrics.py), on
the device that holds the ranks, and ``TopKAccumulator``, whose
``reduce`` sums across the ranks of a group (JAX: across processes)."""

from __future__ import annotations

import torch


def first_match_ranks(actual: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Rank (0-indexed) of the first beam exactly matching ``actual``.

    Args:
        actual: (B, D) ground-truth id tuples (D=1 for plain item ids).
        top_k: (B, K, D) ranked predictions.
    Returns:
        (B,) int32 rank in [0, K]; K means "not found".
    """
    matches = (actual[:, None, :] == top_k).all(dim=-1)  # (B, K)
    K = top_k.shape[1]
    found = matches.any(dim=1)
    rank = matches.to(torch.int32).argmax(dim=1)  # first True
    return torch.where(found, rank, K).to(torch.int32)


def recall_at_k(ranks: torch.Tensor, k: int) -> torch.Tensor:
    """Sum (not mean) of hits in top-k; divide by total at reduce time."""
    return (ranks < k).to(torch.float32).sum()


def ndcg_at_k(ranks: torch.Tensor, k: int) -> torch.Tensor:
    in_top = ranks < k
    dcg = torch.where(in_top, 1.0 / torch.log2(ranks.to(torch.float32) + 2.0), 0.0)
    return dcg.sum()


def batch_metrics(actual: torch.Tensor, top_k: torch.Tensor, ks: tuple[int, ...]) -> dict:
    """Sums for every K plus the batch count."""
    ranks = first_match_ranks(actual, top_k)
    out = {"total": torch.tensor(float(ranks.shape[0]))}
    for k in ks:
        out[f"recall_sum@{k}"] = recall_at_k(ranks, k)
        out[f"ndcg_sum@{k}"] = ndcg_at_k(ranks, k)
    return out


class TopKAccumulator:
    """Host-side accumulator over device-computed batch sums; ``reduce``
    divides through after summing over ``group`` (a ``TPGroup`` whose
    ranks saw different batches), when given."""

    def __init__(self, ks: tuple[int, ...] = (1, 5, 10)):
        self.ks = tuple(ks)
        self.reset()

    def reset(self) -> None:
        self._sums: dict[str, float] = {}

    def accumulate(self, actual: torch.Tensor, top_k: torch.Tensor) -> None:
        for k, v in batch_metrics(actual, top_k, self.ks).items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)

    def reduce(self, group=None) -> dict[str, float]:
        from genrec_tpu_torch.parallel.mesh import metric_allreduce

        sums = metric_allreduce(dict(self._sums), group)
        total = max(sums.get("total", 0.0), 1.0)
        out = {}
        for k in self.ks:
            out[f"Recall@{k}"] = sums.get(f"recall_sum@{k}", 0.0) / total
            out[f"NDCG@{k}"] = sums.get(f"ndcg_sum@{k}", 0.0) / total
        return out
