"""Recall@K / NDCG@K rank metrics (port of genrec_tpu/ops/metrics.py, the
part the HSTU slice runs), on the device that holds the ranks."""

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
