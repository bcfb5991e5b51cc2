"""Evaluation helpers shared by the sequential trainers (HSTU, SASRec)."""

from __future__ import annotations

import torch

from genrec_tpu_torch.data.batching import batch_iterator, fold_valid, prefetch_to_device
from genrec_tpu_torch.ops.metrics import first_match_ranks

KS = (1, 5, 10)


def topk_sums(last, targets, valid) -> dict:
    """Device sums of one eval batch from its (B, V) next-item logits:
    column 0 at -inf, the top 10 in ``jax.lax.top_k``'s order (higher score
    first, the lower index first among ties: a stable descending sort), and
    the hit and DCG sums at 1, 5 and 10 over the rows ``valid`` keeps."""
    last = last.to(torch.float32)
    last[:, 0] = -torch.inf
    top = torch.sort(last, dim=-1, descending=True, stable=True).indices[:, :10]
    ranks = first_match_ranks(targets, top[..., None])
    v = valid.to(torch.float32)
    out = {"total": v.sum()}
    for k in KS:
        hit = ranks < k
        out[f"recall_sum@{k}"] = (hit * v).sum()
        out[f"ndcg_sum@{k}"] = (torch.where(
            hit, 1.0 / torch.log2(ranks.to(torch.float32) + 2.0), 0.0) * v).sum()
    return out


def evaluate(eval_step, arrays, batch_size, device):
    """Recall@{1,5,10} and NDCG@{1,5,10} over ``arrays`` (padded last
    batch masked out)."""
    sums: dict[str, torch.Tensor] = {}
    for batch, _ in prefetch_to_device(fold_valid(batch_iterator(arrays, batch_size)),
                                       device):
        for k, v in eval_step(batch, batch["valid"]).items():
            sums[k] = v if k not in sums else sums[k] + v
    sums = {k: float(v) for k, v in sums.items()}
    total = max(sums.get("total", 0.0), 1.0)
    return {
        **{f"Recall@{k}": sums[f"recall_sum@{k}"] / total for k in KS},
        **{f"NDCG@{k}": sums[f"ndcg_sum@{k}"] / total for k in KS},
    }
