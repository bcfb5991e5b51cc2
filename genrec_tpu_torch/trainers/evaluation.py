"""Evaluation helpers: the sharded eval batches every trainer's eval reads,
and the top-k sums of the sequential trainers (HSTU, SASRec)."""

from __future__ import annotations

import torch

from genrec_tpu_torch.data.batching import batch_iterator, prefetch_to_device
from genrec_tpu_torch.ops.metrics import first_match_ranks
from genrec_tpu_torch.parallel.mesh import metric_allreduce, shard_batch

KS = (1, 5, 10)


def eval_batches(arrays, batch_size, data_group=None, device=None):
    """This data rank's rows of every padded batch of ``arrays``, in order
    (JAX's sharded eval: each rank scores its rows of the padded batch and
    the sums are added over the data group with ``metric_allreduce``).
    Yields (rows, their valid mask as bool, the global index of the first
    row). With a ``device`` the rows and the mask are tensors there, copied
    ahead of use (``prefetch_to_device``); else numpy."""
    rank = 0 if data_group is None else data_group.rank
    parts = ((shard_batch({**host, "valid": valid}, data_group), None)
             for host, valid in batch_iterator(arrays, batch_size))
    if device is not None:
        parts = prefetch_to_device(parts, device)
    for b, (part, _) in enumerate(parts):
        valid = part.pop("valid")
        valid = valid.bool() if device is not None else valid.astype(bool)
        yield part, valid, b * batch_size + rank * valid.shape[0]


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


def evaluate(eval_step, arrays, batch_size, device, data_group=None):
    """Recall@{1,5,10} and NDCG@{1,5,10} over ``arrays`` (padded last
    batch masked out). With a ``data_group`` each rank scores its rows of
    every padded batch and the sums are added over the group
    (``metric_allreduce``, JAX's sharded eval)."""
    sums: dict[str, torch.Tensor] = {}
    for batch, valid, _ in eval_batches(arrays, batch_size, data_group, device):
        for k, v in eval_step(batch, valid).items():
            sums[k] = v if k not in sums else sums[k] + v
    sums = metric_allreduce({k: float(v) for k, v in sums.items()}, data_group)
    total = max(sums.get("total", 0.0), 1.0)
    return {
        **{f"Recall@{k}": sums[f"recall_sum@{k}"] / total for k in KS},
        **{f"NDCG@{k}": sums[f"ndcg_sum@{k}"] / total for k in KS},
    }
