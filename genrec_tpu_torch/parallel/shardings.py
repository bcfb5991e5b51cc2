"""Megatron tensor parallelism for the Qwen backbone and for TIGER, and
expert parallelism for Qwen's mixture of experts (ports of ``qwen_rules``,
``tiger_rules`` and ``moe_rules``, genrec_tpu/parallel/shardings.py:24-57),
and the retrieval scoring ``item_topk`` on one device (JAX :120-160; its
shard_map branch over the item axis of a mesh is not ported, ROADMAP A26).

The JAX rules shard the parameters of one program and leave the
collectives to GSPMD: column-parallel q/k/v/gate/up kernels (their
output features), row-parallel o/down kernels (their input features),
and the embedding and head over the vocabulary; for TIGER the vocab head,
the sem-id rows and the FFN hidden units; for MoE the expert stacks. Here
each rank holds its shard and the layers issue the collectives:

- ``ColumnParallelLinear``: this rank's block of output features, the
  bias sharded alongside (GSPMD leaves the bias replicated and slices it;
  the arithmetic is the same). Its input goes through ``copy_to_tp``
  (identity forward, all-reduce of the gradient backward) once per use of
  the replicated activation, by the caller.
- ``RowParallelLinear``: this rank's block of input features, its partial
  output summed by ``reduce_from_tp`` (all-reduce forward, identity
  backward).
- ``VocabParallelEmbedding``: ids outside this rank's rows look up zeros,
  the partial rows summed over the group (in float32, exactly).
- ``gather_from_tp``: rank-local logits concatenated over the vocabulary
  (the head of generation).

Every sharded parameter carries ``tp_sharded = True`` (the clip of
``core.harness`` counts its square sum over the group). q heads split in
contiguous blocks per rank; a rank holds the KV heads its q heads use
(``kv_range``). Where tp does not divide the KV heads, a KV head sits on
every rank whose q heads use it (GSPMD's arithmetic when it cannot shard
the KV axis evenly): those ``k_proj`` / ``v_proj`` rows are replicas, their
gradients are summed over the holders (``sum_replica_grads``) and their
square sums weighted by 1 / holders in the clip (``tp_row_weight``).

Where a split axis does not divide, the port raises (``shard_count``),
where JAX's ``param_specs`` would replicate it: TIGER's trainer pads the
vocabulary to a multiple of tp (``pad_vocab_to``), as JAX's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW = ("o_proj", "down_proj")
VOCAB = ("embed_tokens", "lm_head")


def tp_size(group) -> int:
    return 1 if group is None else group.size


def tp_rank(group) -> int:
    return 0 if group is None else group.rank


def shard_count(n: int, tp: int, what: str) -> int:
    """n / tp, raising when tp does not divide n."""
    if n % tp:
        raise ValueError(f"{what} ({n}) must divide by tensor_parallel ({tp})")
    return n // tp


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g, "sum"), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return group.all_gather(x, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.group.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def copy_to_tp(x, group):
    """Identity forward; the gradient is summed over the group backward."""
    return x if tp_size(group) == 1 else _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    """Sum over the group forward; identity backward."""
    return x if tp_size(group) == 1 else _ReduceFromTP.apply(x, group)


def gather_from_tp(x, group):
    """Concatenation over the group along the last axis in rank order;
    backward takes this rank's slice of the gradient."""
    return x if tp_size(group) == 1 else _GatherFromTP.apply(x, group)


def _param(shape, device, sharded: bool) -> nn.Parameter:
    p = nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))
    p.tp_sharded = sharded
    return p


class ColumnParallelLinear(nn.Module):
    """y = x Wᵀ + b over this rank's out_features / tp outputs (or
    ``out_local`` of them, for rows held by ownership, e.g. KV heads); W is
    ``nn.Linear``'s (out, in) layout, fp32, cast to x's dtype at use."""

    def __init__(self, in_features: int, out_features: int, bias: bool, group, device,
                 out_local: int | None = None):
        super().__init__()
        tp = tp_size(group)
        out = (shard_count(out_features, tp, "column-parallel out_features")
               if out_local is None else out_local)
        self.weight = _param((out, in_features), device, tp > 1)
        self.bias = _param((out,), device, tp > 1) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class RowParallelLinear(nn.Module):
    """y = sum over the group of x_r W_rᵀ, x_r this rank's in_features / tp
    inputs (no bias: the Qwen o_proj and down_proj have none)."""

    def __init__(self, in_features: int, out_features: int, group, device):
        super().__init__()
        tp = tp_size(group)
        self.group = group
        self.weight = _param(
            (out_features, shard_count(in_features, tp, "row-parallel in_features")),
            device, tp > 1)

    def forward(self, x):
        return reduce_from_tp(F.linear(x, self.weight.to(x.dtype)), self.group)


class VocabParallelEmbedding(nn.Module):
    """Rows [rank V / tp, (rank + 1) V / tp) of the (V, d) table, fp32. The
    lookup returns the full rows (float32), the same on every rank."""

    def __init__(self, num_embeddings: int, dim: int, group, device):
        super().__init__()
        tp = tp_size(group)
        self.group = group
        self.rows = shard_count(num_embeddings, tp, "vocab size")
        self.weight = _param((self.rows, dim), device, tp > 1)

    def forward(self, ids):
        if tp_size(self.group) == 1:
            return self.weight[ids]
        off = tp_rank(self.group) * self.rows
        here = (ids >= off) & (ids < off + self.rows)
        rows = self.weight[torch.where(here, ids - off, 0)] * here[..., None]
        return reduce_from_tp(rows, self.group)


def kv_range(heads: int, kv_heads: int, rank: int, tp: int) -> tuple[int, int]:
    """[kv0, kv1): the KV heads rank ``rank`` of ``tp`` holds, those its
    contiguous q heads [q0, q1) use: [floor(q0 / g), ceil(q1 / g)) with
    g = heads / kv_heads."""
    n = shard_count(heads, tp, "num_attention_heads")
    g = heads // kv_heads
    q0, q1 = rank * n, (rank + 1) * n
    return q0 // g, -(-q1 // g)


def kv_holders(heads: int, kv_heads: int, tp: int) -> list[int]:
    """How many ranks hold each KV head."""
    count = [0] * kv_heads
    for r in range(tp):
        a, b = kv_range(heads, kv_heads, r, tp)
        for h in range(a, b):
            count[h] += 1
    return count


class _SumReplicaGrad:
    """A tensor hook: the gradient of this rank's rows ``[r0, r1)`` of a
    ``rows``-row parameter, summed with the other holders' gradients of the
    same rows (one all-reduce of a full-size buffer, zeros where a rank
    holds nothing)."""

    def __init__(self, group, rows: int, r0: int, r1: int):
        self.group, self.rows, self.r0, self.r1 = group, rows, r0, r1

    def __call__(self, g):
        full = g.new_zeros((self.rows, *g.shape[1:]))
        full[self.r0:self.r1] = g
        return self.group.all_reduce(full, "sum")[self.r0:self.r1]


def sum_replica_grads(p: torch.Tensor, group, rows: int, r0: int, r1: int,
                      row_weight: torch.Tensor) -> None:
    """Mark ``p`` (rows [r0, r1) of a ``rows``-row parameter, some of them
    held by other ranks too) so that its gradient is summed over the
    holders, and its square sum counts each row once in the clip
    (``tp_row_weight``: 1 / holders, a row each)."""
    p.register_hook(_SumReplicaGrad(group, rows, r0, r1))
    p.tp_sharded = True
    p.tp_row_weight = row_weight


def shard_dim(name: str) -> int | None:
    """The axis of a Qwen state-dict entry that tensor parallelism splits:
    0 for column-parallel weights and biases and the vocab tables, 1 for
    row-parallel weights, None for replicated entries (the norms, the MoE
    router and expert stacks)."""
    parts = name.split(".")
    if parts[0] in VOCAB:
        return 0
    if "moe" in parts:
        return None
    if len(parts) >= 2 and parts[-2] in COLUMN:
        return 0
    if len(parts) >= 2 and parts[-2] in ROW and parts[-1] == "weight":
        return 1
    return None


def _shard(full: dict, rank: int, tp: int, dim_of, rows_of=None) -> dict:
    """This rank's contiguous block of each entry along ``dim_of(name)``
    (None: replicated), or the rows ``rows_of(name)`` gives where it gives
    any. Raises when tp does not divide a split axis."""
    out = {}
    for name, t in full.items():
        dim = dim_of(name)
        rows = None if rows_of is None else rows_of(name)
        if dim is None or tp == 1:
            out[name] = t
        elif rows is not None:
            out[name] = t[rows[0]:rows[1]].contiguous()
        else:
            n = shard_count(t.shape[dim], tp, f"{name} axis {dim}")
            out[name] = t.narrow(dim, rank * n, n).contiguous()
    return out


def shard_qwen_params(full: dict, rank: int, tp: int, cfg=None) -> dict:
    """This rank's shard of a full Qwen state dict (the port's names, full
    shapes): contiguous blocks along ``shard_dim``, replicated entries as
    they are. ``k_proj`` / ``v_proj`` rows follow ``kv_range`` when ``cfg``
    (a ``QwenConfig``) is given, so a tp that does not divide the KV heads
    replicates or splits them; without it they split evenly. Raises when tp
    does not divide a split axis."""
    def kv_rows(name):
        if cfg is None or name.split(".")[-2:-1] not in (["k_proj"], ["v_proj"]):
            return None
        a, b = kv_range(cfg.num_attention_heads, cfg.num_key_value_heads, rank, tp)
        return a * cfg.head_dim, b * cfg.head_dim

    return _shard(full, rank, tp, shard_dim, kv_rows)


EXPERT_STACKS = ("gate_proj", "up_proj", "down_proj")


def expert_shard_dim(name: str) -> int | None:
    """0 for a MoE expert stack (``layers.<i>.moe.{gate,up,down}_proj``,
    (E, D, F) or (E, F, D)), None otherwise (JAX ``moe_rules``: the router
    stays replicated)."""
    parts = name.split(".")
    return 0 if len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in EXPERT_STACKS else None


def shard_expert_params(full: dict, rank: int, ep: int) -> dict:
    """This rank's shard of a full MoE Qwen state dict under expert
    parallelism ``ep``: experts [rank E / ep, (rank + 1) E / ep) of every
    stack, everything else replicated. Raises when ep does not divide E."""
    return _shard(full, rank, ep, expert_shard_dim)


def tiger_shard_dim(name: str) -> int | None:
    """The axis of a TIGER state-dict entry that tensor parallelism splits
    (JAX ``tiger_rules``): 0 for the vocab head (``output_head.weight``,
    (V, d)), the sem-id rows and every FFN ``wi`` (its output features), 1
    for every FFN ``wo`` (its input features), None for the rest (attention
    stays replicated)."""
    parts = name.split(".")
    if name in ("output_head.weight", "sem_id_embedding.embedding"):
        return 0
    if len(parts) >= 3 and parts[-3] == "ff" and parts[-1] == "weight":
        return {"wi": 0, "wo": 1}.get(parts[-2])
    return None


def shard_tiger_params(full: dict, rank: int, tp: int) -> dict:
    """This rank's shard of a full TIGER state dict: contiguous blocks
    along ``tiger_shard_dim``. Raises when tp does not divide a split axis
    (pad the vocabulary with ``pad_vocab_to=tp``)."""
    return _shard(full, rank, tp, tiger_shard_dim)


def _score_items(h: torch.Tensor, emb) -> torch.Tensor:
    """fp32 (B, V) scores of last-hiddens against a table.

    A ``QuantizedTable`` (anything with ``.data`` and ``.scale``)
    dequantises at score: ``(h @ data.T) * scale`` equals ``h @ (data *
    scale[:, None]).T`` in fp32, so the resident operand stays int8 and
    the accumulation fp32."""
    if hasattr(emb, "scale"):
        return (h.to(torch.float32) @ emb.data.to(torch.float32).T) * emb.scale[None, :]
    return (h @ emb.T).to(torch.float32)


def item_topk(h: torch.Tensor, item_emb, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k items from last-hidden states: (B, d) x (V, d) -> (scores
    fp32, ids int64), both (B, k), with the pad row (item 0) excluded.

    ``item_emb`` is a plain (V, d) table or an int8
    ``ops.quant.QuantizedTable``. Ties rank the lower id first, as
    ``jax.lax.top_k`` does: a stable descending sort (``torch.topk``
    does not promise that order)."""
    k = min(k, item_emb.shape[0])
    scores = _score_items(h, item_emb)
    scores[:, 0] = -torch.inf
    order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return order.values[:, :k], order.indices[:, :k]
