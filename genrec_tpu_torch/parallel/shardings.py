"""Megatron tensor parallelism for the Qwen backbone (port of ``qwen_rules``,
genrec_tpu/parallel/shardings.py:33-42).

The JAX rules shard the parameters of one program and leave the
collectives to GSPMD: column-parallel q/k/v/gate/up kernels (their
output features), row-parallel o/down kernels (their input features),
and the embedding and head over the vocabulary. Here each rank holds its
shard and the layers issue the collectives:

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
contiguous blocks per rank and KV heads likewise, so each rank's q heads
use its own KV heads: ``num_key_value_heads % tp == 0`` is required.
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
    """y = x Wᵀ + b over this rank's out_features / tp outputs; W is
    ``nn.Linear``'s (out, in) layout, fp32, cast to x's dtype at use."""

    def __init__(self, in_features: int, out_features: int, bias: bool, group, device):
        super().__init__()
        tp = tp_size(group)
        out = shard_count(out_features, tp, "column-parallel out_features")
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


def shard_dim(name: str) -> int | None:
    """The axis of a Qwen state-dict entry that tensor parallelism splits:
    0 for column-parallel weights and biases and the vocab tables, 1 for
    row-parallel weights, None for replicated entries (the norms)."""
    parts = name.split(".")
    if parts[0] in VOCAB:
        return 0
    if len(parts) >= 2 and parts[-2] in COLUMN:
        return 0
    if len(parts) >= 2 and parts[-2] in ROW and parts[-1] == "weight":
        return 1
    return None


def shard_qwen_params(full: dict, rank: int, tp: int) -> dict:
    """This rank's shard of a full Qwen state dict (the port's names, full
    shapes): contiguous blocks along ``shard_dim``, replicated entries as
    they are. Raises when tp does not divide a split axis."""
    out = {}
    for name, t in full.items():
        dim = shard_dim(name)
        if dim is None or tp == 1:
            out[name] = t
            continue
        n = shard_count(t.shape[dim], tp, f"{name} axis {dim}")
        out[name] = t.narrow(dim, rank * n, n).contiguous()
    return out
