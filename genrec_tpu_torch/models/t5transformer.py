"""T5-style transformer encoder-decoder, TIGER's backbone (port of
genrec_tpu/models/t5transformer.py: the training forward, the dense
KV-cached decode, the paged decode and the speculative tree pass).

Same contracts as the JAX module: per-layer T5 relative bias stored as an
``(n_heads * num_buckets, 1)`` parameter, bias-free projections, fused
``kv`` projection for self-attention (first half K, second half V),
pre-norm blocks, T5 ReLU FFN, RMS norms with fp32 statistics, softmax in
fp32, masked scores FILLED with -1e9 (kept inside the softmax) and an
additive ``attn_mask`` added after the fill.

Mixed precision as Flax ``dtype``: parameters stay float32 and are cast
to ``dtype`` where they are used; scores, bias and softmax are float32,
the attention weights and every activation ``dtype``. Dropout (rates as
the Flax modules': attention weights, FFN hidden, each residual branch)
draws its bits from the ``generator`` a training forward is given.

Layouts follow the JAX functions so the tests compare like with like:
encoder tensors are (B, L, d); decode tensors are (B, K, ...) with K
beams; the self-attention suffix cache is (B, K, S, H, hd); cross K/V
from ``project_kv`` are (B, H, Lm, hd). ``nn.Linear`` stores ``(out, in)``
where Flax stores ``(in, out)``; ``genrec_tpu_torch.convert`` transposes.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.kernels.table_grad import table_grad
from genrec_tpu_torch.models.layers import Dense, RMSNorm, dropout
from genrec_tpu_torch.ops.buckets import t5_relative_position_bucket
from genrec_tpu_torch.ops.paged import paged_attention
from genrec_tpu_torch.ops.spec_tree import tree_virtual_cache
from genrec_tpu_torch.parallel.shardings import (
    copy_to_tp,
    reduce_from_tp,
    shard_count,
    tp_rank,
    tp_size,
)

_NEG = -1e9


def _linear(d_in: int, d_out: int, dtype, device) -> Dense:
    return Dense(d_in, d_out, dtype, device, bias=False)


class _TableLookup(torch.autograd.Function):
    """``table.reshape(-1)[idx]`` whose backward sums the gradient of each
    entry in one histogram pass (``kernels.table_grad``: a fixed-order
    kernel on the card, ``torch.bincount`` on the CPU). Autograd's backward
    of the plain gather sorts the indices and adds each entry's duplicates
    one after another: the packed encoder's bias grid reads 192 entries
    ~5.7 M times a layer, and that backward took ~9 ms a layer on an
    H100. ``bincount`` on CUDA adds through atomics, whose order changes
    from run to run; the kernel keeps a TIGER step's bits the same on
    every run."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table.reshape(-1)[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        g = table_grad(idx.reshape(-1).to(torch.int64).contiguous(),
                       grad.reshape(-1).to(torch.float32).contiguous(),
                       math.prod(ctx.table_shape))
        return g.reshape(ctx.table_shape), None


class T5Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, is_cross_attention: bool = False,
                 has_relative_bias: bool = True, num_relative_buckets: int = 32,
                 max_distance: int = 128, dropout: float = 0.0, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.n_heads = n_heads
        self.is_cross_attention = is_cross_attention
        self.has_relative_bias = has_relative_bias and not is_cross_attention
        self.num_relative_buckets = num_relative_buckets
        self.max_distance = max_distance
        self.dropout = dropout
        self.q = _linear(d_model, d_model, dtype, device)
        if is_cross_attention:
            self.k = _linear(d_model, d_model, dtype, device)
            self.v = _linear(d_model, d_model, dtype, device)
        else:
            self.kv = _linear(d_model, 2 * d_model, dtype, device)
        self.o = _linear(d_model, d_model, dtype, device)
        if self.has_relative_bias:
            self.rel_bias = nn.Parameter(
                torch.empty(n_heads * num_relative_buckets, 1, device=device)
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def _bias_from_rel(self, rel: torch.Tensor) -> torch.Tensor:
        """``rel`` (..., k) int grid of ``mem - ctx`` -> (..., H, k) bias."""
        buckets = t5_relative_position_bucket(
            rel, self.num_relative_buckets, self.max_distance, bidirectional=True
        )
        head_offset = (
            torch.arange(self.n_heads, device=rel.device) * self.num_relative_buckets
        )[:, None]
        return _TableLookup.apply(self.rel_bias, buckets[..., None, :] + head_offset)

    def forward(self, query: torch.Tensor, key=None, value=None, attn_mask=None,
                key_padding_mask=None, deterministic: bool = True, positions=None,
                generator=None) -> torch.Tensor:
        """Attention over (B, L, d) ``query``: self-attention, or
        cross-attention to ``key`` / ``value``. ``key_padding_mask`` (B, Lk),
        True = padding, fills -1e9; ``attn_mask`` is additive, (Lq, Lk) or
        broadcastable; ``positions`` (B, L) per-token positions (within a
        segment for packed rows) for the relative bias."""
        B, Lq, _ = query.shape
        H, hd = self.n_heads, self.head_dim
        if self.is_cross_attention:
            k, v = self.k(key), self.v(value)
        else:
            k, v = self.kv(query).chunk(2, dim=-1)
        q = self.q(query)

        def split(x):
            return x.reshape(B, -1, H, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        Lk = k.shape[2]
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (hd**-0.5)
        scores = scores.to(torch.float32)
        if self.has_relative_bias:
            if positions is not None:
                rel = positions[:, None, :] - positions[:, :, None]  # (B, q, k)
                scores = scores + self._bias_from_rel(rel).transpose(1, 2)
            else:
                pos = torch.arange(max(Lq, Lk), device=query.device)
                rel = pos[None, :Lk] - pos[:Lq, None]  # (q, k) mem - ctx
                scores = scores + self._bias_from_rel(rel).transpose(0, 1)[None]
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], _NEG)
        if attn_mask is not None:
            scores = scores + attn_mask
        attn = torch.softmax(scores, dim=-1).to(query.dtype)
        attn = dropout(attn, self.dropout, deterministic, generator)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        out = out.transpose(1, 2).reshape(B, Lq, self.d_model)
        return self.o(out)

    # ---- incremental decode ------------------------------------------------

    def decode_self(self, x: torch.Tensor, cache: dict, step: int):
        """One self-attention decode step against a static KV cache.

        x: (B, K, d_model), the current position of each of K beams;
        cache {"k", "v"}: (B, K, S, H, hd), written at slot ``step``;
        slots > step score -1e9. Returns (out, new_cache); the cache is
        not modified in place."""
        B, K, _ = x.shape
        H, hd = self.n_heads, self.head_dim
        k_new, v_new = self.kv(x).chunk(2, dim=-1)
        q = self.q(x).reshape(B, K, H, hd)
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[:, :, step] = k_new.reshape(B, K, H, hd)
        cv[:, :, step] = v_new.reshape(B, K, H, hd)
        S = ck.shape[2]
        pos = torch.arange(S, device=x.device)
        scores = torch.einsum("bkhd,bkshd->bkhs", q, ck) * (hd**-0.5)
        scores = scores.to(torch.float32)
        if self.has_relative_bias:
            scores = scores + self._bias_from_rel(pos - step)  # (H, S) at query ``step``
        scores = scores.masked_fill(pos > step, _NEG)
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkhs,bkshd->bkhd", attn, cv).reshape(B, K, self.d_model)
        return self.o(out), {"k": ck, "v": cv}

    def decode_self_ragged(self, x: torch.Tensor, cache: dict, steps: torch.Tensor):
        """One self-attention decode step with a PER-ROW step operand.

        x: (B, K, d_model); cache {"k", "v"}: (B, K, S, H, hd); steps (B,).
        Row b writes its new K/V at slot steps[b], attends slots <=
        steps[b] (later slots score -1e9), with the relative bias read at
        query position steps[b]. Returns (out, new_cache); the cache is
        not modified in place.
        """
        B, K, _ = x.shape
        H, hd = self.n_heads, self.head_dim
        k_new, v_new = self.kv(x).chunk(2, dim=-1)
        q = self.q(x).reshape(B, K, H, hd)
        S = cache["k"].shape[2]
        pos = torch.arange(S, device=x.device)
        hit = (pos[None, :] == steps[:, None])[:, None, :, None, None]
        ck = torch.where(hit, k_new.reshape(B, K, 1, H, hd), cache["k"])
        cv = torch.where(hit, v_new.reshape(B, K, 1, H, hd), cache["v"])
        scores = torch.einsum("bkhd,bkshd->bkhs", q, ck) * (hd**-0.5)
        scores = scores.to(torch.float32)
        if self.has_relative_bias:
            rel = pos[None, :] - steps[:, None]  # (B, S) mem - ctx
            scores = scores + self._bias_from_rel(rel)[:, None]  # (B, 1, H, S)
        scores = scores.masked_fill(
            pos[None, None, None, :] > steps[:, None, None, None], _NEG
        )
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkhs,bkshd->bkhd", attn, cv).reshape(B, K, self.d_model)
        return self.o(out), {"k": ck, "v": cv}

    def decode_self_tree(self, x: torch.Tensor, cache: dict, topo, steps: torch.Tensor):
        """Speculative tree-verification self-attention: one pass over
        every candidate-tree node (``ops.spec_tree``).

        x (B, N, d_model): N tree nodes in place of the K beams. cache: the
        COMMITTED (B, K, S, H, hd) suffix cache, read only (the accept scan
        commits). steps (B,): the slots' decode positions. Node n attends
        its root beam's committed prefix plus its ancestors' K/V from this
        pass (``tree_virtual_cache``), with the ops of
        ``decode_self_ragged`` at its own position steps + level[n].
        Returns (out (B, N, d_model), (k_new, v_new) each (B, N, H, hd)).
        """
        B, N, _ = x.shape
        H, hd = self.n_heads, self.head_dim
        k_new, v_new = self.kv(x).chunk(2, dim=-1)
        q = self.q(x).reshape(B, N, H, hd)
        k_new = k_new.reshape(B, N, H, hd)
        v_new = v_new.reshape(B, N, H, hd)
        S = cache["k"].shape[2]
        pos = torch.arange(S, device=x.device)
        node_steps = steps[:, None] + topo.on(x.device)["level"][None, :]  # (B, N)
        vk = tree_virtual_cache(cache["k"], k_new, topo, steps)
        vv = tree_virtual_cache(cache["v"], v_new, topo, steps)
        scores = torch.einsum("bkhd,bkshd->bkhs", q, vk) * (hd**-0.5)
        scores = scores.to(torch.float32)
        if self.has_relative_bias:
            rel = pos[None, None, :] - node_steps[:, :, None]  # (B, N, S) mem - ctx
            scores = scores + self._bias_from_rel(rel)  # (B, N, H, S)
        scores = scores.masked_fill(
            pos[None, None, None, :] > node_steps[:, :, None, None], _NEG
        )
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkhs,bkshd->bkhd", attn, vv).reshape(B, N, self.d_model)
        return self.o(out), (k_new, v_new)

    def project_kv(self, memory: torch.Tensor):
        """Cross-attention K/V from the encoder memory, computed once per
        request batch: (B, Lm, d) -> two (B, H, Lm, hd)."""
        B, Lm, _ = memory.shape
        H, hd = self.n_heads, self.head_dim
        k = self.k(memory).reshape(B, Lm, H, hd).transpose(1, 2)
        v = self.v(memory).reshape(B, Lm, H, hd).transpose(1, 2)
        return k, v

    def decode_cross(self, x: torch.Tensor, kv, key_padding_mask=None) -> torch.Tensor:
        """Cross-attention of K beams against the batch-sized cached K/V:
        x (B, K, d_model), kv two (B, H, Lm, hd), key_padding_mask (B, Lm)
        True = padding. The einsum resolves the beam axis against the
        memory: no K-fold copy of it."""
        B, K, _ = x.shape
        H, hd = self.n_heads, self.head_dim
        k, v = kv
        q = self.q(x).reshape(B, K, H, hd)
        scores = torch.einsum("bkhd,bhmd->bkhm", q, k) * (hd**-0.5)
        scores = scores.to(torch.float32)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], _NEG)
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkhm,bhmd->bkhd", attn, v).reshape(B, K, self.d_model)
        return self.o(out)

    def decode_cross_paged(self, x, k_pool, v_pool, block_tables, seq_lens):
        """Cross-attention of K beams against PAGED memory K/V: each row
        reads its own pages through its block-table row; positions >=
        seq_lens[b] are masked. Beams share the row's pages."""
        B, K, _ = x.shape
        q = self.q(x).reshape(B, K, self.n_heads, self.head_dim)
        out = paged_attention(q, k_pool, v_pool, block_tables, seq_lens)
        return self.o(out.reshape(B, K, self.d_model))


class T5FeedForward(nn.Module):
    """relu(x wiᵀ) woᵀ with dropout on the hidden units. Under a
    tensor-parallel ``group`` (JAX ``tiger_rules``) ``wi`` is column-parallel
    (this rank's hidden_dim / tp units) and ``wo`` row-parallel: the input
    enters through ``copy_to_tp`` and the partial outputs are summed over
    the group. The dropout mask is drawn at the full hidden width and this
    rank's block kept, as at tp = 1."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.1,
                 dtype=torch.float32, device="cuda", group=None):
        super().__init__()
        device = resolve_device(device)
        self.dropout = dropout
        self.group = group
        tp = tp_size(group)
        local = shard_count(hidden_dim, tp, "dim_feedforward")
        self.wi = _linear(dim, local, dtype, device)
        self.wo = _linear(local, dim, dtype, device)
        if tp > 1:
            for w, axis in ((self.wi.weight, 0), (self.wo.weight, 1)):
                w.tp_sharded, w.tp_dim = True, axis

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        tp = tp_size(self.group)
        shard = None if tp == 1 else (tp_rank(self.group), tp)
        h = torch.relu(self.wi(copy_to_tp(x, self.group)))
        h = dropout(h, self.dropout, deterministic, generator, shard)
        return reduce_from_tp(self.wo(h), self.group)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ff_hidden_dim: int = 2048,
                 cross_attn: bool = False, dropout: float = 0.1, dtype=torch.float32,
                 device="cuda", group=None):
        super().__init__()
        device = resolve_device(device)
        self.dropout = dropout
        self.self_attn = T5Attention(dim, num_heads, dropout=dropout, dtype=dtype,
                                     device=device)
        self.norm1 = RMSNorm(dim, device=device)
        self.has_cross = cross_attn
        if cross_attn:
            self.cross_attn = T5Attention(
                dim, num_heads, is_cross_attention=True, has_relative_bias=False,
                dropout=dropout, dtype=dtype, device=device,
            )
            self.norm_cross = RMSNorm(dim, device=device)
        self.ff = T5FeedForward(dim, ff_hidden_dim, dropout, dtype, device=device, group=group)
        self.norm2 = RMSNorm(dim, device=device)

    def forward(self, x: torch.Tensor, context=None, attn_mask=None, key_padding_mask=None,
                memory_key_padding_mask=None, deterministic: bool = True, positions=None,
                generator=None) -> torch.Tensor:
        """Self-attention, cross-attention to ``context`` (decoder blocks
        given one), FFN; each a pre-norm residual branch with dropout."""
        def drop(h):
            return dropout(h, self.dropout, deterministic, generator)

        h = self.self_attn(self.norm1(x), attn_mask=attn_mask,
                           key_padding_mask=key_padding_mask, deterministic=deterministic,
                           positions=positions, generator=generator)
        x = x + drop(h)
        if self.has_cross and context is not None:
            h = self.cross_attn(self.norm_cross(x), key=context, value=context,
                                key_padding_mask=memory_key_padding_mask,
                                deterministic=deterministic, generator=generator)
            x = x + drop(h)
        h = self.ff(self.norm2(x), deterministic, generator)
        return x + drop(h)

    def decode_step(self, x, cache, cross_kv=None, memory_key_padding_mask=None,
                    step: int = 0):
        """Cached one-position decode: x (B, K, dim) -> (out, new_cache)."""
        h, new_cache = self.self_attn.decode_self(self.norm1(x), cache, step)
        x = x + h
        if self.has_cross and cross_kv is not None:
            x = x + self.cross_attn.decode_cross(self.norm_cross(x), cross_kv,
                                                 memory_key_padding_mask)
        return x + self.ff(self.norm2(x)), new_cache

    def decode_step_paged(self, x, cache, k_pool, v_pool, block_tables,
                          seq_lens, steps):
        """Per-row-step self-attention + paged cross-attention + FFN."""
        h, new_cache = self.self_attn.decode_self_ragged(self.norm1(x), cache, steps)
        x = x + h
        if self.has_cross:
            x = x + self.cross_attn.decode_cross_paged(
                self.norm_cross(x), k_pool, v_pool, block_tables, seq_lens
            )
        return x + self.ff(self.norm2(x)), new_cache

    def decode_step_tree(self, x, cache, k_pool, v_pool, block_tables,
                         seq_lens, topo, steps):
        """``decode_step_paged`` over tree nodes: tree self-attention
        against the committed cache and the in-pass ancestors; the paged
        cross-attention reads the slot's pages with the node axis where
        the beam axis was (B1/B2 on the card). Returns (out, (k_new,
        v_new)), the nodes' K/V for the accept scan to commit."""
        h, kv = self.self_attn.decode_self_tree(self.norm1(x), cache, topo, steps)
        x = x + h
        if self.has_cross:
            x = x + self.cross_attn.decode_cross_paged(
                self.norm_cross(x), k_pool, v_pool, block_tables, seq_lens
            )
        return x + self.ff(self.norm2(x)), kv


class TransformerEncoder(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int,
                 ff_hidden_dim: int = 2048, dropout: float = 0.1, dtype=torch.float32,
                 device="cuda", group=None):
        super().__init__()
        device = resolve_device(device)
        self.layers = nn.ModuleList(
            TransformerBlock(dim, num_heads, ff_hidden_dim, cross_attn=False,
                             dropout=dropout, dtype=dtype, device=device, group=group)
            for _ in range(depth)
        )

    def forward(self, src: torch.Tensor, attn_mask=None, key_padding_mask=None,
                deterministic: bool = True, positions=None, generator=None) -> torch.Tensor:
        for layer in self.layers:
            src = layer(src, attn_mask=attn_mask, key_padding_mask=key_padding_mask,
                        deterministic=deterministic, positions=positions,
                        generator=generator)
        return src


class TransformerDecoder(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int,
                 ff_hidden_dim: int = 2048, dropout: float = 0.1, dtype=torch.float32,
                 device="cuda", group=None):
        super().__init__()
        device = resolve_device(device)
        self.layers = nn.ModuleList(
            TransformerBlock(dim, num_heads, ff_hidden_dim, cross_attn=True,
                             dropout=dropout, dtype=dtype, device=device, group=group)
            for _ in range(depth)
        )

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, attn_mask=None,
                key_padding_mask=None, memory_key_padding_mask=None,
                deterministic: bool = True, generator=None) -> torch.Tensor:
        for layer in self.layers:
            tgt = layer(tgt, context=memory, attn_mask=attn_mask,
                        key_padding_mask=key_padding_mask,
                        memory_key_padding_mask=memory_key_padding_mask,
                        deterministic=deterministic, generator=generator)
        return tgt

    def precompute_cross_kv(self, memory: torch.Tensor):
        """Per-layer cross-attention K/V from the (B, Lm, d) memory."""
        return [layer.cross_attn.project_kv(memory) for layer in self.layers]

    def decode_step(self, x, caches, cross_kvs, memory_key_padding_mask=None,
                    step: int = 0):
        """Advance all layers one position: x (B, K, dim) -> (out,
        new_caches)."""
        new_caches = []
        for layer, cache, ckv in zip(self.layers, caches, cross_kvs):
            x, nc = layer.decode_step(x, cache, ckv, memory_key_padding_mask, step=step)
            new_caches.append(nc)
        return x, new_caches

    def decode_step_paged(self, x, caches, k_pools, v_pools, block_tables,
                          seq_lens, steps):
        """Advance all layers one per-row position against the paged
        cross-attention pools (one (pages, page, H, hd) K and V pool per
        layer). Returns (out, new_caches)."""
        new_caches = []
        for layer, cache, kp, vp in zip(self.layers, caches, k_pools, v_pools):
            x, nc = layer.decode_step_paged(
                x, cache, kp, vp, block_tables, seq_lens, steps
            )
            new_caches.append(nc)
        return x, new_caches

    def decode_tree(self, x, caches, k_pools, v_pools, block_tables,
                    seq_lens, topo, steps):
        """One verification pass over every tree node, all layers: x (B, N,
        dim) -> (out, per-layer (k_new, v_new)). The committed caches are
        read, never written."""
        node_kvs = []
        for layer, cache, kp, vp in zip(self.layers, caches, k_pools, v_pools):
            x, kv = layer.decode_step_tree(
                x, cache, kp, vp, block_tables, seq_lens, topo, steps
            )
            node_kvs.append(kv)
        return x, node_kvs


def causal_mask(T: int, device=None) -> torch.Tensor:
    """Additive (T, T) float32 mask: -1e9 above the diagonal."""
    upper = torch.triu(torch.ones((T, T), dtype=torch.bool, device=device), diagonal=1)
    return torch.where(upper, _NEG, 0.0)


class TransformerEncoderDecoder(nn.Module):
    """The encoder and decoder under the Flax parameter names
    (``transformer.encoder`` / ``transformer.decoder``); ``group`` shards
    every FFN over a tensor-parallel group (``T5FeedForward``)."""

    def __init__(self, d_model: int, nhead: int, num_encoder_layers: int,
                 num_decoder_layers: int, dim_feedforward: int = 2048, dropout: float = 0.1,
                 dtype=torch.float32, device="cuda", group=None):
        super().__init__()
        device = resolve_device(device)
        self.encoder = TransformerEncoder(
            d_model, num_encoder_layers, nhead, dim_feedforward, dropout, dtype,
            device=device, group=group,
        )
        self.decoder = TransformerDecoder(
            d_model, num_decoder_layers, nhead, dim_feedforward, dropout, dtype,
            device=device, group=group,
        )

    def forward(self, src, tgt, src_key_padding_mask=None, memory_key_padding_mask=None,
                tgt_mask=None, deterministic: bool = True, generator=None):
        if tgt_mask is None:
            tgt_mask = causal_mask(tgt.shape[1], tgt.device)
        memory = self.encoder(src, key_padding_mask=src_key_padding_mask,
                              deterministic=deterministic, generator=generator)
        return self.decoder(tgt, memory, attn_mask=tgt_mask,
                            memory_key_padding_mask=memory_key_padding_mask,
                            deterministic=deterministic, generator=generator)


def init_decode_caches(depth: int, batch: int, beams: int, max_len: int, n_heads: int,
                       d_model: int, dtype=torch.float32, device="cuda") -> list[dict]:
    """Zeroed per-layer self-attention suffix caches, (B, K, S, H, hd)."""
    shape = (batch, beams, max_len, n_heads, d_model // n_heads)
    dev = resolve_device(device)
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)} for _ in range(depth)]


def gather_beam_caches(caches, sel_parent: torch.Tensor):
    """Reorder every (B, K, S, H, hd) cache leaf along the beam axis by
    ``sel_parent`` (B, K), the surviving parents of a beam-search top-k."""
    B, K = sel_parent.shape
    out = []
    for cache in caches:
        new = {}
        for name, leaf in cache.items():
            idx = sel_parent.reshape(B, K, *([1] * (leaf.dim() - 2))).expand(
                B, K, *leaf.shape[2:]
            )
            new[name] = torch.gather(leaf, 1, idx)
        out.append(new)
    return out
