"""T5-style transformer encoder-decoder, TIGER's backbone (port of
genrec_tpu/models/t5transformer.py, the parts the paged serving path runs).

Same contracts as the JAX module: per-layer T5 relative bias stored as an
``(n_heads * num_buckets, 1)`` parameter, bias-free projections, fused
``kv`` projection for self-attention (first half K, second half V),
pre-norm blocks, T5 ReLU FFN, RMS norms with fp32 statistics, softmax in
fp32, and masked scores FILLED with -1e9 (kept inside the softmax).

Layouts follow the JAX functions so the tests compare like with like:
encoder tensors are (B, L, d); decode tensors are (B, K, ...) with K
beams; the self-attention suffix cache is (B, K, S, H, hd); cross K/V
from ``project_kv`` are (B, H, Lm, hd). ``nn.Linear`` stores ``(out, in)``
where Flax stores ``(in, out)``; ``genrec_tpu_torch.convert`` transposes.
"""

from __future__ import annotations

import torch
from torch import nn

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.layers import RMSNorm
from genrec_tpu_torch.ops.buckets import t5_relative_position_bucket
from genrec_tpu_torch.ops.paged import paged_attention

_NEG = -1e9


def _linear(d_in: int, d_out: int, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, device=device)


class T5Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, is_cross_attention: bool = False,
                 has_relative_bias: bool = True, num_relative_buckets: int = 32,
                 max_distance: int = 128, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.n_heads = n_heads
        self.is_cross_attention = is_cross_attention
        self.has_relative_bias = has_relative_bias and not is_cross_attention
        self.num_relative_buckets = num_relative_buckets
        self.max_distance = max_distance
        self.q = _linear(d_model, d_model, device)
        if is_cross_attention:
            self.k = _linear(d_model, d_model, device)
            self.v = _linear(d_model, d_model, device)
        else:
            self.kv = _linear(d_model, 2 * d_model, device)
        self.o = _linear(d_model, d_model, device)
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
        return self.rel_bias[buckets[..., None, :] + head_offset, 0]

    def forward(self, query: torch.Tensor, key_padding_mask=None) -> torch.Tensor:
        """Encoder self-attention: (B, L, d) -> (B, L, d).
        ``key_padding_mask`` (B, L), True = padding."""
        B, Lq, _ = query.shape
        H, hd = self.n_heads, self.head_dim
        k, v = self.kv(query).chunk(2, dim=-1)
        q = self.q(query)

        def split(x):
            return x.reshape(B, -1, H, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        Lk = k.shape[2]
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (hd**-0.5)
        scores = scores.to(torch.float32)
        if self.has_relative_bias:
            pos = torch.arange(max(Lq, Lk), device=query.device)
            rel = pos[None, :Lk] - pos[:Lq, None]  # (q, k) mem - ctx
            scores = scores + self._bias_from_rel(rel).transpose(0, 1)[None]
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], _NEG)
        attn = torch.softmax(scores, dim=-1).to(query.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        out = out.transpose(1, 2).reshape(B, Lq, self.d_model)
        return self.o(out)

    # ---- incremental decode ------------------------------------------------

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

    def project_kv(self, memory: torch.Tensor):
        """Cross-attention K/V from the encoder memory, computed once per
        request batch: (B, Lm, d) -> two (B, H, Lm, hd)."""
        B, Lm, _ = memory.shape
        H, hd = self.n_heads, self.head_dim
        k = self.k(memory).reshape(B, Lm, H, hd).transpose(1, 2)
        v = self.v(memory).reshape(B, Lm, H, hd).transpose(1, 2)
        return k, v

    def decode_cross_paged(self, x, k_pool, v_pool, block_tables, seq_lens):
        """Cross-attention of K beams against PAGED memory K/V: each row
        reads its own pages through its block-table row; positions >=
        seq_lens[b] are masked. Beams share the row's pages."""
        B, K, _ = x.shape
        q = self.q(x).reshape(B, K, self.n_heads, self.head_dim)
        out = paged_attention(q, k_pool, v_pool, block_tables, seq_lens)
        return self.o(out.reshape(B, K, self.d_model))


class T5FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.wi = _linear(dim, hidden_dim, device)
        self.wo = _linear(hidden_dim, dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(torch.relu(self.wi(x)))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ff_hidden_dim: int = 2048,
                 cross_attn: bool = False, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.self_attn = T5Attention(dim, num_heads, device=device)
        self.norm1 = RMSNorm(dim, device=device)
        self.has_cross = cross_attn
        if cross_attn:
            self.cross_attn = T5Attention(
                dim, num_heads, is_cross_attention=True, has_relative_bias=False,
                device=device,
            )
            self.norm_cross = RMSNorm(dim, device=device)
        self.ff = T5FeedForward(dim, ff_hidden_dim, device=device)
        self.norm2 = RMSNorm(dim, device=device)

    def forward(self, x: torch.Tensor, key_padding_mask=None) -> torch.Tensor:
        """Encoder block (no cross-attention)."""
        x = x + self.self_attn(self.norm1(x), key_padding_mask=key_padding_mask)
        return x + self.ff(self.norm2(x))

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


class TransformerEncoder(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int,
                 ff_hidden_dim: int = 2048, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.layers = nn.ModuleList(
            TransformerBlock(dim, num_heads, ff_hidden_dim, cross_attn=False,
                             device=device)
            for _ in range(depth)
        )

    def forward(self, src: torch.Tensor, key_padding_mask=None) -> torch.Tensor:
        for layer in self.layers:
            src = layer(src, key_padding_mask=key_padding_mask)
        return src


class TransformerDecoder(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int,
                 ff_hidden_dim: int = 2048, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.layers = nn.ModuleList(
            TransformerBlock(dim, num_heads, ff_hidden_dim, cross_attn=True,
                             device=device)
            for _ in range(depth)
        )

    def precompute_cross_kv(self, memory: torch.Tensor):
        """Per-layer cross-attention K/V from the (B, Lm, d) memory."""
        return [layer.cross_attn.project_kv(memory) for layer in self.layers]

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


class TransformerEncoderDecoder(nn.Module):
    """Holds the encoder and decoder under the Flax parameter names
    (``transformer.encoder`` / ``transformer.decoder``)."""

    def __init__(self, d_model: int, nhead: int, num_encoder_layers: int,
                 num_decoder_layers: int, dim_feedforward: int = 2048, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.encoder = TransformerEncoder(
            d_model, num_encoder_layers, nhead, dim_feedforward, device=device
        )
        self.decoder = TransformerDecoder(
            d_model, num_decoder_layers, nhead, dim_feedforward, device=device
        )


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
