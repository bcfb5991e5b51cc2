"""HSTU: Hierarchical Sequential Transduction Unit (port of
genrec_tpu/models/hstu.py).

One fused projection -> SiLU -> split U, V, Q, K; attention scores with
no softmax and no 1/sqrt(d) scale, passed through SiLU; a relative
position bias (with the reference's clamp quirk) and a log-bucketed
temporal bias; LayerNorm then an elementwise gate by U; -1e9 causal,
padding and cross-segment fills; CE with ignore_index 0 over the tied
item-embedding logits.

``use_pallas`` keeps its JAX name: True runs ``kernels.hstu_attention.
hstu_attention`` (the CUDA kernels on the card, their plain versions on
the CPU), False the materialised-bias ``hstu_attention_ref`` under
autograd. ``fused_ce`` selects ``kernels.fused_ce.fused_ce_mean_loss``
for the training loss instead of logits + CE.

Mixed precision follows the Flax model, not autocast: parameters stay
float32 and are cast to ``dtype`` where they are used (Flax
``Dense(dtype=...)``); the LayerNorms compute in float32; activations
between layers are in ``dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.kernels.fused_ce import fused_ce_mean_loss
from genrec_tpu_torch.kernels.hstu_attention import hstu_attention, hstu_attention_ref
from genrec_tpu_torch.models.layers import Dense, LayerNorm, dropout, truncated_normal
from genrec_tpu_torch.ops.losses import cross_entropy_with_ignore
from genrec_tpu_torch.parallel.mesh import global_count
from genrec_tpu_torch.parallel.shardings import item_topk


class RelativePositionBias(nn.Module):
    """Causal log-bucket position bias; the parameter is (buckets, H)."""

    def __init__(self, num_buckets: int, num_heads: int, device):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(num_buckets, num_heads, device=device))

    def table(self) -> torch.Tensor:
        """(H, num_buckets) view for the attention kernels."""
        return self.bias.t().contiguous()


class TemporalBias(RelativePositionBias):
    """log2-bucketed |timestamp diff| bias; the parameter is (buckets, H)."""


class HSTULayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float,
                 num_position_buckets: int = 32, num_time_buckets: int = 64,
                 max_position_distance: int = 128, use_temporal_bias: bool = True,
                 use_pallas: bool = False, dtype=torch.float32, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        self.max_position_distance = max_position_distance
        self.use_temporal_bias = use_temporal_bias
        self.use_pallas = use_pallas
        self.dtype = dtype
        self.projection = Dense(embed_dim, 4 * embed_dim, dtype, dev)
        self.position_bias = RelativePositionBias(num_position_buckets, num_heads, dev)
        if use_temporal_bias:
            self.temporal_bias = TemporalBias(num_time_buckets, num_heads, dev)
        self.attn_norm = LayerNorm(embed_dim, eps=1e-5, device=dev)
        self.ffn_norm = LayerNorm(embed_dim, eps=1e-5, device=dev)
        self.ffn_in = Dense(embed_dim, 4 * embed_dim, dtype, dev)
        self.ffn_out = Dense(4 * embed_dim, embed_dim, dtype, dev)

    def forward(self, x, padding_mask, timestamps=None, deterministic: bool = True,
                segment_ids=None, generator=None):
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H
        residual = x

        projected = F.silu(self.projection(x))
        U, V, Q, K = projected.split(D, dim=-1)

        def split(t):
            return t.reshape(B, L, H, hd).transpose(1, 2)

        Q, K, V = split(Q), split(K), split(V)
        ttab = (self.temporal_bias.table()
                if (self.use_temporal_bias and timestamps is not None) else None)
        ts = timestamps if ttab is not None else None
        # No softmax, no sqrt(d) scale: SiLU attention.
        if self.use_pallas:
            out = hstu_attention(Q, K, V, ts, padding_mask, self.position_bias.table(), ttab,
                                 segment_ids, self.max_position_distance)
        else:
            out = hstu_attention_ref(Q, K, V, ts, padding_mask, self.position_bias.table(),
                                     ttab, self.max_position_distance,
                                     segment_ids=segment_ids).to(x.dtype)
        out = out.transpose(1, 2).reshape(B, L, D)
        out = self.attn_norm(out).to(x.dtype) * U
        x = residual + dropout(out, self.dropout, deterministic, generator)

        h = self.ffn_in(self.ffn_norm(x).to(x.dtype))
        h = dropout(F.silu(h), self.dropout, deterministic, generator)
        h = dropout(self.ffn_out(h), self.dropout, deterministic, generator)
        return x + h


class HSTU(nn.Module):
    """HSTU sequential recommender. Weights are drawn from ``seed`` (a CPU
    generator, so every device gets the same weights) or loaded with
    ``load_state_dict`` (``convert.hstu_params_from_flax``)."""

    def __init__(self, num_items: int, max_seq_len: int = 50, embed_dim: int = 64,
                 num_heads: int = 2, num_blocks: int = 2, dropout: float = 0.2,
                 num_position_buckets: int = 32, num_time_buckets: int = 64,
                 max_position_distance: int = 128, use_temporal_bias: bool = True,
                 use_pallas: bool = False, fused_ce: bool = False, dtype=torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_items, self.max_seq_len, self.embed_dim = num_items, max_seq_len, embed_dim
        self.dropout = dropout
        self.fused_ce = fused_ce
        self.dtype = dtype
        self.item_embedding = nn.Parameter(torch.zeros(num_items + 1, embed_dim, device=dev))
        self.layers = nn.ModuleList(
            HSTULayer(embed_dim, num_heads, dropout, num_position_buckets,
                      num_time_buckets, max_position_distance, use_temporal_bias,
                      use_pallas, dtype=dtype, device=dev)
            for _ in range(num_blocks)
        )
        self.final_norm = LayerNorm(embed_dim, eps=1e-5, device=dev)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.item_embedding.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded init with the Flax model's initialisers: the embedding
        and bias tables truncated N(0, 0.02), Dense kernels truncated
        N(0, 1/fan_in) (lecun_normal), Dense biases 0, norms 1 and 0."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Dense):
                m.weight.copy_(truncated_normal(m.weight.shape, m.in_features ** -0.5, gen))
                m.bias.zero_()
            elif isinstance(m, RelativePositionBias):
                m.bias.copy_(truncated_normal(m.bias.shape, 0.02, gen))
        self.item_embedding.copy_(truncated_normal(self.item_embedding.shape, 0.02, gen))

    def _encode(self, input_ids, timestamps=None, deterministic: bool = True,
                segment_ids=None, generator=None):
        """Backbone shared by training/eval (``forward``) and serving
        (``last_hidden``): embeddings -> HSTU layers -> final norm."""
        padding_mask = input_ids == 0
        if timestamps is not None:
            timestamps = timestamps.to(torch.int32)
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32)
        # padding_idx=0 semantics: the pad row reads zero.
        x = self.item_embedding[input_ids.long()].to(self.dtype)
        x = torch.where(padding_mask[..., None], 0.0, x)
        x = dropout(x, self.dropout, deterministic, generator)
        for layer in self.layers:
            x = layer(x, padding_mask, timestamps, deterministic, segment_ids, generator)
        return self.final_norm(x).to(self.dtype)

    def forward(self, input_ids, timestamps=None, targets=None, deterministic: bool = True,
                segment_ids=None, generator=None):
        """(logits (B, L, V+1) or None, mean loss or None). ``segment_ids``
        ((B, L) int, 0 = pad) switches attention to causal and
        same-segment for packed rows; with ``fused_ce`` and targets the
        logits are never formed and None is returned for them."""
        x = self._encode(input_ids, timestamps, deterministic, segment_ids, generator)
        if targets is not None and self.fused_ce:
            return None, fused_ce_mean_loss(x, self.item_embedding.to(self.dtype), targets)
        logits = x @ self.item_embedding.to(self.dtype).T
        loss = None
        if targets is not None:
            per_tok, valid = cross_entropy_with_ignore(logits, targets, ignore_index=0)
            loss = per_tok.sum() / global_count(valid.sum()).clamp_min(1.0)
        return logits, loss

    def last_hidden(self, input_ids, timestamps=None):
        """Serving entry point: final-norm hidden state at the last slot,
        (B, d), for right-aligned histories (see ``SASRec.last_hidden``)."""
        return self._encode(input_ids, timestamps, deterministic=True)[:, -1]

    def predict(self, input_ids, timestamps=None, top_k: int = 10):
        """Top-k next items from the last slot, pad id excluded: the serving
        head's scoring (``parallel.shardings.item_topk``)."""
        h = self.last_hidden(input_ids, timestamps)
        return item_topk(h, self.item_embedding.to(self.dtype), top_k)[1]
