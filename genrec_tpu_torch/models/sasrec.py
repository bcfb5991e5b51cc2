"""SASRec: self-attentive next-item recommender (port of
genrec_tpu/models/sasrec.py, itself faithful to the official TF
implementation, arXiv:1808.09781).

The quirks that matter for metric parity, all kept:

1. the item embedding is scaled by sqrt(d), the position embedding is not;
2. padding (id 0) positions are zeroed after the embedding AND after every
   block;
3. attention: Q from the pre-normed x, K and V from the raw x; key and
   causal masks filled with -1e9 (not -inf) before the fp32 softmax; the
   query mask applied AFTER the softmax; the residual adds the NORMED
   query;
4. FFN: relu MLP, dropout after each linear, the residual adds the raw x;
5. logits = x @ item_embedding.T over the whole vocabulary (the head is
   tied to the input table); CE with ignore_index 0, mean over valid
   tokens. With ``fused_ce`` and targets the loss goes through
   ``kernels.fused_ce.fused_ce_mean_loss`` (the CUDA kernels on the card,
   their plain versions on the CPU) and no logits are formed. The tied
   table's gradient sums the gather's and the CE head's.

The packed path (``segment_ids`` and ``positions``, both (B, L) int):
attention becomes causal and same-segment, and the position table is read
at the within-segment position. The attention itself is plain PyTorch, as
it is plain ``jnp.einsum`` in JAX.

Mixed precision follows the Flax model: parameters float32, cast to
``dtype`` where they are used; LayerNorm statistics (eps 1e-8) and the
softmax in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.kernels.fused_ce import fused_ce_mean_loss
from genrec_tpu_torch.models.layers import Dense, LayerNorm, dropout, truncated_normal
from genrec_tpu_torch.ops.losses import cross_entropy_with_ignore
from genrec_tpu_torch.parallel.mesh import global_count
from genrec_tpu_torch.parallel.shardings import item_topk

NEG = -1e9


class _Attention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float, dtype, device):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.q_proj = Dense(embed_dim, embed_dim, dtype, device)
        self.k_proj = Dense(embed_dim, embed_dim, dtype, device)
        self.v_proj = Dense(embed_dim, embed_dim, dtype, device)

    def forward(self, query, key_value, mask, deterministic: bool, segment_ids=None,
                generator=None):
        B, L, D = query.shape
        H = self.num_heads
        hd = D // H

        def split(t):
            return t.reshape(B, L, H, hd).transpose(1, 2)

        q = split(self.q_proj(query))
        k = split(self.k_proj(key_value))
        v = split(self.v_proj(key_value))
        scores = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
        hidden = mask[:, None, None, :, 0] == 0  # (B, 1, 1, L): padded keys
        hidden = hidden | torch.triu(torch.ones((L, L), dtype=torch.bool,
                                                device=query.device), diagonal=1)
        if segment_ids is not None:
            hidden = hidden | (segment_ids[:, :, None] != segment_ids[:, None, :])[:, None]
        scores = scores.masked_fill(hidden, NEG)
        attn = torch.softmax(scores.to(torch.float32), dim=-1).to(query.dtype)
        attn = attn * mask[:, None]  # the query mask after the softmax
        attn = dropout(attn, self.dropout, deterministic, generator)
        out = (attn @ v).transpose(1, 2).reshape(B, L, D)
        return out + query  # the residual adds the normed query


class _FFN(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int, dropout: float, dtype, device):
        super().__init__()
        self.dropout = dropout
        self.fc1 = Dense(embed_dim, ffn_dim, dtype, device)
        self.fc2 = Dense(ffn_dim, embed_dim, dtype, device)

    def forward(self, x, residual, deterministic: bool, generator=None):
        h = dropout(F.relu(self.fc1(x)), self.dropout, deterministic, generator)
        h = dropout(self.fc2(h), self.dropout, deterministic, generator)
        return h + residual


class SASRecBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int, dropout: float,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.norm1 = LayerNorm(embed_dim, eps=1e-8, device=dev)
        self.attention = _Attention(embed_dim, num_heads, dropout, dtype, dev)
        self.norm2 = LayerNorm(embed_dim, eps=1e-8, device=dev)
        self.ffn = _FFN(embed_dim, ffn_dim, dropout, dtype, dev)

    def forward(self, x, mask, deterministic: bool, segment_ids=None, generator=None):
        dt = self.dtype
        x = self.attention(self.norm1(x).to(dt), x.to(dt), mask, deterministic,
                           segment_ids, generator)
        return self.ffn(self.norm2(x).to(dt), x, deterministic, generator)


class SASRec(nn.Module):
    """SASRec sequential recommender. Weights are drawn from ``seed`` (a CPU
    generator, so every device gets the same weights) or loaded with
    ``load_state_dict`` (``convert.sasrec_params_from_flax``)."""

    def __init__(self, num_items: int, max_seq_len: int = 50, embed_dim: int = 64,
                 num_heads: int = 2, num_blocks: int = 2, ffn_dim: int = 256,
                 dropout: float = 0.2, dtype=torch.float32, fused_ce: bool = False,
                 device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_items, self.max_seq_len, self.embed_dim = num_items, max_seq_len, embed_dim
        self.dropout = dropout
        self.dtype = dtype
        self.fused_ce = fused_ce
        self.item_embedding = nn.Parameter(torch.zeros(num_items + 1, embed_dim, device=dev))
        self.position_embedding = nn.Parameter(torch.zeros(max_seq_len, embed_dim,
                                                           device=dev))
        self.blocks = nn.ModuleList(
            SASRecBlock(embed_dim, num_heads, ffn_dim, dropout, dtype, dev)
            for _ in range(num_blocks)
        )
        self.final_norm = LayerNorm(embed_dim, eps=1e-8, device=dev)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.item_embedding.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded init with the Flax model's initialisers: both tables
        xavier_uniform, Dense kernels truncated N(0, 1/fan_in)
        (lecun_normal), Dense biases 0, norms 1 and 0."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Dense):
                m.weight.copy_(truncated_normal(m.weight.shape, m.in_features ** -0.5, gen))
                m.bias.zero_()
        for table in (self.item_embedding, self.position_embedding):
            table.copy_(nn.init.xavier_uniform_(torch.empty(table.shape), generator=gen))

    def _encode(self, input_ids, deterministic: bool = True, segment_ids=None,
                positions=None, generator=None):
        """Backbone shared by training/eval (``forward``) and serving
        (``last_hidden``): embeddings -> blocks -> final norm, (B, L, d)
        float32."""
        L = input_ids.shape[1]
        dt = self.dtype
        mask = (input_ids != 0)[..., None].to(dt)
        x = self.item_embedding[input_ids.long()].to(dt) * (self.embed_dim ** 0.5)
        pos = (self.position_embedding[None, :L] if positions is None
               else self.position_embedding[positions.long()])
        x = dropout(x + pos.to(dt), self.dropout, deterministic, generator) * mask
        for block in self.blocks:
            x = block(x, mask, deterministic, segment_ids, generator) * mask
        return self.final_norm(x)

    def forward(self, input_ids, targets=None, deterministic: bool = True,
                segment_ids=None, positions=None, generator=None):
        """(logits (B, L, V+1) or None, mean loss or None). With
        ``fused_ce`` and targets the logits are never formed and None is
        returned for them."""
        x = self._encode(input_ids, deterministic, segment_ids, positions, generator)
        x = x.to(self.dtype)
        table = self.item_embedding.to(self.dtype)
        if targets is not None and self.fused_ce:
            return None, fused_ce_mean_loss(x, table, targets)
        logits = x @ table.T
        loss = None
        if targets is not None:
            per_tok, valid = cross_entropy_with_ignore(logits, targets, ignore_index=0)
            loss = per_tok.sum() / global_count(valid.sum()).clamp_min(1.0)
        return logits, loss

    def last_hidden(self, input_ids):
        """Serving entry point: the final-norm hidden state at the last slot,
        (B, d) float32. Callers right-align histories so that slot L-1 holds
        the newest item; the (B, L, V) logits are never formed."""
        return self._encode(input_ids)[:, -1]

    def predict(self, input_ids, top_k: int = 10):
        """Top-k next items from the last position, pad id excluded: the
        serving head's scoring (``parallel.shardings.item_topk``)."""
        h = self.last_hidden(input_ids).to(self.dtype)
        return item_topk(h, self.item_embedding.to(self.dtype), top_k)[1]
