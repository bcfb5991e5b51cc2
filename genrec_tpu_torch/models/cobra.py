"""COBRA: cascaded sparse-dense generative recommendation (port of
genrec_tpu/models/cobra.py: the model, its training forward and metrics,
the dense cached and uncached beam searches, beam fusion, and the paged
decode path the serving engine runs).

Each history item is C sparse codebook tokens followed by one dense text
vector (the item tower, ``LightT5Encoder``); a causal post-norm decoder
(torch's ``TransformerDecoderLayer`` over an EMPTY memory: the
cross-attention term is zero but its ``norm2`` still applies) reads the
interleaved sequence, and per-codebook heads predict the next item's codes
(codebook 0 from the dense position, codebook c > 0 from codebook c - 1's
position). Parameters carry the Flax names (``layer_<i>`` ->
``layers.<i>``, Dense ``kernel`` -> ``weight``, LayerNorm ``scale`` ->
``weight``; ``convert.cobra_params_from_flax``). ``dtype`` is the
compute dtype, as Flax's: parameters stay float32 and are cast where used,
LayerNorms and softmax compute in float32, activations are ``dtype``; the
decode paths apply the sparse heads in float32 (JAX's ``x @ kernel +
bias`` promotes a bf16 ``x``). The paged path is float32 only: the paged
kernels (B1, B2) take float32 queries and pages. Dropout draws from the
``generator`` a training forward is given.

The decode paths:

- ``cobra_generate``: deterministic top-k beam search over the C
  codebooks, KV-cached (one prefill over the history, then one suffix
  position per codebook step) or uncached (the full decoder per step);
- ``cobra_prefill_paged`` / ``cobra_paged_decode_step`` /
  ``cobra_generate_paged``: the history K/V written into page pools, each
  suffix step reading them through ``ops.paged.paged_attention_stats``
  (the B1 kernel over float32 pages, B2 over int8 pages, on the card) and
  merging that partial with the dense suffix partial
  (``ops.paged.merge_attention_stats``);
- ``cobra_spec_tree_step``: the speculative tree decode of the suffix
  (``ops.spec_tree``): every tree node's history partial through B1/B2,
  its suffix partial over its virtual cache (``ops.paged.
  tree_suffix_stats``), then the plain step's ``_cobra_beam_update``
  replayed level by level.

``jax.lax.top_k`` breaks ties by the lower index; every top-k here is a
stable sort (``models.tiger._top_k``): trie-masked beams tie at -1e32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.layers import Dense, LayerNorm, dropout, truncated_normal
from genrec_tpu_torch.models.t5transformer import gather_beam_caches, init_decode_caches
from genrec_tpu_torch.models.tiger import _top_k
from genrec_tpu_torch.ops.losses import cross_entropy_with_ignore
from genrec_tpu_torch.ops.normalize import l2norm
from genrec_tpu_torch.ops.paged import (
    merge_attention_stats,
    paged_attention_stats,
    tree_suffix_stats,
    write_pages,
)
from genrec_tpu_torch.ops.quant import KV_DTYPES, QuantizedKVPool
from genrec_tpu_torch.ops.spec_tree import (
    commit_level_kv,
    match_drafted,
    tree_topology,
    tree_virtual_cache,
)
from genrec_tpu_torch.ops.trie import advance_ragged, legal_mask_ragged, legal_topk_ragged

NEG = -1e9
_NEG_SIM = -1e4
_ILLEGAL = -1e32


class CobraOutput(NamedTuple):
    loss: torch.Tensor
    loss_sparse: torch.Tensor
    loss_dense: torch.Tensor
    acc_correct: torch.Tensor
    acc_total: torch.Tensor
    recall_correct: torch.Tensor
    recall_total: torch.Tensor
    vec_cos_sim: torch.Tensor
    codebook_entropy: torch.Tensor


class CobraGenerationOutput(NamedTuple):
    sem_ids: torch.Tensor  # (B, K, C)
    dense_vecs: torch.Tensor  # (B, K, D)
    scores: torch.Tensor  # (B, K)


class BeamFusionOutput(NamedTuple):
    item_ids: torch.Tensor  # (B, K)
    sem_ids: torch.Tensor  # (B, K, C)
    scores: torch.Tensor  # (B, K)


def _causal(L: int, device) -> torch.Tensor:
    return torch.triu(torch.ones((L, L), dtype=torch.bool, device=device), diagonal=1)


class _TorchMHA(nn.Module):
    """torch.nn.MultiheadAttention-equivalent self-attention: a packed qkv
    projection with bias (``in_proj``), scaled dot product, an output
    projection with bias (``out_proj``). Masked scores are filled with
    -1e9 and kept inside the softmax."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.dim, self.num_heads, self.dropout_rate = dim, num_heads, dropout_rate
        self.in_proj = Dense(dim, 3 * dim, dtype, device)
        self.out_proj = Dense(dim, dim, dtype, device)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def forward(self, x, attn_mask=None, key_padding_mask=None, deterministic=True,
                generator=None):
        return self._full(x, attn_mask, key_padding_mask, deterministic, generator)[0]

    def prefill(self, x, attn_mask=None, key_padding_mask=None):
        """The full forward, also returning (k, v) each (B, H, L, hd)."""
        return self._full(x, attn_mask, key_padding_mask, True)

    def _full(self, x, attn_mask, key_padding_mask, deterministic, generator=None):
        B, L, D = x.shape
        H, hd = self.num_heads, self.head_dim
        q, k, v = self.in_proj(x).split(D, dim=-1)
        split = lambda t: t.reshape(B, L, H, hd).transpose(1, 2)  # noqa: E731
        q, k, v = split(q), split(k), split(v)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * (hd**-0.5)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[None, None], NEG)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], NEG)
        attn = dropout(torch.softmax(scores, dim=-1).to(x.dtype), self.dropout_rate,
                       deterministic, generator)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(B, L, D)
        return self.out_proj(out), (k, v)

    def _step_qkv(self, x):
        B, K, D = x.shape
        q, k_new, v_new = self.in_proj(x).split(D, dim=-1)
        shape = (B, K, self.num_heads, self.head_dim)
        return q.reshape(shape).contiguous(), k_new.reshape(shape), v_new.reshape(shape)

    def decode_paged(self, x, k_pool, v_pool, block_tables, seq_lens, cache, steps):
        """``decode`` with the history K/V read from page pools and a
        per-row suffix slot ``steps`` (S,). The paged history partial and
        the dense suffix partial merge through the flash identity into the
        dense path's joint softmax over [history ++ suffix]."""
        B, K, D = x.shape
        hd = self.head_dim
        q, k_new, v_new = self._step_qkv(x)
        S = cache["k"].shape[2]
        slots = torch.arange(S, device=x.device)
        hit = (slots[None, :] == steps[:, None])[:, None, :, None, None]
        ck = torch.where(hit, k_new[:, :, None], cache["k"])
        cv = torch.where(hit, v_new[:, :, None], cache["v"])
        acc_h, m_h, l_h = paged_attention_stats(q, k_pool, v_pool, block_tables, seq_lens)
        s_suf = torch.einsum("bkhd,bkshd->bkhs", q, ck) * (hd**-0.5)
        s_suf = s_suf.masked_fill(slots[None, None, None, :] > steps[:, None, None, None], NEG)
        m_s = s_suf.amax(dim=-1)
        e = torch.exp(s_suf - m_s[..., None])
        l_s = e.sum(dim=-1)
        acc_s = torch.einsum("bkhs,bkshd->bkhd", e, cv)
        out = merge_attention_stats(acc_h, m_h, l_h, acc_s, m_s, l_s).reshape(B, K, D)
        return self.out_proj(out), {"k": ck, "v": cv}

    def decode_tree(self, x, k_pool, v_pool, block_tables, seq_lens, cache, topo,
                    base_steps):
        """Speculative tree-verification twin of ``decode_paged``: one pass
        over every tree node (N in place of the beam axis). The paged
        history partial is the same ``paged_attention_stats`` read (the
        nodes of a slot share its pages as its beams do); the suffix
        partial runs over each node's virtual cache (``ops.spec_tree.
        tree_virtual_cache``) through ``tree_suffix_stats``; the two merge
        as in the plain step. ``cache`` is read, never written. Returns
        (out, (k_new, v_new) per-node projections)."""
        B, N, D = x.shape
        q, k_new, v_new = self._step_qkv(x)
        vc_k = tree_virtual_cache(cache["k"], k_new, topo, base_steps)
        vc_v = tree_virtual_cache(cache["v"], v_new, topo, base_steps)
        acc_h, m_h, l_h = paged_attention_stats(q, k_pool, v_pool, block_tables, seq_lens)
        node_slots = base_steps[:, None] + topo.on(x.device)["level"][None, :]
        acc_s, m_s, l_s = tree_suffix_stats(q, vc_k, vc_v, node_slots)
        out = merge_attention_stats(acc_h, m_h, l_h, acc_s, m_s, l_s).reshape(B, N, D)
        return self.out_proj(out), (k_new, v_new)

    def decode(self, x, hist_kv, hist_pad, cache, slot: int):
        """One suffix position for K beams against the shared history K/V
        (B, H, Lh, hd), padding ``hist_pad`` (B, Lh) True; the suffix cache
        (B, K, S, H, hd) is written at ``slot``. Scores over [history ++
        suffix] softmaxed jointly."""
        B, K, D = x.shape
        hd = self.head_dim
        q, k_new, v_new = self._step_qkv(x)
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[:, :, slot] = k_new
        cv[:, :, slot] = v_new
        hk, hv = hist_kv
        Lh, S = hk.shape[2], ck.shape[2]
        s_hist = torch.einsum("bkhd,bhmd->bkhm", q, hk).to(torch.float32) * (hd**-0.5)
        s_hist = s_hist.masked_fill(hist_pad[:, None, None, :], NEG)
        s_suf = torch.einsum("bkhd,bkshd->bkhs", q, ck).to(torch.float32) * (hd**-0.5)
        s_suf = s_suf.masked_fill(torch.arange(S, device=x.device) > slot, NEG)
        attn = torch.softmax(torch.cat([s_hist, s_suf], dim=-1), dim=-1).to(x.dtype)
        out = (torch.einsum("bkhm,bhmd->bkhd", attn[..., :Lh], hv)
               + torch.einsum("bkhs,bkshd->bkhd", attn[..., Lh:], cv)).reshape(B, K, D)
        return self.out_proj(out), {"k": ck, "v": cv}


class _PostNormEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` (norm_first=False, relu)."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int, dropout_rate: float,
                 dtype, device):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = _TorchMHA(dim, num_heads, dropout_rate, dtype, device)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.linear1 = Dense(dim, ff_dim, dtype, device)
        self.linear2 = Dense(ff_dim, dim, dtype, device)

    def forward(self, x, key_padding_mask, deterministic=True, generator=None):
        def drop(t):
            return dropout(t, self.dropout_rate, deterministic, generator)

        h = self.self_attn(x, key_padding_mask=key_padding_mask, deterministic=deterministic,
                           generator=generator)
        x = self.norm1(x + drop(h)).to(x.dtype)
        h = drop(torch.relu(self.linear1(x)))
        return self.norm2(x + drop(self.linear2(h))).to(x.dtype)


class _PostNormDecoderLayer(nn.Module):
    """torch ``nn.TransformerDecoderLayer`` with EMPTY memory: the
    cross-attention term contributes zero but its add & norm (``norm2``)
    still applies. The unused cross projections are omitted, as in JAX."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int, dropout_rate: float,
                 dtype, device):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = _TorchMHA(dim, num_heads, dropout_rate, dtype, device)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.norm3 = LayerNorm(dim, eps=1e-5, device=device)
        self.linear1 = Dense(dim, ff_dim, dtype, device)
        self.linear2 = Dense(ff_dim, dim, dtype, device)

    def forward(self, x, attn_mask, key_padding_mask, deterministic=True, generator=None):
        h = self.self_attn(x, attn_mask=attn_mask, key_padding_mask=key_padding_mask,
                           deterministic=deterministic, generator=generator)
        return self._post_attn(x, h, deterministic, generator)

    def _post_attn(self, x, h, deterministic=True, generator=None):
        def drop(t):
            return dropout(t, self.dropout_rate, deterministic, generator)

        x = self.norm1(x + drop(h)).to(x.dtype)
        x = self.norm2(x).to(x.dtype)  # + cross-attention over empty memory, which is 0
        h = drop(torch.relu(self.linear1(x)))
        return self.norm3(x + drop(self.linear2(h))).to(x.dtype)

    def prefill(self, x, attn_mask, key_padding_mask):
        h, kv = self.self_attn.prefill(x, attn_mask, key_padding_mask)
        return self._post_attn(x, h), kv

    def decode(self, x, hist_kv, hist_pad, cache, slot: int):
        h, new_cache = self.self_attn.decode(x, hist_kv, hist_pad, cache, slot)
        return self._post_attn(x, h), new_cache

    def decode_paged(self, x, k_pool, v_pool, block_tables, seq_lens, cache, steps):
        h, new_cache = self.self_attn.decode_paged(x, k_pool, v_pool, block_tables,
                                                   seq_lens, cache, steps)
        return self._post_attn(x, h), new_cache

    def decode_tree(self, x, k_pool, v_pool, block_tables, seq_lens, cache, topo,
                    base_steps):
        h, kv = self.self_attn.decode_tree(x, k_pool, v_pool, block_tables, seq_lens,
                                           cache, topo, base_steps)
        return self._post_attn(x, h), kv


class LightT5Encoder(nn.Module):
    """The item tower: embed + post-norm transformer encoder, mean-pool over
    non-pad tokens (token id 0 is padding), project, L2-normalise."""

    def __init__(self, n_layers: int = 1, hidden_dim: int = 768, output_dim: int = 768,
                 num_heads: int = 8, ff_dim: int = 2048, vocab_size: int = 32128,
                 max_seq_len: int = 512, dropout_rate: float = 0.1, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(vocab_size, hidden_dim, device=device))
        self.pos_embedding = nn.Parameter(torch.empty(max_seq_len, hidden_dim, device=device))
        self.layers = nn.ModuleList(
            _PostNormEncoderLayer(hidden_dim, num_heads, ff_dim, dropout_rate, dtype, device)
            for _ in range(n_layers)
        )
        self.layer_norm = LayerNorm(hidden_dim, eps=1e-5, device=device)
        self.proj = Dense(hidden_dim, output_dim, dtype, device)

    def forward(self, batch_tokens, deterministic=True, generator=None):
        """(N, L) or (B, T, L) token ids -> (N, d) or (B, T, d) unit vectors."""
        lead = batch_tokens.shape[:-1]
        flat = batch_tokens.reshape(-1, batch_tokens.shape[-1]).long()
        L = flat.shape[1]
        x = (F.embedding(flat, self.embedding).to(self.dtype)
             + self.pos_embedding[None, :L].to(self.dtype))
        pad = flat == 0
        for layer in self.layers:
            x = layer(x, pad, deterministic, generator)
        x = self.layer_norm(x)
        mask = (~pad)[..., None].to(torch.float32)
        pooled = (x * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1e-9)
        return l2norm(self.proj(pooled)).reshape(*lead, -1)


class CobraDecoder(nn.Module):
    def __init__(self, hidden_dim: int = 768, n_layers: int = 6, n_heads: int = 12,
                 ff_dim: int = 2048, dropout_rate: float = 0.1, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.layers = nn.ModuleList(
            _PostNormDecoderLayer(hidden_dim, n_heads, ff_dim, dropout_rate, dtype, device)
            for _ in range(n_layers)
        )

    def forward(self, tgt, tgt_key_padding_mask=None, deterministic=True, generator=None):
        causal = _causal(tgt.shape[1], tgt.device)
        x = tgt
        for layer in self.layers:
            x = layer(x, causal, tgt_key_padding_mask, deterministic, generator)
        return x

    def prefill(self, tgt, tgt_key_padding_mask=None):
        """The forward over the history once, returning per-layer (k, v)."""
        causal = _causal(tgt.shape[1], tgt.device)
        x, kvs = tgt, []
        for layer in self.layers:
            x, kv = layer.prefill(x, causal, tgt_key_padding_mask)
            kvs.append(kv)
        return x, kvs

    def decode(self, x, hist_kvs, hist_pad, caches, slot: int):
        """Advance one suffix position for K beams: x (B, K, dim)."""
        new_caches = []
        for layer, hkv, cache in zip(self.layers, hist_kvs, caches):
            x, nc = layer.decode(x, hkv, hist_pad, cache, slot)
            new_caches.append(nc)
        return x, new_caches

    def decode_paged(self, x, k_pools, v_pools, block_tables, seq_lens, caches, steps):
        """``decode`` with each layer's history K/V read from its page pools
        and a per-row suffix slot."""
        new_caches = []
        for layer, kp, vp, cache in zip(self.layers, k_pools, v_pools, caches):
            x, nc = layer.decode_paged(x, kp, vp, block_tables, seq_lens, cache, steps)
            new_caches.append(nc)
        return x, new_caches

    def decode_tree(self, x, k_pools, v_pools, block_tables, seq_lens, caches, topo,
                    base_steps):
        """One verification pass over every tree node, all layers: x (B, N,
        dim) -> (out, per-layer (k_new, v_new))."""
        node_kvs = []
        for layer, kp, vp, cache in zip(self.layers, k_pools, v_pools, caches):
            x, kv = layer.decode_tree(x, kp, vp, block_tables, seq_lens, cache, topo,
                                      base_steps)
            node_kvs.append(kv)
        return x, node_kvs


class CobraEmbedding(nn.Module):
    """Interleave C sparse codebook embeddings and one dense vector per
    item (a static reshape), plus position and type (sparse 0, dense 1)
    embeddings under the sequence mask."""

    def __init__(self, id_vocab_size: int, n_codebooks: int = 3, d_model: int = 768,
                 max_len: int = 1024, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.id_vocab_size, self.n_codebooks, self.max_len = id_vocab_size, n_codebooks, max_len
        self.dtype = dtype
        self.id_embed = nn.Parameter(
            torch.empty(id_vocab_size * n_codebooks + 1, d_model, device=device))
        self.type_embed = nn.Parameter(torch.empty(2, d_model, device=device))
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model, device=device))

    @property
    def pad_id(self) -> int:
        return self.id_vocab_size * self.n_codebooks

    def forward(self, input_ids, input_vecs, mask, n_complete_items: Optional[int] = None):
        """input_ids (B, L), input_vecs (B, T, D), mask (B, L + T_complete)."""
        B, L = input_ids.shape
        C = self.n_codebooks
        dev = input_ids.device
        if n_complete_items is None:
            n_complete_items = L // C
        n_tok = n_complete_items * C
        token_type = torch.arange(L, device=dev) % C
        is_pad = input_ids == self.pad_id
        offset_ids = torch.where(is_pad, input_ids, input_ids + token_type[None] * self.id_vocab_size)
        # The pad row is the table's last; torch's padding_idx pins it to zero.
        dt = self.dtype
        sparse = F.embedding(offset_ids, self.id_embed).to(dt).masked_fill(is_pad[..., None], 0.0)
        chunks = []
        if n_tok > 0:
            comp = sparse[:, :n_tok].reshape(B, n_complete_items, C, -1)
            dense = input_vecs[:, :n_complete_items, None, :].to(dt)
            chunks.append(torch.cat([comp, dense], dim=2).reshape(B, n_complete_items * (C + 1), -1))
        if L - n_tok > 0:
            chunks.append(sparse[:, n_tok:])
        h = torch.cat(chunks, dim=1)
        out_len = h.shape[1]
        item_types = torch.cat([torch.zeros(C, dtype=torch.long), torch.ones(1, dtype=torch.long)])
        type_row = torch.cat([item_types.repeat(n_complete_items),
                              torch.zeros(L - n_tok, dtype=torch.long)])[:out_len].to(dev)
        m = mask[..., None].to(dt)
        h = h * m
        h = h + self.pos_embed[None, :out_len].to(dt) * m
        return h + self.type_embed[type_row][None].to(dt) * m

    def suffix_token(self, tok, slot: int, base_pos: int):
        """Embed ONE generated token per beam, tok (B, K), at suffix
        position ``slot`` (absolute position base_pos + slot), laid out as
        ``forward`` lays out an appended sparse token."""
        dt = self.dtype
        h = self.id_embed[tok.long() + (slot % self.n_codebooks) * self.id_vocab_size].to(dt)
        return h + self.pos_embed[base_pos + slot].to(dt) + self.type_embed[0].to(dt)

    def suffix_token_ragged(self, tok, steps, base_pos):
        """``suffix_token`` with per-row suffix slots ``steps`` (B,) and
        per-row history ends ``base_pos`` (B,)."""
        offset = tok.long() + (steps.long()[:, None] % self.n_codebooks) * self.id_vocab_size
        pos = (base_pos.long() + steps.long()).clamp(0, self.max_len - 1)
        return self.id_embed[offset] + self.pos_embed[pos][:, None] + self.type_embed[0]

    def suffix_token_tree(self, tok, node_slots, base_pos):
        """``suffix_token_ragged`` with PER-NODE suffix slots: tok (B, N),
        node_slots (B, N); each tree node embeds its drafted code at its
        own speculated position. A drafted code outside the codebook (only
        a test's forced draft makes one) is never accepted; it is clamped
        so its row exists."""
        tok = tok.long().clamp(0, self.id_vocab_size - 1)
        offset = tok + (node_slots.long() % self.n_codebooks) * self.id_vocab_size
        pos = (base_pos.long()[:, None] + node_slots.long()).clamp(0, self.max_len - 1)
        return self.id_embed[offset] + self.pos_embed[pos] + self.type_embed[0]


def interleave_seq_mask(seq_mask, C: int, n_complete_items: Optional[int] = None):
    """(B, L) sparse mask -> (B, L + T_complete): after each complete item
    its dense slot, carrying the mask of the item's last sparse token."""
    B, L = seq_mask.shape
    if n_complete_items is None:
        n_complete_items = L // C
    n_tok = n_complete_items * C
    parts = []
    if n_tok > 0:
        comp = seq_mask[:, :n_tok].reshape(B, n_complete_items, C)
        parts.append(torch.cat([comp, comp[:, :, C - 1:C]], dim=2).reshape(B, -1))
    if L - n_tok > 0:
        parts.append(seq_mask[:, n_tok:])
    return torch.cat(parts, dim=1)


class Cobra(nn.Module):
    """COBRA computing in ``dtype``. Weights are drawn from ``seed`` with the Flax
    model's initialisers (a CPU generator, so every device gets the same
    weights) or loaded with ``load_state_dict``."""

    def __init__(self, encoder_n_layers: int = 1, encoder_hidden_dim: int = 768,
                 encoder_num_heads: int = 8, encoder_vocab_size: int = 32128,
                 id_vocab_size: int = 512, n_codebooks: int = 3, d_model: int = 768,
                 max_len: int = 1024, temperature: float = 0.2, decoder_n_layers: int = 8,
                 decoder_num_heads: int = 6, decoder_dropout: float = 0.1,
                 dtype=torch.float32, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.id_vocab_size, self.n_codebooks, self.d_model = id_vocab_size, n_codebooks, d_model
        self.temperature = temperature
        self.decoder_n_layers, self.decoder_num_heads = decoder_n_layers, decoder_num_heads
        # The JAX model passes no dropout to the tower: its default, 0.1.
        self.encoder = LightT5Encoder(encoder_n_layers, encoder_hidden_dim, d_model,
                                      encoder_num_heads, vocab_size=encoder_vocab_size,
                                      dtype=dtype, device=dev)
        self.cobra_emb = CobraEmbedding(id_vocab_size, n_codebooks, d_model, max_len, dtype,
                                        dev)
        self.decoder = CobraDecoder(d_model, decoder_n_layers, decoder_num_heads,
                                    dropout_rate=decoder_dropout, dtype=dtype, device=dev)
        for c in range(n_codebooks):
            self.add_module(f"sparse_head_{c}", Dense(d_model, id_vocab_size, dtype, dev))
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.cobra_emb.id_embed.device

    @property
    def pad_id(self) -> int:
        return self.id_vocab_size * self.n_codebooks

    @property
    def head_dim(self) -> int:
        return self.d_model // self.decoder_num_heads

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Flax's initialisers: raw embedding tables N(0, 1), Dense kernels
        lecun_normal (truncated, std fan_in^-1/2) with zero biases,
        LayerNorms scale 1 and bias 0."""
        gen = torch.Generator().manual_seed(seed)
        for name, mod in self.named_modules():
            if isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                mod.weight.copy_(truncated_normal(mod.weight.shape, mod.in_features**-0.5, gen))
                mod.bias.zero_()
        for p in (self.encoder.embedding, self.encoder.pos_embedding, self.cobra_emb.id_embed,
                  self.cobra_emb.type_embed, self.cobra_emb.pos_embed):
            p.copy_(torch.randn(p.shape, generator=gen))

    def sparse_head(self, c: int, x):
        """Codebook ``c``'s logits in float32, as the decode paths take
        them (JAX applies the head as ``x @ kernel + bias``, which promotes
        a bf16 ``x`` to float32)."""
        head = getattr(self, f"sparse_head_{c}")
        return F.linear(x.to(torch.float32), head.weight, head.bias)

    # ---- training ---------------------------------------------------------

    def forward(self, input_ids, encoder_input_ids, deterministic=True,
                generator=None) -> CobraOutput:
        """Losses and metrics of one batch: input_ids (B, T*C) sem-ids with
        ``pad_id`` padding, encoder_input_ids (B, T, Ltxt) item text."""
        C = self.n_codebooks
        dev = input_ids.device
        vecs = self.encoder(encoder_input_ids, deterministic, generator)
        B, TC = input_ids.shape
        T = TC // C
        seq_mask = interleave_seq_mask(input_ids != self.pad_id, C)
        emb = self.cobra_emb(input_ids, vecs, seq_mask)
        h = self.decoder(emb, tgt_key_padding_mask=~seq_mask, deterministic=deterministic,
                         generator=generator)

        loss_sparse = 0.0
        total_correct = torch.zeros((), dtype=torch.long, device=dev)
        total_tokens = torch.zeros((), dtype=torch.long, device=dev)
        all_item_correct = torch.ones((B, T - 1), dtype=torch.bool, device=dev)
        all_valid = None
        items = torch.arange(1, T, device=dev)
        for c in range(C):
            if c == 0:
                pos_c = torch.arange(0, T - 1, device=dev) * (C + 1) + C  # dense positions
                target_pos = items * C
            else:
                pos_c = items * (C + 1) + (c - 1)
                target_pos = items * C + c
            logits = getattr(self, f"sparse_head_{c}")(h[:, pos_c, :]).to(torch.float32)
            target = input_ids[:, target_pos]
            valid = target != self.pad_id
            if all_valid is None:
                all_valid = valid
            ce, _ = cross_entropy_with_ignore(logits, target, ignore_index=self.pad_id)
            loss_sparse = loss_sparse + ce.sum() / valid.sum().clamp_min(1)
            hit = logits.argmax(dim=-1) == target
            total_correct = total_correct + (hit & valid).sum()
            total_tokens = total_tokens + valid.sum()
            all_item_correct = all_item_correct & (hit | ~valid)
        loss_sparse = loss_sparse / C
        recall_correct = (all_item_correct & all_valid).sum()
        recall_total = all_valid.sum()

        # Dense in-batch InfoNCE, where-masked: a row's other positions in
        # the same sequence and invalid columns are not negatives.
        vec_pred = h[:, items * (C + 1) + (C - 1), :]
        vec_gt = vecs[:, 1:, :].detach()
        Q = B * (T - 1)
        valid_dense = seq_mask[:, (C + 1)::(C + 1)].reshape(Q)
        vp = l2norm(vec_pred.reshape(Q, -1).to(torch.float32))
        vg = l2norm(vec_gt.reshape(Q, -1).to(torch.float32))
        seq_ids = torch.arange(B, device=dev).repeat_interleave(T - 1)
        eye = torch.eye(Q, dtype=torch.bool, device=dev)
        same_seq = (seq_ids[None, :] == seq_ids[:, None]) & ~eye
        sim = (vp @ vg.T) / self.temperature
        sim = sim.masked_fill(same_seq, _NEG_SIM)
        sim = sim.masked_fill(~valid_dense[None, :] & ~eye, _NEG_SIM)
        vd = valid_dense.to(torch.float32)
        dense_ce = (torch.logsumexp(sim, dim=-1) - torch.diagonal(sim)) * vd
        loss_dense = dense_ce.sum() / vd.sum().clamp_min(1)
        vec_cos_sim = ((vp * vg).sum(dim=-1) * vd).sum() / vd.sum().clamp_min(1)

        entropies = []
        for c in range(C):
            usage = torch.bincount(input_ids[:, c::C].reshape(-1).long(),
                                   minlength=self.pad_id + 1).to(torch.float32)
            prob = usage / usage.sum().clamp_min(1)
            entropies.append(-(prob * torch.log(prob + 1e-12)).sum())
        return CobraOutput(
            loss=loss_sparse + loss_dense, loss_sparse=loss_sparse, loss_dense=loss_dense,
            acc_correct=total_correct, acc_total=total_tokens,
            recall_correct=recall_correct, recall_total=recall_total,
            vec_cos_sim=vec_cos_sim, codebook_entropy=torch.stack(entropies).mean(),
        )

    # ---- generation -------------------------------------------------------

    def encode_items(self, encoder_input_ids):
        return self.encoder(encoder_input_ids, deterministic=True)

    def _embed_history(self, input_ids, vecs, n_complete_items):
        seq_mask = interleave_seq_mask(input_ids != self.pad_id, self.n_codebooks,
                                       n_complete_items)
        return self.cobra_emb(input_ids, vecs, seq_mask, n_complete_items), seq_mask

    def decode_hidden(self, input_ids, vecs, n_complete_items):
        """The decoder over (possibly partial) sequences: (h, seq_mask)."""
        emb, seq_mask = self._embed_history(input_ids, vecs, n_complete_items)
        return self.decoder(emb, tgt_key_padding_mask=~seq_mask), seq_mask

    def decode_prefill(self, input_ids, vecs, n_complete_items):
        """``decode_hidden`` that also returns the per-layer history K/V."""
        emb, seq_mask = self._embed_history(input_ids, vecs, n_complete_items)
        h, kvs = self.decoder.prefill(emb, tgt_key_padding_mask=~seq_mask)
        return h, seq_mask, kvs

    def decode_suffix_step(self, tok, slot: int, base_pos: int, hist_kvs, hist_pad, caches):
        """Advance the sem-id suffix one codebook position for K beams:
        tok (B, K) chosen at the previous step. (h (B, K, d), caches)."""
        x = self.cobra_emb.suffix_token(tok, slot, base_pos)
        return self.decoder.decode(x, hist_kvs, hist_pad, caches, slot)

    def decode_suffix_step_paged(self, tok, steps, base_pos, k_pools, v_pools,
                                 block_tables, seq_lens, caches):
        """``decode_suffix_step`` through the paged history pools with
        per-row suffix slots and history ends."""
        x = self.cobra_emb.suffix_token_ragged(tok, steps, base_pos)
        return self.decoder.decode_paged(x, k_pools, v_pools, block_tables, seq_lens,
                                         caches, steps)

    def decode_suffix_tree_paged(self, node_tok, topo, base_steps, base_pos, k_pools,
                                 v_pools, block_tables, seq_lens, caches):
        """Speculative tree verification: hidden states of EVERY tree node
        in one suffix pass. ``base_steps`` (S,) is the level-0 suffix slot
        (the plain step's ``steps - 1``); node n sits at base + level[n].
        Returns (h (S, N, d), per-layer (k_new, v_new)); ``caches`` are
        read only."""
        node_slots = base_steps[:, None] + topo.on(node_tok.device)["level"][None, :]
        x = self.cobra_emb.suffix_token_tree(node_tok, node_slots, base_pos)
        return self.decoder.decode_tree(x, k_pools, v_pools, block_tables, seq_lens,
                                        caches, topo, base_steps)


def _constrained_logp(logits, trie, prefix_idx, step: int):
    """Log-probs over (..., V) logits, trie-masked when a trie is given:
    illegal continuations of ``prefix_idx`` are -1e32 before the softmax
    and again after (a dead beam's flat softmax must never win)."""
    if trie is None:
        return torch.log_softmax(logits.to(torch.float32), dim=-1)
    legal = trie.legal_mask(prefix_idx, step)
    logp = torch.log_softmax(logits.masked_fill(~legal, _ILLEGAL).to(torch.float32), dim=-1)
    return logp.masked_fill(~legal, _ILLEGAL)


def _take_beams(x, parent):
    """x (B, K, ...) reordered along the beam axis by parent (B, K)."""
    idx = parent.reshape(*parent.shape, *([1] * (x.dim() - 2))).expand(*parent.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


@torch.no_grad()
def cobra_generate(model: Cobra, input_ids, encoder_input_ids, n_candidates: int = 10,
                   temperature: float = 1.0, item_vecs=None, use_cache: bool = True,
                   trie=None) -> CobraGenerationOutput:
    """Deterministic top-k beam search over the C codebooks.

    ``use_cache`` decodes the history ONCE and advances only the sem-id
    suffix per codebook step against per-layer KV caches; without it the
    full decoder re-runs per step (the parity reference). ``trie`` (the
    catalog's ``TensorTrie`` on the inputs' device) constrains every step
    to real items' continuations."""
    C, K, V = model.n_codebooks, n_candidates, model.id_vocab_size
    B = input_ids.shape[0]
    dev = input_ids.device
    vecs = item_vecs if item_vecs is not None else model.encode_items(encoder_input_ids)
    T_items = vecs.shape[1]
    if use_cache and input_ids.shape[1] == C * T_items:
        return _cobra_generate_cached(model, input_ids, vecs, K, temperature, trie)

    rows = torch.arange(B, device=dev)
    prefix_idx = None  # (B, K) trie prefixes of the beams
    for c in range(C):
        if c == 0:
            h, seq_mask = model.decode_hidden(input_ids, vecs, T_items)
            h_c = h[rows, seq_mask.sum(dim=1) - 1]  # (B, D) the last valid position
            logits = model.sparse_head(0, h_c) / temperature
            zero = torch.zeros((B,), dtype=torch.long, device=dev)
            beam_scores, tok = _top_k(_constrained_logp(logits, trie, zero, 0), K)
            beam_tokens = tok[..., None]
            if trie is not None:
                prefix_idx = trie.advance(torch.zeros_like(tok), tok, 0)
            h_last = h_c[:, None].expand(B, K, h_c.shape[-1])
        else:
            flat_ids = torch.cat([input_ids[:, None].expand(B, K, input_ids.shape[1]),
                                  beam_tokens.to(input_ids.dtype)], dim=-1).reshape(B * K, -1)
            flat_vecs = vecs[:, None].expand(B, K, *vecs.shape[1:]).reshape(B * K, T_items, -1)
            h, seq_mask = model.decode_hidden(flat_ids, flat_vecs, T_items)
            h_c = h[torch.arange(B * K, device=dev), seq_mask.sum(dim=1) - 1]
            logits = (model.sparse_head(c, h_c) / temperature).reshape(B, K, V)
            logp = _constrained_logp(logits, trie, prefix_idx, c)
            beam_scores, idx = _top_k((beam_scores[..., None] + logp).reshape(B, K * V), K)
            parent, tok = idx // V, idx % V
            beam_tokens = torch.cat([_take_beams(beam_tokens, parent), tok[..., None]], dim=-1)
            if trie is not None:
                prefix_idx = trie.advance(torch.gather(prefix_idx, 1, parent), tok, c)
            h_last = _take_beams(h_c.reshape(B, K, -1), parent)
    return CobraGenerationOutput(sem_ids=beam_tokens,
                                 dense_vecs=l2norm(h_last.to(torch.float32)), scores=beam_scores)


def _cobra_generate_cached(model: Cobra, input_ids, vecs, K: int, temperature: float,
                           trie=None) -> CobraGenerationOutput:
    """KV-cached beam search: one prefill over the interleaved history,
    then one suffix position per codebook step. Partially padded rows read
    ``h[n_valid + c - 1]``, a position inside the causal history whose
    hidden state the appended tokens do not change, from the prefill."""
    C, V = model.n_codebooks, model.id_vocab_size
    B = input_ids.shape[0]
    dev = input_ids.device
    h_pre, seq_mask, hist_kvs = model.decode_prefill(input_ids, vecs, vecs.shape[1])
    Lint = seq_mask.shape[1]
    n_valid = seq_mask.sum(dim=1)
    rows = torch.arange(B, device=dev)
    h_c = h_pre[rows, n_valid - 1]
    logits = model.sparse_head(0, h_c) / temperature
    zero = torch.zeros((B,), dtype=torch.long, device=dev)
    beam_scores, tok = _top_k(_constrained_logp(logits, trie, zero, 0), K)
    beam_tokens = tok[..., None]
    prefix_idx = None if trie is None else trie.advance(torch.zeros_like(tok), tok, 0)
    h_last = h_c[:, None].expand(B, K, h_c.shape[-1])
    full = n_valid == Lint
    hist_pad = ~seq_mask
    caches = init_decode_caches(model.decoder_n_layers, B, K, max(C - 1, 1),
                                model.decoder_num_heads, model.d_model, model.dtype,
                                device=dev)
    for c in range(1, C):
        h_new, caches = model.decode_suffix_step(beam_tokens[:, :, c - 1], c - 1, Lint,
                                                 hist_kvs, hist_pad, caches)
        pos = (n_valid + c - 1).clamp(0, Lint - 1)
        h_c = torch.where(full[:, None, None], h_new, h_pre[rows, pos][:, None, :])
        logp = _constrained_logp(model.sparse_head(c, h_c) / temperature, trie, prefix_idx, c)
        beam_scores, idx = _top_k((beam_scores[..., None] + logp).reshape(B, K * V), K)
        parent, tok = idx // V, idx % V
        beam_tokens = torch.cat([_take_beams(beam_tokens, parent), tok[..., None]], dim=-1)
        if trie is not None:
            prefix_idx = trie.advance(torch.gather(prefix_idx, 1, parent), tok, c)
        caches = gather_beam_caches(caches, parent)
        h_last = _take_beams(h_c, parent)
    return CobraGenerationOutput(sem_ids=beam_tokens,
                                 dense_vecs=l2norm(h_last.to(torch.float32)), scores=beam_scores)


@torch.no_grad()
def beam_fusion(model: Cobra, input_ids, encoder_input_ids, item_dense_vecs, item_sem_ids,
                n_candidates: int = 10, n_beam: int = 50, temperature: float = 1.0,
                alpha: float = 0.5, item_vecs=None, use_cache: bool = True,
                trie=None) -> BeamFusionOutput:
    """Beam candidates and their dense nearest neighbours, alpha-fused:
    alpha x softmax(beam scores) + (1 - alpha) x (max cosine + 1) / 2."""
    gen = cobra_generate(model, input_ids, encoder_input_ids, n_candidates=n_beam,
                         temperature=temperature, item_vecs=item_vecs,
                         use_cache=use_cache, trie=trie)
    sim = torch.einsum("bkd,nd->bkn", gen.dense_vecs, l2norm(item_dense_vecs.to(torch.float32)))
    max_sim, best_item = sim.max(dim=-1).values, sim.argmax(dim=-1)
    fused = alpha * torch.softmax(gen.scores, dim=-1) + (1 - alpha) * (max_sim + 1) / 2
    top_scores, top_idx = _top_k(fused, n_candidates)
    item_ids = torch.gather(best_item, 1, top_idx)
    return BeamFusionOutput(item_ids=item_ids, sem_ids=item_sem_ids[item_ids],
                            scores=top_scores)


# ---- paged decode (history K/V in page pools, per-slot steps) --------------


def init_cobra_paged_state(model: Cobra, n_slots: int, beams: int) -> dict:
    """Zeroed slot-major decode state on the model's device. cache_k and
    cache_v stack the per-layer suffix caches on axis 1."""
    C, nl, H, hd, d = (model.n_codebooks, model.decoder_n_layers, model.decoder_num_heads,
                       model.head_dim, model.d_model)
    dev = model.device
    cache = (n_slots, nl, beams, max(C - 1, 1), H, hd)
    return {
        "beam_tokens": torch.zeros((n_slots, beams, C), dtype=torch.long, device=dev),
        "beam_scores": torch.zeros((n_slots, beams), dtype=torch.float32, device=dev),
        "prefix_idx": torch.zeros((n_slots, beams), dtype=torch.long, device=dev),
        "cache_k": torch.zeros(cache, device=dev),
        "cache_v": torch.zeros(cache, device=dev),
        "tail_hidden": torch.zeros((n_slots, C, d), device=dev),
        "full": torch.zeros((n_slots,), dtype=torch.bool, device=dev),
        "base_pos": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        "h_last": torch.zeros((n_slots, beams, d), device=dev),
    }


@torch.no_grad()
def cobra_prefill_paged(model: Cobra, input_ids, vecs, block_tables, k_pools, v_pools,
                        trie, n_candidates: int, temperature: float = 1.0):
    """Prefill that writes the interleaved history K/V into the page pools
    (in place) through ``block_tables``, and resolves codebook 0 from the
    last dense position. Returns (k_pools, v_pools, init): init holds the
    codebook-0 beam, the C prefill tail hiddens that partially padded rows
    read, the full-row flag, base_pos (the valid interleaved length, also
    the pools' seq_lens, int32) and h_last."""
    C = model.n_codebooks
    B = input_ids.shape[0]
    dev = input_ids.device
    h_pre, seq_mask, hist_kvs = model.decode_prefill(input_ids, vecs, vecs.shape[1])
    for kp, vp, (k, v) in zip(k_pools, v_pools, hist_kvs):
        write_pages(kp, block_tables, k)
        write_pages(vp, block_tables, v)
    Lint = seq_mask.shape[1]
    n_valid = seq_mask.sum(dim=1).to(torch.int32)
    rows = torch.arange(B, device=dev)
    tail = torch.stack([h_pre[rows, (n_valid.long() + c - 1).clamp(0, Lint - 1)]
                        for c in range(C)], dim=1)  # c = 0 feeds the head below
    logits = model.sparse_head(0, tail[:, 0]) / temperature
    zero = torch.zeros((B,), dtype=torch.long, device=dev)
    beam_scores, tok = _top_k(_constrained_logp(logits, trie, zero, 0), n_candidates)
    beam_tokens = torch.zeros((B, n_candidates, C), dtype=torch.long, device=dev)
    beam_tokens[:, :, 0] = tok
    init = {
        "beam_tokens": beam_tokens,
        "beam_scores": beam_scores,
        "prefix_idx": (torch.zeros_like(tok) if trie is None
                       else trie.advance(torch.zeros_like(tok), tok, 0)),
        "tail_hidden": tail,
        "full": n_valid == Lint,
        "base_pos": n_valid,
        "h_last": tail[:, 0][:, None].expand(B, n_candidates, model.d_model),
    }
    return k_pools, v_pools, init


def _cobra_beam_update(model: Cobra, trie, logits_scaled, beam_tokens, beam_scores,
                       prefix_idx, steps):
    """One beam selection from this step's temperature-scaled (S, K, V)
    logits, each row at its own codebook ``steps``. Returns (beam_tokens,
    beam_scores, prefix_idx, parent, tok)."""
    S, K, C = beam_tokens.shape
    V = model.id_vocab_size
    if trie is None:
        logp = torch.log_softmax(logits_scaled.to(torch.float32), dim=-1)
    else:
        legal = legal_mask_ragged(trie, prefix_idx, steps)
        logp = torch.log_softmax(logits_scaled.masked_fill(~legal, _ILLEGAL), dim=-1)
        logp = logp.masked_fill(~legal, _ILLEGAL)
    new_scores, idx = _top_k((beam_scores[..., None] + logp).reshape(S, K * V), K)
    parent, tok = idx // V, idx % V
    hit = torch.arange(C, device=steps.device)[None, None, :] == steps[:, None, None]
    new_tokens = torch.where(hit, tok[..., None], _take_beams(beam_tokens, parent))
    new_prefix = (torch.zeros_like(prefix_idx) if trie is None
                  else advance_ragged(trie, torch.gather(prefix_idx, 1, parent), tok, steps))
    return new_tokens, new_scores, new_prefix, parent, tok


@torch.no_grad()
def cobra_paged_decode_step(model: Cobra, trie, state: dict, steps, block_tables, seq_lens,
                            k_pools, v_pools, temperature: float = 1.0) -> dict:
    """One suffix codebook position for every slot; steps (S,) holds each
    row's codebook c in [1, C-1]. Pools: one K and one V pool (fp32 or
    ``QuantizedKVPool``) per decoder layer. Free slots compute garbage
    harmlessly: nothing here reduces across rows."""
    C = model.n_codebooks
    S, K, _ = state["beam_tokens"].shape
    caches = [{"k": state["cache_k"][:, i], "v": state["cache_v"][:, i]}
              for i in range(state["cache_k"].shape[1])]
    prev = (steps - 1).clamp(0, C - 1)[:, None, None].expand(S, K, 1)
    tok_prev = torch.gather(state["beam_tokens"], 2, prev)[:, :, 0]
    h_new, caches = model.decode_suffix_step_paged(
        tok_prev, steps - 1, state["base_pos"], k_pools, v_pools, block_tables, seq_lens,
        caches)
    c_idx = steps.clamp(0, C - 1).long()
    h_tail = state["tail_hidden"][torch.arange(S, device=steps.device), c_idx]
    h_c = torch.where(state["full"][:, None, None], h_new, h_tail[:, None, :])
    logits = model.sparse_head(0, h_c)
    for c in range(1, C):  # every sparse head computed, row-selected (C is tiny)
        logits = torch.where((steps == c)[:, None, None], model.sparse_head(c, h_c), logits)
    beam_tokens, beam_scores, prefix_idx, parent, _ = _cobra_beam_update(
        model, trie, logits / temperature, state["beam_tokens"], state["beam_scores"],
        state["prefix_idx"], steps)
    caches = gather_beam_caches(caches, parent)
    return {
        "beam_tokens": beam_tokens,
        "beam_scores": beam_scores,
        "prefix_idx": prefix_idx,
        "cache_k": torch.stack([c["k"] for c in caches], dim=1),
        "cache_v": torch.stack([c["v"] for c in caches], dim=1),
        "tail_hidden": state["tail_hidden"],
        "full": state["full"],
        "base_pos": state["base_pos"],
        "h_last": _take_beams(h_c, parent),
    }


@torch.no_grad()
def cobra_spec_tree_step(model: Cobra, trie, state: dict, steps, block_tables, seq_lens,
                         k_pools, v_pools, fanout=4, depth: int | None = None,
                         temperature: float = 1.0, draft_override=None):
    """Speculative tree decode of the COBRA suffix: commit 1 to ``depth +
    1`` codebook positions a slot in ONE decoder invocation.

    As ``models.tiger.tiger_spec_tree_step``: draft trie-legal children a
    beam by draft weight (the first F codes when ``trie`` is None, free
    decode), verify the tree in one suffix pass
    (``Cobra.decode_suffix_tree_paged``), replay the plain step's
    ``_cobra_beam_update`` level by level, and accept while every
    selection was a drafted edge. Level 0 is exact. ``draft_override``
    (tests) replaces the level-l drafts. Returns (new_state, accept (S,)
    int64).
    """
    C = model.n_codebooks
    S, K, _ = state["beam_tokens"].shape
    dev = state["beam_tokens"].device
    if depth is None:
        depth = max(C - 2, 0)
    depth = max(min(int(depth), C - 2), 0)
    topo = tree_topology(K, fanout, depth)
    caches = [{"k": state["cache_k"][:, i], "v": state["cache_v"][:, i]}
              for i in range(state["cache_k"].shape[1])]

    # -- draft ---------------------------------------------------------------
    prev = (steps - 1).clamp(0, C - 1)[:, None, None].expand(S, K, 1)
    tok_prev = torch.gather(state["beam_tokens"], 2, prev)[:, :, 0]
    levels_tok = [tok_prev]
    draft_toks = []
    cur_prefix = state["prefix_idx"]  # (S, N_prev), N_0 = K
    for l in range(1, depth + 1):
        step_l = (steps + (l - 1)).clamp_max(C - 1)
        F_l = topo.fanouts[l - 1]
        if draft_override is not None:
            d_tok = torch.as_tensor(draft_override[l - 1], dtype=torch.int64, device=dev)
        elif trie is None:  # free decode: no legality to expand
            d_tok = torch.arange(F_l, device=dev).expand(S, cur_prefix.shape[1], F_l)
        else:
            d_tok, _ = legal_topk_ragged(trie, cur_prefix, step_l, F_l)
        draft_toks.append(d_tok)
        levels_tok.append(d_tok.reshape(S, -1))
        if trie is None:
            cur_prefix = torch.zeros((S, d_tok.shape[1] * d_tok.shape[2]),
                                     dtype=torch.int64, device=dev)
        else:
            cur_prefix = advance_ragged(trie, cur_prefix[..., None].expand(d_tok.shape),
                                        d_tok, step_l).reshape(S, -1)
    node_tok = torch.cat(levels_tok, dim=1)  # (S, N)

    # -- verify: one suffix pass over the whole tree ---------------------------
    h_nodes, node_kvs = model.decode_suffix_tree_paged(
        node_tok, topo, steps - 1, state["base_pos"], k_pools, v_pools, block_tables,
        seq_lens, caches)  # (S, N, d)
    node_steps = steps[:, None] + topo.on(dev)["level"][None, :]
    c_idx = node_steps.clamp(0, C - 1)
    d = h_nodes.shape[-1]
    # Rows whose history does not fill the bucket read their prefill tail.
    h_tail = torch.gather(state["tail_hidden"], 1, c_idx[..., None].expand(*c_idx.shape, d))
    h_c_nodes = torch.where(state["full"][:, None, None], h_nodes, h_tail)
    logits_nodes = model.sparse_head(0, h_c_nodes)
    for c in range(1, C):  # every sparse head computed, node-selected (C is tiny)
        logits_nodes = torch.where((node_steps == c)[..., None],
                                   model.sparse_head(c, h_c_nodes), logits_nodes)
    logits_nodes = logits_nodes / temperature

    # -- accept scan: replay the plain update along the drafted tree ----------
    run_tokens = com_tokens = state["beam_tokens"]
    run_scores = com_scores = state["beam_scores"]
    run_prefix = com_prefix = state["prefix_idx"]
    run_ck = com_ck = [c["k"] for c in caches]
    run_cv = com_cv = [c["v"] for c in caches]
    com_h_last = state["h_last"]
    cur_local = torch.arange(K, device=dev)[None].expand(S, K)
    ok = torch.ones((S,), dtype=torch.bool, device=dev)
    accept = torch.zeros((S,), dtype=torch.int64, device=dev)
    V = logits_nodes.shape[-1]
    for j in range(depth + 1):
        applied = ok & (steps + j <= C - 1)
        step_j = (steps + j).clamp_max(C - 1)
        flat_idx = int(topo.level_offsets[j]) + cur_local  # (S, K)
        logits_j = torch.gather(logits_nodes, 1, flat_idx[..., None].expand(S, K, V))
        new_tokens, new_scores, new_prefix, parent, sel_tok = _cobra_beam_update(
            model, trie, logits_j, run_tokens, run_scores, run_prefix, step_j)
        # This level's suffix-cache slot is steps - 1 + j.
        new_ck, new_cv = commit_level_kv(node_kvs, run_ck, run_cv, flat_idx, parent,
                                         step_j - 1)
        h_c_sel = _take_beams(h_c_nodes, flat_idx)
        new_h_last = _take_beams(h_c_sel, parent)
        ap2 = applied[:, None]
        ap3 = applied[:, None, None]
        ap5 = applied[:, None, None, None, None]
        com_tokens = torch.where(ap3, new_tokens, com_tokens)
        com_scores = torch.where(ap2, new_scores, com_scores)
        com_prefix = torch.where(ap2, new_prefix, com_prefix)
        com_h_last = torch.where(ap3, new_h_last, com_h_last)
        com_ck = [torch.where(ap5, n, c) for n, c in zip(new_ck, com_ck)]
        com_cv = [torch.where(ap5, n, c) for n, c in zip(new_cv, com_cv)]
        accept = accept + applied.long()
        if j < depth:
            parent_local = torch.gather(cur_local, 1, parent)
            matched, child_f = match_drafted(draft_toks[j], parent_local, sel_tok)
            ok = applied & matched
            cur_local = parent_local * topo.fanouts[j] + child_f
            run_tokens, run_scores, run_prefix = new_tokens, new_scores, new_prefix
            run_ck, run_cv = new_ck, new_cv

    new_state = dict(state)
    new_state.update(
        beam_tokens=com_tokens,
        beam_scores=com_scores,
        prefix_idx=com_prefix,
        cache_k=torch.stack(com_ck, dim=1),
        cache_v=torch.stack(com_cv, dim=1),
        h_last=com_h_last,
    )
    return new_state, accept


@torch.no_grad()
def cobra_generate_paged(model: Cobra, input_ids, encoder_input_ids, n_candidates: int = 10,
                         temperature: float = 1.0, item_vecs=None, trie=None,
                         page_size: int = 8, kv_dtype: str = "float32") -> CobraGenerationOutput:
    """``cobra_generate(use_cache=True)`` through the paged path: prefill
    into a fresh pool (contiguous block tables), then the suffix step with
    every row in lockstep. The offline reference for serving.
    ``kv_dtype="int8"`` stores the pools quantised."""
    C = model.n_codebooks
    B = input_ids.shape[0]
    dev = input_ids.device
    vecs = item_vecs if item_vecs is not None else model.encode_items(encoder_input_ids)
    T_items = vecs.shape[1]
    if input_ids.shape[1] != C * T_items:
        raise ValueError("paged decode requires complete-item histories")
    Lint = T_items * (C + 1)
    pages_per_slot = -(-Lint // page_size)
    block_tables = (1 + torch.arange(B * pages_per_slot, device=dev)).reshape(
        B, pages_per_slot).to(torch.int32)
    shape = (1 + B * pages_per_slot, page_size, model.decoder_num_heads, model.head_dim)
    if kv_dtype == "int8":
        zeros = lambda: QuantizedKVPool.zeros(shape, device=dev)  # noqa: E731
    elif kv_dtype == "float32":
        zeros = lambda: torch.zeros(shape, device=dev)  # noqa: E731
    else:
        raise ValueError(f"kv_dtype {kv_dtype!r} not supported; choose one of {KV_DTYPES}")
    nl = model.decoder_n_layers
    k_pools = tuple(zeros() for _ in range(nl))
    v_pools = tuple(zeros() for _ in range(nl))
    k_pools, v_pools, init = cobra_prefill_paged(model, input_ids, vecs, block_tables,
                                                 k_pools, v_pools, trie, n_candidates,
                                                 temperature)
    state = init_cobra_paged_state(model, B, n_candidates)
    state.update(init)
    for c in range(1, C):
        state = cobra_paged_decode_step(
            model, trie, state, torch.full((B,), c, dtype=torch.long, device=dev),
            block_tables, init["base_pos"], k_pools, v_pools, temperature=temperature)
    return CobraGenerationOutput(sem_ids=state["beam_tokens"],
                                 dense_vecs=l2norm(state["h_last"]),
                                 scores=state["beam_scores"])
