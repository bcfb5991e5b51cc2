"""TIGER generative retrieval over semantic IDs: the paged serving path
(port of genrec_tpu/models/tiger.py).

``Tiger`` holds the encoder-decoder and its embeddings under the Flax
parameter names (``genrec_tpu_torch.convert`` maps a JAX param tree onto
it). The functions below are the paged decode of the serving engine:

- ``tiger_prefill_paged``: encoder pass + per-layer cross-attention K/V
  written straight into the page pools through the batch's block tables;
- ``tiger_paged_decode_step``: every slot advances one constrained-beam
  position, each at its own step, with cross-attention read from the
  pools by the paged-attention kernel;
- ``tiger_generate_paged``: the two above with every row in lockstep —
  the offline reference the serving engine's answers are held to.

Serving is deterministic beam search (the JAX path with ``rng=None``).
Ties are broken as ``jax.lax.top_k`` and ``jnp.lexsort`` break them (lower
index first), with stable sorts: ties really happen (every illegal
candidate scores -1e32, and small catalogs leave fewer legal children
than beams), and ``torch.topk`` promises no order among them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.embeddings import SemIdEmbedding, UserIdEmbedding
from genrec_tpu_torch.models.layers import RMSNorm
from genrec_tpu_torch.models.t5transformer import (
    TransformerEncoderDecoder,
    gather_beam_caches,
)
from genrec_tpu_torch.ops.paged import write_pages
from genrec_tpu_torch.ops.trie import advance_ragged, legal_mask_ragged

_ILLEGAL = -1e32


class TigerGenerationOutput(NamedTuple):
    sem_ids: torch.Tensor  # (B, K, D)
    log_probas: torch.Tensor  # (B, K)


class Tiger(nn.Module):
    """TIGER encoder-decoder for inference. Weights are drawn from
    ``seed`` (a CPU generator, so every device gets the same weights) or
    loaded with ``load_state_dict``."""

    def __init__(self, embedding_dim: int, attn_dim: int, num_heads: int,
                 n_layers: int, num_item_embeddings: int, num_user_embeddings: int,
                 sem_id_dim: int, max_pos: int = 2048, pad_vocab_to: int = 1,
                 dim_feedforward: int = 1024, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.embedding_dim = embedding_dim
        self.attn_dim = attn_dim
        self.num_heads = num_heads
        self.n_layers = n_layers
        self.num_item_embeddings = num_item_embeddings
        self.num_user_embeddings = num_user_embeddings
        self.sem_id_dim = sem_id_dim
        self.pad_vocab_to = pad_vocab_to
        self.bos_embedding = nn.Parameter(torch.empty(embedding_dim, device=dev))
        self.norm = RMSNorm(embedding_dim, device=dev)
        self.norm_context = RMSNorm(embedding_dim, device=dev)
        self.sem_id_embedding = SemIdEmbedding(
            num_item_embeddings, sem_id_dim, embedding_dim,
            rows_multiple=pad_vocab_to, device=dev,
        )
        self.user_id_embedding = UserIdEmbedding(
            num_user_embeddings, embedding_dim, device=dev
        )
        # Unused by the forward, as in the JAX model; kept so the two
        # parameter surfaces match leaf for leaf. (The JAX model's
        # ``out_proj`` Dense is never called, so Flax creates no leaf for
        # it and the port has no counterpart.)
        self.pos_embedding = nn.Parameter(torch.empty(max_pos, embedding_dim, device=dev))
        self.decoder_pos_embedding = nn.Parameter(
            torch.empty(sem_id_dim, embedding_dim, device=dev)
        )
        self.in_proj = nn.Linear(embedding_dim, attn_dim, bias=False, device=dev)
        self.in_proj_context = nn.Linear(embedding_dim, attn_dim, bias=False, device=dev)
        self.transformer = TransformerEncoderDecoder(
            d_model=attn_dim, nhead=num_heads,
            num_encoder_layers=n_layers // 2, num_decoder_layers=n_layers // 2,
            dim_feedforward=dim_feedforward, device=dev,
        )
        self.output_head = nn.Linear(attn_dim, self.padded_vocab_size, bias=False,
                                     device=dev)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.bos_embedding.device

    @property
    def vocab_size(self) -> int:
        return self.num_item_embeddings * self.sem_id_dim + 1

    @property
    def padded_vocab_size(self) -> int:
        m = max(self.pad_vocab_to, 1)
        return -(-self.vocab_size // m) * m

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Seeded init with the Flax model's scales: embeddings N(0, 1),
        relative biases N(0, 0.02), norms 1, projections N(0, 1/fan_in)."""
        gen = torch.Generator().manual_seed(seed)
        norms = {f"{n}.weight" for n, m in self.named_modules() if isinstance(m, RMSNorm)}
        for name, p in self.named_parameters():
            if name in norms:
                w = torch.ones(p.shape)
            elif name.endswith("rel_bias"):
                w = torch.randn(p.shape, generator=gen) * 0.02
            elif name.endswith(".weight"):  # nn.Linear, (out, in)
                w = torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5
            else:  # embedding tables and the BOS vector
                w = torch.randn(p.shape, generator=gen)
            p.copy_(w)

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        if self.padded_vocab_size == self.vocab_size:
            return logits
        live = torch.arange(self.padded_vocab_size, device=logits.device) < self.vocab_size
        return logits.masked_fill(~live, -1e9)

    def _encoder_input(self, user_input_ids, item_input_ids, token_type_ids, seq_mask):
        if user_input_ids.dim() == 1:
            user_input_ids = user_input_ids[:, None]
        user_emb = self.user_id_embedding(user_input_ids)  # (B, 1, E)
        item_emb = self.sem_id_embedding(item_input_ids, token_type_ids)
        enc = torch.cat([user_emb, item_emb], dim=1)
        pad = torch.cat(
            [torch.zeros(seq_mask.shape[0], 1, dtype=torch.bool, device=seq_mask.device),
             seq_mask == 0], dim=1,
        )  # True = padding; the user token is always valid
        return enc, pad

    def encode_context(self, user_input_ids, item_input_ids, token_type_ids, seq_mask):
        enc, pad = self._encoder_input(user_input_ids, item_input_ids,
                                       token_type_ids, seq_mask)
        enc = self.in_proj_context(self.norm_context(enc))
        return self.transformer.encoder(enc, key_padding_mask=pad), pad

    def encode_for_decode(self, user_input_ids, item_input_ids, token_type_ids, seq_mask):
        """Encoder pass + once-per-batch cross-attention K/V projection:
        (per-layer [(B, H, Lm, hd) K, V], pad (B, Lm))."""
        memory, pad = self.encode_context(user_input_ids, item_input_ids,
                                          token_type_ids, seq_mask)
        return self.transformer.decoder.precompute_cross_kv(memory), pad

    def decode_step_paged(self, last_tok, caches, k_pools, v_pools,
                          block_tables, seq_lens, steps):
        """One decode position for every row at its own step against the
        paged cross-attention K/V. last_tok (S, K); rows with steps == 0
        start from BOS. caches: per-layer {"k", "v"} (S, K, D, H, hd).
        Returns (logits (S, K, V) fp32, new_caches)."""
        S, K = last_tok.shape
        bos = self.bos_embedding.expand(S, K, self.embedding_dim)
        tok_type = (steps - 1).clamp(0, self.sem_id_dim - 1)[:, None].expand(S, K)
        emb = self.sem_id_embedding(last_tok, tok_type)
        x = torch.where((steps == 0)[:, None, None], bos, emb)
        x = self.in_proj(self.norm(x))
        x, new_caches = self.transformer.decoder.decode_step_paged(
            x, caches, k_pools, v_pools, block_tables, seq_lens, steps
        )
        logits = self._mask_pad_logits(self.output_head(x))
        return logits.to(torch.float32), new_caches


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, descending,
    the lower index first among equal values."""
    idx = torch.sort(-x, dim=-1, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _dedup_top_k(scores: torch.Tensor, keys: torch.Tensor, k: int):
    """Per row: keep the best-scoring instance of each key, return top-k.

    scores, keys: (..., M). ``jnp.lexsort((-scores, keys))`` as two
    stable sorts: by -score, then by key (a stable sort keeps the score
    order, and the original index order, inside each key)."""
    o1 = torch.sort(-scores, dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(keys, -1, o1), dim=-1, stable=True).indices
    order = torch.gather(o1, -1, o2)
    ks = torch.gather(keys, -1, order)
    first = torch.ones_like(ks, dtype=torch.bool)
    first[..., 1:] = ks[..., 1:] != ks[..., :-1]
    keep = torch.zeros_like(first).scatter_(-1, order, first)
    return _top_k(scores.masked_fill(~keep, float("-inf")), k)


def init_tiger_paged_state(model: Tiger, n_slots: int, beams: int) -> dict:
    """Zeroed slot-major decode state on the model's device. cache_k and
    cache_v stack the per-layer suffix caches on axis 1."""
    nl = model.n_layers // 2
    H = model.num_heads
    hd = model.attn_dim // H
    D = model.sem_id_dim
    dev = model.device
    return {
        "beam_seqs": torch.zeros((n_slots, beams, D), dtype=torch.int64, device=dev),
        "beam_logps": torch.zeros((n_slots, beams), dtype=torch.float32, device=dev),
        "prefix_idx": torch.zeros((n_slots, beams), dtype=torch.int64, device=dev),
        "cache_k": torch.zeros((n_slots, nl, beams, D, H, hd), device=dev),
        "cache_v": torch.zeros((n_slots, nl, beams, D, H, hd), device=dev),
    }


def _tiger_beam_update(model: Tiger, trie, logits, beam_seqs, beam_logps,
                       prefix_idx, steps, temperature: float, sample_factor: int):
    """One constrained-beam selection from this step's (S, K, V) logits.
    Returns (beam_seqs, beam_logps, prefix_idx, sel_parent, sel_tok)."""
    S, K, D = beam_seqs.shape
    Kcb = model.num_item_embeddings
    KK = min(K * sample_factor, Kcb)
    dev = logits.device
    flat = logits.reshape(S * K, -1)
    cols = steps.repeat_interleave(K)[:, None] * Kcb + torch.arange(Kcb, device=dev)
    window = torch.gather(flat, 1, cols)  # per-row vocab window at its own step
    legal = legal_mask_ragged(trie, prefix_idx, steps).reshape(S * K, Kcb)
    masked = window.masked_fill(~legal, _ILLEGAL)
    logp = torch.log_softmax(masked / temperature, dim=-1)

    _, cand_tok = _top_k(logp, KK)
    cand_logp = torch.gather(logp, 1, cand_tok)
    cand_legal = torch.gather(legal, 1, cand_tok)
    cand_logp = cand_logp.masked_fill(~cand_legal, _ILLEGAL)

    total = (beam_logps.reshape(S * K, 1) + cand_logp).reshape(S, K * KK)
    toks = cand_tok.reshape(S, K * KK)
    parents = torch.arange(K, device=dev).repeat_interleave(KK)[None].expand(S, K * KK)
    keys = torch.gather(prefix_idx, 1, parents) * Kcb + toks
    top_scores, top_idx = _dedup_top_k(total, keys, K)

    sel_parent = torch.gather(parents, 1, top_idx)  # (S, K)
    sel_tok = torch.gather(toks, 1, top_idx)
    new_seqs = torch.gather(beam_seqs, 1, sel_parent[..., None].expand(S, K, D))
    hit = torch.arange(D, device=dev)[None, None, :] == steps[:, None, None]
    new_seqs = torch.where(hit, sel_tok[..., None], new_seqs)
    sel_prefix = torch.gather(prefix_idx, 1, sel_parent)
    new_prefix = advance_ragged(trie, sel_prefix, sel_tok, steps)
    return new_seqs, top_scores, new_prefix, sel_parent, sel_tok


@torch.no_grad()
def tiger_paged_decode_step(model: Tiger, trie, state: dict, steps, block_tables,
                            seq_lens, k_pools, v_pools, temperature: float = 0.2,
                            sample_factor: int = 6) -> dict:
    """Advance every slot one constrained-beam position (per-slot steps).

    steps (S,) int64; block_tables (S, Pm) int32; seq_lens (S,) int32;
    pools: one (P, page, H, hd) K and V pool per decoder layer. Free slots
    compute garbage harmlessly: nothing here reduces across rows.
    """
    S, K, D = state["beam_seqs"].shape
    caches = [
        {"k": state["cache_k"][:, i], "v": state["cache_v"][:, i]}
        for i in range(state["cache_k"].shape[1])
    ]
    last_idx = (steps - 1).clamp(0, D - 1)[:, None, None].expand(S, K, 1)
    last_tok = torch.gather(state["beam_seqs"], 2, last_idx)[:, :, 0]
    logits, caches = model.decode_step_paged(
        last_tok, caches, k_pools, v_pools, block_tables, seq_lens, steps
    )
    beam_seqs, beam_logps, prefix_idx, sel_parent, _ = _tiger_beam_update(
        model, trie, logits, state["beam_seqs"], state["beam_logps"],
        state["prefix_idx"], steps, temperature, sample_factor,
    )
    caches = gather_beam_caches(caches, sel_parent)
    return {
        "beam_seqs": beam_seqs,
        "beam_logps": beam_logps,
        "prefix_idx": prefix_idx,
        "cache_k": torch.stack([c["k"] for c in caches], dim=1),
        "cache_v": torch.stack([c["v"] for c in caches], dim=1),
    }


@torch.no_grad()
def tiger_prefill_paged(model: Tiger, user_input_ids, item_input_ids,
                        token_type_ids, seq_mask, block_tables, k_pools, v_pools):
    """Bucketed prefill that writes its cross-attention K/V into the page
    pools (in place). Returns (k_pools, v_pools, seq_lens (B,) int32): the
    valid KV length per row, user token + real sem-id tokens, which
    assumes a CONTIGUOUS valid prefix in seq_mask. Rows padded past their
    page allocation scatter into the null page 0."""
    cross_kvs, pad = model.encode_for_decode(
        user_input_ids, item_input_ids, token_type_ids, seq_mask
    )
    seq_lens = (~pad).sum(dim=1).to(torch.int32)
    for pool, kv in zip(k_pools, cross_kvs):
        write_pages(pool, block_tables, kv[0])
    for pool, kv in zip(v_pools, cross_kvs):
        write_pages(pool, block_tables, kv[1])
    return k_pools, v_pools, seq_lens


@torch.no_grad()
def tiger_generate_paged(model: Tiger, trie, user_input_ids, item_input_ids,
                         token_type_ids, seq_mask, temperature: float = 0.2,
                         n_top_k_candidates: int = 10, sample_factor: int = 6,
                         page_size: int = 8) -> TigerGenerationOutput:
    """Deterministic constrained beam search through the paged path:
    prefill into a fresh pool (contiguous block tables), then the decode
    step with every row in lockstep. The offline reference for serving.
    Inputs are tensors on the model's device; seq_mask rows must be
    contiguous valid prefixes (the serving layout)."""
    B = item_input_ids.shape[0]
    K = n_top_k_candidates
    D = model.sem_id_dim
    nl = model.n_layers // 2
    H = model.num_heads
    hd = model.attn_dim // H
    dev = model.device
    Lm = seq_mask.shape[1] + 1  # + user token
    pages_per_slot = -(-Lm // page_size)
    num_pages = 1 + B * pages_per_slot  # page 0 = the null page
    block_tables = (1 + torch.arange(B * pages_per_slot, device=dev)).reshape(
        B, pages_per_slot).to(torch.int32)
    k_pools = tuple(torch.zeros((num_pages, page_size, H, hd), device=dev) for _ in range(nl))
    v_pools = tuple(torch.zeros((num_pages, page_size, H, hd), device=dev) for _ in range(nl))
    k_pools, v_pools, seq_lens = tiger_prefill_paged(
        model, user_input_ids, item_input_ids, token_type_ids, seq_mask,
        block_tables, k_pools, v_pools,
    )
    state = init_tiger_paged_state(model, B, K)
    for step in range(D):
        state = tiger_paged_decode_step(
            model, trie, state, torch.full((B,), step, dtype=torch.int64, device=dev),
            block_tables, seq_lens, k_pools, v_pools,
            temperature=temperature, sample_factor=sample_factor,
        )
    return TigerGenerationOutput(sem_ids=state["beam_seqs"], log_probas=state["beam_logps"])
