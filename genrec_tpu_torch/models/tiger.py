"""TIGER generative retrieval over semantic IDs (port of
genrec_tpu/models/tiger.py: the training forwards, the dense
trie-constrained decode and the paged serving decode).

``Tiger`` holds the encoder-decoder and its embeddings under the Flax
parameter names (``genrec_tpu_torch.convert`` maps a JAX param tree onto
it). ``forward`` is the training forward (loss: the per-sequence SUM of
token CE, then the batch mean), ``forward_packed`` its packed-row twin
(several examples an encoder row, segment-restricted attention, the
decoders per example). ``dtype`` is the compute dtype, as Flax's:
parameters float32, cast where used; norms and softmax float32; dropout
from the ``generator`` a training forward is given.

Decoding:

- ``tiger_generate``: trie-constrained beam search over a ``DenseTrie``,
  ``PackedTrie`` or ``TensorTrie``, KV-cached (self-attention appends a
  position a step, cross-attention K/V projected once from the
  batch-sized memory) or uncached (the decoder re-run over the prefix);
  deterministic, or sampling KK = min(K * sample_factor, K_cb) candidates
  a beam without replacement by Gumbel-top-k (noise from a
  ``torch.Generator``), then dedup by full sequence and the top K;
- ``tiger_prefill_paged`` / ``tiger_paged_decode_step`` /
  ``tiger_generate_paged``: the serving engine's paged decode, in the
  model's dtype as JAX's: a float32 or bf16 model over pages of its own
  dtype (B1) or int8 pages (B2), its cross-attention read from the pools
  by the paged-attention kernel;
- ``tiger_spec_tree_step``: the speculative tree decode (``ops.
  spec_tree``): a tree of trie-legal drafts verified in one decoder pass
  (``Tiger.decode_tree_paged``, every node through B1/B2), then the plain
  step's ``_tiger_beam_update`` replayed level by level, committing 1 to
  D codes a slot.

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
from genrec_tpu_torch.models.layers import Dense, RMSNorm, dropout
from genrec_tpu_torch.models.t5transformer import (
    TransformerEncoderDecoder,
    causal_mask,
    gather_beam_caches,
    init_decode_caches,
)
from genrec_tpu_torch.ops.gumbel import sample_gumbel
from genrec_tpu_torch.ops.losses import cross_entropy_with_ignore
from genrec_tpu_torch.ops.paged import write_pages
from genrec_tpu_torch.ops.quant import KV_DTYPES, QuantizedKVPool
from genrec_tpu_torch.ops.spec_tree import commit_level_kv, match_drafted, tree_topology
from genrec_tpu_torch.ops.trie import advance_ragged, legal_mask_ragged, legal_topk_ragged
from genrec_tpu_torch.parallel.mesh import global_count, global_mean
from genrec_tpu_torch.parallel.shardings import (
    copy_to_tp,
    gather_from_tp,
    shard_count,
    tp_rank,
    tp_size,
)

_ILLEGAL = -1e32


class TigerOutput(NamedTuple):
    logits: torch.Tensor
    loss: torch.Tensor | None


class TigerGenerationOutput(NamedTuple):
    sem_ids: torch.Tensor  # (B, K, D)
    log_probas: torch.Tensor  # (B, K)


class TigerPackedOutput(NamedTuple):
    per_example_loss: torch.Tensor  # (R, S) token-sum CE per segment
    loss: torch.Tensor  # mean over valid segments
    real_tokens: torch.Tensor  # scalar: non-pad encoder slots in the batch


class Tiger(nn.Module):
    """TIGER encoder-decoder. Weights are drawn from ``seed`` (a CPU
    generator, so every device gets the same weights) or loaded with
    ``load_state_dict``.

    ``group`` (a ``parallel.mesh.TPGroup``) makes the module this rank's
    shard under JAX ``tiger_rules``: the vocab head column-parallel over
    ``padded_vocab_size`` (its logits gathered over the group before the
    pad mask and the loss), the sem-id rows and every FFN split over the
    group, attention and the rest replicated. ``pad_vocab_to`` must make
    the vocabulary divide by the group's size (the trainer passes tp)."""

    def __init__(self, embedding_dim: int, attn_dim: int, num_heads: int,
                 n_layers: int, num_item_embeddings: int, num_user_embeddings: int,
                 sem_id_dim: int, max_pos: int = 2048, pad_vocab_to: int = 1,
                 dim_feedforward: int = 1024, dropout: float = 0.0,
                 dtype=torch.float32, device="cuda", seed: int = 0, group=None):
        super().__init__()
        dev = resolve_device(device)
        self.group = group
        self.dropout = dropout
        self.dtype = dtype
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
            rows_multiple=pad_vocab_to, dtype=dtype, device=dev, group=group,
        )
        self.user_id_embedding = UserIdEmbedding(
            num_user_embeddings, embedding_dim, dtype=dtype, device=dev
        )
        # Unused by the forward, as in the JAX model; kept so the two
        # parameter surfaces match leaf for leaf. (The JAX model's
        # ``out_proj`` Dense is never called, so Flax creates no leaf for
        # it and the port has no counterpart.)
        self.pos_embedding = nn.Parameter(torch.empty(max_pos, embedding_dim, device=dev))
        self.decoder_pos_embedding = nn.Parameter(
            torch.empty(sem_id_dim, embedding_dim, device=dev)
        )
        self.in_proj = Dense(embedding_dim, attn_dim, dtype, dev, bias=False)
        self.in_proj_context = Dense(embedding_dim, attn_dim, dtype, dev, bias=False)
        self.transformer = TransformerEncoderDecoder(
            d_model=attn_dim, nhead=num_heads,
            num_encoder_layers=n_layers // 2, num_decoder_layers=n_layers // 2,
            dim_feedforward=dim_feedforward, dropout=dropout, dtype=dtype, device=dev,
            group=group,
        )
        tp = tp_size(group)
        self.output_head = Dense(attn_dim, shard_count(self.padded_vocab_size, tp, "padded vocab"),
                                 dtype, dev, bias=False)
        if tp > 1:
            self.output_head.weight.tp_sharded, self.output_head.weight.tp_dim = True, 0
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
        relative biases N(0, 0.02), norms 1, projections N(0, 1/fan_in).
        Under a group every parameter is drawn at its full shape and this
        rank's block kept. The vocab head and the sem-id table are drawn at
        the natural vocabulary and their ``pad_vocab_to`` rows are zeros
        (inert: masked logits, rows never read), so every tp starts from
        tp = 1's weights."""
        gen = torch.Generator().manual_seed(seed)
        tp, rank = tp_size(self.group), tp_rank(self.group)
        norms = {f"{n}.weight" for n, m in self.named_modules() if isinstance(m, RMSNorm)}
        vocab_rows = ("output_head.weight", "sem_id_embedding.embedding")
        for name, p in self.named_parameters():
            dim = getattr(p, "tp_dim", None)
            shape = list(p.shape)
            if dim is not None:
                shape[dim] *= tp
            padded = shape[0]
            if name in vocab_rows:
                shape[0] = self.vocab_size
            if name in norms:
                w = torch.ones(shape)
            elif name.endswith("rel_bias"):
                w = torch.randn(shape, generator=gen) * 0.02
            elif name.endswith(".weight"):  # nn.Linear, (out, in)
                w = torch.randn(shape, generator=gen) * shape[1] ** -0.5
            else:  # embedding tables and the BOS vector
                w = torch.randn(shape, generator=gen)
            if padded > shape[0]:
                w = torch.cat([w, w.new_zeros((padded - shape[0], *shape[1:]))])
            if dim is not None:
                w = w.narrow(dim, rank * p.shape[dim], p.shape[dim])
            p.copy_(w)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Logits over the whole padded vocabulary: this rank's columns of
        the head, gathered over the group."""
        return gather_from_tp(self.output_head(copy_to_tp(x, self.group)), self.group)

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        if self.padded_vocab_size == self.vocab_size:
            return logits
        live = torch.arange(self.padded_vocab_size, device=logits.device) < self.vocab_size
        return logits.masked_fill(~live, -1e9)

    def _drop(self, x, deterministic: bool, generator):
        return dropout(x, self.dropout, deterministic, generator)

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

    def _decoder_input(self, B: int, target_input_ids, target_token_type_ids):
        """BOS, then the embedded target prefix: (B, 1 + T, E)."""
        bos = self.bos_embedding.to(self.dtype).expand(B, 1, self.embedding_dim)
        if target_input_ids is None or target_input_ids.shape[1] == 0:
            return bos
        tgt = self.sem_id_embedding(target_input_ids, target_token_type_ids)
        return torch.cat([bos, tgt], dim=1)

    def _token_loss(self, logits, target_ids, target_types):
        """Per-token CE of the D target codes (ignore_index -1: vocab id 0
        is a real token here, nothing is masked): (N, D)."""
        target_vocab = target_types * self.num_item_embeddings + target_ids
        per_tok, _ = cross_entropy_with_ignore(logits[:, :-1, :], target_vocab,
                                               ignore_index=-1)
        return per_tok

    # ---- training forwards -------------------------------------------------

    def forward(self, user_input_ids, item_input_ids, token_type_ids, target_input_ids,
                target_token_type_ids, seq_mask, deterministic: bool = True,
                generator=None) -> TigerOutput:
        """Logits (B, T + 1, V) and, with D targets, the loss: the
        per-sequence SUM of token CE, then the batch mean."""
        if seq_mask is None:
            seq_mask = torch.ones_like(item_input_ids)
        B = item_input_ids.shape[0]
        enc, pad = self._encoder_input(user_input_ids, item_input_ids, token_type_ids,
                                       seq_mask)
        dec = self._decoder_input(B, target_input_ids, target_token_type_ids)
        enc = self.in_proj_context(self._drop(self.norm_context(enc), deterministic,
                                              generator))
        dec = self.in_proj(self._drop(self.norm(dec), deterministic, generator))
        out = self.transformer(enc, dec, src_key_padding_mask=pad,
                               memory_key_padding_mask=pad, deterministic=deterministic,
                               generator=generator)
        logits = self._mask_pad_logits(self._head(out))
        loss = None
        if target_input_ids is not None and target_input_ids.shape[1] == self.sem_id_dim:
            per_tok = self._token_loss(logits, target_input_ids, target_token_type_ids)
            loss = global_mean(per_tok.sum(dim=1))
        return TigerOutput(logits=logits, loss=loss)

    def forward_packed(self, item_input_ids, token_type_ids, user_token_ids, user_mask,
                       segment_ids, positions, target_ids, segment_valid,
                       deterministic: bool = True, generator=None) -> TigerPackedOutput:
        """The training forward over PACKED encoder rows (token operands
        (R, L)): each segment is its user token (``user_mask`` marks the
        slot, ``user_token_ids`` holds the id) and its flattened history;
        encoder attention stays inside a segment (-1e9 across) and the
        relative bias reads within-segment ``positions``, so a segment's
        memory equals the unpacked forward's. The decoders stay per example
        ((R * S, D + 1) rows, ``target_ids`` (R, S, D)), each cross-attending
        into its own segment of its row's memory. The loss is the
        per-sequence token-sum CE averaged over the valid segments
        (``segment_valid`` (R, S)): the unpacked batch mean over the same
        examples."""
        R, L = item_input_ids.shape
        item_emb = self.sem_id_embedding(item_input_ids, token_type_ids)
        user_emb = self.user_id_embedding(user_token_ids)
        enc = torch.where(user_mask[..., None] == 1, user_emb, item_emb)
        pad = segment_ids == 0
        cross = segment_ids[:, :, None] != segment_ids[:, None, :]
        seg_mask = torch.where(cross, -1e9, 0.0)[:, None]  # additive (R, 1, L, L)
        enc = self.in_proj_context(self._drop(self.norm_context(enc), deterministic,
                                              generator))
        memory = self.transformer.encoder(enc, attn_mask=seg_mask, key_padding_mask=pad,
                                          deterministic=deterministic, positions=positions,
                                          generator=generator)

        _, S, D = target_ids.shape
        N = R * S
        dev = target_ids.device
        tgt_flat = target_ids.reshape(N, D)
        tgt_types = torch.arange(D, device=dev).expand(N, D)
        dec = self._decoder_input(N, tgt_flat, tgt_types)
        dec = self.in_proj(self._drop(self.norm(dec), deterministic, generator))
        mem = memory.repeat_interleave(S, dim=0)  # (N, L, attn_dim)
        seg_of = torch.arange(1, S + 1, device=dev).repeat(R)
        mem_pad = segment_ids.repeat_interleave(S, dim=0) != seg_of[:, None]
        out = self.transformer.decoder(dec, mem, attn_mask=causal_mask(D + 1, dev),
                                       memory_key_padding_mask=mem_pad,
                                       deterministic=deterministic, generator=generator)
        logits = self._mask_pad_logits(self._head(out))
        seq_loss = self._token_loss(logits, tgt_flat, tgt_types).sum(dim=1).reshape(R, S)
        valid = segment_valid.to(torch.float32)
        loss = (seq_loss * valid).sum() / global_count(valid.sum()).clamp_min(1.0)
        return TigerPackedOutput(per_example_loss=seq_loss, loss=loss,
                                 real_tokens=(segment_ids != 0).sum())

    # ---- generation --------------------------------------------------------

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

    def decode_step(self, memory, memory_pad, tgt_ids, tgt_type):
        """Uncached: float32 logits at the last position of the (possibly
        empty) prefix, the decoder re-run over all of it."""
        dec = self._decoder_input(memory.shape[0], tgt_ids, tgt_type)
        dec = self.in_proj(self.norm(dec))
        out = self.transformer.decoder(dec, memory,
                                       attn_mask=causal_mask(dec.shape[1], memory.device),
                                       memory_key_padding_mask=memory_pad)
        return self._mask_pad_logits(self._head(out))[:, -1, :].to(torch.float32)

    def decode_step_cached(self, last_tok, caches, cross_kvs, memory_pad, step: int):
        """Logits for decode position ``step`` from the PREVIOUS token only
        (None at step 0: BOS), against the per-layer suffix caches:
        last_tok (B, K). Returns (logits (B, K, V) fp32, new_caches)."""
        B = memory_pad.shape[0]
        K = caches[0]["k"].shape[1]
        if last_tok is None:
            x = self.bos_embedding.to(self.dtype).expand(B, K, self.embedding_dim)
        else:
            x = self.sem_id_embedding(last_tok, torch.full_like(last_tok, step - 1))
        x = self.in_proj(self.norm(x))
        x, new_caches = self.transformer.decoder.decode_step(
            x, caches, cross_kvs, memory_key_padding_mask=memory_pad, step=step
        )
        logits = self._mask_pad_logits(self._head(x))
        return logits.to(torch.float32), new_caches

    def decode_tree_paged(self, node_tok, topo, steps, caches, k_pools, v_pools,
                          block_tables, seq_lens):
        """Speculative tree verification: logits for EVERY candidate-tree
        node in one decoder pass (``ops.spec_tree``).

        node_tok (S, N): level-major node inputs, level 0 each beam's last
        committed token (the plain step's input; BOS where the slot is at
        step 0), level l the drafted step-(t + l - 1) candidates. Each
        node's logits come from the ops ``decode_step_paged`` runs at its
        step. Returns (logits (S, N, V) fp32, per-layer (k_new, v_new));
        ``caches`` are read, never written.
        """
        S, N = node_tok.shape
        node_steps = steps[:, None] + topo.on(node_tok.device)["level"][None, :]
        bos = self.bos_embedding.to(self.dtype).expand(S, N, self.embedding_dim)
        tok_type = (node_steps - 1).clamp(0, self.sem_id_dim - 1)
        # A drafted code outside the codebook (only a test's forced draft
        # makes one) is never accepted; clamped, its embedding row exists.
        tok = node_tok.clamp(0, self.num_item_embeddings - 1)
        emb = self.sem_id_embedding(tok, tok_type)
        x = torch.where((node_steps == 0)[..., None], bos, emb)
        x = self.in_proj(self.norm(x))
        x, node_kvs = self.transformer.decoder.decode_tree(
            x, caches, k_pools, v_pools, block_tables, seq_lens, topo, steps
        )
        logits = self._mask_pad_logits(self._head(x))
        return logits.to(torch.float32), node_kvs

    def decode_step_paged(self, last_tok, caches, k_pools, v_pools,
                          block_tables, seq_lens, steps):
        """One decode position for every row at its own step against the
        paged cross-attention K/V. last_tok (S, K); rows with steps == 0
        start from BOS. caches: per-layer {"k", "v"} (S, K, D, H, hd).
        Returns (logits (S, K, V) fp32, new_caches)."""
        S, K = last_tok.shape
        bos = self.bos_embedding.to(self.dtype).expand(S, K, self.embedding_dim)
        tok_type = (steps - 1).clamp(0, self.sem_id_dim - 1)[:, None].expand(S, K)
        emb = self.sem_id_embedding(last_tok, tok_type)
        x = torch.where((steps == 0)[:, None, None], bos, emb)
        x = self.in_proj(self.norm(x))
        x, new_caches = self.transformer.decoder.decode_step_paged(
            x, caches, k_pools, v_pools, block_tables, seq_lens, steps
        )
        logits = self._mask_pad_logits(self._head(x))
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


def init_tiger_paged_state(model: Tiger, n_slots: int, beams: int,
                           draft_hint: bool = False) -> dict:
    """Zeroed slot-major decode state on the model's device. cache_k and
    cache_v stack the per-layer suffix caches on axis 1, in the model's
    dtype. ``draft_hint`` (speculative engines) adds ``logits0`` (float32),
    the slot's step-0 logit window that the prefill computes for the
    drafter."""
    nl = model.n_layers // 2
    H = model.num_heads
    hd = model.attn_dim // H
    D = model.sem_id_dim
    dev = model.device
    state = {
        "beam_seqs": torch.zeros((n_slots, beams, D), dtype=torch.int64, device=dev),
        "beam_logps": torch.zeros((n_slots, beams), dtype=torch.float32, device=dev),
        "prefix_idx": torch.zeros((n_slots, beams), dtype=torch.int64, device=dev),
        "cache_k": torch.zeros((n_slots, nl, beams, D, H, hd), dtype=model.dtype, device=dev),
        "cache_v": torch.zeros((n_slots, nl, beams, D, H, hd), dtype=model.dtype, device=dev),
    }
    if draft_hint:
        state["logits0"] = torch.zeros((n_slots, model.num_item_embeddings), device=dev)
    return state


def _draw_candidates(logp: torch.Tensor, k: int, generator=None) -> torch.Tensor:
    """``k`` candidates a row of (N, V) log-probs: the top k, or with
    ``generator`` the top k of logp + Gumbel noise, which draws k
    categories without replacement from softmax(logp) (the distribution
    of ``torch.multinomial(probs, k)``)."""
    if generator is not None:
        logp = logp + sample_gumbel(logp.shape, generator, device=logp.device)
    return _top_k(logp, k)[1]


def _select_beams(model: Tiger, window, legal, beam_logps, prefix_idx,
                  temperature: float, sample_factor: int, generator=None):
    """One constrained-beam selection from this step's (B * K, K_cb) logit
    window and legal mask: log_softmax of the masked window / T, KK =
    min(K * sample_factor, K_cb) candidates a beam (the top KK, or with
    ``generator`` a Gumbel-top-k draw: sampling without replacement),
    illegal draws at -1e32, accumulated scores deduplicated by full
    sequence (``prefix * K_cb + token``), the top K kept. Returns
    (beam scores, sel_parent, sel_tok), each (B, K)."""
    B, K = beam_logps.shape
    Kcb = model.num_item_embeddings
    KK = min(K * sample_factor, Kcb)
    dev = window.device
    logp = torch.log_softmax(window.masked_fill(~legal, _ILLEGAL) / temperature, dim=-1)
    cand_tok = _draw_candidates(logp, KK, generator)
    cand_logp = torch.gather(logp, 1, cand_tok)
    cand_logp = cand_logp.masked_fill(~torch.gather(legal, 1, cand_tok), _ILLEGAL)

    total = (beam_logps.reshape(B * K, 1) + cand_logp).reshape(B, K * KK)
    toks = cand_tok.reshape(B, K * KK)
    parents = torch.arange(K, device=dev).repeat_interleave(KK)[None].expand(B, K * KK)
    keys = torch.gather(prefix_idx, 1, parents) * Kcb + toks
    top_scores, top_idx = _dedup_top_k(total, keys, K)
    return top_scores, torch.gather(parents, 1, top_idx), torch.gather(toks, 1, top_idx)


def _tiger_beam_update(model: Tiger, trie, logits, beam_seqs, beam_logps,
                       prefix_idx, steps, temperature: float, sample_factor: int):
    """One constrained-beam selection from this step's (S, K, V) logits,
    each row at its own step. Returns (beam_seqs, beam_logps, prefix_idx,
    sel_parent, sel_tok)."""
    S, K, D = beam_seqs.shape
    Kcb = model.num_item_embeddings
    dev = logits.device
    flat = logits.reshape(S * K, -1)
    cols = steps.repeat_interleave(K)[:, None] * Kcb + torch.arange(Kcb, device=dev)
    window = torch.gather(flat, 1, cols)  # per-row vocab window at its own step
    legal = legal_mask_ragged(trie, prefix_idx, steps).reshape(S * K, Kcb)
    top_scores, sel_parent, sel_tok = _select_beams(
        model, window, legal, beam_logps, prefix_idx, temperature, sample_factor)
    new_seqs = torch.gather(beam_seqs, 1, sel_parent[..., None].expand(S, K, D))
    hit = torch.arange(D, device=dev)[None, None, :] == steps[:, None, None]
    new_seqs = torch.where(hit, sel_tok[..., None], new_seqs)
    sel_prefix = torch.gather(prefix_idx, 1, sel_parent)
    new_prefix = advance_ragged(trie, sel_prefix, sel_tok, steps)
    return new_seqs, top_scores, new_prefix, sel_parent, sel_tok


@torch.no_grad()
def tiger_generate(model: Tiger, trie, user_input_ids, item_input_ids, token_type_ids,
                   seq_mask, generator=None, temperature: float = 0.2,
                   n_top_k_candidates: int = 10, sample_factor: int = 6,
                   deterministic: bool = False, use_cache: bool = True
                   ) -> TigerGenerationOutput:
    """Trie-constrained beam search over the model's sem-id steps.

    Each step samples KK = min(K * sample_factor, K_cb) candidates a beam
    WITHOUT replacement from softmax(masked logits / temperature)
    (Gumbel-top-k, the noise from ``generator``), accumulates log-probs,
    dedups by full sequence and keeps the top K; ``deterministic`` drops
    the noise (pure beam search). ``use_cache`` runs the KV-cached
    decode; otherwise the decoder re-runs the prefix over a K-fold copy of
    the memory. ``trie``: a ``DenseTrie``, ``PackedTrie`` or
    ``TensorTrie`` on the model's device."""
    if not deterministic and generator is None:
        raise ValueError("sampled decoding draws its Gumbel noise from a torch.Generator: "
                         "pass generator=, or deterministic=True")
    B = item_input_ids.shape[0]
    K = n_top_k_candidates
    Kcb = model.num_item_embeddings
    D = model.sem_id_dim
    dev = item_input_ids.device
    gen = None if deterministic else generator
    if use_cache:
        cross_kvs, pad = model.encode_for_decode(user_input_ids, item_input_ids,
                                                 token_type_ids, seq_mask)
        caches = init_decode_caches(len(cross_kvs), B, K, D, model.num_heads,
                                    model.attn_dim, model.dtype, device=dev)
    else:
        memory, pad = model.encode_context(user_input_ids, item_input_ids,
                                           token_type_ids, seq_mask)
        Lm = memory.shape[1]
        memory = memory[:, None].expand(B, K, Lm, memory.shape[-1]).reshape(B * K, Lm, -1)
        pad = pad[:, None].expand(B, K, Lm).reshape(B * K, Lm)

    beam_seqs = torch.zeros((B, K, D), dtype=torch.long, device=dev)
    beam_logps = torch.zeros((B, K), dtype=torch.float32, device=dev)
    prefix_idx = torch.zeros((B, K), dtype=torch.long, device=dev)
    for step in range(D):
        if use_cache:
            last_tok = None if step == 0 else beam_seqs[:, :, step - 1]
            logits, caches = model.decode_step_cached(last_tok, caches, cross_kvs, pad, step)
            logits = logits.reshape(B * K, -1)
        else:
            tgt_ids = tgt_type = None
            if step:
                tgt_ids = beam_seqs[:, :, :step].reshape(B * K, step)
                tgt_type = torch.arange(step, device=dev).expand(B * K, step)
            logits = model.decode_step(memory, pad, tgt_ids, tgt_type)
        window = logits[:, step * Kcb:(step + 1) * Kcb]
        legal = trie.legal_mask(prefix_idx.reshape(B * K), step)
        beam_logps, sel_parent, sel_tok = _select_beams(
            model, window, legal, beam_logps, prefix_idx, temperature, sample_factor, gen)
        beam_seqs = torch.gather(beam_seqs, 1, sel_parent[..., None].expand(B, K, D))
        beam_seqs[:, :, step] = sel_tok
        prefix_idx = trie.advance(torch.gather(prefix_idx, 1, sel_parent), sel_tok, step)
        if use_cache:
            caches = gather_beam_caches(caches, sel_parent)
    return TigerGenerationOutput(sem_ids=beam_seqs, log_probas=beam_logps)


@torch.no_grad()
def tiger_paged_decode_step(model: Tiger, trie, state: dict, steps, block_tables,
                            seq_lens, k_pools, v_pools, temperature: float = 0.2,
                            sample_factor: int = 6) -> dict:
    """Advance every slot one constrained-beam position (per-slot steps).

    steps (S,) int64; block_tables (S, Pm) int32; seq_lens (S,) int32;
    pools: one (P, page, H, hd) K and V pool (or QuantizedKVPool) per
    decoder layer. Free slots compute garbage harmlessly: nothing here
    reduces across rows.
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
def tiger_spec_tree_step(model: Tiger, trie, state: dict, steps, block_tables, seq_lens,
                         k_pools, v_pools, fanout=4, depth: int | None = None,
                         temperature: float = 0.2, sample_factor: int = 6,
                         draft_override=None):
    """Speculative tree decode: commit 1 to ``depth + 1`` constrained-beam
    positions a slot in ONE decoder invocation.

    Draft: per beam the top-``fanout`` trie-legal continuations by the
    trie's draft weights (``ops.trie.legal_topk_ragged``; at step 0 the
    top of the prefill's ``logits0`` window where the state has one),
    expanded ``depth`` levels into a static-topology tree. Verify: one
    decoder pass over every node (``Tiger.decode_tree_paged``); level 0
    is the current step's own forward, always exact. Accept: replay the
    plain step's ``_tiger_beam_update`` level by level on the verified
    logits; a level commits only while every selected (parent, token)
    pair was a drafted edge, so the result is the plain step run
    accept-many times, and a drafter that disagrees commits exactly 1.
    Deterministic beams only. ``draft_override`` (tests) replaces the
    drafter's level-l candidate arrays (S, N_{l-1}, F).

    Returns (new_state, accept (S,) int64 codes committed a slot).
    """
    S, K, D = state["beam_seqs"].shape
    dev = state["beam_seqs"].device
    if depth is None:
        depth = D - 1
    depth = max(min(int(depth), D - 1), 0)
    topo = tree_topology(K, fanout, depth)
    caches = [
        {"k": state["cache_k"][:, i], "v": state["cache_v"][:, i]}
        for i in range(state["cache_k"].shape[1])
    ]

    # -- draft the candidate tree (trie gathers only, no model work) ---------
    last_idx = (steps - 1).clamp(0, D - 1)[:, None, None].expand(S, K, 1)
    last_tok = torch.gather(state["beam_seqs"], 2, last_idx)[:, :, 0]
    levels_tok = [last_tok]  # level-0 inputs: the plain step's
    draft_toks = []
    cur_prefix = state["prefix_idx"]  # (S, N_prev), N_0 = K
    for l in range(1, depth + 1):
        step_l = (steps + (l - 1)).clamp_max(D - 1)  # overdeep levels are never accepted
        if draft_override is not None:
            d_tok = torch.as_tensor(draft_override[l - 1], dtype=torch.int64, device=dev)
        else:
            d_tok, _ = legal_topk_ragged(trie, cur_prefix, step_l, topo.fanouts[l - 1])
            if l == 1 and "logits0" in state:
                # At step 0 the root codebook's branching carries no
                # popularity signal: draft the top of the model's own
                # step-0 window, computed at prefill.
                hint = _top_k(state["logits0"], topo.fanouts[0])[1]  # (S, F1)
                d_tok = torch.where((steps == 0)[:, None, None],
                                    hint[:, None, :].expand(d_tok.shape), d_tok)
        draft_toks.append(d_tok)  # (S, N_{l-1}, F)
        levels_tok.append(d_tok.reshape(S, -1))
        cur_prefix = advance_ragged(
            trie, cur_prefix[..., None].expand(d_tok.shape), d_tok, step_l,
        ).reshape(S, -1)
    node_tok = torch.cat(levels_tok, dim=1)  # (S, N)

    # -- verify: one pass over the whole tree ----------------------------------
    logits_all, node_kvs = model.decode_tree_paged(
        node_tok, topo, steps, caches, k_pools, v_pools, block_tables, seq_lens
    )  # (S, N, V), per-layer (k_new, v_new)

    # -- accept scan: replay the plain update along the drafted tree ----------
    run_seqs = com_seqs = state["beam_seqs"]
    run_logps = com_logps = state["beam_logps"]
    run_prefix = com_prefix = state["prefix_idx"]
    run_ck = com_ck = [c["k"] for c in caches]
    run_cv = com_cv = [c["v"] for c in caches]
    cur_local = torch.arange(K, device=dev)[None].expand(S, K)
    ok = torch.ones((S,), dtype=torch.bool, device=dev)
    accept = torch.zeros((S,), dtype=torch.int64, device=dev)
    V = logits_all.shape[-1]
    for j in range(depth + 1):
        applied = ok & (steps + j <= D - 1)  # (S,) per-slot acceptance
        step_j = (steps + j).clamp_max(D - 1)
        flat_idx = int(topo.level_offsets[j]) + cur_local  # (S, K) node ids
        logits_j = torch.gather(logits_all, 1, flat_idx[..., None].expand(S, K, V))
        new_seqs, new_logps, new_prefix, sel_parent, sel_tok = _tiger_beam_update(
            model, trie, logits_j, run_seqs, run_logps, run_prefix, step_j,
            temperature, sample_factor,
        )
        new_ck, new_cv = commit_level_kv(node_kvs, run_ck, run_cv, flat_idx, sel_parent, step_j)
        ap2 = applied[:, None]
        ap5 = applied[:, None, None, None, None]
        com_seqs = torch.where(applied[:, None, None], new_seqs, com_seqs)
        com_logps = torch.where(ap2, new_logps, com_logps)
        com_prefix = torch.where(ap2, new_prefix, com_prefix)
        com_ck = [torch.where(ap5, n, c) for n, c in zip(new_ck, com_ck)]
        com_cv = [torch.where(ap5, n, c) for n, c in zip(new_cv, com_cv)]
        accept = accept + applied.long()
        if j < depth:
            parent_local = torch.gather(cur_local, 1, sel_parent)
            matched, child_f = match_drafted(draft_toks[j], parent_local, sel_tok)
            ok = applied & matched
            cur_local = parent_local * topo.fanouts[j] + child_f
            run_seqs, run_logps, run_prefix = new_seqs, new_logps, new_prefix
            run_ck, run_cv = new_ck, new_cv

    new_state = dict(state)
    new_state.update(
        beam_seqs=com_seqs,
        beam_logps=com_logps,
        prefix_idx=com_prefix,
        cache_k=torch.stack(com_ck, dim=1),
        cache_v=torch.stack(com_cv, dim=1),
    )
    return new_state, accept


@torch.no_grad()
def tiger_prefill_paged(model: Tiger, user_input_ids, item_input_ids,
                        token_type_ids, seq_mask, block_tables, k_pools, v_pools,
                        trie=None, draft_hint: bool = False):
    """Bucketed prefill that writes its cross-attention K/V into the page
    pools (in place). Returns (k_pools, v_pools, seq_lens (B,) int32,
    extras): seq_lens is the valid KV length per row, user token + real
    sem-id tokens, which assumes a CONTIGUOUS valid prefix in seq_mask.
    Rows padded past their page allocation scatter into the null page 0.

    ``draft_hint`` (the speculative engine) also runs the BOS decoder
    position against the fresh encoder memory and returns
    ``extras["logits0"]`` (B, K_cb): the step-0 logit window, trie-masked
    to -inf where ``trie`` is given, which the drafter ranks the first
    speculated level by. It only ranks candidates, so the dense pass's
    float association is harmless."""
    cross_kvs, pad = model.encode_for_decode(
        user_input_ids, item_input_ids, token_type_ids, seq_mask
    )
    seq_lens = (~pad).sum(dim=1).to(torch.int32)
    extras = {}
    if draft_hint:
        B = pad.shape[0]
        caches = init_decode_caches(len(cross_kvs), B, 1, model.sem_id_dim, model.num_heads,
                                    model.attn_dim, model.dtype, device=pad.device)
        logits, _ = model.decode_step_cached(None, caches, cross_kvs, pad, 0)  # (B, 1, V)
        window = logits[:, 0, : model.num_item_embeddings]
        if trie is not None:
            legal = trie.legal_mask(torch.zeros((B,), dtype=torch.long, device=pad.device), 0)
            window = window.masked_fill(~legal, float("-inf"))
        extras["logits0"] = window.to(torch.float32)
    for pool, kv in zip(k_pools, cross_kvs):
        write_pages(pool, block_tables, kv[0])
    for pool, kv in zip(v_pools, cross_kvs):
        write_pages(pool, block_tables, kv[1])
    return k_pools, v_pools, seq_lens, extras


@torch.no_grad()
def tiger_generate_paged(model: Tiger, trie, user_input_ids, item_input_ids,
                         token_type_ids, seq_mask, temperature: float = 0.2,
                         n_top_k_candidates: int = 10, sample_factor: int = 6,
                         page_size: int = 8,
                         kv_dtype: str = "float32") -> TigerGenerationOutput:
    """Deterministic constrained beam search through the paged path:
    prefill into a fresh pool (contiguous block tables), then the decode
    step with every row in lockstep. The offline reference for serving.
    Inputs are tensors on the model's device; seq_mask rows must be
    contiguous valid prefixes (the serving layout). ``kv_dtype="float32"``
    means pools not quantised, in the model's dtype (float32 or bf16, as
    JAX's); ``"int8"`` stores them quantised (``ops.quant.QuantizedKVPool``)."""
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
    shape = (num_pages, page_size, H, hd)
    if kv_dtype == "int8":
        zeros = lambda: QuantizedKVPool.zeros(shape, device=dev)  # noqa: E731
    elif kv_dtype == "float32":
        zeros = lambda: torch.zeros(shape, dtype=model.dtype, device=dev)  # noqa: E731
    else:
        raise ValueError(f"kv_dtype {kv_dtype!r} not supported; choose one of {KV_DTYPES}")
    k_pools = tuple(zeros() for _ in range(nl))
    v_pools = tuple(zeros() for _ in range(nl))
    k_pools, v_pools, seq_lens, _ = tiger_prefill_paged(
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
