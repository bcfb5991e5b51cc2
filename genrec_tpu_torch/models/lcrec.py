"""LCRec: an LLM recommender with codebook tokens (port of
genrec_tpu/models/lcrec.py).

``<Cc_k>`` codebook tokens are appended to the vocabulary as contiguous
ranges (token id base + c K + k), so the constrained beam search scores
a static slice of the logits at each of its C steps over one shared KV
cache. The SFT loss masks prompt and pad labels with -100.

Functions take the port's ``QwenLM`` (which holds its parameters, and
its tensor-parallel group or None) where the JAX functions take a Flax
module and a param tree:

- ``extend_vocab`` on a full state dict (``qwen_init_params``), with a
  ``torch.Generator`` for the new rows, before the shards are cut;
- ``sft_loss`` (dense, or fused through B3/B4) on a model without a
  group; ``make_tp_sharded_fused_sft_loss`` for a model with one (B8);
- ``generate_greedy`` and ``generate_topk_constrained`` on either: under
  tensor parallelism every rank gathers the whole vocabulary's logits
  and runs the same search. ``generate_topk_constrained(trie=...)`` keeps
  every beam inside the catalog with any trie of the port
  (``ops.trie.DenseTrie``, ``PackedTrie``, ``catalog.tensor_trie.
  TensorTrie``): a beam's prefix rank follows its parent through
  ``trie.advance`` and each step's codebook slice is masked with
  ``trie.legal_mask``.

Not ported: ``make_sp_sft_loss`` (sequence parallelism with ring
attention; raises, ROADMAP A15).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from genrec_tpu_torch.kernels.fused_ce import fused_ce_mean_loss, sharded_fused_linear_ce
from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM, collect_moe_aux
from genrec_tpu_torch.ops.losses import cross_entropy_with_ignore, mask_vocab_logits
from genrec_tpu_torch.parallel.mesh import global_count


class LCRecGenerationOutput(NamedTuple):
    sem_ids: torch.Tensor  # (B, W, C) codebook indices (not token ids)
    log_probas: torch.Tensor  # (B, W)


def extend_vocab(cfg: QwenConfig, params: dict, num_codebooks: int, codebook_size: int,
                 generator: torch.Generator, base: int | None = None, pad_to: int = 1):
    """Append num_codebooks x codebook_size codebook tokens to the vocab of
    a full state dict: rows [base, base + n) drawn from N(0, 0.02) (the
    embedding's, then the untied head's, from ``generator``), the table
    grown by zero rows to max(V, base + n) rounded up to ``pad_to``.
    Returns (new cfg, new params, base)."""
    n_new = num_codebooks * codebook_size
    base = cfg.vocab_size if base is None else base
    if base > cfg.vocab_size:
        raise ValueError(f"base {base} beyond model vocab {cfg.vocab_size}")
    total = max(cfg.vocab_size, base + n_new)
    total = -(-total // pad_to) * pad_to
    grow = total - cfg.vocab_size
    params = dict(params)

    def extended(table):
        rows = torch.empty((n_new, table.shape[1]), dtype=table.dtype, device=table.device)
        rows.normal_(0.0, 0.02, generator=generator)
        if grow:
            table = torch.cat([table, table.new_zeros((grow, table.shape[1]))], dim=0)
        else:
            table = table.clone()
        table[base:base + n_new] = rows
        return table

    params["embed_tokens.weight"] = extended(params["embed_tokens.weight"])
    if not cfg.tie_word_embeddings:
        params["lm_head"] = extended(params["lm_head"])
    return dataclasses.replace(cfg, vocab_size=total), params, base


def sft_loss(model: QwenLM, input_ids, attention_mask, labels, valid_vocab: int | None = None,
             use_fused_ce: bool = False):
    """Causal-LM CE with -100-masked labels (logits at t predict labels at
    t + 1), mean over the valid labels. ``valid_vocab`` keeps vocab pad
    rows out of the softmax. ``use_fused_ce`` routes the head through the
    fused CE (B3/B4 on the card), over the head's first ``valid_vocab``
    rows. A model with a tensor-parallel group takes
    ``make_tp_sharded_fused_sft_loss`` for the fused CE. A MoE backbone adds
    its layers' router load-balance losses (JAX ``collect_moe_aux``)."""
    aux: list = []
    if use_fused_ce:
        if model.group is not None:
            raise ValueError("a tensor-parallel model takes the vocab-sharded fused CE: "
                             "make_tp_sharded_fused_sft_loss")
        _, h = model(input_ids, attention_mask=attention_mask, return_hidden=True,
                     compute_logits=False, moe_aux=aux)
        w = model.head_weight.to(model.dtype)
        if valid_vocab is not None:
            w = w[:valid_vocab]
        return (fused_ce_mean_loss(h[:, :-1, :], w, labels[:, 1:], ignore_index=-100)
                + collect_moe_aux(aux))
    logits = mask_vocab_logits(model(input_ids, attention_mask=attention_mask, moe_aux=aux),
                               valid_vocab)
    per_tok, valid = cross_entropy_with_ignore(logits[:, :-1, :], labels[:, 1:],
                                               ignore_index=-100)
    return per_tok.sum() / global_count(valid.sum()).clamp_min(1.0) + collect_moe_aux(aux)


def make_tp_sharded_fused_sft_loss(model: QwenLM, valid_vocab: int):
    """``loss_fn(batch) -> loss``: the SFT loss with the head's fused CE
    vocab-sharded over the model's group (B8, ``sharded_fused_linear_ce``).

    The backbone's hidden states are replicated; they enter B8 directly,
    whose backward already sums dx over the group (a second all-reduce on
    the way in would count it twice). With a tied head the embedding's
    shard is both the lookup table and B8's head shard, and its gradient
    is the sum of both uses. A MoE backbone adds its router losses."""
    if model.group is None:
        raise ValueError("make_tp_sharded_fused_sft_loss needs a model with a "
                         "tensor-parallel group")
    d = model.cfg.hidden_size

    def loss_fn(batch):
        aux: list = []
        _, h = model(batch["input_ids"], attention_mask=batch["attention_mask"],
                     return_hidden=True, compute_logits=False, moe_aux=aux)
        t = batch["labels"][:, 1:]
        per_row = sharded_fused_linear_ce(
            h[:, :-1, :].reshape(-1, d), model.head_weight.to(model.dtype), t.reshape(-1),
            model.group, -100, valid_vocab)
        valid = (t.reshape(-1) != -100).to(torch.float32)
        return (per_row.sum() / global_count(valid.sum()).clamp_min(1.0)
                + collect_moe_aux(aux))

    return loss_fn


def make_sp_sft_loss(*args, **kwargs):
    raise NotImplementedError("sequence parallelism (ring attention) is not ported; "
                              "ROADMAP A15 ports it")


def _positions(attention_mask):
    """Left-pad-aware positions (HF convention)."""
    return (torch.cumsum(attention_mask, dim=1) - 1).clamp_min(0)


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among ties (``jax.lax.top_k``'s order)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, order), order


@torch.no_grad()
def generate_greedy(model: QwenLM, input_ids, attention_mask, max_new_tokens: int, eos_id: int,
                    max_cache: int | None = None, valid_vocab: int | None = None):
    """Unconstrained greedy decode over a KV cache; rows that emitted EOS
    keep emitting it. Logits at ids >= ``valid_vocab`` are -inf. Returns
    (B, max_new_tokens) token ids."""
    B, L = input_ids.shape
    S = max_cache or (L + max_new_tokens)
    positions = _positions(attention_mask)
    caches = model.init_cache(B, S)
    pad = torch.cat([attention_mask, attention_mask.new_zeros((B, S - L))], dim=1)
    logits, caches = model.decode_step(input_ids, positions, caches, pad)
    next_pos = positions[:, -1] + 1
    done = torch.zeros(B, dtype=torch.bool, device=input_ids.device)
    slot = torch.arange(S, device=input_ids.device)[None, :]
    toks = []
    for step in range(max_new_tokens):
        logits = logits.to(torch.float32)
        if valid_vocab is not None:
            col = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(col < valid_vocab, logits, -torch.inf)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        tok = torch.where(done, eos_id, tok).to(torch.int32)
        done = done | (tok == eos_id)
        pad = torch.where(slot == caches[0]["idx"], 1, pad).to(pad.dtype)
        logits, caches = model.decode_step(tok[:, None], (next_pos + step)[:, None], caches, pad)
        toks.append(tok)
    return torch.stack(toks, dim=1)


@torch.no_grad()
def generate_topk_constrained(model: QwenLM, input_ids, attention_mask, base_vocab: int,
                              num_codebooks: int, codebook_size: int, beam_width: int = 10,
                              temperature: float = 1.0, max_cache: int | None = None,
                              trie=None) -> LCRecGenerationOutput:
    """Beam search over the codebook-token cascade: the prompt encoded once
    per row, its cache repeated over the beams, then C steps each scoring
    the static slice [base + c K, base + (c + 1) K) of a log-softmax over
    the whole (padded) vocabulary, pad rows included, as the JAX search
    does. With beam_width > codebook_size the first step fills the extra
    beams with -inf.

    ``trie`` (optional) restricts every step to catalog tuples: the root's
    legal mask before step 0's top-k, then each beam's prefix rank
    (``trie.advance``, following its parent) masks the next slice; a dead
    beam carries the trie's sentinel rank, whose mask is all False, so its
    score stays -inf. Ties rank the lower index first, -inf ones too
    (``jax.lax.top_k``'s order), so dead beams match the JAX search's."""
    B, L = input_ids.shape
    W, K, C = beam_width, codebook_size, num_codebooks
    S = max_cache or (L + C)
    dev = input_ids.device
    positions = _positions(attention_mask)
    caches = model.init_cache(B, S)
    pad = torch.cat([attention_mask, attention_mask.new_zeros((B, S - L))], dim=1)
    logits, caches = model.decode_step(input_ids, positions, caches, pad)
    caches = [{"k": c["k"].repeat_interleave(W, dim=0), "v": c["v"].repeat_interleave(W, dim=0),
               "idx": c["idx"]} for c in caches]
    pad_bw = pad.repeat_interleave(W, dim=0)
    next_pos = positions[:, -1] + 1
    slot = torch.arange(S, device=dev)[None, :]
    beam_tokens = torch.zeros((B, W, C), dtype=torch.int64, device=dev)
    beam_scores = None
    for c in range(C):
        lo = base_vocab + c * K
        logp = torch.log_softmax(logits.to(torch.float32) / temperature, dim=-1)
        logp_w = logp[:, lo:lo + K]
        if c == 0:
            if trie is not None:
                root = torch.zeros(B, dtype=torch.int64, device=dev)
                logp_w = torch.where(trie.legal_mask(root, 0), logp_w, -torch.inf)
            W0 = min(W, K)
            scores, toks = _top_k(logp_w, W0)
            if W0 < W:
                scores = torch.cat([scores, scores.new_full((B, W - W0), -torch.inf)], dim=1)
                toks = torch.cat([toks, toks.new_zeros((B, W - W0))], dim=1)
            beam_scores = scores
            beam_tokens[:, :, 0] = toks
            if trie is not None:
                beam_rank = trie.advance(torch.zeros_like(toks), toks, 0)
        else:
            logp_w = logp_w.reshape(B, W, K)
            if trie is not None:
                logp_w = torch.where(trie.legal_mask(beam_rank, c), logp_w, -torch.inf)
            combined = (beam_scores[..., None] + logp_w).reshape(B, W * K)
            beam_scores, idx = _top_k(combined, W)
            parent, tok = idx // K, idx % K
            beam_tokens = beam_tokens.gather(1, parent[..., None].expand(B, W, C)).clone()
            beam_tokens[:, :, c] = tok
            if trie is not None:
                beam_rank = trie.advance(beam_rank.gather(1, parent), tok, c)
            flat_parent = (parent + torch.arange(B, device=dev)[:, None] * W).reshape(B * W)
            caches = [{"k": cc["k"][flat_parent], "v": cc["v"][flat_parent], "idx": cc["idx"]}
                      for cc in caches]
        if c < C - 1:
            tok_ids = (beam_tokens[:, :, c] + lo).reshape(B * W, 1)
            step_pos = (next_pos[:, None] + c).repeat_interleave(W, dim=0).reshape(B * W, 1)
            pad_bw = torch.where(slot == caches[0]["idx"], 1, pad_bw).to(pad_bw.dtype)
            logits, caches = model.decode_step(tok_ids, step_pos, caches, pad_bw)
    return LCRecGenerationOutput(sem_ids=beam_tokens.to(torch.int32), log_probas=beam_scores)
