"""NoteLLM-style Query2Embedding: an LLM as a retrieval embedder (port of
genrec_tpu/models/notellm.py).

A Qwen2 backbone with an appended ``[EMB]`` token whose last hidden state
is the sentence embedding; a contrastive loss over PAIRED batches (rows
0, 2, 4, .. are queries, 1, 3, 5, .. their positives) with a learnable
temperature tau (exp'd), hard-negative down-weighting, an optional
category-generation CE mixed by alpha, and a paired-batch top-k accuracy.

Functions take the port's ``QwenLM`` (which holds its parameters) where
the JAX functions take a Flax module and a param tree. ``NoteLLM`` is the
trainable pair: the backbone and the fp32 scalar ``tau``, so that one
``state_dict`` (and one optimizer) holds both. No Pallas kernel runs on
this path in JAX, so none runs here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM
from genrec_tpu_torch.models.lcrec import _positions, _top_k, extend_vocab
from genrec_tpu_torch.ops.losses import cross_entropy_with_ignore
from genrec_tpu_torch.ops.normalize import l2norm
from genrec_tpu_torch.parallel.mesh import (
    data_gather,
    global_count,
    global_mean,
    step_row_offset,
)


class Query2EmbeddingOutput(NamedTuple):
    sentence_embedding: torch.Tensor  # (B, D) fp32, L2-normalised
    loss: Optional[torch.Tensor]
    cl_loss: Optional[torch.Tensor]
    gen_loss: Optional[torch.Tensor]


class NoteLLM(nn.Module):
    """The backbone and the learnable temperature ``tau`` (a 0-d fp32
    parameter, exp'd in the loss), trained jointly."""

    def __init__(self, backbone: QwenLM, tau_init: float = 3.0):
        super().__init__()
        self.backbone = backbone
        self.tau = nn.Parameter(torch.tensor(float(tau_init), dtype=torch.float32,
                                             device=backbone.norm.weight.device))


def add_emb_token(cfg: QwenConfig, params: dict, generator: torch.Generator):
    """Append the [EMB] special token to a full state dict (the
    resize_token_embeddings equivalent). Returns (new cfg, new params,
    the token's id)."""
    return extend_vocab(cfg, params, 1, 1, generator)


def query2embedding_forward(model: QwenLM, input_ids, attention_mask, emb_token_idx,
                            tau: torch.Tensor, labels=None, hardneg=None, alpha: float = 0.01,
                            hardneg_r: float = 0.1, return_loss: bool = True,
                            pair_groups=None) -> Query2EmbeddingOutput:
    """Sentence embedding + paired contrastive (+ optional generation) loss.

    input_ids rows are interleaved pairs: even rows queries, odd rows
    positives. emb_token_idx (B, 1): the [EMB] position of each row.
    pair_groups (B/2,): a group id per pair; off-diagonal entries of one
    group are masked out of the InfoNCE softmax (duplicate positives are
    not negatives). The head runs only for the generation loss."""
    positions = _positions(attention_mask)
    need_logits = return_loss and labels is not None
    logits, hidden = model(input_ids, attention_mask=attention_mask, positions=positions,
                           return_hidden=True, compute_logits=need_logits)
    B = input_ids.shape[0]
    sent = hidden[torch.arange(B, device=hidden.device), emb_token_idx[:, 0].long()]
    sent = l2norm(sent.to(torch.float32))
    if not return_loss:
        return Query2EmbeddingOutput(sent, None, None, None)

    # In a data-parallel step this rank's queries score against every
    # rank's positives (gathered with a backward that sums their gradient
    # over the data group): the InfoNCE of the global batch, whose pairs
    # lie whole on one rank.
    q, p = sent[::2], data_gather(sent[1::2], grad=True)
    n = q.shape[0]
    rows = torch.arange(n, device=sent.device)
    diag = step_row_offset() + rows  # each query's own positive
    sim = q @ p.T  # (B/2, global pairs), already normalised
    scaled = sim * torch.exp(tau)
    if pair_groups is not None:
        eye = torch.zeros(sim.shape, dtype=torch.bool, device=sim.device)
        eye[rows, diag] = True
        dup = (pair_groups[:, None] == data_gather(pair_groups)[None, :]) & ~eye
        scaled = torch.where(dup, -1e9, scaled)
    neg_logp = torch.logsumexp(scaled, dim=1) - scaled[rows, diag]
    if hardneg is not None:
        # Hard negatives: their CE term becomes the down-weighted
        # mean-similarity penalty log(mean sim + 1) r.
        hard_term = torch.log(sim.mean(dim=1) + 1.0) * hardneg_r
        cl_loss = global_mean(torch.where(hardneg, hard_term, neg_logp))
    else:
        cl_loss = global_mean(neg_logp)

    gen_loss = None
    loss = cl_loss
    if labels is not None:
        per_tok, valid = cross_entropy_with_ignore(logits[:, :-1, :], labels[:, 1:],
                                                   ignore_index=-100)
        n_valid = global_count(valid.sum())
        gen_loss = per_tok.sum() / n_valid.clamp_min(1.0)
        # Fully-masked labels fall back to the pure contrastive loss, not
        # cl_loss / (1 + alpha).
        loss = torch.where(n_valid > 0, (cl_loss + gen_loss * alpha) / (1 + alpha), cl_loss)
    return Query2EmbeddingOutput(sent, loss, cl_loss, gen_loss)


def paired_topk_accuracy(embeddings: torch.Tensor, topk: int = 5) -> float:
    """Top-k retrieval accuracy over interleaved (query, positive) rows: for
    each positive, whether its query is among the k most similar queries
    (the lower index first among ties, as ``jax.lax.top_k``)."""
    q = l2norm(embeddings[::2].to(torch.float32))
    p = l2norm(embeddings[1::2].to(torch.float32))
    sim = q @ p.T
    n = sim.shape[0]
    _, idx = _top_k(sim.T, min(topk, n))
    correct = (idx == torch.arange(n, device=idx.device)[:, None]).any(dim=1)
    return float(correct.to(torch.float32).mean())
