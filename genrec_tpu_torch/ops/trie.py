"""Prefix-legality tables for trie-constrained decoding (port of
genrec_tpu/ops/trie.py: ``DenseTrie``, ``PackedTrie``, ``build_trie``,
the per-row-step helpers and ``tuples_are_valid``).

``DenseTrie`` flattens the legal sem-id tuples once into boolean tables,
``tables[t]`` of shape (K^t, K) with entry [p, c] "codeword c may follow
the base-K packed prefix p": the legal mask of a whole beam batch is one
gather on the device (K 256, D 3: 16.8 MB of bool). ``PackedTrie`` keeps
O(N) memory at any depth: a prefix is its RANK among the sorted unique
valid prefixes of its length, step t stores the sorted keys ``rank * K +
code``, and membership is a ``torch.searchsorted``; dead prefixes map to
the sentinel rank ``len(keys[t])``. ``build_trie`` picks the dense tables
while the deepest fits in ``dense_max_bits`` bools.

The tables are built on the host with numpy and held as torch tensors on
``device`` (int64 keys, the index type torch gathers take).
``legal_mask_ragged`` / ``advance_ragged`` (and ``legal_topk_ragged``, the
speculative drafter's expansion) serve rows at different depths in one
call: ``catalog.TensorTrie`` does it with one gather, the two tries
here by computing every depth and selecting per row (depth is 3-4).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from genrec_tpu_torch.device import resolve_device


class DenseTrie:
    """Legality tables for sem-id tuples of depth D over codebook size K."""

    def __init__(self, tables: Sequence[torch.Tensor], codebook_size: int):
        self.tables = list(tables)  # tables[t]: (K^t, K) bool
        self.codebook_size = codebook_size
        self.depth = len(self.tables)

    @classmethod
    def build(cls, valid_ids: np.ndarray, codebook_size: int, device="cuda") -> "DenseTrie":
        """valid_ids: (N, D) int array of legal tuples."""
        valid_ids = np.asarray(valid_ids)
        N, D = valid_ids.shape
        K = codebook_size
        if K**(D - 1) * K > 2**32:
            raise ValueError(
                f"dense trie of depth {D} over {K} codes needs {K**D} bits; "
                "use PackedTrie for deep/wide id spaces"
            )
        dev = resolve_device(device)
        tables = []
        prefix = np.zeros(N, np.int64)
        for t in range(D):
            tab = np.zeros((K**t, K), bool)
            tab[prefix, valid_ids[:, t]] = True
            tables.append(torch.as_tensor(tab, device=dev))
            prefix = prefix * K + valid_ids[:, t]
        return cls(tables, K)

    def legal_mask(self, prefix_idx: torch.Tensor, step: int) -> torch.Tensor:
        """prefix_idx (...) packed base-K prefixes -> (..., K) bool."""
        return self.tables[step][prefix_idx.long()]

    def advance(self, prefix_idx: torch.Tensor, token: torch.Tensor, step: int) -> torch.Tensor:
        """Prefix id after consuming ``token`` at ``step`` (base-K packing;
        illegal tokens land on all-False table rows, i.e. dead prefixes)."""
        del step
        return prefix_idx.long() * self.codebook_size + token.long()


class PackedTrie:
    """Rank-based legality by binary search: O(N) memory at any depth,
    indices < N * K at every depth."""

    def __init__(self, step_keys: Sequence[torch.Tensor], codebook_size: int):
        self.step_keys = list(step_keys)  # step t: sorted unique rank*K+code
        self.codebook_size = codebook_size
        self.depth = len(self.step_keys)

    @classmethod
    def build(cls, valid_ids: np.ndarray, codebook_size: int, device="cuda") -> "PackedTrie":
        valid_ids = np.asarray(valid_ids, np.int64)
        N, D = valid_ids.shape
        K = codebook_size
        if N * K > 2**31 - 1:
            raise ValueError(f"{N} prefixes x {K} codes overflows int32 keys")
        dev = resolve_device(device)
        keys = []
        rank = np.zeros(N, np.int64)
        for t in range(D):
            k = rank * K + valid_ids[:, t]
            uniq = np.unique(k)
            keys.append(torch.as_tensor(uniq, dtype=torch.int64, device=dev))
            rank = np.searchsorted(uniq, k)
        return cls(keys, K)

    def legal_mask(self, prefix_idx: torch.Tensor, step: int) -> torch.Tensor:
        keys = self.step_keys[step]
        cand = prefix_idx.long()[..., None] * self.codebook_size + torch.arange(
            self.codebook_size, device=keys.device)
        pos = torch.searchsorted(keys, cand).clamp_max(keys.shape[0] - 1)
        return keys[pos] == cand

    def advance(self, prefix_idx: torch.Tensor, token: torch.Tensor, step: int) -> torch.Tensor:
        """Rank of the extended prefix among step ``step``'s valid prefixes;
        illegal or dead extensions get the sentinel rank len(keys[step])."""
        keys = self.step_keys[step]
        key = prefix_idx.long() * self.codebook_size + token.long()
        pos = torch.searchsorted(keys, key).clamp_max(keys.shape[0] - 1)
        return torch.where(keys[pos] == key, pos, keys.shape[0])


def build_trie(valid_ids: np.ndarray, codebook_size: int, dense_max_bits: int = 2**28,
               device="cuda"):
    """DenseTrie when the deepest table fits in ``dense_max_bits`` bools,
    else PackedTrie."""
    D = np.asarray(valid_ids).shape[1]
    if codebook_size**D <= dense_max_bits:
        return DenseTrie.build(valid_ids, codebook_size, device)
    return PackedTrie.build(valid_ids, codebook_size, device)


def _clip_prefix(trie, prefix_idx: torch.Tensor, step: int) -> torch.Tensor:
    """Keep prefixes evaluated at a foreign depth inside a dense table's
    rows (their result is computed, never selected)."""
    if isinstance(trie, DenseTrie):
        return prefix_idx.long().clamp_max(trie.tables[step].shape[0] - 1)
    return prefix_idx


def legal_mask_ragged(trie, prefix_idx: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """prefix_idx (S, ...) + steps (S,) -> (S, ..., K) bool legal codes,
    each row at its own depth."""
    own = getattr(trie, "legal_mask_ragged", None)
    if own is not None:
        return own(prefix_idx, steps)
    sel_shape = steps.shape + (1,) * prefix_idx.dim()
    out = None
    for t in range(trie.depth):
        mask_t = trie.legal_mask(_clip_prefix(trie, prefix_idx, t), t)
        out = mask_t if out is None else torch.where((steps == t).reshape(sel_shape), mask_t, out)
    return out


def advance_ragged(trie, prefix_idx: torch.Tensor, token: torch.Tensor,
                   steps: torch.Tensor) -> torch.Tensor:
    """``trie.advance`` with a per-row step operand."""
    own = getattr(trie, "advance_ragged", None)
    if own is not None:
        return own(prefix_idx, token, steps)
    sel_shape = steps.shape + (1,) * (prefix_idx.dim() - 1)
    out = None
    for t in range(trie.depth):
        adv_t = trie.advance(_clip_prefix(trie, prefix_idx, t), token, t)
        out = adv_t if out is None else torch.where((steps == t).reshape(sel_shape), adv_t, out)
    return out


def legal_topk_ragged(trie, prefix_idx: torch.Tensor, steps: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` trie-legal child codes per prefix, each row at its own
    depth: the expansion the speculative drafter (``ops.spec_tree``)
    builds its candidate tree from.

    Ranked by descending draft weight where the trie carries one
    (``catalog.TensorTrie.child_weights_ragged``), ties, and tries without
    weights, by ascending code (a stable sort, as ``jax.lax.top_k``
    breaks ties). prefix_idx (S, ...), steps (S,) -> (tokens (S, ..., k)
    int64, legal (S, ..., k) bool); a prefix with fewer than ``k`` legal
    children pads with illegal codes flagged False.
    """
    legal = legal_mask_ragged(trie, prefix_idx, steps)  # (S, ..., K)
    weigher = getattr(trie, "child_weights_ragged", None)
    score = (weigher(prefix_idx, steps) if weigher is not None
             else torch.zeros(legal.shape, device=legal.device))
    score = score.masked_fill(~legal, float("-inf"))
    tok = torch.sort(-score, dim=-1, stable=True).indices[..., :k]
    return tok, torch.gather(legal, -1, tok)


def tuples_are_valid(trie, seqs: torch.Tensor) -> torch.Tensor:
    """(..., D) sem-id tuples -> (...) bool: is each a complete legal item?
    Walks ``legal_mask`` / ``advance`` from the root, so it serves every
    trie type whatever its prefix representation."""
    if seqs.shape[-1] != trie.depth:
        raise ValueError(f"tuples of depth {seqs.shape[-1]} vs trie depth {trie.depth}")
    flat = seqs.reshape(-1, trie.depth).long()
    prefix = torch.zeros(flat.shape[0], dtype=torch.long, device=flat.device)
    ok = torch.ones(flat.shape[0], dtype=torch.bool, device=flat.device)
    for t in range(trie.depth):
        tok = flat[:, t]
        legal = trie.legal_mask(prefix, t)
        ok = ok & torch.gather(legal, 1, tok[:, None])[:, 0]
        prefix = trie.advance(prefix, tok, t)
    return ok.reshape(seqs.shape[:-1])
