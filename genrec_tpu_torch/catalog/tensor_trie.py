"""TensorTrie: the legal-item trie as flat device tensors (port of
genrec_tpu/catalog/tensor_trie.py, the parts constrained decoding uses).

Encoding — a rank-based child table, one row per depth:

- ``keys`` (D, C) — step t's sorted unique ``parent_rank * K + code``
  pairs, padded to the capacity C with ``PAD_KEY`` (int32 max, sorting
  above every real key);
- ``offsets`` (D, C+1) — the CSR row index (node p's children occupy
  ``keys[t, offsets[t, p]:offsets[t, p+1]]``); build-time stats only;
- ``weights`` (D, C) float32 — each node's draft weight, the sum of the
  item weights below it (by default every item weighs 1: the node's
  leaf count), 0 on padding; the speculative drafter ranks legal
  children by it (``child_weights_ragged``, ``ops.trie.
  legal_topk_ragged``).

A prefix is its RANK among the sorted valid prefixes of its length; the
dead-prefix sentinel is C. ``legal_mask`` / ``advance`` (every row at one
depth) and ``legal_mask_ragged`` / ``advance_ragged`` (each row at its own,
through the per-row key row ``keys[steps]``) are batched
``torch.searchsorted`` gathers: no host sync, no Python loop over beams.

``build`` runs on the host in numpy; ``to(device)`` returns the same trie
with its tables as torch tensors (int64, the index type torch gathers
take). The capacity rungs of the JAX trie are kept so both packages build
identical tables from the same catalog.
"""

from __future__ import annotations

import numpy as np
import torch

from genrec_tpu_torch.device import resolve_device

PAD_KEY = np.iinfo(np.int32).max
MIN_CAPACITY = 64
CAPACITY_GROWTH = 4


def capacity_for(n_nodes: int) -> int:
    """The static capacity rung covering ``n_nodes`` trie nodes."""
    c = MIN_CAPACITY
    while c < n_nodes:
        c *= CAPACITY_GROWTH
    return c


class TensorTrie:
    """Flat tensor trie over sem-id tuples of depth D, codebook size K."""

    def __init__(self, keys, offsets, codebook_size: int, weights=None):
        self.keys = keys        # (D, C), per-row sorted, PAD_KEY-padded
        self.offsets = offsets  # (D, C+1) CSR row index
        self.codebook_size = int(codebook_size)
        if weights is None:  # no signal: the drafter ranks by code order
            weights = np.zeros(np.shape(keys), np.float32)
        self.weights = weights  # (D, C) float32, 0 on padding

    @property
    def depth(self) -> int:
        return int(self.keys.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[1])

    @classmethod
    def build(cls, valid_ids: np.ndarray, codebook_size: int,
              capacity: int | None = None,
              item_weights: np.ndarray | None = None) -> "TensorTrie":
        """Flatten (N, D) legal tuples into the padded host encoding.
        ``item_weights`` (N,) scores each tuple (default 1 each); a node's
        draft weight is the sum over the tuples below it."""
        valid_ids = np.asarray(valid_ids, np.int64)
        if valid_ids.ndim != 2 or valid_ids.size == 0:
            raise ValueError(f"need a (N, D) tuple table, got {valid_ids.shape}")
        N, D = valid_ids.shape
        K = int(codebook_size)
        if valid_ids.min() < 0 or valid_ids.max() >= K:
            raise ValueError(f"sem-id codes outside [0, {K})")
        w_items = (np.ones(N, np.float64) if item_weights is None
                   else np.asarray(item_weights, np.float64).reshape(N))
        step_keys, step_weights = [], []
        rank = np.zeros(N, np.int64)
        for t in range(D):
            k = rank * K + valid_ids[:, t]
            uniq = np.unique(k)
            step_keys.append(uniq)
            rank = np.searchsorted(uniq, k)
            step_weights.append(np.bincount(rank, weights=w_items, minlength=len(uniq)))
        n_max = max(len(u) for u in step_keys)
        C = capacity_for(n_max) if capacity is None else int(capacity)
        if C < n_max:
            raise ValueError(f"capacity {C} < {n_max} trie nodes at the widest step")
        if (C + 1) * K > PAD_KEY:
            raise ValueError(
                f"capacity {C} x codebook {K} overflows int32 keys: the largest "
                f"candidate key (C + 1) * K = {(C + 1) * K} exceeds {PAD_KEY}"
            )
        keys = np.full((D, C), PAD_KEY, np.int32)
        offsets = np.zeros((D, C + 1), np.int32)
        weights = np.zeros((D, C), np.float32)
        for t, uniq in enumerate(step_keys):
            keys[t, : len(uniq)] = uniq
            weights[t, : len(uniq)] = step_weights[t]
            offsets[t] = np.searchsorted(uniq, np.arange(C + 1) * K)
        return cls(keys, offsets, K, weights)

    def to(self, device="cuda") -> "TensorTrie":
        """The same trie with its key tables as int64 and its weights as
        float32 torch tensors on ``device``."""
        dev = resolve_device(device)
        return TensorTrie(
            torch.as_tensor(np.asarray(self.keys), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(self.offsets), dtype=torch.int64, device=dev),
            self.codebook_size,
            torch.as_tensor(np.asarray(self.weights), dtype=torch.float32, device=dev),
        )

    # -- the decode-loop interface -------------------------------------------

    def legal_mask(self, prefix_idx: torch.Tensor, step: int) -> torch.Tensor:
        """prefix_idx (...) ranks at depth ``step`` -> (..., K) bool of the
        legal next codes."""
        K = self.codebook_size
        row_keys = self.keys[step]  # (C,)
        cand = prefix_idx.long()[..., None] * K + torch.arange(K, device=row_keys.device)
        pos = torch.searchsorted(row_keys, cand).clamp_max(row_keys.shape[0] - 1)
        return row_keys[pos] == cand

    def advance(self, prefix_idx: torch.Tensor, token: torch.Tensor, step: int) -> torch.Tensor:
        """Rank of each extended prefix at depth ``step``; dead or illegal
        extensions get the sentinel capacity C."""
        row_keys = self.keys[step]
        C = row_keys.shape[0]
        key = prefix_idx.long() * self.codebook_size + token.long()
        pos = torch.searchsorted(row_keys, key).clamp_max(C - 1)
        return torch.where(row_keys[pos] == key, pos, torch.full_like(pos, C))

    def legal_mask_ragged(self, prefix_idx: torch.Tensor,
                          steps: torch.Tensor) -> torch.Tensor:
        """prefix_idx (S, ...) ranks + steps (S,) -> (S, ..., K) bool of
        the legal next codes, each row at its own depth."""
        K = self.codebook_size
        row_keys = self.keys[steps.long()]  # (S, C)
        S = prefix_idx.shape[0]
        cand = prefix_idx.long()[..., None] * K + torch.arange(K, device=row_keys.device)
        flat = cand.reshape(S, -1)
        pos = torch.searchsorted(row_keys, flat).clamp_max(row_keys.shape[1] - 1)
        return (torch.gather(row_keys, 1, pos) == flat).reshape(cand.shape)

    def advance_ragged(self, prefix_idx: torch.Tensor, token: torch.Tensor,
                       steps: torch.Tensor) -> torch.Tensor:
        """Rank of each extended prefix at its row's depth; dead or illegal
        extensions get the sentinel capacity C."""
        row_keys = self.keys[steps.long()]
        C = row_keys.shape[1]
        S = prefix_idx.shape[0]
        key = (prefix_idx.long() * self.codebook_size + token.long()).reshape(S, -1)
        pos = torch.searchsorted(row_keys, key).clamp_max(C - 1)
        hit = torch.gather(row_keys, 1, pos) == key
        return torch.where(hit, pos, torch.full_like(pos, C)).reshape(prefix_idx.shape)

    def child_weights_ragged(self, prefix_idx: torch.Tensor,
                             steps: torch.Tensor) -> torch.Tensor:
        """prefix_idx (S, ...) ranks + steps (S,) -> (S, ..., K) float32:
        the draft weight of each child code where it is legal, 0 where it
        is not, each row at its own depth."""
        K = self.codebook_size
        row_keys = self.keys[steps.long()]  # (S, C)
        row_w = self.weights[steps.long()]  # (S, C)
        S = prefix_idx.shape[0]
        cand = prefix_idx.long()[..., None] * K + torch.arange(K, device=row_keys.device)
        flat = cand.reshape(S, -1)
        pos = torch.searchsorted(row_keys, flat).clamp_max(row_keys.shape[1] - 1)
        hit = torch.gather(row_keys, 1, pos) == flat
        w = torch.where(hit, torch.gather(row_w, 1, pos), torch.zeros((), device=row_w.device))
        return w.reshape(cand.shape)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"TensorTrie(depth={self.depth}, capacity={self.capacity}, "
                f"K={self.codebook_size})")
