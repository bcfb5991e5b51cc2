"""Per-row-step trie dispatch (port of the ``legal_mask_ragged`` /
``advance_ragged`` helpers of genrec_tpu/ops/trie.py).

The port decodes against ``catalog.TensorTrie`` only, whose uniform
(D, C) key table serves every row at its own depth with one gather. The
JAX package's DenseTrie/PackedTrie select-over-depths path has no
counterpart yet.
"""

from __future__ import annotations

import torch

from genrec_tpu_torch.catalog.tensor_trie import TensorTrie


def _tensor_trie(trie) -> TensorTrie:
    if not isinstance(trie, TensorTrie):
        raise TypeError(f"the port decodes against a TensorTrie, got {type(trie).__name__}")
    return trie


def legal_mask_ragged(trie, prefix_idx: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """prefix_idx (S, ...) + steps (S,) -> (S, ..., K) bool legal codes."""
    return _tensor_trie(trie).legal_mask_ragged(prefix_idx, steps)


def advance_ragged(trie, prefix_idx: torch.Tensor, token: torch.Tensor,
                   steps: torch.Tensor) -> torch.Tensor:
    """Rank of each extended prefix at its row's depth (sentinel C when
    dead)."""
    return _tensor_trie(trie).advance_ragged(prefix_idx, token, steps)
