"""CatalogSnapshot: the item corpus the serving heads decode against (port
of genrec_tpu/catalog/snapshot.py: ``build``, ``item_index``,
``device_trie``; no save/load, no hot swap yet).

Besides ``item_sem_ids`` (N, D), a snapshot may carry COBRA's dense item
tower: ``item_vecs`` (N, d), precomputed, or ``item_text_tokens`` (N, L),
the tokenised item text the head encodes once per version. ``version`` is
the same content hash as the JAX snapshot's over all three, so the two
packages stamp the same version on the same corpus.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from genrec_tpu_torch.catalog.tensor_trie import TensorTrie


def _content_version(item_sem_ids: np.ndarray, codebook_size: int,
                     item_vecs=None, item_text_tokens=None) -> str:
    h = hashlib.sha256()
    h.update(str(int(codebook_size)).encode())
    h.update(np.ascontiguousarray(item_sem_ids).tobytes())
    for arr in (item_vecs, item_text_tokens):
        h.update(b"|")
        if arr is not None:
            h.update(str(arr.dtype).encode() + str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


class CatalogSnapshot:
    """Immutable corpus artifact. Build with :meth:`build`."""

    def __init__(self, item_sem_ids: np.ndarray, codebook_size: int,
                 trie: TensorTrie, version: str, item_vecs: Optional[np.ndarray] = None,
                 item_text_tokens: Optional[np.ndarray] = None):
        self.item_sem_ids = np.asarray(item_sem_ids, np.int64)
        self.codebook_size = int(codebook_size)
        self.item_vecs = None if item_vecs is None else np.asarray(item_vecs)
        self.item_text_tokens = (None if item_text_tokens is None
                                 else np.asarray(item_text_tokens))
        self._trie = trie
        self.version = version
        self._device_tries: dict[str, TensorTrie] = {}
        self._item_index: dict | None = None

    @classmethod
    def build(cls, item_sem_ids: np.ndarray, codebook_size: int,
              item_vecs: Optional[np.ndarray] = None,
              item_text_tokens: Optional[np.ndarray] = None,
              capacity: int | None = None) -> "CatalogSnapshot":
        """Version-stamp a corpus and build its trie at the smallest
        capacity rung covering it (or at ``capacity``)."""
        item_sem_ids = np.asarray(item_sem_ids, np.int64)
        trie = TensorTrie.build(item_sem_ids, codebook_size, capacity=capacity)
        vecs = None if item_vecs is None else np.asarray(item_vecs)
        text = None if item_text_tokens is None else np.asarray(item_text_tokens)
        return cls(item_sem_ids, codebook_size, trie,
                   _content_version(item_sem_ids, codebook_size, vecs, text), vecs, text)

    @property
    def n_items(self) -> int:
        return int(self.item_sem_ids.shape[0])

    @property
    def depth(self) -> int:
        return int(self.item_sem_ids.shape[1])

    @property
    def capacity(self) -> int:
        return self._trie.capacity

    def device_trie(self, device="cuda") -> TensorTrie:
        """The trie's tables on ``device``, uploaded once per device."""
        key = str(device)
        if key not in self._device_tries:
            self._device_tries[key] = self._trie.to(device)
        return self._device_tries[key]

    def item_index(self) -> dict:
        """sem-id tuple -> corpus item id (cached)."""
        if self._item_index is None:
            self._item_index = {
                tuple(int(c) for c in row): i
                for i, row in enumerate(self.item_sem_ids)
            }
        return self._item_index

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"CatalogSnapshot(version={self.version}, n_items={self.n_items}, "
                f"depth={self.depth}, K={self.codebook_size}, "
                f"capacity={self.capacity})")
