"""CatalogSnapshot: the item corpus the serving heads decode against (port
of genrec_tpu/catalog/snapshot.py: ``build``, ``item_index``,
``device_trie``; no save/load, no hot swap yet).

``version`` is the same content hash as the JAX snapshot's, so the two
packages stamp the same version on the same corpus.
"""

from __future__ import annotations

import hashlib

import numpy as np

from genrec_tpu_torch.catalog.tensor_trie import TensorTrie


def _content_version(item_sem_ids: np.ndarray, codebook_size: int) -> str:
    h = hashlib.sha256()
    h.update(str(int(codebook_size)).encode())
    h.update(np.ascontiguousarray(item_sem_ids).tobytes())
    for _ in range(2):  # the JAX hash's two absent optional tables
        h.update(b"|")
    return h.hexdigest()[:16]


class CatalogSnapshot:
    """Immutable corpus artifact. Build with :meth:`build`."""

    def __init__(self, item_sem_ids: np.ndarray, codebook_size: int,
                 trie: TensorTrie, version: str):
        self.item_sem_ids = np.asarray(item_sem_ids, np.int64)
        self.codebook_size = int(codebook_size)
        self._trie = trie
        self.version = version
        self._device_tries: dict[str, TensorTrie] = {}
        self._item_index: dict | None = None

    @classmethod
    def build(cls, item_sem_ids: np.ndarray, codebook_size: int,
              capacity: int | None = None) -> "CatalogSnapshot":
        """Version-stamp a corpus and build its trie at the smallest
        capacity rung covering it (or at ``capacity``)."""
        item_sem_ids = np.asarray(item_sem_ids, np.int64)
        trie = TensorTrie.build(item_sem_ids, codebook_size, capacity=capacity)
        return cls(item_sem_ids, codebook_size, trie,
                   _content_version(item_sem_ids, codebook_size))

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
