"""CatalogSnapshot: the item corpus as a versioned, swappable artifact
(port of genrec_tpu/catalog/snapshot.py).

Besides ``item_sem_ids`` (N, D), a snapshot may carry COBRA's dense item
tower: ``item_vecs`` (N, d), precomputed, or ``item_text_tokens`` (N, L),
the tokenised item text the head encodes once per version. ``version`` is
the same content hash as the JAX snapshot's over all three, so the two
packages stamp the same version on the same corpus; ``capacity`` is the
TensorTrie rung the snapshot pads to.

On-disk format, shared with the JAX package (each reads the other's
files): one ``catalog-<version>.npz`` written ATOMICALLY (a tmp file in
the target directory + ``os.replace``), so a watcher never observes a
half-written snapshot under the final name. ``load`` recomputes the
content hash and raises ``CatalogIntegrityError`` when it differs from
the recorded version: the serving watcher (serving/catalog.py)
quarantines such files and keeps serving the previous catalog.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from genrec_tpu_torch.catalog.tensor_trie import TensorTrie
from genrec_tpu_torch.device import resolve_device

#: On-disk snapshot filename prefix/suffix.
FILE_PREFIX = "catalog-"
FILE_SUFFIX = ".npz"


class CatalogIntegrityError(RuntimeError):
    """A snapshot file failed to load or its content hash does not match
    its recorded version — the file is garbled or tampered."""


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
    """Immutable corpus artifact. Build with :meth:`build`, persist with
    :meth:`save`, restore with :meth:`load`."""

    def __init__(self, item_sem_ids: np.ndarray, codebook_size: int,
                 item_vecs: Optional[np.ndarray] = None,
                 item_text_tokens: Optional[np.ndarray] = None,
                 capacity: int = 0, version: str = ""):
        self.item_sem_ids = np.asarray(item_sem_ids, np.int64)
        self.codebook_size = int(codebook_size)
        self.item_vecs = None if item_vecs is None else np.asarray(item_vecs)
        self.item_text_tokens = (None if item_text_tokens is None
                                 else np.asarray(item_text_tokens))
        self.capacity = int(capacity)
        self.version = version
        self._trie: Optional[TensorTrie] = None
        self._device_tries: dict[str, TensorTrie] = {}
        self._device_sem_ids: dict[str, torch.Tensor] = {}
        self._item_index: Optional[dict] = None

    @classmethod
    def build(cls, item_sem_ids: np.ndarray, codebook_size: int,
              item_vecs: Optional[np.ndarray] = None,
              item_text_tokens: Optional[np.ndarray] = None,
              capacity: Optional[int] = None) -> "CatalogSnapshot":
        """Version-stamp a corpus and build its trie at the smallest
        capacity rung covering it (or at ``capacity``)."""
        item_sem_ids = np.asarray(item_sem_ids, np.int64)
        snap = cls(item_sem_ids, codebook_size, item_vecs, item_text_tokens)
        trie = TensorTrie.build(item_sem_ids, codebook_size, capacity=capacity)
        snap.capacity = trie.capacity
        snap._trie = trie
        snap.version = _content_version(item_sem_ids, codebook_size, snap.item_vecs,
                                        snap.item_text_tokens)
        return snap

    @property
    def n_items(self) -> int:
        return int(self.item_sem_ids.shape[0])

    @property
    def depth(self) -> int:
        return int(self.item_sem_ids.shape[1])

    def trie(self) -> TensorTrie:
        """The snapshot's host TensorTrie at its capacity rung (cached)."""
        if self._trie is None:
            self._trie = TensorTrie.build(self.item_sem_ids, self.codebook_size,
                                          capacity=self.capacity)
        return self._trie

    def device_trie(self, device="cuda") -> TensorTrie:
        """The trie's tables on ``device``, uploaded once per device (the
        serving swap path uploads on the staging thread, so the batcher's
        ``set_catalog`` is a pointer read)."""
        key = str(device)
        if key not in self._device_tries:
            self._device_tries[key] = self.trie().to(device)
        return self._device_tries[key]

    def device_item_sem_ids(self, device="cuda") -> torch.Tensor:
        """``item_sem_ids`` as an int64 tensor on ``device`` (cached)."""
        key = str(device)
        if key not in self._device_sem_ids:
            self._device_sem_ids[key] = torch.as_tensor(self.item_sem_ids,
                                                        device=resolve_device(device))
        return self._device_sem_ids[key]

    def item_index(self) -> dict:
        """sem-id tuple -> corpus item id (cached)."""
        if self._item_index is None:
            self._item_index = {
                tuple(int(c) for c in row): i
                for i, row in enumerate(self.item_sem_ids)
            }
        return self._item_index

    # -- atomic on-disk format -----------------------------------------------

    def filename(self) -> str:
        return f"{FILE_PREFIX}{self.version}{FILE_SUFFIX}"

    def save(self, directory: str) -> str:
        """Write ``catalog-<version>.npz`` atomically; returns the path."""
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, self.filename())
        payload = dict(
            item_sem_ids=self.item_sem_ids,
            codebook_size=np.int64(self.codebook_size),
            capacity=np.int64(self.capacity),
            version=np.str_(self.version),
        )
        if self.item_vecs is not None:
            payload["item_vecs"] = self.item_vecs
        if self.item_text_tokens is not None:
            payload["item_text_tokens"] = self.item_text_tokens
        fd, tmp = tempfile.mkstemp(prefix=self.filename() + ".", suffix=".tmp", dir=directory)
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)  # atomic publish under the final name
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return final

    @classmethod
    def load(cls, path: str) -> "CatalogSnapshot":
        """Load + integrity-verify: the recorded version must equal the
        hash recomputed from the loaded arrays."""
        try:
            with np.load(path, allow_pickle=False) as z:
                snap = cls(
                    item_sem_ids=z["item_sem_ids"],
                    codebook_size=int(z["codebook_size"]),
                    item_vecs=z["item_vecs"] if "item_vecs" in z else None,
                    item_text_tokens=z["item_text_tokens"] if "item_text_tokens" in z else None,
                    capacity=int(z["capacity"]),
                    version=str(z["version"]),
                )
        except Exception as e:  # unreadable/truncated/garbled archive
            raise CatalogIntegrityError(f"{path}: unreadable snapshot: {e!r}") from e
        want = _content_version(snap.item_sem_ids, snap.codebook_size, snap.item_vecs,
                                snap.item_text_tokens)
        if snap.version != want:
            raise CatalogIntegrityError(
                f"{path}: content hash {want} != recorded version {snap.version} — "
                "snapshot is garbled")
        if snap.capacity < 1:
            raise CatalogIntegrityError(f"{path}: invalid capacity {snap.capacity}")
        return snap

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"CatalogSnapshot(version={self.version}, n_items={self.n_items}, "
                f"depth={self.depth}, K={self.codebook_size}, "
                f"capacity={self.capacity})")


def list_snapshots(directory: str) -> list[str]:
    """Snapshot files in ``directory``, oldest-mtime first (the watcher
    stages the newest). Non-snapshot files are ignored."""
    if not os.path.isdir(directory):
        return []
    out = [os.path.join(directory, name) for name in os.listdir(directory)
           if name.startswith(FILE_PREFIX) and name.endswith(FILE_SUFFIX)]
    out.sort(key=lambda p: (os.path.getmtime(p), p))
    return out
