"""Portable semantic-ID artifact: the RQ-VAE -> downstream interface
(copy of genrec_tpu/data/sem_ids.py, numpy arrays on disk; a file written by
either package loads in the other).

The reference couples stages by loading a full RQ-VAE torch checkpoint
inside every downstream Dataset constructor (amazon.py:296-313,
amazon_cobra.py:80-96, amazon_lcrec.py:236-252). Here the trained RQ-VAE
exports one .npz of precomputed ids; TIGER/LCRec/COBRA datasets just read
it — stages stay decoupled and the artifact is framework-agnostic.
"""

from __future__ import annotations

import os

import numpy as np

from genrec_tpu_torch.parallel.mesh import joined_mesh


def save_sem_ids(path: str, sem_ids: np.ndarray, codebook_size: int) -> None:
    """sem_ids: (num_items, sem_id_dim) int array, row i = item id i+1.
    Under a data axis only data rank 0 writes (every rank holds the same
    ids); the other ranks return."""
    mesh = joined_mesh()
    if mesh is not None and not mesh.writer:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        sem_ids=np.asarray(sem_ids, np.int32),
        codebook_size=np.int32(codebook_size),
    )


def load_sem_ids(path: str) -> tuple[np.ndarray, int]:
    z = np.load(path)
    return z["sem_ids"], int(z["codebook_size"])


def random_unique_sem_ids(
    num_items: int, codebook_size: int, dim: int, rng: np.random.Generator
) -> np.ndarray:
    """Distinct random sem-id tuples for the synthetic datasets of TIGER,
    COBRA and LCRec."""
    capacity = codebook_size**dim
    if num_items > capacity:
        raise ValueError(
            f"cannot draw {num_items} distinct tuples from a {codebook_size}^{dim}"
            f"={capacity} id space"
        )
    seen: set[tuple] = set()
    out = np.zeros((num_items, dim), np.int32)
    for i in range(num_items):
        while True:
            t = tuple(rng.integers(0, codebook_size, dim))
            if t not in seen:
                seen.add(t)
                out[i] = t
                break
    return out


def dedup_sem_ids(sem_ids: np.ndarray, codebook_size: int) -> np.ndarray:
    """Append a collision-disambiguation column (0..n within duplicates).

    Optional 4th code as in the reference (amazon.py:323-353, disabled in
    its shipped configs but part of the API surface).
    """
    out = np.zeros((len(sem_ids), sem_ids.shape[1] + 1), sem_ids.dtype)
    out[:, :-1] = sem_ids
    seen: dict[tuple, int] = {}
    for i, row in enumerate(map(tuple, sem_ids)):
        k = seen.get(row, 0)
        out[i, -1] = k
        seen[row] = k + 1
    return out
