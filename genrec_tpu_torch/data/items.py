"""Item-embedding datasets for RQ-VAE training (copy of
genrec_tpu/data/items.py, numpy only: ``train_eval_split``,
``SyntheticItemEmbeddings`` and ``ItemEmbeddingData``).

The text -> embedding preprocessing (``load_item_texts``,
``encode_item_texts``) is not copied: it needs the review files and
sentence-transformers. Training reads the cached
``<root>/processed/<split>_item_emb.npy`` it writes, or the synthetic
clustered generator.
"""

from __future__ import annotations

import os

import numpy as np


def train_eval_split(n: int, eval_frac: float = 0.05, seed: int = 42):
    """Deterministic 95/5 split (same protocol as amazon.py:221-233)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_eval = int(n * eval_frac)
    return perm[n_eval:], perm[:n_eval]


class SyntheticItemEmbeddings:
    """Clustered unit-norm embeddings: k-means-friendly structure so
    RQ-VAE training/collision metrics behave like real data."""

    def __init__(
        self,
        num_items: int = 2000,
        dim: int = 768,
        n_clusters: int = 32,
        noise: float = 0.2,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        centers = rng.normal(size=(n_clusters, dim))
        centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
        assign = rng.integers(0, n_clusters, num_items)
        x = centers[assign] + noise * rng.normal(size=(num_items, dim))
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        self.embeddings = x.astype(np.float32)

    def arrays(self):
        tr, ev = train_eval_split(len(self.embeddings))
        return self.embeddings[tr], self.embeddings[ev]


class ItemEmbeddingData:
    """Cached item embeddings from ``<root>/processed/<split>_item_emb.npy``."""

    def __init__(self, root: str, split: str):
        path = os.path.join(root, "processed", f"{split}_item_emb.npy")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"item embeddings not found at {path}; run "
                f"genrec_tpu.data.items.encode_item_texts first (requires a "
                f"local sentence-T5 model) or provide the file."
            )
        self.embeddings = np.load(path).astype(np.float32)

    def arrays(self):
        tr, ev = train_eval_split(len(self.embeddings))
        return self.embeddings[tr], self.embeddings[ev]

