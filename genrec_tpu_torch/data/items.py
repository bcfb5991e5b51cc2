"""Item-embedding datasets for RQ-VAE training and the item text (copy of
genrec_tpu/data/items.py, numpy only: ``train_eval_split``,
``SyntheticItemEmbeddings``, ``ItemEmbeddingData``, ``load_item_texts`` and
``format_item_text``).

``encode_item_texts`` (item text -> sentence-T5 embeddings) is not copied:
it needs a sentence-T5 model, which is not in the repository. Training
reads the cached ``<root>/processed/<split>_item_emb.npy`` it writes, or
the synthetic clustered generator.
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


def load_item_texts(root: str, split: str) -> list[str]:
    """Formatted item text per item id (row i -> id i+1), from the persisted
    asin ordering + raw meta — the ONE assembly shared by the embedding
    preprocessing and COBRA's tokenized-text path."""
    from genrec_tpu_torch.data.amazon import DATASET_FILES, load_item_asins, parse_gzip_json

    asins = load_item_asins(root, split)
    meta_path = os.path.join(root, "raw", split, DATASET_FILES[split]["meta"])
    metas = {r.get("asin"): r for r in parse_gzip_json(meta_path) if r.get("asin")}
    return [format_item_text(metas.get(a, {})) for a in asins]


def format_item_text(meta: dict) -> str:
    """Item text template — byte-for-byte the reference's layout
    (amazon.py:199-205): newline-joined, all five keys always present.

    Subtlety: the reference stages ``{'title': meta.get('title'), ...}``
    (amazon.py:181-187) and then formats ``info.get('title', '')`` — the
    key EXISTS with value None, so a missing field renders as the literal
    string ``None`` (and lists/dicts render via str()), not as ''.
    Items absent from the meta dump get NO row at all in the reference
    (it iterates item_info.keys(), silently misaligning embeddings with
    item ids); we instead keep an all-None row so ids stay aligned —
    deliberate deviation, same text shape."""
    info = {
        k: meta.get(k)
        for k in ("title", "price", "salesRank", "brand", "categories")
    }
    return (
        f"'title':{info['title']}\n"
        f" 'price':{info['price']}\n"
        f" 'salesRank':{info['salesRank']}\n"
        f" 'brand':{info['brand']}\n"
        f" 'categories':{info['categories']}"
    )
