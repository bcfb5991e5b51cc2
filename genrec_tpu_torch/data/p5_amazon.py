"""P5-preprocessed Amazon Reviews pipeline (the RQ-VAE trainer's default
data source in the reference; a copy of genrec_tpu/data/p5_amazon.py,
numpy only).

Parity target: reference genrec/data/p5_amazon.py — ``sequential_data.txt``
parsing with 1-based ids remapped to 0-based (:280-311), leave-two-out
splits (train = seq[:-2], val target = seq[-2] with a max_seq_len window,
test target = seq[-1]; -1 padding), item text template
``Title: ..; Brand: ..; Categories: ..; Price: ..;`` (:345-357), seed-42
95/5 item train/eval mask (:365-367), and training-time random-crop
subsampling of sequences (:409-500).

Differences by design: no torch_geometric HeteroData container (plain
npz cache), no Google-Drive download (zero egress — files must exist
locally), and downstream stages read the portable sem-id artifact instead
of loading an RQ-VAE checkpoint in the constructor.
"""

from __future__ import annotations

import json
import os

import numpy as np


def parse_sequential_data(path: str):
    """``sequential_data.txt``: one line per user, "uid item1 item2 ..."
    (1-based ids). Returns (user_ids, sequences 0-based)."""
    user_ids, seqs = [], []
    with open(path) as f:
        for line in f:
            parts = list(map(int, line.split()))
            if len(parts) < 2:
                continue
            user_ids.append(parts[0])
            seqs.append(np.asarray(parts[1:], np.int64) - 1)  # remap to 0-based
    return np.asarray(user_ids, np.int64), seqs


def p5_item_text(meta: dict) -> str:
    """Item sentence template (p5_amazon.py:345-357)."""
    cats = meta.get("categories")
    cat0 = cats[0] if isinstance(cats, list) and cats else cats
    brand = meta.get("brand") or "Unknown"
    return (
        f"Title: {meta.get('title')}; Brand: {brand}; "
        f"Categories: {cat0}; Price: {meta.get('price')}; "
    )


def item_train_mask(n_items: int, seed: int = 42, holdout: float = 0.05):
    """Seed-fixed 95/5 item mask (p5_amazon.py:365-367 uses torch rand;
    deterministic numpy equivalent)."""
    rng = np.random.default_rng(seed)
    return rng.random(n_items) > holdout


class P5AmazonData:
    """Loads a P5-format directory:

        <root>/raw/<split>/sequential_data.txt
        <root>/raw/<split>/datamaps.json      (item2id map)
        <root>/raw/<split>/meta.json.gz       (item metadata)
        <root>/processed/<split>_item_emb.npy (text embeddings, optional)
    """

    def __init__(self, root: str, split: str = "beauty", max_seq_len: int = 20):
        self.root = root
        self.split = split
        self.max_seq_len = max_seq_len
        raw = os.path.join(root, "raw", split)
        seq_path = os.path.join(raw, "sequential_data.txt")
        if not os.path.exists(seq_path):
            raise FileNotFoundError(
                f"{seq_path} not found; this environment has no egress — "
                "place the P5_data files there manually."
            )
        self.user_ids, self.sequences = parse_sequential_data(seq_path)
        self.num_items = 1 + max(int(s.max()) for s in self.sequences)

    # ---- item side (RQ-VAE training) --------------------------------------

    def item_texts(self) -> list[str]:
        from genrec_tpu_torch.data.amazon import parse_gzip_json

        raw = os.path.join(self.root, "raw", self.split)
        with open(os.path.join(raw, "datamaps.json")) as f:
            maps = json.load(f)
        asin2id = {a: int(v) - 1 for a, v in maps["item2id"].items()}
        texts = [""] * self.num_items
        for meta in parse_gzip_json(os.path.join(raw, "meta.json.gz")):
            iid = asin2id.get(meta.get("asin"))
            if iid is not None and 0 <= iid < self.num_items:
                texts[iid] = p5_item_text(meta)
        return texts

    def item_embeddings(self, train_only: bool | None = None) -> np.ndarray:
        """Cached embeddings (rows = 0-based item ids); optionally filtered
        by the seed-42 train mask (P5AmazonReviewsItemDataset semantics)."""
        path = os.path.join(self.root, "processed", f"{self.split}_item_emb.npy")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} missing; encode item_texts() with a sentence-T5 "
                "model first (see data/items.encode_item_texts)."
            )
        emb = np.load(path).astype(np.float32)
        if train_only is None:
            return emb
        mask = item_train_mask(len(emb))
        return emb[mask] if train_only else emb[~mask]

    # ---- sequence side (TIGER training over sem-ids) ----------------------

    def split_sequences(self, which: str = "train"):
        """Leave-two-out protocol with the reference's exact windows.

        train: full seq[:-2] (variable length, for random-crop subsampling)
        val:   window seq[-(L+2):-2], target seq[-2]
        test:  window seq[-(L+1):-1], target seq[-1]
        """
        L = self.max_seq_len
        out_hist, out_tgt = [], []
        for s in self.sequences:
            if which == "train":
                out_hist.append(s[:-2])
                out_tgt.append(int(s[-2]))
            elif which == "val":
                out_hist.append(s[-(L + 2) : -2])
                out_tgt.append(int(s[-2]))
            else:
                out_hist.append(s[-(L + 1) : -1])
                out_tgt.append(int(s[-1]))
        return out_hist, np.asarray(out_tgt, np.int64)


def random_crop_subsample(
    seq: np.ndarray, max_seq_len: int, rng: np.random.Generator
) -> np.ndarray:
    """Training-time subsampling (P5AmazonReviewsSeqDataset:472-477).

    ``seq`` is history + [future item]. Reference semantics reproduced
    exactly: start ~ U[0, len-3], then end ~ U[start+3, start+max_seq_len+1]
    clipped to the sequence — so crop LENGTHS are sampled in
    [3, max_seq_len+1] at random offsets (not always the maximal window).
    The caller splits window[:-1] (inputs) / window[-1] (target).
    """
    n = len(seq)
    if n <= 3:
        return seq
    start = int(rng.integers(0, max(0, n - 3) + 1))
    end = int(rng.integers(start + 3, start + max_seq_len + 2))
    return seq[start : min(end, n)]
