"""COBRA datasets: sequences + per-item tokenized text (a copy of
genrec_tpu/data/cobra_seq.py; numpy and the port's own data modules).

Parity target: reference genrec/data/amazon_cobra.py (one sample per user,
no sliding window :168-209; per-item tokenized text :217-227) and the
trainer collate (cobra_trainer.py:25-88: train appends the target item to
the input so the model supervises every next-item position; eval keeps
history and target separate). Static shapes: fixed max_items and
max_text_len, pad_id = id_vocab_size * C.
"""

from __future__ import annotations

import numpy as np


class CobraSeqData:
    def __init__(
        self,
        sequences: list[np.ndarray],
        sem_ids: np.ndarray,  # (N_items, C), row i = item id i+1
        item_texts: np.ndarray,  # (N_items, Ltxt) token ids, 0 = pad
        id_vocab_size: int,
        max_items: int = 20,
    ):
        self.sequences = sequences
        self.sem_ids = np.asarray(sem_ids, np.int32)
        self.item_texts = np.asarray(item_texts, np.int32)
        self.C = self.sem_ids.shape[1]
        self.id_vocab_size = id_vocab_size
        self.pad_id = id_vocab_size * self.C
        self.max_items = max_items

    def _pack(self, items: np.ndarray, n_slots: int):
        """items -> (flat sem ids padded with pad_id, text tokens padded 0)."""
        C = self.C
        ids = np.full(n_slots * C, self.pad_id, np.int32)
        txt = np.zeros((n_slots, self.item_texts.shape[1]), np.int32)
        items = items[-n_slots:]
        n = len(items)
        ids[: n * C] = self.sem_ids[items - 1].reshape(-1)
        txt[:n] = self.item_texts[items - 1]
        return ids, txt

    def train_arrays(self) -> dict:
        """One sample per user: history+target packed together (train-mode
        collate, cobra_trainer.py:45-67)."""
        n_slots = self.max_items + 1
        out_ids, out_txt = [], []
        for seq in self.sequences:
            if len(seq) < 3:
                continue
            upto = seq[:-2]  # leave valid/test items out
            if len(upto) < 2:
                continue
            ids, txt = self._pack(np.asarray(upto), n_slots)
            out_ids.append(ids)
            out_txt.append(txt)
        return {
            "input_ids": np.stack(out_ids),
            "encoder_input_ids": np.stack(out_txt),
        }

    def eval_arrays(self, split: str = "valid") -> dict:
        out_ids, out_txt, out_tgt = [], [], []
        for seq in self.sequences:
            if len(seq) < 3:
                continue
            hist = seq[:-2] if split == "valid" else seq[:-1]
            target = seq[-2] if split == "valid" else seq[-1]
            if len(hist) < 1:
                continue
            ids, txt = self._pack(np.asarray(hist), self.max_items)
            out_ids.append(ids)
            out_txt.append(txt)
            out_tgt.append(self.sem_ids[target - 1])
        return {
            "input_ids": np.stack(out_ids),
            "encoder_input_ids": np.stack(out_txt),
            "target_sem_ids": np.stack(out_tgt),
        }


def amazon_cobra_data(
    root: str,
    split: str,
    sem_ids_path: str,
    tokenizer_name: str = "sentence-transformers/sentence-t5-base",
    max_text_len: int = 32,
    max_items: int = 20,
):
    """Amazon wiring: sequences + sem-id artifact + HF-tokenized item text
    (reference amazon_cobra.py:217-227). Needs a local HF tokenizer."""
    from transformers import AutoTokenizer

    from genrec_tpu_torch.data.amazon import load_sequences
    from genrec_tpu_torch.data.items import load_item_texts
    from genrec_tpu_torch.data.sem_ids import load_sem_ids

    seqs, _, num_items = load_sequences(root, split)
    sem_ids, codebook_size = load_sem_ids(sem_ids_path)
    if len(sem_ids) != num_items:
        raise ValueError(
            f"sem-id artifact {sem_ids_path} has {len(sem_ids)} rows but the "
            f"{split} split has {num_items} items — artifact from a different "
            "split or a stale parse"
        )
    texts = load_item_texts(root, split)

    tok = AutoTokenizer.from_pretrained(tokenizer_name)
    enc = tok(texts, padding="max_length", truncation=True, max_length=max_text_len)
    item_texts = np.asarray(enc["input_ids"], np.int32)
    return CobraSeqData(seqs, sem_ids, item_texts, codebook_size, max_items=max_items)


def synthetic_cobra_data(
    num_items: int = 120,
    id_vocab_size: int = 16,
    n_codebooks: int = 3,
    text_vocab: int = 50,
    text_len: int = 6,
    max_items: int = 8,
    seed: int = 0,
    **seq_kwargs,
):
    """Synthetic sequences; item text correlates with the item so the dense
    path can learn."""
    from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset

    from genrec_tpu_torch.data.sem_ids import random_unique_sem_ids

    ds = SyntheticSeqDataset(num_items=num_items, seed=seed, **seq_kwargs)
    sem_ids = random_unique_sem_ids(
        num_items, id_vocab_size, n_codebooks, np.random.default_rng(seed + 1)
    )
    # Deterministic item "words" + noise token.
    texts = np.zeros((num_items, text_len), np.int32)
    for i in range(num_items):
        base = 1 + (i * 7) % (text_vocab - 1)
        texts[i] = [(base + j) % (text_vocab - 1) + 1 for j in range(text_len)]
    return CobraSeqData(ds.sequences, sem_ids, texts, id_vocab_size, max_items=max_items)
