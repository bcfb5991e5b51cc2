"""Sequence-of-semantic-ids datasets for TIGER (a copy of
genrec_tpu/data/tiger_seq.py; it imports only numpy and the port's own
data modules).

Parity target: reference genrec/data/amazon.py:242-479 (AmazonSeqDataset):
user sequences sorted by timestamp, min length 5; train = sliding window
over seq[:-2], valid target = seq[-2], test target = seq[-1] (:409-442);
each history item flattened into its sem-id tuple with token_type = pos %
sem_id_dim (:459-479). Decoupling change: items are tokenized from the
portable sem-id artifact (data/sem_ids.py) instead of loading an RQ-VAE
torch checkpoint inside the dataset constructor (amazon.py:296-313).
"""

from __future__ import annotations

import numpy as np


class TigerSeqData:
    """Builds fixed-shape arrays from raw item-id sequences + sem-id table.

    sem_ids: (num_items, D) — row i is the tuple for item id i+1.
    """

    def __init__(
        self,
        sequences: list[np.ndarray],
        sem_ids: np.ndarray,
        max_items: int = 20,
        user_hash_size: int = 10_000,
    ):
        self.sequences = sequences
        self.sem_ids = np.asarray(sem_ids, np.int32)
        self.max_items = max_items
        self.D = self.sem_ids.shape[1]
        self.user_hash_size = user_hash_size

    def _flatten_history(self, items: np.ndarray):
        """items (<=max_items,) item ids -> flattened sem ids, items FIRST
        and padding after.

        Matches the reference collate's default padding_side="left" branch,
        which despite its name writes item tokens at positions 0..n-1 with
        padding at the tail (tiger_trainer.py:60-65) — alignment matters
        because the T5 relative-position buckets see absolute distances.
        Returns (input_ids, token_type_ids, seq_mask) of length max_items*D;
        padding positions carry id 0 / type 0 / mask 0 (masked out of
        attention via seq_mask).
        """
        L = self.max_items * self.D
        ids = np.zeros(L, np.int32)
        types = np.zeros(L, np.int32)
        mask = np.zeros(L, np.int32)
        items = items[-self.max_items :]
        n = len(items) * self.D
        ids[:n] = self.sem_ids[items - 1].reshape(-1)
        types[:n] = np.tile(np.arange(self.D), len(items))
        mask[:n] = 1
        return ids, types, mask

    def _samples(self, split: str):
        out_ids, out_types, out_mask, out_user, out_tgt = [], [], [], [], []
        for u, seq in enumerate(self.sequences):
            if split == "train":
                body = seq[:-2]
                if len(body) < 2:
                    continue
                positions = range(1, len(body))
            elif split == "valid":
                if len(seq) < 3:
                    continue
                body = seq[:-1]
                positions = [len(body) - 1]
            else:  # test
                if len(seq) < 3:
                    continue
                body = seq
                positions = [len(body) - 1]
            for i in positions:
                ids, types, mask = self._flatten_history(np.asarray(body[:i]))
                out_ids.append(ids)
                out_types.append(types)
                out_mask.append(mask)
                out_user.append(u % self.user_hash_size)
                out_tgt.append(self.sem_ids[body[i] - 1])
        return {
            "item_input_ids": np.stack(out_ids),
            "token_type_ids": np.stack(out_types),
            "seq_mask": np.stack(out_mask),
            "user_ids": np.asarray(out_user, np.int32),
            "target_ids": np.stack(out_tgt),
        }

    def train_arrays(self):
        return self._samples("train")

    def train_examples(self) -> list[dict]:
        """Raw variable-length train samples for the sequence packer.

        Each example is the ENCODER token stream with the user token
        inline at slot 0 (the packer has no per-segment prepend hook):
        ``user_mask`` marks that slot, ``user_token_ids`` carries the
        hashed user id there, and ``item_input_ids``/``token_type_ids``
        carry the flattened sem-id history after it. ``target_ids`` is a
        per-segment key (one (D,) tuple per example)."""
        out = []
        for u, seq in enumerate(self.sequences):
            body = seq[:-2]
            if len(body) < 2:
                continue
            for i in range(1, len(body)):
                # One copy of the tokenization: _flatten_history, with its
                # padded tail sliced off (the packer owns layout).
                flat_ids, flat_types, flat_mask = self._flatten_history(
                    np.asarray(body[:i])
                )
                n = int(flat_mask.sum())
                ids = np.zeros(1 + n, np.int32)
                types = np.zeros(1 + n, np.int32)
                ids[1:] = flat_ids[:n]
                types[1:] = flat_types[:n]
                user_tok = np.zeros(1 + n, np.int32)
                user_tok[0] = u % self.user_hash_size
                user_mask = np.zeros(1 + n, np.int32)
                user_mask[0] = 1
                out.append({
                    "item_input_ids": ids,
                    "token_type_ids": types,
                    "user_token_ids": user_tok,
                    "user_mask": user_mask,
                    "target_ids": self.sem_ids[body[i] - 1],
                })
        return out

    def eval_arrays(self, split: str = "valid"):
        return self._samples(split)

    def valid_item_sem_ids(self) -> np.ndarray:
        """All items' sem-id tuples — the trie's legality source."""
        return self.sem_ids


def synthetic_tiger_data(
    num_items: int = 200,
    codebook_size: int = 32,
    sem_id_dim: int = 3,
    max_items: int = 10,
    seed: int = 0,
    **seq_kwargs,
):
    """Synthetic sequences + distinct random sem-id tuples (CI path)."""
    from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset

    from genrec_tpu_torch.data.sem_ids import random_unique_sem_ids

    ds = SyntheticSeqDataset(num_items=num_items, seed=seed, **seq_kwargs)
    sem_ids = random_unique_sem_ids(
        num_items, codebook_size, sem_id_dim, np.random.default_rng(seed + 1)
    )
    return TigerSeqData(ds.sequences, sem_ids, max_items=max_items)
