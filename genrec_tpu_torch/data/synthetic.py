"""Synthetic sequential-recommendation data for tests and benchmarks
(copy of genrec_tpu/data/synthetic.py; numpy only).

The environment has no network egress, so the Amazon downloads
(amazon.py:24-66) can't run in CI; this generator produces sequences with
learnable structure (popularity skew + first-order Markov transitions) so
trainers demonstrably reduce loss and recall beats chance. Leave-one-out
protocol mirrors the reference: train on seq[:-2] with shifted targets,
valid target = seq[-2], test target = seq[-1] (amazon.py:409-442).
"""

from __future__ import annotations

import numpy as np


class SyntheticSeqDataset:
    def __init__(
        self,
        num_items: int = 200,
        num_users: int = 500,
        max_seq_len: int = 50,
        min_len: int = 5,
        max_len: int = 30,
        seed: int = 0,
    ):
        self.num_items = num_items
        self.max_seq_len = max_seq_len
        rng = np.random.default_rng(seed)

        # Popularity-skewed base distribution + deterministic Markov chain:
        # after item i, with p=0.6 jump to one of 3 fixed successors.
        base_p = rng.dirichlet(np.ones(num_items) * 0.3)
        successors = rng.integers(1, num_items + 1, size=(num_items + 1, 3))

        self.sequences: list[np.ndarray] = []
        for _ in range(num_users):
            length = int(rng.integers(min_len, max_len + 1))
            seq = np.empty(length, np.int64)
            seq[0] = rng.choice(num_items, p=base_p) + 1
            for t in range(1, length):
                if rng.random() < 0.6:
                    seq[t] = successors[seq[t - 1], rng.integers(3)]
                else:
                    seq[t] = rng.choice(num_items, p=base_p) + 1
            self.sequences.append(seq)

        # Fabricated timestamps: ~1 event/day with jitter (for HSTU).
        self.timestamps = [
            np.cumsum(rng.integers(3600, 172800, size=len(s))) + 1_500_000_000
            for s in self.sequences
        ]

    def _left_pad(self, seq: np.ndarray, fill=0) -> np.ndarray:
        out = np.zeros(self.max_seq_len, np.int64)
        s = seq[-self.max_seq_len :]
        out[self.max_seq_len - len(s) :] = s
        return out

    def train_arrays(self) -> dict:
        """input = seq[:-3], target = shifted by one (next-item at each pos).

        Derived from `train_examples` (the single copy of the sampling
        protocol) by left-padding each example into its own row."""
        exs = self.train_examples()
        return {
            "input_ids": np.stack(
                [self._left_pad(e["input_ids"]) for e in exs]
            ).astype(np.int32),
            "targets": np.stack(
                [self._left_pad(e["targets"]) for e in exs]
            ).astype(np.int32),
        }

    def train_examples(self, with_time: bool = False) -> list[dict]:
        """Raw variable-length train examples for the sequence packer
        (data/batching.pack_examples): same (input, shifted-target) samples
        as `train_arrays`, but unpadded — the packer owns layout."""
        out = []
        for seq, ts in zip(self.sequences, self.timestamps):
            body, tbody = seq[:-2], ts[:-2]
            if len(body) < 2:
                continue
            ex = {
                "input_ids": body[:-1][-self.max_seq_len:].astype(np.int32),
                "targets": body[1:][-self.max_seq_len:].astype(np.int32),
            }
            if with_time:
                ex["timestamps"] = tbody[:-1][-self.max_seq_len:].astype(np.int64)
            out.append(ex)
        return out

    def eval_arrays(self, split: str = "valid") -> dict:
        """valid: history=seq[:-2], target=seq[-2]; test: seq[:-1] -> seq[-1]."""
        cut = -2 if split == "valid" else -1
        inputs, targets = [], []
        for seq in self.sequences:
            hist = seq[:cut] if cut == -2 else seq[:-1]
            if len(hist) < 1:
                continue
            inputs.append(self._left_pad(hist))
            targets.append(seq[cut])
        return {
            "input_ids": np.stack(inputs).astype(np.int32),
            "targets": np.asarray(targets, np.int32)[:, None],
        }

    def train_arrays_with_time(self) -> dict:
        exs = self.train_examples(with_time=True)
        return {
            "input_ids": np.stack(
                [self._left_pad(e["input_ids"]) for e in exs]
            ).astype(np.int32),
            "targets": np.stack(
                [self._left_pad(e["targets"]) for e in exs]
            ).astype(np.int32),
            "timestamps": np.stack(
                [self._left_pad(e["timestamps"]) for e in exs]
            ).astype(np.int64),
        }

    def eval_arrays_with_time(self, split: str = "valid") -> dict:
        cut = -2 if split == "valid" else -1
        out_in, out_tgt, out_ts = [], [], []
        for seq, ts in zip(self.sequences, self.timestamps):
            hist = seq[:cut] if cut == -2 else seq[:-1]
            thist = ts[:cut] if cut == -2 else ts[:-1]
            if len(hist) < 1:
                continue
            out_in.append(self._left_pad(hist))
            out_ts.append(self._left_pad(thist))
            out_tgt.append(seq[cut])
        return {
            "input_ids": np.stack(out_in).astype(np.int32),
            "targets": np.asarray(out_tgt, np.int32)[:, None],
            "timestamps": np.stack(out_ts).astype(np.int64),
        }
