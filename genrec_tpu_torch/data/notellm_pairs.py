"""Synthetic paired-note data for NoteLLM (Query2Embedding) training (a
copy of genrec_tpu/data/notellm_pairs.py over the port's WordTokenizer).

The reference ships NoteLLM as library code with no dataset or trainer
(genrec/models/notellm.py — "no trainer or config in-repo"); this module
supplies the paired-batch protocol its loss expects so the model family
is trainable end to end here: rows interleave (query, positive) where
both texts describe the same underlying note (a shared signature word
plus noise words), and retrieval quality is measurable as paired top-k
accuracy.

Arrays follow the [EMB]-token contract of models/notellm.py: each row is
``words... [EMB] pad...`` with ``emb_idx`` pointing at the [EMB] slot
(the embedding is that token's last hidden state).
"""

from __future__ import annotations

import numpy as np

from genrec_tpu_torch.data.lcrec_tasks import WordTokenizer

_FILLER = [
    "review", "notes", "daily", "quick", "guide", "tips", "best", "ideas",
    "simple", "easy", "top", "new", "real", "full", "mini", "plus",
]


def _note_words(rng: np.random.Generator, topic_word: str, n_words: int):
    fill = rng.choice(_FILLER, size=n_words - 1, replace=True)
    words = [topic_word] + list(fill)
    rng.shuffle(words)
    return words


class NoteLLMPairData:
    """Paired (query, positive) note texts over ``num_topics`` topics.

    Train/eval split is by TOPIC (an eval query's positive is never seen
    in training), mirroring the retrieval framing of the reference's
    paired top-k metric (notellm.py:236-265).
    """

    def __init__(
        self,
        num_topics: int = 64,
        eval_topics: int = 16,
        max_len: int = 12,
        seed: int = 0,
    ):
        self.rng = np.random.default_rng(seed)
        self.max_len = max_len
        topics = [f"topic{i}" for i in range(num_topics + eval_topics)]
        self.tokenizer = WordTokenizer(
            sorted(set(topics) | set(_FILLER)) + ["[EMB]"],
            num_codebooks=0,
            codebook_size=0,
        )
        self.emb_id = self.tokenizer.word_to_id["[EMB]"]
        self.train_topics = topics[:num_topics]
        self.eval_topics = topics[num_topics:]

    def _encode_row(self, words) -> tuple[list[int], int]:
        ids = [self.tokenizer.word_to_id[w] for w in words]
        ids = ids[: self.max_len - 1] + [self.emb_id]
        return ids, len(ids) - 1

    def _pairs(self, topics, pairs_per_topic: int):
        """Arrays with leading dim = PAIRS, shape (P, 2, L): the pair is
        the shuffling/sharding unit (batch_iterator permutes rows, which
        must never split a query from its positive); the trainer
        flattens (B, 2, L) -> (2B, L) interleaved rows for the loss."""
        rows, emb_idx = [], []
        n_words = self.max_len - 3
        for t in topics:
            for _ in range(pairs_per_topic):
                for _side in range(2):
                    ids, e = self._encode_row(_note_words(self.rng, t, n_words))
                    rows.append(ids)
                    emb_idx.append(e)
        L = self.max_len
        out = np.zeros((len(rows), L), np.int32)
        mask = np.zeros((len(rows), L), np.int32)
        for i, ids in enumerate(rows):
            out[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        P = len(rows) // 2
        topic_of = {t: i for i, t in enumerate(
            self.train_topics + self.eval_topics
        )}
        topic_id = np.repeat(
            [topic_of[t] for t in topics], pairs_per_topic
        ).astype(np.int32)
        return {
            "input_ids": out.reshape(P, 2, L),
            "attention_mask": mask.reshape(P, 2, L),
            "emb_idx": np.asarray(emb_idx, np.int32).reshape(P, 2, 1),
            # Per-pair topic label: the loss masks same-topic off-diagonal
            # entries out of the in-batch InfoNCE softmax (two pairs about
            # one note are duplicate positives, not negatives).
            "topic_id": topic_id,
        }

    def train_arrays(self, pairs_per_topic: int = 4):
        return self._pairs(self.train_topics, pairs_per_topic)

    def eval_arrays(self, pairs_per_topic: int = 1):
        return self._pairs(self.eval_topics, pairs_per_topic)
