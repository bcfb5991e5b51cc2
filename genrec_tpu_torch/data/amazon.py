"""Amazon Reviews 2014 (5-core) sequence pipeline (a copy of
genrec_tpu/data/amazon.py; numpy and the port's own native parser).

Parity target: reference genrec/data/amazon.py:24-66 (SNAP download,
gzip-json parse, asin->id mapping) and genrec/data/amazon_sasrec.py /
amazon_hstu.py (leave-one-out sample generation, left-pad collate).

Host-side NumPy only: the arrays feed `data.batching.batch_iterator`.
Differences from the reference, by design:
- parsed sequences are cached to an .npz once, so repeat runs skip the
  gzip re-parse the reference does on every trainer start;
- samples are materialized as fixed-shape (N, max_seq_len) int32 arrays
  instead of per-batch dynamic padding.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import urllib.error
import urllib.request

import numpy as np

logger = logging.getLogger(__name__)

SNAP_BASE_URL = "http://snap.stanford.edu/data/amazon/productGraph/categoryFiles"

DATASET_FILES = {
    "beauty": {
        "reviews": "reviews_Beauty_5.json.gz",
        "meta": "meta_Beauty.json.gz",
    },
    "sports": {
        "reviews": "reviews_Sports_and_Outdoors_5.json.gz",
        "meta": "meta_Sports_and_Outdoors.json.gz",
    },
    "toys": {
        "reviews": "reviews_Toys_and_Games_5.json.gz",
        "meta": "meta_Toys_and_Games.json.gz",
    },
    "clothing": {
        "reviews": "reviews_Clothing_Shoes_and_Jewelry_5.json.gz",
        "meta": "meta_Clothing_Shoes_and_Jewelry.json.gz",
    },
}


def parse_gzip_json(path: str):
    """Yield records from a gzipped JSON-lines file (tolerating the
    python-repr lines present in the 2014 dumps)."""
    with gzip.open(path, "rt", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                try:
                    yield eval(line)  # noqa: S307 - 2014 dump quirk
                except Exception:
                    continue


def _maybe_download(
    url: str, dest: str, *, attempts: int = 3, backoff: float = 2.0,
    sleep=None,
) -> None:
    """Download with bounded retry + exponential backoff.

    Writes to ``<dest>.part`` and renames into place only on success, so
    a transient failure can never leave a truncated ``dest`` that poisons
    the next attempt's exists-check; the partial file itself is removed
    after the final failure. ``sleep`` is injectable for tests."""
    if os.path.exists(dest):
        return
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    if sleep is None:
        import time

        sleep = time.sleep
    part = dest + ".part"
    last_err: Exception | None = None
    for attempt in range(attempts):
        if attempt:
            delay = backoff * (2 ** (attempt - 1))
            logger.warning(
                "download attempt %d/%d for %s failed (%s); retrying in %.1fs",
                attempt, attempts, url, last_err, delay,
            )
            sleep(delay)
        logger.info("downloading %s -> %s", url, dest)
        try:
            urllib.request.urlretrieve(url, part)
            os.replace(part, dest)
            return
        except urllib.error.HTTPError as e:
            last_err = e
            if os.path.exists(part):
                os.remove(part)
            if 400 <= e.code < 500:
                # Deterministic client error (bad split name, retired
                # URL): retrying cannot help — fail immediately.
                break
        except Exception as e:
            last_err = e
            if os.path.exists(part):
                os.remove(part)
    raise FileNotFoundError(
        f"Could not download {url} ({last_err}). This environment may have "
        f"no network egress — place the file manually at {dest}."
    ) from last_err


def load_sequences(
    root: str, split: str, min_seq_len: int = 5, download: bool = True
):
    """Build user sequences sorted by timestamp.

    Returns (sequences, timestamps, num_items): lists of int arrays (item
    ids from 1; 0 reserved for padding) and the vocab size. Cached to
    ``<root>/processed/<split>_seqs.npz`` keyed on min_seq_len. A parse
    takes the native streaming parser (genrec_tpu_torch.native) when it
    builds, else the Python path; both assign ids by first appearance and
    give the same arrays.
    """
    split = split.lower()
    if split not in DATASET_FILES:
        raise ValueError(f"unknown split {split!r}; options: {sorted(DATASET_FILES)}")
    cache = os.path.join(root, "processed", f"{split}_seqs_min{min_seq_len}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        flat, lens, ts = z["items"], z["lengths"], z["timestamps"]
        offsets = np.concatenate([[0], np.cumsum(lens)])
        seqs = [flat[offsets[i] : offsets[i + 1]] for i in range(len(lens))]
        tss = [ts[offsets[i] : offsets[i + 1]] for i in range(len(lens))]
        return seqs, tss, int(z["num_items"])

    reviews_path = os.path.join(root, "raw", split, DATASET_FILES[split]["reviews"])
    if not os.path.exists(reviews_path):
        if download:
            _maybe_download(
                f"{SNAP_BASE_URL}/{DATASET_FILES[split]['reviews']}", reviews_path
            )
        else:
            raise FileNotFoundError(reviews_path)

    # Native streaming parser (genrec_tpu_torch.native) when buildable: the
    # same first-appearance id assignment as the Python path below.
    parsed = None
    from genrec_tpu_torch import native

    try:
        parsed = native.parse_reviews_native(reviews_path)  # per-process temp handoff
    except Exception as e:  # a failed native parse: the Python path reads the file
        logger.warning("native parse of %s failed (%s); parsing in Python", reviews_path, e)

    if parsed is not None:
        u_idx, i_idx, ts_arr, _, item_names = parsed
        n_item_ids = len(item_names)
        asins = item_names
        # Vectorized assembly: stable sort by (user, time) keeps file order
        # for ties (== the Python path's stable per-user sort), then split
        # on user boundaries. User indices are first-appearance ordered.
        order = np.lexsort((ts_arr, u_idx))
        u_sorted = np.asarray(u_idx)[order]
        i_sorted = np.asarray(i_idx)[order] + 1  # 0 is padding
        t_sorted = np.asarray(ts_arr)[order]
        bounds = np.flatnonzero(np.diff(u_sorted)) + 1
        seq_list = np.split(i_sorted, bounds)
        ts_list = np.split(t_sorted, bounds)
        seqs = [s for s in seq_list if len(s) >= min_seq_len]
        tss = [t for s, t in zip(seq_list, ts_list) if len(s) >= min_seq_len]
    else:
        item_ids: dict[str, int] = {}
        users_events: dict = {}
        for r in parse_gzip_json(reviews_path):
            asin, uid = r.get("asin"), r.get("reviewerID")
            if not asin or not uid:
                continue
            if asin not in item_ids:
                item_ids[asin] = len(item_ids) + 1  # 0 is padding
            users_events.setdefault(uid, []).append(
                (r.get("unixReviewTime", 0), item_ids[asin])
            )
        n_item_ids = len(item_ids)
        asins = list(item_ids)
        seqs, tss = [], []
        for uid, events in users_events.items():
            events.sort(key=lambda x: x[0])
            if len(events) >= min_seq_len:
                seqs.append(np.asarray([e[1] for e in events], np.int64))
                tss.append(np.asarray([e[0] for e in events], np.int64))

    os.makedirs(os.path.dirname(cache), exist_ok=True)
    np.savez_compressed(
        cache,
        items=np.concatenate(seqs) if seqs else np.zeros(0, np.int64),
        timestamps=np.concatenate(tss) if tss else np.zeros(0, np.int64),
        lengths=np.asarray([len(s) for s in seqs], np.int64),
        num_items=n_item_ids,
        # asin for item id i+1 = asins[i]: persisted so downstream stages
        # (e.g. COBRA's item-text attach) never re-derive the ordering.
        asins=np.asarray(asins),
    )
    logger.info("parsed %d sequences, %d items", len(seqs), n_item_ids)
    return seqs, tss, n_item_ids


def load_item_asins(root: str, split: str, min_seq_len: int = 5) -> list[str]:
    """asin for each item id (row i -> id i+1), from the sequence cache."""
    cache = os.path.join(root, "processed", f"{split}_seqs_min{min_seq_len}.npz")
    if not os.path.exists(cache):
        load_sequences(root, split, min_seq_len, download=False)
    z = np.load(cache)
    if "asins" not in z:
        raise ValueError(f"{cache} predates asin persistence; delete and re-parse")
    return [str(a) for a in z["asins"]]


class AmazonSASRecData:
    """Leave-one-out item-id sequences for SASRec/HSTU.

    Sample protocol mirrors amazon_sasrec.py:84-113: train = sliding window
    over seq[:-2] (one sample per position, targets = shifted history+target);
    valid: history seq[:-2] -> target seq[-2]; test: seq[:-1] -> seq[-1].
    """

    def __init__(
        self,
        root: str = "dataset/amazon",
        split: str = "beauty",
        max_seq_len: int = 50,
        min_seq_len: int = 5,
        download: bool = True,
        with_timestamps: bool = False,
    ):
        self.max_seq_len = max_seq_len
        self.with_timestamps = with_timestamps
        self.sequences, self.timestamps, self.num_items = load_sequences(
            root, split, min_seq_len, download
        )

    def _left_pad(self, seq, dtype=np.int32):
        out = np.zeros(self.max_seq_len, dtype)
        s = np.asarray(seq)[-self.max_seq_len :]
        if len(s):
            out[self.max_seq_len - len(s) :] = s
        return out

    def train_arrays(self) -> dict:
        """Left-padded rows derived from `train_examples` — the single
        copy of the sliding-window sampling protocol."""
        exs = self.train_examples()
        out = {
            "input_ids": np.stack(
                [self._left_pad(e["input_ids"]) for e in exs]
            ).astype(np.int32),
            "targets": np.stack(
                [self._left_pad(e["targets"]) for e in exs]
            ).astype(np.int32),
        }
        if self.with_timestamps:
            out["timestamps"] = np.stack(
                [self._left_pad(e["timestamps"], np.int64) for e in exs]
            )
        return out

    def train_examples(self) -> list[dict]:
        """Raw variable-length train samples for the sequence packer —
        the same sliding-window expansion as `train_arrays` (one sample
        per position, so most are SHORT prefixes), unpadded."""
        L = self.max_seq_len
        out = []
        for seq, ts in zip(self.sequences, self.timestamps):
            body, tbody = seq[:-2], ts[:-2]
            if len(body) < 2:
                continue
            for i in range(1, len(body)):
                hist = body[max(0, i - L): i]
                full = np.append(hist, body[i])
                ex = {
                    "input_ids": full[:-1].astype(np.int32),
                    "targets": full[1:].astype(np.int32),
                }
                if self.with_timestamps:
                    ex["timestamps"] = np.asarray(
                        tbody[max(0, i - L): i], np.int64
                    )
                out.append(ex)
        return out

    def eval_arrays(self, split: str = "valid") -> dict:
        inputs, targets, times = [], [], []
        for seq, ts in zip(self.sequences, self.timestamps):
            if len(seq) < 3:
                continue
            if split == "valid":
                hist, target, thist = seq[:-2], seq[-2], ts[:-2]
            else:
                hist, target, thist = seq[:-1], seq[-1], ts[:-1]
            inputs.append(self._left_pad(hist))
            targets.append(target)
            if self.with_timestamps:
                times.append(self._left_pad(thist, np.int64))
        out = {
            "input_ids": np.stack(inputs).astype(np.int32),
            "targets": np.asarray(targets, np.int32)[:, None],
        }
        if self.with_timestamps:
            out["timestamps"] = np.stack(times)
        return out
