"""The Amazon data paths, port against the JAX package, on dumps a test
writes itself (no network).

Pairs: genrec_tpu_torch/native (the C++ review parser) and
data/amazon.py (``load_sequences`` through the native parser and through
Python, ``AmazonSASRecData``, ``_maybe_download``), data/items.py
(``load_item_texts``), data/p5_amazon.py, data/lcrec_tasks.py
(``load_lcrec_item_meta``, ``amazon_lcrec_data`` with the fixture HF
tokenizer and with the ``WordTokenizer`` fallback) and data/cobra_seq.py
(``amazon_cobra_data`` with the fixture tokenizer's directory) with their
JAX twins. The dumps are chip_smoke.write_amazon_dump's (SNAP 2014 layout,
seeded numpy) at a few dozen users, plus the JAX tests' pathological
lines. Tolerance: exact; every output is an integer array or text.
"""

import gzip
import json
import os
import shutil
import urllib.error

import numpy as np
import pytest
from transformers import AutoTokenizer

import chip_smoke
from genrec_tpu.data import amazon as jamazon
from genrec_tpu.data import cobra_seq as jcobra
from genrec_tpu.data import items as jitems
from genrec_tpu.data import lcrec_tasks as jlcrec
from genrec_tpu.data import p5_amazon as jp5
from genrec_tpu.native import parse_reviews_native as jparse_native
from genrec_tpu_torch import native
from genrec_tpu_torch.data import amazon, cobra_seq, items, lcrec_tasks, p5_amazon
from genrec_tpu_torch.data.sem_ids import random_unique_sem_ids, save_sem_ids

TOK_DIR = os.path.join(os.path.dirname(__file__), "data", "tiny_hf_tokenizer")
DUMP = dict(users=40, items=30, reviews=260, seed=0, emb_dim=24)


def _dump(path):
    chip_smoke.write_amazon_dump(path, **DUMP)
    return str(path)


def _copies(tmp_path, n):
    """n independent copies of one dump (each keeps its own parse cache)."""
    first = _dump(tmp_path / "root0")
    out = [first]
    for i in range(1, n):
        shutil.copytree(first, tmp_path / f"root{i}")
        out.append(str(tmp_path / f"root{i}"))
    return out


def _cache(root):
    return dict(np.load(os.path.join(root, "processed", "beauty_seqs_min5.npz")))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_load_sequences_matches_jax(tmp_path, monkeypatch, use_native):
    port_root, jax_root = _copies(tmp_path, 2)
    assert native.native_available(), native.build_error()
    if not use_native:  # the Python path, as where the parser cannot build
        monkeypatch.setattr(native, "parse_reviews_native", lambda *a, **k: None)
    seqs, tss, n = amazon.load_sequences(port_root, "beauty", download=False)
    jseqs, jtss, jn = jamazon.load_sequences(jax_root, "beauty", download=False)
    assert n == jn == DUMP["items"] and len(seqs) == len(jseqs) == DUMP["users"]
    for a, b in zip(seqs + tss, jseqs + jtss):
        np.testing.assert_array_equal(a, b)
    got, want = _cache(port_root), _cache(jax_root)
    assert sorted(got) == sorted(want) == ["asins", "items", "lengths", "num_items",
                                           "timestamps"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The cache read back gives the parse; the asins follow the ids.
    again, tss2, n2 = amazon.load_sequences(port_root, "beauty", download=False)
    assert n2 == n and all(np.array_equal(a, b) for a, b in zip(again + tss2, seqs + tss))
    assert amazon.load_item_asins(port_root, "beauty") == jamazon.load_item_asins(jax_root,
                                                                                   "beauty")


def test_native_parser_adversarial_lines_match_python_and_jax(tmp_path):
    """reviewText quoting the timestamp key, an empty asin and a non-object
    line (the JAX test's lines): the port's native parse, the JAX native
    parse and the Python reading agree."""
    gz_path = tmp_path / "adv.json.gz"
    rows = [
        {"reviewerID": "u1", "asin": "a1",
         "reviewText": 'someone wrote "unixReviewTime": 999 in a review',
         "unixReviewTime": 1234},
        {"reviewerID": "u1", "asin": "", "unixReviewTime": 5},
        {"reviewerID": "u2", "asin": "a2", "unixReviewTime": 777},
        {"reviewerID": "u3", "asin": "a1", "unixReviewTime": 778},
    ]
    with gzip.open(gz_path, "wt") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write("not a json object at all\n")
    got = native.parse_reviews_native(str(gz_path))
    want = jparse_native(str(gz_path))
    assert got is not None and want is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    u_idx, i_idx, ts, users, item_names = got
    assert list(ts) == [1234, 777, 778] and users == ["u1", "u2", "u3"]
    assert item_names == ["a1", "a2"] and list(i_idx) == [0, 1, 0]
    py = [(r["reviewerID"], r["asin"], r["unixReviewTime"])
          for r in amazon.parse_gzip_json(str(gz_path)) if r.get("asin")]
    assert [(users[u], item_names[i], t) for u, i, t in zip(u_idx, i_idx, ts)] == py


def _pathological_root(tmp_path):
    """The JAX test's 2014 meta pathologies: python-repr lines, floats,
    nested categories, salesRank dicts, non-ASCII, missing fields, a
    garbage line, an item without meta."""
    root = tmp_path / "amazon"
    raw = root / "raw" / "beauty"
    raw.mkdir(parents=True)
    with gzip.open(raw / "reviews_Beauty_5.json.gz", "wt") as f:
        for u in ("u0", "u1"):
            for t in range(5):
                f.write(json.dumps({"reviewerID": u, "asin": f"a{t}",
                                    "unixReviewTime": t}) + "\n")
    metas = [
        "{'asin': 'a0', 'title': 'Crème brûlée kit — №1', 'price': 12.99, "
        "'salesRank': {'Beauty': 4231}, 'brand': \"L'Or\\u00e9al\", "
        "'categories': [['Beauty', 'Skin Care']]}",
        json.dumps({"asin": "a1", "title": "Plain soap", "categories": [["Beauty"]]}),
        json.dumps({"asin": "a2"}),
        "not parseable at all {{{",
        "{'asin': 'a3', 'title': 'Täglich Öl', 'price': 7.5, "
        "'brand': '', 'categories': [['Beauty', 'Öle', 'Bio']]}",
    ]
    with gzip.open(raw / "meta_Beauty.json.gz", "wt") as f:
        f.write("\n".join(metas) + "\n")
    return root


def test_item_texts_and_lcrec_meta_match_jax_byte_for_byte(tmp_path):
    root = _pathological_root(tmp_path)
    jroot = tmp_path / "jax"
    shutil.copytree(root, jroot)
    amazon.load_sequences(str(root), "beauty", download=False)
    jamazon.load_sequences(str(jroot), "beauty", download=False)
    got = items.load_item_texts(str(root), "beauty")
    want = jitems.load_item_texts(str(jroot), "beauty")
    assert got == want and len(got) == 5
    assert "'price':None" in got[1] and "Täglich Öl" in got[3]
    meta = {"title": "x", "price": 1.5, "categories": [["A", "B"]]}
    assert items.format_item_text(meta) == jitems.format_item_text(meta)
    assert (lcrec_tasks.load_lcrec_item_meta(str(root), "beauty")
            == jlcrec.load_lcrec_item_meta(str(jroot), "beauty"))
    # The generated dump's 2014-style meta too.
    port_root, jax_root = _copies(tmp_path, 2)
    amazon.load_sequences(port_root, "beauty", download=False)
    jamazon.load_sequences(jax_root, "beauty", download=False)
    assert (items.load_item_texts(port_root, "beauty")
            == jitems.load_item_texts(jax_root, "beauty"))
    assert (lcrec_tasks.load_lcrec_item_meta(port_root, "beauty")
            == jlcrec.load_lcrec_item_meta(jax_root, "beauty"))


@pytest.mark.parametrize("with_timestamps", [False, True], ids=["sasrec", "hstu"])
def test_sasrec_data_matches_jax(tmp_path, with_timestamps):
    port_root, jax_root = _copies(tmp_path, 2)
    got = amazon.AmazonSASRecData(port_root, "beauty", max_seq_len=8, download=False,
                                  with_timestamps=with_timestamps)
    want = jamazon.AmazonSASRecData(jax_root, "beauty", max_seq_len=8, download=False,
                                    with_timestamps=with_timestamps)
    assert got.num_items == want.num_items
    ge, we = got.train_examples(), want.train_examples()
    assert len(ge) == len(we) > 0
    for a, b in zip(ge, we):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    pairs = [(got.train_arrays(), want.train_arrays())]
    pairs += [(got.eval_arrays(s), want.eval_arrays(s)) for s in ("valid", "test")]
    for a, b in pairs:
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _patch_retrieve(monkeypatch, fn):
    monkeypatch.setattr(amazon.urllib.request, "urlretrieve", fn)


def test_maybe_download_retries_with_backoff_then_succeeds(tmp_path, monkeypatch):
    dest = str(tmp_path / "raw" / "f.json.gz")
    calls, delays = [], []

    def flaky(url, path):
        calls.append(url)
        with open(path, "wb") as f:
            f.write(b"payload" if len(calls) == 3 else b"trunc")
        if len(calls) < 3:
            raise OSError("connection reset")

    _patch_retrieve(monkeypatch, flaky)
    amazon._maybe_download("http://x/f.json.gz", dest, attempts=3, backoff=0.5,
                           sleep=delays.append)
    assert len(calls) == 3 and delays == [0.5, 1.0]
    assert open(dest, "rb").read() == b"payload" and not os.path.exists(dest + ".part")


def test_maybe_download_cleans_partial_after_final_failure(tmp_path, monkeypatch):
    dest = str(tmp_path / "raw" / "f.json.gz")

    def always_fail(url, path):
        with open(path, "wb") as f:
            f.write(b"trunc")
        raise OSError("no route to host")

    _patch_retrieve(monkeypatch, always_fail)
    with pytest.raises(FileNotFoundError, match="no route to host"):
        amazon._maybe_download("http://x/f.json.gz", dest, attempts=2, backoff=0.1,
                               sleep=lambda s: None)
    assert not os.path.exists(dest) and not os.path.exists(dest + ".part")


def test_maybe_download_leaves_an_existing_destination(tmp_path, monkeypatch):
    dest = str(tmp_path / "f.json.gz")
    with open(dest, "wb") as f:
        f.write(b"cached")

    def boom(url, path):
        raise AssertionError("download attempted despite cached file")

    _patch_retrieve(monkeypatch, boom)
    amazon._maybe_download("http://x/f.json.gz", dest)
    assert open(dest, "rb").read() == b"cached"


def test_maybe_download_fails_fast_on_4xx(tmp_path, monkeypatch):
    dest = str(tmp_path / "raw" / "f.json.gz")
    calls, delays = [], []

    def not_found(url, path):
        calls.append(url)
        raise urllib.error.HTTPError(url, 404, "Not Found", None, None)

    _patch_retrieve(monkeypatch, not_found)
    with pytest.raises(FileNotFoundError, match="404"):
        amazon._maybe_download("http://x/f.json.gz", dest, attempts=3, backoff=0.5,
                               sleep=delays.append)
    assert len(calls) == 1 and delays == []
    assert not os.path.exists(dest) and not os.path.exists(dest + ".part")
    # Neither load_sequences nor a trainer's loader downloads with download=False.
    with pytest.raises(FileNotFoundError):
        amazon.load_sequences(str(tmp_path / "none"), "beauty", download=False)
    with pytest.raises(ValueError, match="unknown split"):
        amazon.load_sequences(str(tmp_path), "nope")


def test_p5_data_matches_jax(tmp_path):
    root = _dump(tmp_path / "amazon")
    amazon.load_sequences(root, "beauty", download=False)
    chip_smoke.write_p5_copy(root, tmp_path / "p5")
    p5 = str(tmp_path / "p5")
    got = p5_amazon.P5AmazonData(p5, "beauty", max_seq_len=4)
    want = jp5.P5AmazonData(p5, "beauty", max_seq_len=4)
    assert got.num_items == want.num_items == DUMP["items"]
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
    for which in ("train", "val", "test"):
        (gh, gt), (wh, wt) = got.split_sequences(which), want.split_sequences(which)
        np.testing.assert_array_equal(gt, wt)
        for a, b in zip(gh, wh):
            np.testing.assert_array_equal(a, b)
    assert got.item_texts() == want.item_texts() and all(got.item_texts())
    for train_only in (None, True, False):
        np.testing.assert_array_equal(got.item_embeddings(train_only),
                                      want.item_embeddings(train_only))
    np.testing.assert_array_equal(p5_amazon.item_train_mask(1000), jp5.item_train_mask(1000))
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for n in (2, 3, 7, 50):
        for _ in range(5):
            np.testing.assert_array_equal(
                p5_amazon.random_crop_subsample(np.arange(n), 8, r1),
                jp5.random_crop_subsample(np.arange(n), 8, r2))


def _sem_ids(tmp_path, n_items, levels=3, K=8):
    path = str(tmp_path / "sem_ids.npz")
    save_sem_ids(path, random_unique_sem_ids(n_items, K, levels, np.random.default_rng(1)), K)
    return path


@pytest.mark.parametrize("tokenizer", ["hf", "word"])
def test_amazon_lcrec_data_matches_jax(tmp_path, tokenizer):
    """Every task's sampled token ids, one task at a time, equal at one
    seed; the eval sets too."""
    port_root, jax_root = _copies(tmp_path, 2)
    amazon.load_sequences(port_root, "beauty", download=False)
    sem = _sem_ids(tmp_path, DUMP["items"])
    for i, task in enumerate(lcrec_tasks.TASKS):
        weights = tuple(float(j == i) for j in range(len(lcrec_tasks.TASKS)))
        tok = lambda: AutoTokenizer.from_pretrained(TOK_DIR) if tokenizer == "hf" else None  # noqa: E731
        data, tok_p = lcrec_tasks.amazon_lcrec_data(port_root, "beauty", sem, tokenizer=tok(),
                                                    max_len=96, seed=0, task_weights=weights)
        jdata, tok_j = jlcrec.amazon_lcrec_data(jax_root, "beauty", sem, tokenizer=tok(),
                                                max_len=96, seed=0, task_weights=weights)
        assert type(tok_p).__name__ == type(tok_j).__name__
        assert (tok_p.base_vocab, tok_p.vocab_size) == (tok_j.base_vocab, tok_j.vocab_size)
        got, want = data.train_arrays(samples_per_user=2), jdata.train_arrays(samples_per_user=2)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{task} {k}")
        assert (got["labels"] >= 0).any(), task
    for split in ("valid", "test"):
        g, w = data.eval_arrays(split), jdata.eval_arrays(split)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{split} {k}")


def test_amazon_cobra_data_matches_jax(tmp_path):
    port_root, jax_root = _copies(tmp_path, 2)
    sem = _sem_ids(tmp_path, DUMP["items"], K=16)
    got = cobra_seq.amazon_cobra_data(port_root, "beauty", sem, tokenizer_name=TOK_DIR,
                                      max_text_len=12, max_items=6)
    want = jcobra.amazon_cobra_data(jax_root, "beauty", sem, tokenizer_name=TOK_DIR,
                                    max_text_len=12, max_items=6)
    assert (got.C, got.id_vocab_size) == (want.C, want.id_vocab_size) == (3, 16)
    np.testing.assert_array_equal(got.sem_ids, want.sem_ids)
    np.testing.assert_array_equal(got.item_texts, want.item_texts)
    assert (got.item_texts != 0).any()
    for a, b in ((got.train_arrays(), want.train_arrays()),
                 (got.eval_arrays("valid"), want.eval_arrays("valid")),
                 (got.eval_arrays("test"), want.eval_arrays("test"))):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="rows"):
        cobra_seq.amazon_cobra_data(port_root, "beauty", _sem_ids(tmp_path, 5),
                                    tokenizer_name=TOK_DIR)
