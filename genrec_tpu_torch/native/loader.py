"""ctypes bindings and the on-demand build of the native Amazon parser.

``amazon_parser.cpp`` is compiled by g++ (``-O3 -shared -fPIC ... -lz``)
at first use into ``<repo>/build/genrec_tpu_torch/libamazon_parser-<hash>.so``,
the hash covering the source and the flags, under a temporary name renamed
into place, so that two processes building at once never load a
half-written file and an edited source is rebuilt. Nothing is built when
the module is imported. When the build fails (no g++, no zlib headers) the
error is logged once, kept in ``build_error()``, and ``parse_reviews_native``
returns None: the caller parses in Python, with the same output.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "amazon_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "genrec_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lz",)
_lib = None
_error: str | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libamazon_parser-{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS],
                       check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _error
    if _lib is not None:
        return _lib
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.parse_reviews.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.parse_reviews.restype = ctypes.c_int64
        _lib = lib
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or ""
        _error = f"{type(e).__name__}: {e}" + (f"\n{detail.strip()}" if detail else "")
        logger.warning("native Amazon parser unavailable, parsing in Python: %s", _error)
        _lib = False
    return _lib


def native_available() -> bool:
    return bool(_load())


def build_error() -> str | None:
    """Why the native parser could not be built or loaded (None if it was,
    or if no build was tried yet)."""
    return _error


def parse_reviews_native(gz_path: str, cache_path: str | None = None):
    """Parse a reviews_*.json.gz with the native extractor.

    Returns (user_idx, item_idx, timestamps, user_names, item_names) with
    indices ordered by first appearance, the id assignment of the Python
    path in data/amazon.load_sequences; None when the library is
    unavailable or the parse fails. The handoff file is a per-process
    temporary file by default, so trainers sharing a dataset folder never
    race on it."""
    lib = _load()
    if not lib:
        return None
    own_tmp = cache_path is None
    if own_tmp:
        fd, cache_path = tempfile.mkstemp(suffix=".nativebin")
        os.close(fd)
    try:
        n = lib.parse_reviews(gz_path.encode(), cache_path.encode())
        if n < 0:
            return None
        with open(cache_path, "rb") as f:
            n_rec, n_users, n_items = (int(x) for x in np.fromfile(f, np.int64, 3))
            recs = np.fromfile(f, np.int64, n_rec * 3).reshape(n_rec, 3)
            names = f.read().decode().splitlines()
    finally:
        if own_tmp:
            try:
                os.remove(cache_path)
            except OSError:
                pass
    return (recs[:, 0], recs[:, 1], recs[:, 2], names[:n_users],
            names[n_users:n_users + n_items])
