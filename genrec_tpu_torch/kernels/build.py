"""Build and load the port's CUDA kernel libraries.

Every ``csrc/<name>.cu`` is compiled on its own by nvcc into a shared
library with a plain C interface, ``<repo>/build/genrec_tpu_torch/
lib<name>-<hash>.so``, at first use, and loaded with ctypes. The hash
covers the source, every ``csrc`` header it includes (``#include
"x.cuh"``, followed through the headers' own includes) and the flags, so
an edited kernel or header is rebuilt. The
library is written under a temporary name and renamed into place, so two
processes building at once never load a half-written file. Nothing here
runs when a module is imported.

No ``--use_fast_math``: the HSTU kernels' time buckets come from a
float32 log and a division that must agree with the plain version to the
last ulp.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "genrec_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# Every kernel library of the port, by source stem.
LIBRARIES = ("paged_attention", "hstu_attention", "fused_ce", "rq_cascade", "table_grad")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's kernels "
            "are built from source with the CUDA toolkit"
        )
    return path


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def included_headers(source: Path) -> list[Path]:
    """The headers of ``source``'s directory that it includes, directly or
    through other such headers, in the order first reached."""
    found: list[Path] = []
    todo = [source]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_bytes()):
            path = source.parent / name.decode()
            if path.exists() and path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(name: str) -> Path:
    source = source_path(name)
    digest = hashlib.sha256(source.read_bytes())
    for header in included_headers(source):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_library(name: str, verbose: bool = False) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless this source's build exists.

    Returns (path, seconds spent compiling — 0.0 when it was already
    built, the compiler's output). ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel)."""
    path = library_path(name)
    if path.exists():
        return path, 0.0, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(source_path(name))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path, seconds, proc.stdout + proc.stderr


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built at first call. Its
    ``<name>_error_string(int)`` is typed here; the caller types its
    entry points."""
    path, _, _ = build_library(name)
    lib = ctypes.CDLL(str(path))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def raise_on_error(lib: ctypes.CDLL, name: str, what: str, rc: int) -> None:
    """Raise when a C entry point returned a CUDA error code (its
    ``cudaGetLastError()`` after the launch)."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def launch_context(t) -> tuple[int, int]:
    """(the current CUDA stream of ``t``'s device as an int, the device
    index): the last two arguments of every C entry point."""
    return torch.cuda.current_stream(t.device).cuda_stream, t.device.index


def check_tensor(name: str, t, dtypes, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` whose
    dtype is one of ``dtypes``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
