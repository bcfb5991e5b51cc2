"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

``paged_attention_stats_cuda`` launches the hand-written Hopper kernel in
``genrec_tpu_torch/csrc/paged_attention.cu``, which replaces the TPU
kernel ``genrec_tpu/kernels/paged_attention.py::paged_attention_stats_pallas``.
``paged_attention_stats_ref`` is the plain PyTorch version of the same
function (gather, einsum, mask, softmax statistics) — the port of
``genrec_tpu/ops/paged.py::_stats_fallback`` and the numerics contract the
kernel is held to. The CPU takes the plain version (``ops/paged.py``
routes by device); a CUDA tensor goes through the kernel or raises.

The kernel is memory-bound: one call reads ``S*Pm*page*H*hd*2*4`` bytes
of K/V (12.6 MB at the serving shapes S=64, Pm=4, page=16, H=6, hd=64:
3.8 us at 3.35 TB/s). The source's header says what its design does.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into a
shared library with a plain C interface under ``<repo>/build/``, at first
use, loaded with ctypes. The library's file name carries a hash of the
source, so an edited kernel is rebuilt. Nothing here imports or compiles
anything when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

NEG = -1e9

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "genrec_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
MAX_BEAMS = 32
MAX_HEAD_DIM = 128


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the paged-attention "
            "kernel is built from source with the CUDA toolkit"
        )
    return path


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpaged_attention-{digest.hexdigest()[:16]}.so"


def build_library(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernel library unless this source's build exists.

    Returns (path, seconds spent compiling — 0.0 when it was already
    built, the compiler's output). ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel). The library is
    written to a temporary name and renamed, so concurrent builds never
    load a half-written file."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(SOURCE)]
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
def _library() -> ctypes.CDLL:
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    fn = lib.paged_attention_stats_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
    ]
    fn.restype = ctypes.c_int
    lib.paged_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q is on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_attention_stats_cuda(q, k_pool, v_pool, block_tables, seq_lens):
    """Kernel twin of ``paged_attention_stats_ref``: (acc, m, l) fp32.

    q (S, K, H, hd) float32; pools (P, page, H, hd) float32; block_tables
    (S, Pm) int32; seq_lens (S,) int32; all contiguous on one CUDA device,
    K <= 32, hd <= 128. Raises on anything else, and when the build or the
    launch fails (a page too large for a block's shared memory fails the
    launch). Launches on the current stream and does not synchronise.
    ``paged_attention_stats_cuda.launches`` counts the launches.
    """
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        _check(name, t, torch.float32, dev)
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        _check(name, t, torch.int32, dev)
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} and pools {tuple(k_pool.shape)} must be 4-D")
    S, K, H, hd = q.shape
    P, page = k_pool.shape[:2]
    if tuple(k_pool.shape) != (P, page, H, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pools {tuple(k_pool.shape)} / {tuple(v_pool.shape)} do not match "
            f"(P, page, {H}, {hd})"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != S or tuple(seq_lens.shape) != (S,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / seq_lens "
            f"{tuple(seq_lens.shape)} do not match S={S}"
        )
    if P < 1:
        raise ValueError("pools hold no page (page 0 is the null page)")
    if not 1 <= K <= MAX_BEAMS or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"kernel takes 1 <= K <= {MAX_BEAMS}, 1 <= hd <= "
                         f"{MAX_HEAD_DIM}; got K={K}, hd={hd}")
    Pm = block_tables.shape[1]
    acc = torch.empty((S, K, H, hd), dtype=torch.float32, device=dev)
    m = torch.empty((S, K, H), dtype=torch.float32, device=dev)
    l = torch.empty((S, K, H), dtype=torch.float32, device=dev)
    lib = _library()
    rc = lib.paged_attention_stats_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        S, K, H, hd, P, page, Pm, float(hd**-0.5),
        torch.cuda.current_stream(dev).cuda_stream, dev.index,
    )
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention_stats kernel launch failed: {msg} ({rc})")
    paged_attention_stats_cuda.launches += 1
    return acc, m, l


paged_attention_stats_cuda.launches = 0


def paged_attention_stats_ref(q, k_pool, v_pool, block_tables, seq_lens):
    """Plain PyTorch version: gather the slots' pages, score, fill masked
    positions with -1e9, and take the softmax statistics over all Pm*page
    positions. Same shapes and dtypes as the kernel."""
    S, K, H, hd = q.shape
    Pm = block_tables.shape[1]
    page = k_pool.shape[1]
    idx = block_tables.long()
    k = k_pool[idx].reshape(S, Pm * page, H, hd)
    v = v_pool[idx].reshape(S, Pm * page, H, hd)
    s = torch.einsum("skhd,smhd->skhm", q, k).to(torch.float32) * (hd**-0.5)
    tok = torch.arange(Pm * page, device=q.device)
    s = s.masked_fill(tok[None, None, None, :] >= seq_lens.long()[:, None, None, None], NEG)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    acc = torch.einsum("skhm,smhd->skhd", e, v.to(torch.float32))
    return acc, m, l
