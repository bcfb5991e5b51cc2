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

Build: ``kernels/build.py`` compiles ``csrc/paged_attention.cu`` with nvcc
for sm_90a into a ctypes library under ``<repo>/build/`` at first use.
Nothing here imports or compiles anything when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from genrec_tpu_torch.kernels.build import (
    check_tensor,
    launch_context,
    load_library,
    raise_on_error,
)

NEG = -1e9
MAX_BEAMS = 32
MAX_HEAD_DIM = 128


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("paged_attention")
    fn = lib.paged_attention_stats_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
    ]
    fn.restype = ctypes.c_int
    return lib


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
        check_tensor(name, t, (torch.float32,), dev)
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        check_tensor(name, t, (torch.int32,), dev)
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
        *launch_context(q),
    )
    raise_on_error(lib, "paged_attention", "paged_attention_stats", rc)
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
