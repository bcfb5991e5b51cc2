"""Paged decode attention: the CUDA kernels' wrappers and their plain
versions.

``paged_attention_stats_cuda`` (B1) launches the hand-written Hopper
kernel of ``genrec_tpu_torch/csrc/paged_attention.cu`` over float32 pools
with a float32 q, and hands a bfloat16 q over bfloat16 pools to
``paged_attention_stats_bf16_cuda``, the same kernel over bf16 pages.
``paged_attention_stats_quantized_cuda`` (B2: int8 pools with one fp32
scale per page row, dequantised inside the kernel) takes a float32 q and
hands a bfloat16 one to ``paged_attention_stats_quantized_bf16q_cuda``.
They replace the TPU kernels ``paged_attention_stats_pallas`` and
``paged_attention_stats_pallas_quantized`` of
``genrec_tpu/kernels/paged_attention.py``, whose bodies cast q, K and V to
fp32 after the load and so serve a pool of any float type. Every variant
computes what the Pallas body computes: q, K and V converted exactly to
fp32 (int8 rows times their scale), then fp32 arithmetic.
``paged_attention_stats_ref`` and ``paged_attention_stats_quantized_ref``
are the plain PyTorch versions (gather, upcast — for int8 dequantise —
after the gather, einsum, mask, softmax statistics) and the numerics
contract the kernels are held to. With bf16 inputs that contract is the
Pallas kernel's, not JAX's CPU fallback ``ops/paged.py::_stats_fallback``,
which takes the score einsum in bf16 and so rounds every score to bf16.
The CPU takes the plain versions (``ops/paged.py`` routes by device); a
CUDA tensor goes through a kernel or raises. Each variant counts its own
launches (``.launches`` on its wrapper).

The kernels are memory-bound: a call needs the K/V rows of each slot's
first ``min(seq_len, Pm*page)`` positions (all ``Pm*page`` when
``seq_len <= 0``): at the TIGER serving shapes (S=64, K=10, H=6, hd=64,
page=16, Pm=4) with served histories ~6.5 MB of fp32 K/V (8.5 MB with q
and the outputs: 2.5 us at 3.35 TB/s), ~3.3 MB of bf16 K/V, ~1.6 MB of
int8 rows and scales. The kernels walk only those positions (the rest
weigh exactly 0 once a beam's max is above -1e9 + 128, which the kernel
checks), copying them asynchronously into shared memory; the source's
header says what the design does.

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
MAX_HEAD_DIM = 128


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the entry points of a build of ``csrc/paged_attention.cu``."""
    for name in ("paged_attention_stats_f32", "paged_attention_stats_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
    for name in ("paged_attention_stats_q8", "paged_attention_stats_q8_bf16q"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
    lib.paged_attention_block_smem.argtypes = [ctypes.c_int] * 5
    lib.paged_attention_block_smem.restype = ctypes.c_longlong
    lib.paged_attention_error_string.argtypes = [ctypes.c_int]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(load_library("paged_attention"))


# The page types of csrc/paged_attention.cu's paged_attention_block_smem.
_PAGE_KINDS = {"float32": 0, "int8": 1, "bfloat16": 2}


def block_smem_bytes(beams: int, hd: int, page: int, Pm: int, pages: str) -> int:
    """Dynamic shared memory a block takes at these shapes with ``beams``
    beams a block (``min(K, 32)``: a wider query axis spreads over
    several blocks), for ``pages`` "float32" (B1), "bfloat16" (B1 over
    bf16 pages) or "int8" (B2)."""
    return int(_library().paged_attention_block_smem(beams, hd, page, Pm, _PAGE_KINDS[pages]))


def _check_shapes(q, k_shape, v_shape, block_tables, seq_lens):
    """(S, K, H, hd, P, page, Pm) after the checks both kernels share."""
    if q.dim() != 4 or len(k_shape) != 4:
        raise ValueError(f"q {tuple(q.shape)} and pools {tuple(k_shape)} must be 4-D")
    S, K, H, hd = q.shape
    P, page = k_shape[:2]
    if tuple(k_shape) != (P, page, H, hd) or tuple(v_shape) != tuple(k_shape):
        raise ValueError(
            f"pools {tuple(k_shape)} / {tuple(v_shape)} do not match (P, page, {H}, {hd})"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != S or tuple(seq_lens.shape) != (S,):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / seq_lens "
            f"{tuple(seq_lens.shape)} do not match S={S}"
        )
    if P < 1:
        raise ValueError("pools hold no page (page 0 is the null page)")
    if K < 1 or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"kernel takes K >= 1, 1 <= hd <= {MAX_HEAD_DIM}; "
                         f"got K={K}, hd={hd}")
    return S, K, H, hd, P, page, block_tables.shape[1]


def _outputs(S, K, H, hd, dev):
    return (torch.empty((S, K, H, hd), dtype=torch.float32, device=dev),
            torch.empty((S, K, H), dtype=torch.float32, device=dev),
            torch.empty((S, K, H), dtype=torch.float32, device=dev))


def _b1(q, k_pool, v_pool, block_tables, seq_lens, dtype, entry, wrapper):
    """Check and launch B1 with q and pools of ``dtype`` through the C
    entry point ``entry``; ``wrapper`` counts the launch."""
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        check_tensor(name, t, (dtype,), dev)
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        check_tensor(name, t, (torch.int32,), dev)
    S, K, H, hd, P, page, Pm = _check_shapes(q, k_pool.shape, v_pool.shape, block_tables,
                                             seq_lens)
    acc, m, l = _outputs(S, K, H, hd, dev)
    lib = _library()
    rc = getattr(lib, entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        S, K, H, hd, P, page, Pm, float(hd**-0.5),
        *launch_context(q),
    )
    raise_on_error(lib, "paged_attention", wrapper.__name__, rc)
    wrapper.launches += 1
    return acc, m, l


def paged_attention_stats_cuda(q, k_pool, v_pool, block_tables, seq_lens):
    """Kernel twin of ``paged_attention_stats_ref``: (acc, m, l) fp32.

    q (S, K, H, hd) and pools (P, page, H, hd) all float32, or all
    bfloat16 (handed to ``paged_attention_stats_bf16_cuda``, which counts
    those launches); block_tables (S, Pm) int32; seq_lens (S,) int32; all
    contiguous on one CUDA device, any K >= 1 (beams, or a speculative
    tree's nodes: a block takes 32 of them, more spread over blocks), hd
    <= 128, any page size and Pm. Raises on anything else, and when the
    build or the launch fails. Launches on the current stream and does not
    synchronise.
    ``paged_attention_stats_cuda.launches`` counts the float32 launches.
    """
    if q.dtype == torch.bfloat16:
        return paged_attention_stats_bf16_cuda(q, k_pool, v_pool, block_tables, seq_lens)
    return _b1(q, k_pool, v_pool, block_tables, seq_lens, torch.float32,
               "paged_attention_stats_f32", paged_attention_stats_cuda)


paged_attention_stats_cuda.launches = 0


def paged_attention_stats_bf16_cuda(q, k_pool, v_pool, block_tables, seq_lens):
    """``paged_attention_stats_cuda`` over bfloat16 pages with a bfloat16
    q: each element converted exactly to fp32 in the kernel, then B1's
    fp32 arithmetic; the pools are never upcast. Raises unless q and both
    pools are bfloat16. ``paged_attention_stats_bf16_cuda.launches``
    counts the launches."""
    return _b1(q, k_pool, v_pool, block_tables, seq_lens, torch.bfloat16,
               "paged_attention_stats_bf16", paged_attention_stats_bf16_cuda)


paged_attention_stats_bf16_cuda.launches = 0


def _b2(q, k_pool, v_pool, block_tables, seq_lens, dtype, entry, wrapper):
    """Check and launch B2 with a q of ``dtype`` through ``entry``."""
    dev = q.device
    check_tensor("q", q, (dtype,), dev)
    for name, t in (("k_pool.data", k_pool.data), ("v_pool.data", v_pool.data)):
        check_tensor(name, t, (torch.int8,), dev)
    for name, t in (("k_pool.scale", k_pool.scale), ("v_pool.scale", v_pool.scale)):
        check_tensor(name, t, (torch.float32,), dev)
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        check_tensor(name, t, (torch.int32,), dev)
    S, K, H, hd, P, page, Pm = _check_shapes(q, k_pool.data.shape, v_pool.data.shape,
                                             block_tables, seq_lens)
    for name, t in (("k_pool.scale", k_pool.scale), ("v_pool.scale", v_pool.scale)):
        if tuple(t.shape) != (P, page):
            raise ValueError(f"{name} {tuple(t.shape)} must be (P, page) = {(P, page)}")
    acc, m, l = _outputs(S, K, H, hd, dev)
    lib = _library()
    rc = getattr(lib, entry)(
        q.data_ptr(), k_pool.data.data_ptr(), k_pool.scale.data_ptr(),
        v_pool.data.data_ptr(), v_pool.scale.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        S, K, H, hd, P, page, Pm, float(hd**-0.5),
        *launch_context(q),
    )
    raise_on_error(lib, "paged_attention", wrapper.__name__, rc)
    wrapper.launches += 1
    return acc, m, l


def paged_attention_stats_quantized_cuda(q, k_pool, v_pool, block_tables, seq_lens):
    """Kernel twin of ``paged_attention_stats_quantized_ref``: (acc, m, l)
    fp32 over int8 pools. ``k_pool`` / ``v_pool`` are
    ``ops.quant.QuantizedKVPool``s: data (P, page, H, hd) int8 and scale
    (P, page) float32. q (S, K, H, hd) float32, or bfloat16 (handed to
    ``paged_attention_stats_quantized_bf16q_cuda``, which counts those
    launches); block_tables (S, Pm) and seq_lens (S,) int32; all
    contiguous on one CUDA device, any K >= 1, hd <= 128. Each K/V element
    is dequantised in the kernel right after its load; the pools are never
    upcast. Raises as ``paged_attention_stats_cuda`` does.
    ``paged_attention_stats_quantized_cuda.launches`` counts the launches
    with a float32 q.
    """
    if q.dtype == torch.bfloat16:
        return paged_attention_stats_quantized_bf16q_cuda(q, k_pool, v_pool, block_tables,
                                                          seq_lens)
    return _b2(q, k_pool, v_pool, block_tables, seq_lens, torch.float32,
               "paged_attention_stats_q8", paged_attention_stats_quantized_cuda)


paged_attention_stats_quantized_cuda.launches = 0


def paged_attention_stats_quantized_bf16q_cuda(q, k_pool, v_pool, block_tables, seq_lens):
    """``paged_attention_stats_quantized_cuda`` with a bfloat16 q (a bf16
    model over int8 pages): q converted exactly to fp32 as it is staged.
    ``paged_attention_stats_quantized_bf16q_cuda.launches`` counts the
    launches."""
    return _b2(q, k_pool, v_pool, block_tables, seq_lens, torch.bfloat16,
               "paged_attention_stats_q8_bf16q", paged_attention_stats_quantized_bf16q_cuda)


paged_attention_stats_quantized_bf16q_cuda.launches = 0


def paged_attention_stats_ref(q, k_pool, v_pool, block_tables, seq_lens):
    """Plain PyTorch version: gather the slots' pages (block-table entries
    clamped into [0, P), as the kernels clamp; JAX's gather clamps entries
    >= P the same way and wraps negative ones), upcast to fp32, score,
    fill masked positions with -1e9, and take the softmax statistics over
    all Pm*page positions. Same shapes and dtypes as the kernel."""
    S, K, H, hd = q.shape
    Pm = block_tables.shape[1]
    P, page = k_pool.shape[:2]
    idx = block_tables.long().clamp(0, P - 1)
    k = k_pool[idx].reshape(S, Pm * page, H, hd)
    v = v_pool[idx].reshape(S, Pm * page, H, hd)
    return _stats(q, k, v, seq_lens)


def paged_attention_stats_quantized_ref(q, k_pool, v_pool, block_tables, seq_lens):
    """Plain PyTorch version over ``QuantizedKVPool``s: gather the slots'
    int8 rows and their scales, dequantise after the gather
    (float(int8) * scale), then ``paged_attention_stats_ref``'s
    arithmetic. Same shapes and dtypes as the kernel."""
    S, K, H, hd = q.shape
    Pm = block_tables.shape[1]
    P, page = k_pool.data.shape[:2]
    idx = block_tables.long().clamp(0, P - 1)

    def rows(pool):
        out = pool.data[idx].to(torch.float32) * pool.scale[idx][..., None, None]
        return out.reshape(S, Pm * page, H, hd)

    return _stats(q, rows(k_pool), rows(v_pool), seq_lens)


def _stats(q, k, v, seq_lens):
    """(acc, m, l) of q (S, K, H, hd) over per-slot K/V (S, M, H, hd),
    positions at or past seq_lens filled with -1e9. q, K and V are upcast
    to fp32 BEFORE the score einsum, as the Pallas body casts after its
    loads: a bf16 q or bf16 pages give fp32 scores (JAX's CPU fallback
    rounds them to bf16 instead)."""
    hd = q.shape[-1]
    q, k, v = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
    s = torch.einsum("skhd,smhd->skhm", q, k) * (hd**-0.5)
    tok = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(tok[None, None, None, :] >= seq_lens.long()[:, None, None, None], NEG)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    acc = torch.einsum("skhm,smhd->skhd", e, v)
    return acc, m, l
