"""HSTU SiLU attention: the CUDA kernels' wrappers, their plain versions,
and the autograd function that joins them.

``hstu_attention_fwd_cuda`` and ``hstu_attention_bwd_cuda`` launch the
hand-written Hopper kernels in ``genrec_tpu_torch/csrc/hstu_attention.cu``,
which replace the TPU kernels ``genrec_tpu/kernels/hstu_attention.py::
hstu_attention_pallas`` and ``::hstu_attention_bwd_pallas``.
``hstu_attention_ref`` is the port of ``hstu_attention_xla`` (the
materialised-bias version) and ``hstu_attention_bwd_ref`` its explicit
backward; they are the numerics contract the kernels are held to.
``hstu_attention`` mirrors the JAX ``custom_vjp``: the forward saves only
its inputs and the backward recomputes. A CPU tensor takes the plain
versions; a CUDA tensor launches the kernels or raises.

Scores are fp32 in every version: with bf16 inputs the plain version
multiplies the inputs upcast to fp32, as the Pallas kernel accumulates its
bf16 products in fp32 (``hstu_attention_xla`` rounds its bf16 einsum
first; the two agree exactly in fp32). ``silu(s)`` is rounded to v's
dtype before it meets v, as both JAX versions do.

Bound on an H100 at the trainer's shapes (B=128, H=2, L=50, hd=32, bf16):
bytes (the forward moves 3.3 MB, ~1 us at 3.35 TB/s). The source's header
says what the design does.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from genrec_tpu_torch.kernels.build import (
    check_tensor,
    launch_context,
    load_library,
    raise_on_error,
)
from genrec_tpu_torch.ops.buckets import hstu_log_bucket, hstu_position_bucket

NEG = -1e9
MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("hstu_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hstu_attention_fwd.argtypes = [ptr] * 9 + [i32] * 7 + [f32, i32, ptr, i32]
    lib.hstu_attention_fwd.restype = i32
    lib.hstu_attention_bwd.argtypes = [ptr] * 15 + [i32] * 7 + [f32, i32, ptr, i32]
    lib.hstu_attention_bwd.restype = i32
    return lib


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _checked(q, k, v, timestamps, padding_mask, pos_table, time_table, segment_ids,
             g=None):
    """Shape/dtype/device checks shared by both directions; returns
    (B, H, L, hd, nb, ntb, time_table or None)."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t is not None:
            check_tensor(name, t, _DTYPES, dev)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, hd), got {tuple(q.shape)}")
    B, H, L, hd = q.shape
    for name, t in (("k", k), ("v", v), ("g", g)):
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match q "
                             f"{tuple(q.shape)} {q.dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"kernel takes 1 <= hd <= {MAX_HEAD_DIM}, got {hd}")
    check_tensor("padding_mask", padding_mask, (torch.bool,), dev)
    for name, t in (("timestamps", timestamps), ("segment_ids", segment_ids)):
        if t is not None:
            check_tensor(name, t, (torch.int32,), dev)
    for name, t in (("padding_mask", padding_mask), ("timestamps", timestamps),
                    ("segment_ids", segment_ids)):
        if t is not None and tuple(t.shape) != (B, L):
            raise ValueError(f"{name} must be ({B}, {L}), got {tuple(t.shape)}")
    check_tensor("pos_table", pos_table, (torch.float32,), dev)
    if pos_table.dim() != 2 or pos_table.shape[0] != H:
        raise ValueError(f"pos_table must be ({H}, nb), got {tuple(pos_table.shape)}")
    use_time = timestamps is not None and time_table is not None
    ntb = 0
    if use_time:
        check_tensor("time_table", time_table, (torch.float32,), dev)
        if time_table.dim() != 2 or time_table.shape[0] != H:
            raise ValueError(f"time_table must be ({H}, ntb), got {tuple(time_table.shape)}")
        ntb = time_table.shape[1]
    return B, H, L, hd, pos_table.shape[1], ntb, (time_table if use_time else None)


def _bucket_args(nb: int, max_position_distance: int) -> tuple[int, float]:
    max_exact = nb // 2
    return max_exact, float(math.log(max_position_distance / max_exact))


def hstu_attention_fwd_cuda(q, k, v, timestamps, padding_mask, pos_table, time_table,
                            max_position_distance: int = 128, segment_ids=None):
    """Kernel twin of ``hstu_attention_ref``: (B, H, L, hd) in q's dtype.

    q, k, v (B, H, L, hd) float32 or bfloat16, one dtype; padding_mask
    (B, L) bool; timestamps and segment_ids (B, L) int32 or None;
    pos_table (H, nb) and time_table (H, ntb) float32 (the time table is
    used only with timestamps); all contiguous on one CUDA device, hd <=
    128. Raises on anything else and when the build or launch fails.
    Launches on the current stream and does not synchronise;
    ``hstu_attention_fwd_cuda.launches`` counts the launches."""
    B, H, L, hd, nb, ntb, ttab = _checked(
        q, k, v, timestamps, padding_mask, pos_table, time_table, segment_ids)
    out = torch.empty_like(q)
    max_exact, log_ratio = _bucket_args(nb, max_position_distance)
    lib = _library()
    rc = lib.hstu_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(timestamps if ttab is not None else None), padding_mask.data_ptr(),
        _ptr(segment_ids), pos_table.data_ptr(), _ptr(ttab), out.data_ptr(),
        B, H, L, hd, nb, ntb, max_exact, log_ratio, int(q.dtype == torch.bfloat16),
        *launch_context(q),
    )
    raise_on_error(lib, "hstu_attention", "hstu_attention_fwd", rc)
    hstu_attention_fwd_cuda.launches += 1
    return out


hstu_attention_fwd_cuda.launches = 0


def hstu_attention_bwd_cuda(q, k, v, timestamps, padding_mask, pos_table, time_table, g,
                            max_position_distance: int = 128, segment_ids=None):
    """Kernel twin of ``hstu_attention_bwd_ref``: (dq, dk, dv, dpos_table,
    dtime_table or None), gradients in q's dtype and tables float32.
    Takes what ``hstu_attention_fwd_cuda`` takes plus g (B, H, L, hd) in
    q's dtype. ``hstu_attention_bwd_cuda.launches`` counts the launches;
    the per-(b, h) table partials are summed over the batch afterwards."""
    B, H, L, hd, nb, ntb, ttab = _checked(
        q, k, v, timestamps, padding_mask, pos_table, time_table, segment_ids, g=g)
    dq32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dq = dq32 if q.dtype == torch.float32 else torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dpt = torch.empty((B * H, nb), dtype=torch.float32, device=q.device)
    dtt = (torch.empty((B * H, ntb), dtype=torch.float32, device=q.device)
           if ttab is not None else None)
    max_exact, log_ratio = _bucket_args(nb, max_position_distance)
    lib = _library()
    rc = lib.hstu_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        _ptr(timestamps if ttab is not None else None), padding_mask.data_ptr(),
        _ptr(segment_ids), pos_table.data_ptr(), _ptr(ttab),
        dq32.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dpt.data_ptr(), _ptr(dtt),
        B, H, L, hd, nb, ntb, max_exact, log_ratio, int(q.dtype == torch.bfloat16),
        *launch_context(q),
    )
    raise_on_error(lib, "hstu_attention", "hstu_attention_bwd", rc)
    hstu_attention_bwd_cuda.launches += 1
    dtime = dtt.view(B, H, ntb).sum(0) if dtt is not None else None
    return dq, dk, dv, dpt.view(B, H, nb).sum(0), dtime


hstu_attention_bwd_cuda.launches = 0


def _masked_scores(q, k, timestamps, padding_mask, pos_table, time_table,
                   max_position_distance, segment_ids):
    """(fp32 scores with masked pairs at -1e9, mask (B, 1, L, L), position
    buckets (L, L), time buckets (B, L, L) or None)."""
    B, H, L, hd = q.shape
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    pos = torch.arange(L, device=q.device)
    rel = pos[None, :] - pos[:, None]  # [i, j] = j - i (reference quirk)
    pb = hstu_position_bucket(rel, pos_table.shape[1], max_position_distance)
    scores = scores + pos_table.T[pb].permute(2, 0, 1)[None]
    tb = None
    if timestamps is not None and time_table is not None:
        ts = timestamps.to(torch.int32)
        tb = hstu_log_bucket(ts[:, :, None] - ts[:, None, :], time_table.shape[1]).long()
        scores = scores + time_table.T[tb].permute(0, 3, 1, 2)
    masked = torch.triu(torch.ones((L, L), dtype=torch.bool, device=q.device), diagonal=1)
    masked = masked[None] | padding_mask.to(torch.bool)[:, None, :]
    if segment_ids is not None:
        masked = masked | (segment_ids[:, :, None] != segment_ids[:, None, :])
    masked = masked[:, None]
    return scores.masked_fill(masked, NEG), masked, pb, tb


def hstu_attention_ref(q, k, v, timestamps, padding_mask, pos_table, time_table,
                       max_position_distance: int = 128, segment_ids=None):
    """Plain PyTorch version (port of ``hstu_attention_xla``): materialises
    the biased (B, H, L, L) scores. Same arguments and result as the
    kernel; ``padding_mask`` may be any dtype (nonzero = padding)."""
    s, _, _, _ = _masked_scores(q, k, timestamps, padding_mask, pos_table, time_table,
                                max_position_distance, segment_ids)
    attn = (s * torch.sigmoid(s)).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn.float(), v.float()).to(v.dtype)


def hstu_attention_bwd_ref(q, k, v, timestamps, padding_mask, pos_table, time_table, g,
                           max_position_distance: int = 128, segment_ids=None):
    """Plain PyTorch backward, the arithmetic of the Pallas backward
    kernel in fp32: recompute the masked scores, ds = (g.v) silu'(s) and
    exactly 0 where masked, then dq, dk, dv and the per-bucket sums of ds.
    Returns (dq, dk, dv, dpos_table, dtime_table or None) in the input
    dtypes."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s, masked, pb, tb = _masked_scores(qf, kf, timestamps, padding_mask, pos_table,
                                       time_table, max_position_distance, segment_ids)
    sig = torch.sigmoid(s)
    attn = s * sig
    d_attn = gf @ vf.transpose(-1, -2)
    ds = torch.where(masked, 0.0, d_attn * sig * (1.0 + s * (1.0 - sig)))
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf
    dv = attn.transpose(-1, -2) @ gf
    H, nb = pos_table.shape
    dpt = torch.zeros((H, nb), dtype=torch.float32, device=q.device)
    dpt.index_add_(1, pb.reshape(-1), ds.sum(0).reshape(H, -1))
    dtt = None
    if tb is not None:
        dtt = torch.zeros(time_table.shape, dtype=torch.float32, device=q.device)
        dtt.index_add_(1, tb.reshape(-1), ds.transpose(0, 1).reshape(H, -1))
        dtt = dtt.to(time_table.dtype)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dpt.to(pos_table.dtype), dtt)


class _HSTUAttention(torch.autograd.Function):
    """``jax.custom_vjp`` of ``genrec_tpu/kernels/hstu_attention.py:395``:
    the forward saves its inputs only; the backward recomputes. Routes by
    device: CPU tensors take the plain versions, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, timestamps, padding_mask, pos_table, time_table,
                segment_ids, max_position_distance):
        fwd = hstu_attention_fwd_cuda if q.is_cuda else hstu_attention_ref
        ctx.save_for_backward(q, k, v, timestamps, padding_mask, pos_table, time_table,
                              segment_ids)
        ctx.mpd = max_position_distance
        return fwd(q, k, v, timestamps, padding_mask, pos_table, time_table,
                   max_position_distance, segment_ids=segment_ids)

    @staticmethod
    def backward(ctx, g):
        q, k, v, timestamps, padding_mask, pos_table, time_table, segment_ids = (
            ctx.saved_tensors)
        bwd = hstu_attention_bwd_cuda if q.is_cuda else hstu_attention_bwd_ref
        dq, dk, dv, dpt, dtt = bwd(q, k, v, timestamps, padding_mask, pos_table,
                                   time_table, g.contiguous(), ctx.mpd,
                                   segment_ids=segment_ids)
        if dtt is None and time_table is not None:
            dtt = torch.zeros_like(time_table)
        return dq, dk, dv, None, None, dpt, dtt, None, None


def hstu_attention(q, k, v, timestamps, padding_mask, pos_table, time_table,
                   segment_ids=None, max_position_distance: int = 128):
    """Fused SiLU attention with its fused backward (the JAX
    ``hstu_attention``); tables are (H, buckets) float32."""
    return _HSTUAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), timestamps,
                                padding_mask, pos_table, time_table, segment_ids,
                                max_position_distance)
