"""Fused linear + cross-entropy: the CUDA kernels' wrappers, their plain
versions, and the autograd function that joins them.

``fused_linear_ce_fwd_cuda``, ``fused_linear_ce_dx_cuda`` and
``fused_linear_ce_dw_cuda`` launch the hand-written Hopper kernels in
``genrec_tpu_torch/csrc/fused_ce.cu``, which replace the TPU kernels of
``genrec_tpu/kernels/fused_ce.py``: ``fused_linear_ce_fwd`` and the two
bodies of ``fused_linear_ce_bwd`` (dx, dW). ``fused_linear_ce_ref`` (the
port of ``linear_ce_xla``, materialised logits),
``fused_linear_ce_dx_ref`` and ``fused_linear_ce_dw_ref`` are their plain
versions and the numerics contract they are held to
(``fused_linear_ce_bwd_ref`` is the pair). ``fused_linear_ce`` mirrors the JAX
``custom_vjp`` and ``fused_ce_mean_loss`` the model-side mean. A CPU
tensor takes the plain versions; a CUDA tensor launches the kernels or
raises. The vocab-sharded composition (``sharded_fused_linear_ce``) is
not ported yet.

Logits are fp32 in every version (x and w upcast, as the JAX kernels and
``linear_ce_xla`` do); dx and dW come back in the input dtypes.

Bound on an H100 at the HSTU trainer's shapes (R=6400, V=12102, d=64,
bf16): operations, 9.9 GFLOP per pass over the logits. The source's
header says what the design does.
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

MAX_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("fused_ce")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_ce_workspace.argtypes = [i32] * 4
    lib.fused_ce_workspace.restype = ctypes.c_longlong
    lib.fused_ce_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [ptr, i32]
    lib.fused_ce_fwd.restype = i32
    for fn in (lib.fused_ce_dx, lib.fused_ce_dw):
        fn.argtypes = [ptr] * 7 + [i32] * 5 + [ptr, i32]
        fn.restype = i32
    return lib


_WORKSPACE = {"fwd": 0, "dx": 1, "dw": 2}


def _workspace(lib, which, R, V, d, device):
    """The fp32 partials the kernel's splits write before they are merged."""
    n = lib.fused_ce_workspace(_WORKSPACE[which], R, V, d)
    return torch.empty((n,), dtype=torch.float32, device=device)


def _checked(x, w, targets, lse=None, g=None):
    """Checks shared by the three kernels; returns (R, V, d)."""
    dev = x.device
    check_tensor("x", x, _DTYPES, dev)
    check_tensor("w", w, (x.dtype,), dev)
    check_tensor("targets", targets, (torch.int32,), dev)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x (R, d) and w (V, d) expected, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    R, d = x.shape
    V = w.shape[0]
    if not 1 <= d <= MAX_DIM or V < 1:
        raise ValueError(f"kernel takes 1 <= d <= {MAX_DIM} and V >= 1, got d={d}, V={V}")
    for name, t in (("targets", targets), ("lse", lse), ("g", g)):
        if t is not None:
            if name != "targets":
                check_tensor(name, t, (torch.float32,), dev)
            if tuple(t.shape) != (R,):
                raise ValueError(f"{name} must be ({R},), got {tuple(t.shape)}")
    return R, V, d


def fused_linear_ce_fwd_cuda(x, w, targets, ignore_index: int = 0):
    """Kernel twin of ``fused_linear_ce_ref``: (loss (R,), lse (R,)) fp32.

    x (R, d) and w (V, d) float32 or bfloat16, one dtype, d <= 128;
    targets (R,) int32; all contiguous on one CUDA device. Raises on
    anything else and when the build or launch fails. Launches on the
    current stream and does not synchronise;
    ``fused_linear_ce_fwd_cuda.launches`` counts the launches."""
    R, V, d = _checked(x, w, targets)
    loss = torch.empty((R,), dtype=torch.float32, device=x.device)
    lse = torch.empty((R,), dtype=torch.float32, device=x.device)
    lib = _library()
    ws = _workspace(lib, "fwd", R, V, d, x.device)
    rc = lib.fused_ce_fwd(
        x.data_ptr(), w.data_ptr(), targets.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        ws.data_ptr(), R, V, d, ignore_index, int(x.dtype == torch.bfloat16),
        *launch_context(x),
    )
    raise_on_error(lib, "fused_ce", "fused_linear_ce_fwd", rc)
    fused_linear_ce_fwd_cuda.launches += 1
    return loss, lse


fused_linear_ce_fwd_cuda.launches = 0


def _bwd_launch(which, x, w, targets, lse, g, ignore_index):
    R, V, d = _checked(x, w, targets, lse, g)
    out = torch.empty_like(x if which == "dx" else w)
    lib = _library()
    ws = _workspace(lib, which, R, V, d, x.device)
    rc = getattr(lib, f"fused_ce_{which}")(
        x.data_ptr(), w.data_ptr(), targets.data_ptr(), lse.data_ptr(), g.data_ptr(),
        out.data_ptr(), ws.data_ptr(), R, V, d, ignore_index,
        int(x.dtype == torch.bfloat16), *launch_context(x),
    )
    raise_on_error(lib, "fused_ce", f"fused_linear_ce_{which}", rc)
    return out


def fused_linear_ce_dx_cuda(x, w, targets, lse, g, ignore_index: int = 0):
    """dx (R, d) in x's dtype: sum over the vocabulary of
    g (softmax - onehot) w, with g taken as 0 at ignored rows. Takes what
    ``fused_linear_ce_fwd_cuda`` takes plus lse and g (R,) float32;
    ``fused_linear_ce_dx_cuda.launches`` counts the launches."""
    out = _bwd_launch("dx", x, w, targets, lse, g, ignore_index)
    fused_linear_ce_dx_cuda.launches += 1
    return out


fused_linear_ce_dx_cuda.launches = 0


def fused_linear_ce_dw_cuda(x, w, targets, lse, g, ignore_index: int = 0):
    """dW (V, d) in w's dtype: sum over the rows of g (softmax - onehot)
    x, the transposed grid of ``fused_linear_ce_dx_cuda``;
    ``fused_linear_ce_dw_cuda.launches`` counts the launches."""
    out = _bwd_launch("dw", x, w, targets, lse, g, ignore_index)
    fused_linear_ce_dw_cuda.launches += 1
    return out


fused_linear_ce_dw_cuda.launches = 0


def _logits(x, w):
    return x.float() @ w.float().T


def fused_linear_ce_ref(x, w, targets, ignore_index: int = 0):
    """Plain PyTorch version (port of ``linear_ce_xla``): materialised fp32
    logits, logsumexp and the target logit. Returns (loss, lse) as the
    kernel does; loss is 0 where the target is ``ignore_index``."""
    logits = _logits(x, w)
    lse = torch.logsumexp(logits, dim=-1)
    t = logits.gather(1, targets.long()[:, None])[:, 0]
    return torch.where(targets == ignore_index, 0.0, lse - t), lse


def _coeff(x, w, targets, lse, g, ignore_index):
    """g (exp(logits - lse) - onehot), fp32 (R, V), g zeroed at ignored rows."""
    g = torch.where(targets == ignore_index, 0.0, g.float())
    onehot = (torch.arange(w.shape[0], device=x.device)[None, :] == targets[:, None])
    return g[:, None] * (torch.exp(_logits(x, w) - lse[:, None]) - onehot.float())


def fused_linear_ce_dx_ref(x, w, targets, lse, g, ignore_index: int = 0):
    """Plain version of the dx kernel: coeff w in x's dtype."""
    return (_coeff(x, w, targets, lse, g, ignore_index) @ w.float()).to(x.dtype)


def fused_linear_ce_dw_ref(x, w, targets, lse, g, ignore_index: int = 0):
    """Plain version of the dW kernel: coeffᵀ x in w's dtype."""
    return (_coeff(x, w, targets, lse, g, ignore_index).T @ x.float()).to(w.dtype)


def fused_linear_ce_bwd_ref(x, w, targets, lse, g, ignore_index: int = 0):
    """Plain PyTorch backward, (dx, dW) in the input dtypes."""
    return (fused_linear_ce_dx_ref(x, w, targets, lse, g, ignore_index),
            fused_linear_ce_dw_ref(x, w, targets, lse, g, ignore_index))


class _FusedLinearCE(torch.autograd.Function):
    """``jax.custom_vjp`` of ``genrec_tpu/kernels/fused_ce.py:230``: saves
    x, w, targets and the forward's lse; the backward recomputes the
    logits. Routes by device: CPU tensors take the plain versions, CUDA
    tensors the kernels."""

    @staticmethod
    def forward(ctx, x, w, targets, ignore_index):
        fwd = fused_linear_ce_fwd_cuda if x.is_cuda else fused_linear_ce_ref
        loss, lse = fwd(x, w, targets, ignore_index)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        if x.is_cuda:
            dx_fn, dw_fn = fused_linear_ce_dx_cuda, fused_linear_ce_dw_cuda
        else:
            dx_fn, dw_fn = fused_linear_ce_dx_ref, fused_linear_ce_dw_ref
        args = (x, w, targets, lse, g.float().contiguous(), ctx.ignore_index)
        return dx_fn(*args), dw_fn(*args), None, None


def fused_linear_ce(x, w, targets, ignore_index: int = 0):
    """Exact full-softmax CE over logits = x @ w.T without materialising
    them on the card. Per-row losses, 0 where target == ignore_index."""
    return _FusedLinearCE.apply(x.contiguous(), w.contiguous(),
                                targets.to(torch.int32).contiguous(), ignore_index)


def fused_ce_mean_loss(x, head_weights, targets, ignore_index: int = 0):
    """Mean fused CE over valid (non-ignored) positions, the reference
    trainers' ``sum / max(valid, 1)``. x (..., d); targets (...) matching
    x's leading shape; head logits = x @ head_weights.T."""
    d = x.shape[-1]
    per_row = fused_linear_ce(x.reshape(-1, d), head_weights, targets.reshape(-1),
                              ignore_index)
    valid = (targets.reshape(-1) != ignore_index).to(torch.float32)
    return per_row.sum() / valid.sum().clamp_min(1.0)
