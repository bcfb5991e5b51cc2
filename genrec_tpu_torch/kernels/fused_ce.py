"""Fused linear + cross-entropy: the CUDA kernels' wrappers, their plain
versions, the autograd function that joins them, and the vocab-sharded
composition over a tensor-parallel group.

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
raises.

Every version takes ``vlim``, the live-vocab limit of the JAX
``_tile_logits``: columns at or past min(V, vlim) read -1e30 and stay
inside the softmax. A target outside [0, V) has target logit 0 and no
one-hot column, as the Pallas kernel's sum-select gives.

``sharded_fused_linear_ce`` ports ``sharded_fused_linear_ce`` (B8): the
head vocab-sharded over a ``parallel.mesh.TPGroup``, each rank running
the forward and backward kernels (B3, B4) over its shard with
offset-mapped targets, the per-shard logsumexps merged with one max and
two sums over the group, dx summed over the group and dW left on its
shard. ``sharded_fused_linear_ce_ref`` is its plain twin: the same
composition over the plain versions, on any device.

Logits are fp32 in every version (x and w upcast, as the JAX kernels and
``linear_ce_xla`` do); dx and dW come back in the input dtypes.

Two designs sit under the wrappers, by input type. fp32 inputs run FFMA
kernels (fp32 products from shared memory), which agree with the plain
versions to 1e-5. bf16 inputs run on the tensor cores (wgmma, operands
fed by TMA). The forward walks a split of 256-column vocab tiles per
128-row block and folds each logits tile into every row's running max,
sum of exps and target logit in registers; a merge folds the splits in
order into (loss, lse). The backward's coeff = g (softmax - onehot)
enters the products as a bf16 hi + lo pair (coeff to ~2^-17; one bf16
value moved dW elements near 0 past the 1e-2 tolerance). At d <= 64
(HSTU) one fused kernel keeps coeff in registers and the output tile in
registers for its whole walk, and a merge adds the splits' fp32 partials
in order. At d > 64 (LCRec) the vocabulary goes in chunks: a kernel
writes the chunk's coeff to a bounded workspace, then a second forms dx
(summed over the chunks in order, in fp32) or dW from it. TMA needs
16-byte rows, so the wrapper pads x and w with zero columns to a multiple
of 8 (and slices dx and dW). Every sum has one fixed order, so two calls
give equal bits.

Bound on an H100: operations, 2 R V d per pass over the logits (9.9
GFLOP at the HSTU trainer's shapes R=6400, V=12102, d=64; 0.96 TFLOP at
an LCRec shard under tensor_parallel=2, R=4088, V=76608, d=1536); each
backward is two passes. The source's header says more.
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

MAX_DIM = 2048
FUSED_DIM = 64  # the bf16 backward's fused kernels take d up to here (kFusedDim)
FWD_COLS = 256  # vocab columns of a bf16 forward tile (kFwdN)
NEG = -1e30
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("fused_ce")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_ce_workspace.argtypes = [i32] * 5
    lib.fused_ce_workspace.restype = ctypes.c_longlong
    lib.fused_ce_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr, i32]
    lib.fused_ce_fwd.restype = i32
    lib.fused_ce_bf16_smem.argtypes = [i32, i32]
    lib.fused_ce_bf16_smem.restype = ctypes.c_longlong
    for fn in (lib.fused_ce_dx, lib.fused_ce_dw):
        fn.argtypes = [ptr] * 7 + [i32] * 6 + [ptr, i32]
        fn.restype = i32
    return lib


_WORKSPACE = {"fwd": 0, "dx": 1, "dw": 2}


def _workspace(lib, which, R, V, d, bf16, device):
    """The kernel's scratch: the fp32 partials of its splits (the forward,
    the fp32 backward) or one vocab chunk's bf16 coeff planes and the fp32
    dx sum (the bf16 backward)."""
    n = lib.fused_ce_workspace(_WORKSPACE[which], R, V, d, int(bf16))
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


def _vlim(V: int, vlim) -> int:
    """The kernels' live-vocab limit argument: V for none."""
    return V if vlim is None else int(vlim)


def fused_linear_ce_fwd_cuda(x, w, targets, ignore_index: int = 0, vlim=None):
    """Kernel twin of ``fused_linear_ce_ref``: (loss (R,), lse (R,)) fp32.

    x (R, d) and w (V, d) float32 or bfloat16, one dtype, d <= 2048;
    targets (R,) int32; all contiguous on one CUDA device; ``vlim`` an int
    or None. Raises on anything else and when the build or launch fails.
    Launches on the current stream and does not synchronise;
    ``fused_linear_ce_fwd_cuda.launches`` counts the launches."""
    R, V, _ = _checked(x, w, targets)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x, w = _tma_operand(x), _tma_operand(w)
    dk = x.shape[1]
    loss = torch.empty((R,), dtype=torch.float32, device=x.device)
    lse = torch.empty((R,), dtype=torch.float32, device=x.device)
    lib = _library()
    ws = _workspace(lib, "fwd", R, V, dk, bf16, x.device)
    rc = lib.fused_ce_fwd(
        x.data_ptr(), w.data_ptr(), targets.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        ws.data_ptr(), R, V, dk, ignore_index, _vlim(V, vlim), int(bf16),
        *launch_context(x),
    )
    raise_on_error(lib, "fused_ce", "fused_linear_ce_fwd", rc)
    fused_linear_ce_fwd_cuda.launches += 1
    return loss, lse


fused_linear_ce_fwd_cuda.launches = 0


def workspace_bytes(which: str, R: int, V: int, d: int, dtype) -> int:
    """Bytes of scratch that the ``which`` ("fwd", "dx" or "dw") kernel
    allocates for these sizes and input dtype (d as passed, before the bf16
    kernels' padding)."""
    bf16 = dtype == torch.bfloat16
    dk = d + (-d % 8 if bf16 else 0)
    return 4 * _library().fused_ce_workspace(_WORKSPACE[which], R, V, dk, int(bf16))


_SMEM_KIND = {"coeff": 0, "product": 1, "fwd": 2}


def bf16_block_smem(d: int, kind: str = "coeff") -> int:
    """Dynamic shared memory of one block of a bf16 kernel at width d
    (ptxas reports only static shared memory): the forward's
    (``kind="fwd"``), or the backward's fused kernel at d <= FUSED_DIM,
    else its coeff kernel or product kernel (``"product"``)."""
    return _library().fused_ce_bf16_smem(d + -d % 8, _SMEM_KIND[kind])


def _tma_operand(t):
    """t for the bf16 kernels' TMA loads: d padded with zero columns to a
    multiple of 8 (16-byte rows), the storage 16-byte aligned."""
    pad = -t.shape[1] % 8
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bwd_launch(which, x, w, targets, lse, g, ignore_index, vlim):
    R, V, d = _checked(x, w, targets, lse, g)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x, w = _tma_operand(x), _tma_operand(w)
    dk = x.shape[1]
    out = torch.empty_like(x if which == "dx" else w)
    lib = _library()
    ws = _workspace(lib, which, R, V, dk, bf16, x.device)
    rc = getattr(lib, f"fused_ce_{which}")(
        x.data_ptr(), w.data_ptr(), targets.data_ptr(), lse.data_ptr(), g.data_ptr(),
        out.data_ptr(), ws.data_ptr(), R, V, dk, ignore_index, _vlim(V, vlim), int(bf16),
        *launch_context(x),
    )
    raise_on_error(lib, "fused_ce", f"fused_linear_ce_{which}", rc)
    return out if dk == d else out[:, :d].contiguous()


def fused_linear_ce_dx_cuda(x, w, targets, lse, g, ignore_index: int = 0, vlim=None):
    """dx (R, d) in x's dtype: sum over the vocabulary of
    g (softmax - onehot) w, with g taken as 0 at ignored rows. Takes what
    ``fused_linear_ce_fwd_cuda`` takes plus lse and g (R,) float32;
    ``fused_linear_ce_dx_cuda.launches`` counts the launches."""
    out = _bwd_launch("dx", x, w, targets, lse, g, ignore_index, vlim)
    fused_linear_ce_dx_cuda.launches += 1
    return out


fused_linear_ce_dx_cuda.launches = 0


def fused_linear_ce_dw_cuda(x, w, targets, lse, g, ignore_index: int = 0, vlim=None):
    """dW (V, d) in w's dtype: sum over the rows of g (softmax - onehot)
    x, the transposed grid of ``fused_linear_ce_dx_cuda``;
    ``fused_linear_ce_dw_cuda.launches`` counts the launches."""
    out = _bwd_launch("dw", x, w, targets, lse, g, ignore_index, vlim)
    fused_linear_ce_dw_cuda.launches += 1
    return out


fused_linear_ce_dw_cuda.launches = 0


def _logits(x, w, vlim=None):
    """fp32 logits, columns at or past ``vlim`` at NEG (``_tile_logits``)."""
    logits = x.float() @ w.float().T
    if vlim is not None and vlim < w.shape[0]:
        col = torch.arange(w.shape[0], device=x.device)
        logits = torch.where(col[None, :] < vlim, logits, NEG)
    return logits


def fused_linear_ce_ref(x, w, targets, ignore_index: int = 0, vlim=None):
    """Plain PyTorch version (port of ``linear_ce_xla``): materialised fp32
    logits, logsumexp and the target logit. Returns (loss, lse) as the
    kernel does; loss is 0 where the target is ``ignore_index``; a target
    outside [0, V) has target logit 0 (the Pallas sum-select)."""
    logits = _logits(x, w, vlim)
    lse = torch.logsumexp(logits, dim=-1)
    t = targets.long()
    inside = (t >= 0) & (t < w.shape[0])
    tl = logits.gather(1, torch.where(inside, t, 0)[:, None])[:, 0]
    tl = torch.where(inside, tl, 0.0)
    return torch.where(targets == ignore_index, 0.0, lse - tl), lse


def _coeff(x, w, targets, lse, g, ignore_index, vlim):
    """g (exp(logits - lse) - onehot), fp32 (R, V), g zeroed at ignored
    rows; a target outside [0, V) has no one-hot column."""
    g = torch.where(targets == ignore_index, 0.0, g.float())
    onehot = (torch.arange(w.shape[0], device=x.device)[None, :] == targets[:, None])
    return g[:, None] * (torch.exp(_logits(x, w, vlim) - lse[:, None]) - onehot.float())


def fused_linear_ce_dx_ref(x, w, targets, lse, g, ignore_index: int = 0, vlim=None):
    """Plain version of the dx kernel: coeff w in x's dtype."""
    return (_coeff(x, w, targets, lse, g, ignore_index, vlim) @ w.float()).to(x.dtype)


def fused_linear_ce_dw_ref(x, w, targets, lse, g, ignore_index: int = 0, vlim=None):
    """Plain version of the dW kernel: coeffᵀ x in w's dtype."""
    return (_coeff(x, w, targets, lse, g, ignore_index, vlim).T @ x.float()).to(w.dtype)


def fused_linear_ce_bwd_ref(x, w, targets, lse, g, ignore_index: int = 0, vlim=None):
    """Plain PyTorch backward, (dx, dW) in the input dtypes."""
    return (fused_linear_ce_dx_ref(x, w, targets, lse, g, ignore_index, vlim),
            fused_linear_ce_dw_ref(x, w, targets, lse, g, ignore_index, vlim))


def _versions(kernels: bool):
    """(forward, dx, dW): the kernels or the plain versions."""
    if kernels:
        return fused_linear_ce_fwd_cuda, fused_linear_ce_dx_cuda, fused_linear_ce_dw_cuda
    return fused_linear_ce_ref, fused_linear_ce_dx_ref, fused_linear_ce_dw_ref


class _FusedLinearCE(torch.autograd.Function):
    """``jax.custom_vjp`` of ``genrec_tpu/kernels/fused_ce.py:230``: saves
    x, w, targets and the forward's lse; the backward recomputes the
    logits. Routes by device: CPU tensors take the plain versions, CUDA
    tensors the kernels."""

    @staticmethod
    def forward(ctx, x, w, targets, ignore_index):
        fwd, _, _ = _versions(x.is_cuda)
        loss, lse = fwd(x, w, targets, ignore_index)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        # A gradient nobody asked for (a frozen head under LoRA) launches
        # nothing: XLA drops the JAX backward's dead dW body likewise.
        x, w, targets, lse = ctx.saved_tensors
        _, dx_fn, dw_fn = _versions(x.is_cuda)
        args = (x, w, targets, lse, g.float().contiguous(), ctx.ignore_index)
        want_dx, want_dw = ctx.needs_input_grad[:2]
        return (dx_fn(*args) if want_dx else None), (dw_fn(*args) if want_dw else None), \
            None, None


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


# ---- B8: the vocab-sharded composition --------------------------------------


def local_shard_targets(targets, rank: int, Vs: int, valid_vocab):
    """(local targets, local vlim) of shard ``rank`` of ``Vs`` rows (JAX
    ``_local_shard_targets``): global ids outside [rank Vs, (rank + 1) Vs)
    map to -1, which matches no column; the live-vocab limit becomes
    clip(valid_vocab - rank Vs, 0, Vs), or None."""
    off = rank * Vs
    t = targets.to(torch.int32)
    here = (t >= off) & (t < off + Vs)
    local = torch.where(here, t - off, -1).to(torch.int32).contiguous()
    vlim = None if valid_vocab is None else min(max(int(valid_vocab) - off, 0), Vs)
    return local, vlim


class _ShardedFusedLinearCE(torch.autograd.Function):
    """``_tp_vjp_fwd`` / ``_tp_vjp_bwd`` of ``genrec_tpu/kernels/fused_ce.py``
    (:350, :375): the forward kernel on this rank's shard with
    ``ignore_index=-2`` (never matches), t_l = lse_l - loss_l, then
    m = max(lse_l), lse = m + log(sum(exp(lse_l - m))) and t = sum(t_l)
    over the group; the backward runs the dx and dW kernels against the
    merged lse, sums dx over the group and keeps dW on the shard.
    ``kernels`` picks the CUDA kernels or the plain versions."""

    @staticmethod
    def forward(ctx, x, w_shard, targets, group, ignore_index, valid_vocab, kernels):
        fwd, _, _ = _versions(kernels)
        local, vlim = local_shard_targets(targets, group.rank, w_shard.shape[0], valid_vocab)
        loss_l, lse_l = fwd(x, w_shard, local, -2, vlim)
        t_l = lse_l - loss_l
        m = group.all_reduce(lse_l, "max")
        lse = m + torch.log(group.all_reduce(torch.exp(lse_l - m), "sum"))
        t = group.all_reduce(t_l, "sum")
        ignored = targets == ignore_index
        ctx.save_for_backward(x, w_shard, local, lse, ignored)
        ctx.group, ctx.vlim, ctx.kernels = group, vlim, kernels
        return torch.where(ignored, 0.0, lse - t)

    @staticmethod
    def backward(ctx, g):
        x, w_shard, local, lse, ignored = ctx.saved_tensors
        _, dx_fn, dw_fn = _versions(ctx.kernels)
        g = torch.where(ignored, 0.0, g.float()).contiguous()
        args = (x, w_shard, local, lse, g, -2, ctx.vlim)
        want_dx, want_dw = ctx.needs_input_grad[:2]
        # Every rank asks for the same gradients, so the all-reduce is
        # issued on all of them or on none.
        dx = ctx.group.all_reduce(dx_fn(*args), "sum") if want_dx else None
        return dx, (dw_fn(*args) if want_dw else None), None, None, None, None, None


def _sharded(x, w_shard, targets, group, ignore_index, valid_vocab, kernels):
    return _ShardedFusedLinearCE.apply(
        x.contiguous(), w_shard.contiguous(), targets.to(torch.int32).contiguous(), group,
        ignore_index, valid_vocab, kernels)


def sharded_fused_linear_ce(x, w_shard, targets, group, ignore_index: int = 0,
                            valid_vocab=None):
    """Exact full-softmax CE with the head vocab-sharded over ``group``.

    x (R, d) and targets (R,) (global vocab ids) the same on every rank;
    w_shard (Vs, d) this rank's rows [rank Vs, (rank + 1) Vs) of the
    padded head. Rows past ``valid_vocab`` are left out of the softmax
    and get exactly zero dW. Returns per-row losses (0 at ignored rows),
    the same on every rank. Every rank must call it, in the same order.
    CUDA tensors run the kernels (``sharded_fused_linear_ce.launches``
    counts the calls that did), CPU tensors the plain versions."""
    if x.is_cuda:
        sharded_fused_linear_ce.launches += 1
    return _sharded(x, w_shard, targets, group, ignore_index, valid_vocab, x.is_cuda)


sharded_fused_linear_ce.launches = 0


def sharded_fused_linear_ce_ref(x, w_shard, targets, group, ignore_index: int = 0,
                                valid_vocab=None):
    """Plain twin of ``sharded_fused_linear_ce``: the same composition and
    collectives over the plain versions, on any device."""
    return _sharded(x, w_shard, targets, group, ignore_index, valid_vocab, False)
