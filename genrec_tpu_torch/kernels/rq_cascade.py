"""Residual-quantisation cascade: the CUDA kernel's wrapper and its plain
version.

``rq_cascade_cuda`` launches the hand-written Hopper kernel in
``genrec_tpu_torch/csrc/rq_cascade.cu``, which replaces the TPU kernel
``genrec_tpu/kernels/rq_cascade.py::rq_cascade_pallas``. ``rq_cascade_ref``
is the plain PyTorch version of the same function and the numerics
contract the kernel is held to. ``rq_cascade`` routes by device: the
plain version for CPU tensors, the kernel (or an exception) for CUDA
tensors.

Per level: ``dist = |c|^2 - 2 res . c`` (the kernel's formula, without the
model path's ``|x|^2`` term), a first-occurrence argmin over the K
codewords, ``res -= c_id`` and ``qsum += c_id``. Distances are fp32 with
no TF32 (the caller keeps ``torch.backends.cuda.matmul.allow_tf32`` off,
PyTorch's default): a reduced-precision distance flips near-tie argmins,
and a flip at level 0 cascades. The kernel and the plain version sum
each dot product in different orders, so their ids are compared outside
near ties (``near_tie_rows``).

The kernel is bound by operations: 2*B*K*D*L fp32 FLOPs. The source's
header says what its design does. Build: ``kernels/build.py`` compiles
the source for sm_90a at first use; nothing is built or imported when
this module is imported.
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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the entry point of a build of ``csrc/rq_cascade.cu``."""
    fn = lib.rq_cascade_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    lib.rq_cascade_error_string.argtypes = [ctypes.c_int]
    lib.rq_cascade_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(load_library("rq_cascade"))


def rq_cascade_cuda(x: torch.Tensor, codebooks: torch.Tensor):
    """Kernel twin of ``rq_cascade_ref``: (sem_ids (B, L) int32, qsum (B, D)
    fp32). x (B, D) and codebooks (L, K, D) float32, contiguous, on one
    CUDA device. Raises on anything else and when the build or the launch
    fails (a codebook too large for a block's shared memory fails the
    launch). Launches on the current stream and does not synchronise.
    ``rq_cascade_cuda.launches`` counts the launches."""
    dev = x.device
    check_tensor("x", x, (torch.float32,), dev)
    check_tensor("codebooks", codebooks, (torch.float32,), dev)
    if x.dim() != 2 or codebooks.dim() != 3 or codebooks.shape[2] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and codebooks {tuple(codebooks.shape)} "
                         "must be (B, D) and (L, K, D)")
    B, D = x.shape
    L, K, _ = codebooks.shape
    if min(D, L, K) < 1:
        raise ValueError(f"empty codebooks {tuple(codebooks.shape)}")
    ids = torch.empty((B, L), dtype=torch.int32, device=dev)
    qsum = torch.empty((B, D), dtype=torch.float32, device=dev)
    lib = _library()
    rc = lib.rq_cascade_f32(x.data_ptr(), codebooks.data_ptr(), ids.data_ptr(),
                            qsum.data_ptr(), B, D, L, K, *launch_context(x))
    raise_on_error(lib, "rq_cascade", "rq_cascade", rc)
    rq_cascade_cuda.launches += 1
    return ids, qsum


rq_cascade_cuda.launches = 0


def rq_cascade_ref(x: torch.Tensor, codebooks: torch.Tensor):
    """Plain PyTorch version: the same cascade with one matrix product per
    level. Same shapes and dtypes as the kernel."""
    res = x.to(torch.float32)
    qsum = torch.zeros_like(res)
    ids = []
    for cb in codebooks.to(torch.float32):
        dist = (cb * cb).sum(dim=1)[None, :] - 2.0 * (res @ cb.T)
        idx = torch.argmin(dist, dim=1)  # first occurrence
        chosen = cb[idx]
        res = res - chosen
        qsum = qsum + chosen
        ids.append(idx)
    return torch.stack(ids, dim=1).to(torch.int32), qsum


def rq_cascade(x: torch.Tensor, codebooks: torch.Tensor):
    """(sem_ids (B, L) int32, qsum (B, D)): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.is_cuda:
        return rq_cascade_cuda(x, codebooks)
    return rq_cascade_ref(x, codebooks)


@torch.no_grad()
def near_tie_rows(x: torch.Tensor, codebooks: torch.Tensor, sem_ids: torch.Tensor,
                  rel: float = 1e-5) -> torch.Tensor:
    """(B,) bool: rows whose cascade, followed along ``sem_ids`` in float64,
    meets a level where the two smallest distances are within
    ``rel * max |dist|`` of that level (over the batch). Two fp32
    implementations that sum in different orders may pick either codeword
    of such a row, and every later level follows that pick, so ids are
    compared exactly only on the other rows."""
    res = x.to(torch.float64)
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for level, cb in enumerate(codebooks.to(torch.float64)):
        dist = (cb * cb).sum(dim=1)[None, :] - 2.0 * (res @ cb.T)
        if dist.shape[1] > 1:
            two = torch.topk(dist, 2, dim=1, largest=False).values
            near |= (two[:, 1] - two[:, 0]) <= rel * dist.abs().max()
        res = res - cb[sem_ids[:, level].long()]
    return near
