"""Deterministic gradient of a small table lookup: the CUDA kernel's
wrapper and its plain version.

``table_grad_cuda`` launches the hand-written Hopper kernel in
``genrec_tpu_torch/csrc/table_grad.cu``. It replaces no TPU kernel: it is
the backward of ``models/t5transformer._TableLookup`` (TIGER's relative
bias grid, 192 bins read ~5.7 M times an encoder layer), where
``torch.bincount(weights=)`` on CUDA adds through atomics in an order that
changes from run to run, so two identical TIGER steps gave different
bits. The kernel sums every bin in one fixed order (per-thread private
bins in shared memory, then a fixed-order reduction over threads and over
blocks). ``table_grad_ref`` is the plain version: ``torch.bincount``,
deterministic on the CPU. ``table_grad`` routes by device.

The kernel is bound by bytes: n * 12 (int64 index + fp32 gradient).
Nothing is built or imported when this module is imported.
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
    """Type the entry points of a build of ``csrc/table_grad.cu``."""
    lib.table_grad_layout.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.table_grad_layout.restype = None
    fn = lib.table_grad_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    lib.table_grad_error_string.argtypes = [ctypes.c_int]
    lib.table_grad_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(load_library("table_grad"))


def table_grad_cuda(idx: torch.Tensor, grad: torch.Tensor, bins: int) -> torch.Tensor:
    """Kernel twin of ``table_grad_ref``: (bins,) fp32, ``out[b]`` the sum
    of ``grad`` over the positions where ``idx == b``. idx (n,) int64 and
    grad (n,) fp32, contiguous, on one CUDA device. Raises on anything else,
    on more bins than a block's shared memory holds, and when the build or
    the launch fails. Launches on the current stream and does not
    synchronise. ``table_grad_cuda.launches`` counts the launches."""
    dev = grad.device
    check_tensor("idx", idx, (torch.int64,), dev)
    check_tensor("grad", grad, (torch.float32,), dev)
    if idx.dim() != 1 or grad.shape != idx.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and grad {tuple(grad.shape)} must be one (n,)")
    lib = _library()
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    lib.table_grad_layout(idx.numel(), bins, ctypes.byref(blocks), ctypes.byref(threads))
    if threads.value == 0:
        raise ValueError(f"{bins} bins do not fit a block's shared memory")
    rows = torch.empty((blocks.value, bins), dtype=torch.float32, device=dev)
    out = torch.empty((bins,), dtype=torch.float32, device=dev)
    rc = lib.table_grad_f32(idx.data_ptr(), grad.data_ptr(), rows.data_ptr(), out.data_ptr(),
                            idx.numel(), bins, blocks.value, threads.value, *launch_context(grad))
    raise_on_error(lib, "table_grad", "table_grad", rc)
    table_grad_cuda.launches += 1
    return out


table_grad_cuda.launches = 0


def table_grad_ref(idx: torch.Tensor, grad: torch.Tensor, bins: int) -> torch.Tensor:
    """Plain PyTorch version: a weighted histogram (``torch.bincount``,
    deterministic on the CPU)."""
    return torch.bincount(idx, weights=grad.to(torch.float32), minlength=bins)


def table_grad(idx: torch.Tensor, grad: torch.Tensor, bins: int) -> torch.Tensor:
    """(bins,) fp32 sums of ``grad`` by ``idx``: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if grad.is_cuda:
        return table_grad_cuda(idx, grad, bins)
    return table_grad_ref(idx, grad, bins)
