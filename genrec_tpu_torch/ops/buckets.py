"""Position / time bucketing (port of genrec_tpu/ops/buckets.py).

Same arithmetic as the JAX functions, all in float32 with truncation
toward zero: T5's ``+1e-6`` inside the log, its ``-relative_positions``
sign flip and its log increment clamped before ``max_exact`` is added;
HSTU's clamp of the relative position at 0 and its time bucket
``int(log(max(|d|, 1)) / 0.693)``, clipped to the table.
"""

from __future__ import annotations

import math

import torch


def t5_relative_position_bucket(
    relative_positions: torch.Tensor,
    num_buckets: int = 32,
    max_distance: int = 128,
    bidirectional: bool = True,
) -> torch.Tensor:
    """T5 bucketing of ``key_pos - query_pos`` grids (int tensor in/out)."""
    ret = -relative_positions
    if bidirectional:
        num_buckets //= 2
        sign = (ret < 0).to(ret.dtype)
        ret = ret.abs()
    else:
        ret = ret.clamp_min(0)

    max_exact = num_buckets // 2
    is_small = ret < max_exact
    increment = (
        torch.log(ret.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(ret.dtype)
    large_val = max_exact + increment.clamp_max(num_buckets - max_exact - 1)

    ret = torch.where(is_small, ret, large_val)
    if bidirectional:
        ret = ret + sign * num_buckets
    return ret


def hstu_position_bucket(
    relative_position: torch.Tensor,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """HSTU causal bucketing of ``query_pos - key_pos`` (clamped to >= 0)."""
    rp = relative_position.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    # log(0) at rp=0 is safe: that branch is only selected when rp>=max_exact.
    large = max_exact + (
        torch.log(rp.clamp_min(1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(rp.dtype)
    large = large.clamp_max(num_buckets - 1)
    return torch.where(is_small, rp, large)


def hstu_log_bucket(time_diff: torch.Tensor, num_buckets: int = 64) -> torch.Tensor:
    """log2 bucketing of |timestamp differences|: floor(ln(max(1,|d|))/0.693).

    Float32 as on the CPU, on every device: the log is taken in float64
    and rounded (CUDA's float32 log is one ulp off on some inputs), and the
    divisor is a tensor, since CUDA divides by a Python number by
    multiplying with its reciprocal (|d| = 522,824, whose ln / 0.693 is
    19.0000002, then lands in bucket 18)."""
    abs_diff = time_diff.abs().clamp_min(1).to(torch.float32)
    log = torch.log(abs_diff.to(torch.float64)).to(torch.float32)
    ratio = torch.full((), 0.693, dtype=torch.float32, device=log.device)
    return (log / ratio).to(torch.int32).clamp(0, num_buckets - 1)
