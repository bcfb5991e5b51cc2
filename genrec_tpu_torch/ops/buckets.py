"""T5 relative-position bucketing (port of genrec_tpu/ops/buckets.py).

Same arithmetic as the JAX function: the ``+1e-6`` inside the log, the
``-relative_positions`` sign flip, and the log increment clamped before
``max_exact`` is added, all in float32 with truncation toward zero.
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
