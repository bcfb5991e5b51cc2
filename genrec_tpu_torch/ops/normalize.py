"""Normalisation primitives (port of genrec_tpu/ops/normalize.py, the
part the RQ-VAE slice runs: ``l2norm``; ``rms_norm`` lives with its layer
in ``models/layers.py``)."""

from __future__ import annotations

import torch


def l2norm(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise along ``axis``: ``x / max(||x||, eps)``, the zero vector
    to zero. The squared norm is clamped BEFORE the sqrt, so the gradient
    stays finite at an exactly-zero vector (sqrt at 0 has an infinite
    derivative); ``max(sqrt(max(s, eps^2)), eps) == max(sqrt(s), eps)``."""
    sq = (x * x).sum(dim=axis, keepdim=True)
    n = torch.sqrt(torch.clamp(sq, min=eps * eps))
    return x / torch.clamp(n, min=eps)
