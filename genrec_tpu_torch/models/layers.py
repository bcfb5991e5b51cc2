"""Shared layers (port of genrec_tpu/models/layers.py: ``RMSNorm``)."""

from __future__ import annotations

import torch
from torch import nn

from genrec_tpu_torch.device import resolve_device


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """T5-style RMS norm: variance in float32, no mean subtraction, no bias
    (genrec_tpu/ops/normalize.py ``rms_norm``)."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    variance = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(variance + eps)
    return (xf * weight.to(torch.float32)).to(dtype)


class RMSNorm(nn.Module):
    """T5-style RMS norm layer (fp32 statistics) over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-6, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)
