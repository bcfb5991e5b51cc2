"""Shared layers (port of genrec_tpu/models/layers.py: ``MLP`` and
``RMSNorm``), and the Flax-style ``Dense``, ``LayerNorm`` and ``dropout``
that the HSTU and SASRec ports share."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.ops.normalize import l2norm
from genrec_tpu_torch.parallel.mesh import draw_rows


def truncated_normal(shape, stddev: float, gen: torch.Generator) -> torch.Tensor:
    """Flax ``truncated_normal(stddev)`` (also ``lecun_normal`` with
    stddev = fan_in^-1/2): a standard normal cut at +-2, scaled by
    stddev / 0.8796 (the cut normal's standard deviation). CPU tensor."""
    std = stddev / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std,
                                 generator=gen)


class MLP(nn.Module):
    """Bias-free SiLU MLP with an optional L2-normalised output (the
    RQ-VAE encoder and decoder). Layers are ``dense_<i>``, the Flax names;
    weights are ``nn.Linear``'s (out, in). Initialised by the owner."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int,
                 normalize: bool = False, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dims = [in_dim, *hidden_dims, out_dim]
        self.n_dense = len(dims) - 1
        self.normalize = normalize
        for i in range(self.n_dense):
            self.add_module(f"dense_{i}",
                            nn.Linear(dims[i], dims[i + 1], bias=False, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_dense):
            x = getattr(self, f"dense_{i}")(x)
            if i != self.n_dense - 1:
                x = torch.nn.functional.silu(x)
        if self.normalize:
            x = l2norm(x)
        return x


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


def dropout(x, rate: float, deterministic: bool, generator=None, shard=None):
    """Flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate); the bits come from ``generator``.

    ``shard`` = (rank, tp): ``x`` is rank's block of a last axis tp times
    wider (a tensor-parallel hidden layer). The mask is drawn at the full
    width and this rank's block kept, so the generator advances and every
    unit draws as it would at tp = 1. In a data-parallel step the mask is
    drawn for the global batch and this rank's rows kept
    (``parallel.mesh.draw_rows``): x's leading axis is its batch rows (or
    a whole multiple of them)."""
    if deterministic or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if shard is None:
        keep = draw_rows(torch.rand, x.shape, generator=generator, device=x.device) < keep_prob
    else:
        rank, tp = shard
        n = x.shape[-1]
        full = draw_rows(torch.rand, (*x.shape[:-1], n * tp), generator=generator,
                         device=x.device)
        keep = full[..., rank * n:(rank + 1) * n] < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class Dense(nn.Linear):
    """Flax ``nn.Dense(dtype=...)``: float32 parameters cast to the compute
    dtype at use."""

    def __init__(self, in_features: int, out_features: int, dtype, device,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm(dtype=float32)``: statistics and output float32."""

    def forward(self, x):
        return super().forward(x.to(torch.float32))
