"""Gumbel-softmax sampling (port of genrec_tpu/ops/gumbel.py).

The JAX functions draw from a ``jax.random`` key; here the draw comes
from a ``torch.Generator``, or the caller hands the uniforms in
(``uniform=``), which is how the tests feed both packages the same
noise.
"""

from __future__ import annotations

import torch


def sample_gumbel(shape, generator: torch.Generator | None = None, eps: float = 1e-20,
                  dtype=torch.float32, device=None, uniform: torch.Tensor | None = None):
    """-log(-log(u + eps) + eps) for u ~ U[0, 1) drawn from ``generator``
    (or the given ``uniform``)."""
    if uniform is None:
        uniform = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(uniform + eps) + eps)


def gumbel_softmax_sample(logits: torch.Tensor, temperature: float,
                          generator: torch.Generator | None = None,
                          uniform: torch.Tensor | None = None) -> torch.Tensor:
    """softmax((logits + Gumbel noise) / temperature) over the last axis."""
    y = logits + sample_gumbel(logits.shape, generator, dtype=logits.dtype,
                               device=logits.device, uniform=uniform)
    return torch.softmax(y / temperature, dim=-1)
