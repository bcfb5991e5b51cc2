"""K-means (Lloyd) for codebook initialisation (port of
genrec_tpu/ops/kmeans.py).

Random-choice init, full-batch Lloyd until the largest centroid shift is
below ``stop_threshold`` or ``max_iters`` iterations ran, and dead
clusters reseeded from random data points. The JAX function draws from a
``jax.random`` key; here the draws come from a ``torch.Generator``, or
the caller names the initial rows (``init_idx``), which is how the tests
start both packages from the same rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KmeansOutput(NamedTuple):
    centroids: torch.Tensor  # (k, D)
    assignment: torch.Tensor  # (B,)


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """First-occurrence argmin of ||c||^2 - 2 x.c (||x||^2 is constant
    along the argmin)."""
    dots = x @ centroids.T
    c2 = centroids.square().sum(dim=-1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=-1)


@torch.no_grad()
def kmeans(x: torch.Tensor, k: int, generator: torch.Generator | None = None,
           max_iters: int = 200, stop_threshold: float = 1e-10,
           init_idx: torch.Tensor | None = None) -> KmeansOutput:
    """Run Lloyd's algorithm on ``x`` (B, D) -> k centroids. ``generator``
    (on x's device) draws the k distinct initial rows, unless ``init_idx``
    names them, and the reseed rows of dead clusters."""
    B = x.shape[0]
    if init_idx is None:
        init_idx = torch.randperm(B, generator=generator, device=x.device)[:k]
    centroids = x[init_idx.to(x.device).long()]
    for _ in range(max_iters):
        assignment = _assign(x, centroids)
        counts = torch.bincount(assignment, minlength=k).to(x.dtype)
        sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
        sums.index_add_(0, assignment, x)
        means = sums / torch.clamp(counts[:, None], min=1.0)
        rand_idx = torch.randint(0, B, (k,), generator=generator, device=x.device)
        new = torch.where(counts[:, None] > 0, means, x[rand_idx])
        shift = torch.linalg.vector_norm(new - centroids, dim=-1).max()
        centroids = new
        if float(shift) < stop_threshold:
            break
    return KmeansOutput(centroids=centroids, assignment=_assign(x, centroids))
