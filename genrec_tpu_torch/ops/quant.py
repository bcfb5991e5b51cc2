"""int8 symmetric quantisation for the serving memory path (port of
genrec_tpu/ops/quant.py: ``quantize_symmetric``, ``QuantizedKVPool`` and
``QuantizedTable``).

``QuantizedKVPool`` is one decode layer's K or V page pool as int8
``data`` (num_pages, page_size, heads, head_dim) plus one fp32 ``scale``
per page row (num_pages, page_size), reduced over heads x head_dim. The
scales live at the same page index as their rows, so any page movement
carries both.

Quantisation reproduces the JAX arithmetic step for step, so data and
scales are bit-equal to the JAX function's on the CPU: ``amax`` over the
reduced axes, ``scale = max(amax, 1e-12) / 127``, ``data = round(x /
scale)`` (a division, not a multiply by the reciprocal; round half to
even) clipped to [-127, 127]. An all-zero row gets scale 1e-12 / 127 and
dequantises to exact zeros. Consumers dequantise AFTER the gather
(``ops/paged.gather_pages``) or inside the kernel, never a whole pool.

``QuantizedTable`` is the retrieval heads' int8 item table: int8 ``data``
(V, d) plus one fp32 ``scale`` per row (V,), scored by
``parallel.shardings.item_topk`` as ``(h @ data.T) * scale``.
"""

from __future__ import annotations

import torch

# Smallest admissible scale: keeps x / scale finite for all-zero rows.
_EPS = 1e-12

KV_DTYPES = ("float32", "int8")


def quantize_symmetric(x: torch.Tensor, reduce_axes) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-quantise ``x`` with one scale per kept index. ``reduce_axes``:
    the axes folded into each scale (``(-2, -1)`` for per-token KV rows
    over heads x head_dim). Returns (data int8, scale fp32), scale shaped
    as ``x`` without the reduced axes."""
    x = x.to(torch.float32)
    dims = tuple(reduce_axes)
    amax = x.abs().amax(dim=dims)
    # A float32 tensor divisor: CUDA divides by a Python number by
    # multiplying with its reciprocal, which put scales one ulp off the
    # CPU's (and JAX's) amax / 127 on the card.
    scale = torch.clamp(amax, min=_EPS) / torch.full((), 127.0, dtype=torch.float32,
                                                     device=x.device)
    expand = scale
    for d in sorted(a % x.dim() for a in dims):
        expand = expand.unsqueeze(d)
    data = torch.clamp(torch.round(x / expand), -127, 127).to(torch.int8)
    return data, scale


class QuantizedKVPool:
    """One layer's K or V page pool: int8 ``data`` (P, page, H, hd) and
    fp32 ``scale`` (P, page). Stands where the fp32 (P, page, H, hd) pool
    stands in ``KVPagePool.k_pools`` / ``v_pools``; ``ops/paged.py``
    dispatches on it. Updated in place by ``put_rows`` and
    ``ops.paged.write_pages``."""

    __slots__ = ("data", "scale")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    @classmethod
    def zeros(cls, shape, device="cpu") -> "QuantizedKVPool":
        """All-zero pool of geometry ``shape`` = (P, page, H, hd). Scales
        start at 1, so a never-written page dequantises to zeros."""
        P, page = shape[0], shape[1]
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.ones((P, page), dtype=torch.float32, device=device))

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def dequantize(self) -> torch.Tensor:
        """The full fp32 pool, for tests and debugging only."""
        return self.data.to(torch.float32) * self.scale[:, :, None, None]

    def take_rows(self, pages: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(data[pages], scale[pages]): a page run's rows with their scales."""
        idx = pages.long()
        return self.data[idx], self.scale[idx]

    def put_rows(self, pages: torch.Tensor, data: torch.Tensor,
                 scale: torch.Tensor) -> "QuantizedKVPool":
        """Scatter quantised rows and their scales into ``pages``, IN PLACE
        (the JAX method returns a new pool). Returns self."""
        idx = pages.long()
        self.data[idx] = data.to(torch.int8)
        self.scale[idx] = scale.to(torch.float32)
        return self

    def __repr__(self):
        return f"QuantizedKVPool(data={self.data!r}, scale={self.scale!r})"


class QuantizedTable:
    """A 2-D table as int8 ``data`` (V, d) + fp32 per-row ``scale`` (V,).

    The retrieval heads' item-embedding operand: built once per weights
    version (``from_array``), scored by dequant-at-score in
    ``parallel.shardings.item_topk`` (``(h @ data.T) * scale``, which is
    ``h @ (data * scale[:, None]).T`` in fp32)."""

    __slots__ = ("data", "scale")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    @classmethod
    def from_array(cls, table: torch.Tensor) -> "QuantizedTable":
        """Quantise a (V, d) float table per row (symmetric int8)."""
        return cls(*quantize_symmetric(table.detach(), (-1,)))

    @property
    def shape(self):
        return self.data.shape

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def dequantize(self) -> torch.Tensor:
        return self.data.to(torch.float32) * self.scale[:, None]

    def __repr__(self):
        return f"QuantizedTable(data={self.data!r}, scale={self.scale!r})"
