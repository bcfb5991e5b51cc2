"""Paged KV attention ops (port of genrec_tpu/ops/paged.py).

K/V live in a page pool ``(num_pages, page_size, heads, head_dim)`` and
each decode slot names its pages through a block-table row. Conventions,
shared by the plain version and the CUDA kernel:

- page 0 is the reserved NULL page: unused block-table entries point at
  it, prefill writes of padded tails land in it, and attention never
  reads it unmasked (every position >= ``seq_lens[s]`` scores -1e9);
- masked positions are FILLED with -1e9 and kept inside the softmax, so a
  fully masked slot (``seq_lens[s] == 0``) returns the mean of V over all
  ``Pm * page`` positions, null page included;
- valid tokens are a CONTIGUOUS prefix of the slot's pages.

Routing: ``paged_attention_stats`` takes the plain version
(``_stats_fallback``) only for CPU tensors. For CUDA tensors it launches
the kernel or raises; there is no fallback on the card.
"""

from __future__ import annotations

import torch

from genrec_tpu_torch.kernels.paged_attention import (
    paged_attention_stats_cuda,
    paged_attention_stats_ref as _stats_fallback,
)

NEG = -1e9

__all__ = [
    "NEG", "gather_pages", "write_pages", "paged_attention_stats",
    "paged_attention", "_stats_fallback",
]


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(P, page, H, hd) pool + (S, Pm) block tables -> (S, Pm*page, H, hd)
    contiguous per-slot K or V."""
    S, Pm = block_tables.shape
    out = pool[block_tables.long()]  # (S, Pm, page, H, hd)
    return out.reshape(S, Pm * pool.shape[1], *pool.shape[2:])


def write_pages(pool: torch.Tensor, block_tables: torch.Tensor,
                kv: torch.Tensor) -> torch.Tensor:
    """Scatter one layer's prefill K or V into its slots' pages, IN PLACE
    (the JAX function returns a new pool; here the pool tensor is updated
    and returned, which saves a pool-sized copy per prefill).

    kv: (B, H, L, hd); block_tables (B, Pm). Rows padded with page 0 absorb
    the padded-tail writes (never read unmasked). Requires L <= Pm * page.
    """
    B, H, L, hd = kv.shape
    page = pool.shape[1]
    Pm = block_tables.shape[1]
    cap = Pm * page
    if L > cap:
        raise ValueError(
            f"prefill KV of {L} tokens exceeds the {Pm} x {page} page "
            f"capacity of a slot's block-table row"
        )
    rows = kv.transpose(1, 2)  # (B, L, H, hd)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, cap - L))
    rows = rows.reshape(B, Pm, page, H, hd).to(pool.dtype)
    pool[block_tables.long()] = rows
    return pool


def paged_attention_stats(q, k_pool, v_pool, block_tables, seq_lens):
    """Flash-stats attention of per-slot queries over paged K/V.

    q (S, K, H, hd); pools (P, page, H, hd); block_tables (S, Pm) int32;
    seq_lens (S,) int32. Returns (acc (S, K, H, hd), m (S, K, H),
    l (S, K, H)), all fp32: the unnormalised accumulator, running max and
    running sum over ALL Pm*page positions with masked ones at -1e9.
    """
    if q.is_cuda:
        return paged_attention_stats_cuda(q, k_pool, v_pool, block_tables, seq_lens)
    return _stats_fallback(q, k_pool, v_pool, block_tables, seq_lens)


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens) -> torch.Tensor:
    """Normalised paged attention output, (S, K, H, hd) in q's dtype:
    out = acc / l from the stats primitive."""
    acc, _, l = paged_attention_stats(q, k_pool, v_pool, block_tables, seq_lens)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
