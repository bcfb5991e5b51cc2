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

A pool is an fp32 (P, page, H, hd) tensor or an ``ops.quant.
QuantizedKVPool`` (int8 rows + one fp32 scale per page row): the int8
pool is quantised where it is written (``write_pages``) and dequantised
after the gather (``gather_pages``, the plain versions) or inside the
kernel (B2), never as a whole.

Routing: ``paged_attention_stats`` takes the plain versions
(``_stats_fallback``, ``paged_attention_stats_quantized_ref``) only for
CPU tensors. For CUDA tensors it launches the kernel of the pool's type
(B1 fp32, B2 int8) or raises; there is no fallback on the card.
"""

from __future__ import annotations

import torch

from genrec_tpu_torch.kernels.paged_attention import (
    paged_attention_stats_cuda,
    paged_attention_stats_quantized_cuda,
    paged_attention_stats_quantized_ref,
    paged_attention_stats_ref as _stats_fallback,
)
from genrec_tpu_torch.ops.quant import QuantizedKVPool, quantize_symmetric

NEG = -1e9

__all__ = [
    "NEG", "gather_pages", "write_pages", "paged_attention_stats",
    "tree_suffix_stats", "merge_attention_stats", "paged_attention", "_stats_fallback",
]


def gather_pages(pool, block_tables: torch.Tensor) -> torch.Tensor:
    """(P, page, H, hd) pool + (S, Pm) block tables -> (S, Pm*page, H, hd)
    contiguous per-slot K or V. A ``QuantizedKVPool`` dequantises AFTER
    the gather: only the gathered rows are upcast to fp32."""
    S, Pm = block_tables.shape
    idx = block_tables.long()
    if isinstance(pool, QuantizedKVPool):
        out = pool.data[idx].to(torch.float32) * pool.scale[idx][..., None, None]
    else:
        out = pool[idx]  # (S, Pm, page, H, hd)
    return out.reshape(S, Pm * pool.shape[1], *pool.shape[2:])


def write_pages(pool, block_tables: torch.Tensor, kv: torch.Tensor):
    """Scatter one layer's prefill K or V into its slots' pages, IN PLACE
    (the JAX function returns a new pool; here the pool is updated and
    returned, which saves a pool-sized copy per prefill).

    kv: (B, H, L, hd); block_tables (B, Pm). Rows padded with page 0 absorb
    the padded-tail writes (never read unmasked). Requires L <= Pm * page.
    A ``QuantizedKVPool`` is quantised here, per (page, position) row over
    heads x head_dim, and each row's scale lands at the same page index.
    Several rows may scatter into page 0 in one call; an in-place scatter
    with repeated indices keeps one of them, and page 0's int8 data and
    its scales may then come from different rows. Page 0 is only ever
    read masked, so this changes no output.
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
    rows = rows.reshape(B, Pm, page, H, hd)
    idx = block_tables.long()
    if isinstance(pool, QuantizedKVPool):
        data, scale = quantize_symmetric(rows, (-2, -1))  # scale (B, Pm, page)
        pool.data[idx] = data
        pool.scale[idx] = scale
        return pool
    pool[idx] = rows.to(pool.dtype)
    return pool


def paged_attention_stats(q, k_pool, v_pool, block_tables, seq_lens):
    """Flash-stats attention of per-slot queries over paged K/V.

    q (S, K, H, hd); pools (P, page, H, hd) fp32 or ``QuantizedKVPool``s;
    block_tables (S, Pm) int32; seq_lens (S,) int32. Returns (acc (S, K, H, hd), m (S, K, H),
    l (S, K, H)), all fp32: the unnormalised accumulator, running max and
    running sum over ALL Pm*page positions with masked ones at -1e9.
    """
    if isinstance(k_pool, QuantizedKVPool):
        fn = (paged_attention_stats_quantized_cuda if q.is_cuda
              else paged_attention_stats_quantized_ref)
    else:
        fn = paged_attention_stats_cuda if q.is_cuda else _stats_fallback
    return fn(q, k_pool, v_pool, block_tables, seq_lens)


def tree_suffix_stats(q, vc_k, vc_v, node_steps):
    """Flash statistics of per-NODE queries over per-node virtual suffix
    caches with the tree-causal mask: the speculative tree's twin of the
    dense suffix partial of COBRA's paged step (plain torch, no kernel, as
    in JAX).

    q (S, N, H, hd): one query per tree node. vc_k / vc_v (S, N, Sc, H,
    hd): each node's virtual cache (``ops.spec_tree.tree_virtual_cache``).
    node_steps (S, N): the node's own cache slot; later slots score -1e9
    inside the softmax, as in the plain step. Returns (acc, m, l) fp32,
    to merge with the paged history partial through
    ``merge_attention_stats``.
    """
    hd = q.shape[-1]
    Sc = vc_k.shape[2]
    s = torch.einsum("bkhd,bkshd->bkhs", q, vc_k).to(torch.float32) * (hd**-0.5)
    slots = torch.arange(Sc, device=q.device)
    s = s.masked_fill(slots[None, None, None, :] > node_steps.long()[:, :, None, None], NEG)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    acc = torch.einsum("bkhs,bkshd->bkhd", e, vc_v.to(torch.float32))
    return acc, m, l


def merge_attention_stats(acc_a, m_a, l_a, acc_b, m_b, l_b) -> torch.Tensor:
    """Combine two flash partials into the jointly softmaxed output:
    softmax(concat(scores_a, scores_b)) @ concat(values) up to float
    association. COBRA's paged suffix step merges its paged history
    partial with its dense suffix partial through this."""
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)
    cb = torch.exp(m_b - m)
    l = l_a * ca + l_b * cb
    acc = acc_a * ca[..., None] + acc_b * cb[..., None]
    return acc / l.clamp_min(1e-30)[..., None]


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens) -> torch.Tensor:
    """Normalised paged attention output, (S, K, H, hd) in q's dtype:
    out = acc / l from the stats primitive."""
    acc, _, l = paged_attention_stats(q, k_pool, v_pool, block_tables, seq_lens)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
