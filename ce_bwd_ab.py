#!/usr/bin/env python3
"""A/B of design variants of the port's kernels on one NVIDIA card: the
fused CE (B3, B4), the paged decode attention (B1, B2), the HSTU attention
backward (B6, bf16) and forward (B5, bf16), and the RQ cascade (B7).

    python3 ce_bwd_ab.py [--mode bwd|fwd|fp32|paged|hstu|hstu_fwd|rq] [--reps 3]
                         [--variants a,b] [--parent CHECKOUT] [--out FILE]

With `--parent`, the mode's kernel source of another checkout (say the
parent commit's, unpacked by `git archive` into a directory that
.gitignore lists) is built, checked and timed as variant `parent`, second
in turn; for `hstu` and `hstu_fwd`, through that checkout's own wrapper
module, typed by its own `bind`.

Builds genrec_tpu_torch/csrc/fused_ce.cu as it is and in variants made
by replacing a line or a few of it (each a copy under build/ce_bwd_ab/,
one nvcc each with `-Xptxas -v`, all started together), holds every
variant but `no_coeff_stores` to the plain versions (the bf16 backward
at 1e-2 of max |plain|, the forward's loss and lse and every fp32 output
at 1e-5), then times each by CUDA events over `--reps` calls, variants
in turns (the source first and last), with device time by kernel from
torch.profiler.

`--mode bwd` (the default), dx and dW:
- at an LCRec shard (R 4,088, V 76,608, d 1,536): the source; vocab
  chunks of 32 and 128 MB instead of 64; the coeff kernel on 128 x 128
  tiles instead of 128 x 256; the coeff kernel without its stores
  (timing only: what the stores cost);
- at the HSTU shape (R 6,400, V 12,102, d 64): the fused kernels against
  the chunked path.

`--mode fp32`, the fp32 FFMA kernels: the source (each 64-wide chunk of d
one fmaf chain, the chunks added) against `fp32_one_chain` (one chain
over all of d, the order before), each with `fused_linear_ce_ref`, held
to an fp64 evaluation of the same formulas (loss, lse, dx, dW; dx and dW
from the plain version's lse) at (33, 700, 2048) with x ~ N(0, 1) and
w ~ N(0, 0.1) unscaled, seeds 0-3; then the forward, dx and dW timed at
the LCRec parity run's fp32 shard (R 508, V 76,608, d 1,536).

`--mode fwd`, the forward, at both shapes: the source (128 x 256 tiles,
splits chosen by fwd_split, row tiles the grid's fast axis, exp2f of
logits scaled by log2 e); 128-column tiles; 8 and 32 splits; the splits
as the fast axis (at the chosen count and at 32); expf on unscaled
logits; one ex2.approx.ftz instruction instead of exp2f.

`--mode paged [--kinds f32,int8,bf16,int8_bf16q]`, B1 (fp32 pages, and
bf16 pages with a bf16 q) and B2 (int8 pages, with an fp32 or a bf16 q)
of genrec_tpu_torch/csrc/paged_attention.cu at the TIGER serving shape (K
10, H 6, hd 64, page 16, Pm 4, chip_smoke.py's served lengths) with S 64
and S 16 slots, at COBRA's (K 20, hd 128, Pm 5) and over TIGER's
730-node speculative tree with S 64. Variants of the fp32-q kernel
(`paged_attention_stats_kernel`): the source (live positions only,
cp.async, 8 warps a block, one block per (slot, head) unless that leaves
SMs idle, then the beams split over enough blocks, head dim a template
parameter, the slot's block-table row read once into shared memory);
`all_pages` (every position walked); `tma_bulk` (K/V rows by TMA bulk
copies, one mbarrier a stage, where rows are 16-byte multiples);
`splits_2` (always two blocks a (slot, head)); `warps_4` (4 warps a
block); `runtime_hd` (one instantiation at width 128, the dot's loop
bound hd at run time); `pages_from_global` (each copy reads its
block-table entry from global memory, the first design's way);
`compact_pairs` (scores of the live pairs only, spread evenly, a pair a
thread at a time, the dot in four partial sums); `warp_per_beam`; `lb_1`,
`lb_2`, `lb_3` (`__launch_bounds__` asking for 1, 2, 3 blocks an SM);
and, timed only, `empty` (the kernel returns at once: a launch inside
the graph), `copies_only` (the copies and their wait, no math) and
`no_ev` (no e.V). Variants of the bf16-q kernel
(`paged_attention_mma_kernel`, the `bf16` and `int8_bf16q` kinds):
`planes_2` (e in two bf16 planes, not three: ~16 bits of it),
`mma_lb_3` and `mma_lb_5` (`__launch_bounds__` asking for 3 or 5 blocks
an SM at hd <= 64, not 4 and 3), `mma_stcs` (acc stored by
`st.global.cs`), `mma_warps_8`
and `mma_warps_2` (at most 8, two blocks an SM asked for, or 2 warps
holding tiles, not 4),
`mma_nodes_64`, `_192`, `_256` and `_1024` (at most that many nodes a
block, not 128), `mma_fast_exp` (`__expf` for the weights) and `mma_min_warps_1` (no helper warps issuing copies); timed only,
`mma_empty`, `mma_copies_only` (q, the stages and the stores, no math)
and `mma_no_stores` (no acc stores). Each other variant is held to the
plain versions at 1e-5 of max |plain| (serving, a multi-stage shape, hd 6
and 8; a variant that disagrees is reported and not timed), then timed
as chip_smoke.py times B1 and B2: CUDA-graph replay over input copies
that together exceed L2 three times. With `--burst N`, chip_smoke.py's
bf16 COBRA burst (`cobra_serve_phase`, bf16 pages) is then served with
the source's library, the parent's and the source's again, each profiled
for the paged attention kernel's share of the burst's device time.

`--mode hstu`, the bf16 backward of genrec_tpu_torch/csrc/hstu_attention.cu
(`hstu_bwd_tc_kernel` and its table sums) at the HSTU trainer's shape (B
128, H 2, L 50, hd 32, packed with timestamps): the source (mma.sync on
64-position tiles, dS and silu(S) as bf16 hi + lo planes, the time bucket
from the edge table on every pair); `one_rounding` (dS and silu(S) rounded
to bf16 once: one plane); `log_every_pair` (the double-log bucket on every
pair); `bucket_visible_only` (the bucket behind a branch on visible pairs);
and, timed only, `empty` (returns at once), `loads_only` (the tiles'
copies and their wait, no math), `scores_only` (stops after S, dS and the
bins), `no_dk_dv` (skips the key-owned products) and `no_stores` (no
output stores). Each other variant is held to the plain version (dq, dk, dv
at 1e-2 and the tables at 1e-4 of max |plain|; trainer, left-padded, no
timestamps, L 200, hd 13) and to the source's bits, its errors printed with
whether they stay below a tenth of 1e-2, then timed by CUDA-graph replay
on cold copies, with device time by kernel from torch.profiler.

`--mode hstu_fwd`, the bf16 forward of genrec_tpu_torch/csrc/hstu_attention.cu
(`hstu_fwd_tc_kernel`) at the same shape: the source (mma.sync on
64-position tiles, a block per (b, h) and query tile, two warps a 16-row
group taking alternate 16-key steps at hd <= 64, each step S, then P =
silu(S) rounded once to bf16, then P.V from registers; the time bias
from one table of edges and biases); `log_every_pair` (the double-log
bucket on every pair); `split_1` (one warp a 16-row group); `split_2_lb1`
(two at every width, ptxas free to 255 registers: one block an SM);
`exact_silu` (s * sigmoid(s) with the exact exponential and division);
`tile_32` (32-position tiles); `heads_2` (two (b, h) a block); and,
timed only, `empty`, `loads_only`, `scores_only` (S and P, folded into
the sums without P.V) and `no_stores`. Each other variant is held to the
plain version at 1e-2 of max |plain| (trainer, left-padded, no
timestamps, L 200, hd 13) and to the source's bits, then timed like
`hstu`.

`--mode rq`, B7 of genrec_tpu_torch/csrc/rq_cascade.cu at one export chunk
(B 4,096, L 3, K 256, D 32): the source (32 rows a block, 4 x 8 register
tiles, the three codebooks by one TMA box a level); `cp_async` (staged by
16-byte cp.async instead); `per_level` (one level at a time behind
barriers); `tile_1x8` and `tile_8x8` (1 and 8 rows a thread); `rows_16`
(16 rows a block); and, timed only, `empty` and `staging_only` (the copies and the
norms, no scoring). Each other variant is held to the plain version (ids
exact outside near ties, at most 2% near ties, over six shapes) and to the
source's bits, then timed by CUDA-graph replay on cold copies.

CE inputs are seeded, warm in L2 between calls (unlike chip_smoke.py's
cold copies). Prints each variant's ptxas numbers for the kernels of the
mode, one JSON line per measurement, then the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
# The cells: the LCRec shard, the HSTU trainer's shape, and the LCRec parity
# run's fp32 shard.
SHAPES = {"shard": (4088, 76608, 1536), "hstu": (6400, 12102, 64),
          "fp32_shard": (508, 76608, 1536)}
BF16_TOL = 1e-2  # of max |plain|, as chip_smoke.py
FP32_TOL = 1e-5  # the forward's loss and lse, fp32 outputs: of max |plain|, as chip_smoke.py

_EXP2 = ("constexpr float kFwdScale = 1.4426950408889634f;\n"
         "__device__ __forceinline__ float fwd_exp(float v) { return exp2f(v); }\n"
         "__device__ __forceinline__ float fwd_log(float v) { return log2f(v); }")
_EXPF = ("constexpr float kFwdScale = 1.0f;\n"
         "__device__ __forceinline__ float fwd_exp(float v) { return expf(v); }\n"
         "__device__ __forceinline__ float fwd_log(float v) { return logf(v); }")
_SPLITS_32 = ("constexpr int kFwdSplits = 0;", "constexpr int kFwdSplits = 32;")
_SPLITS_FAST = ("constexpr bool kFwdRowsFast = true;", "constexpr bool kFwdRowsFast = false;")

# name -> the (line of fused_ce.cu replaced, its replacement) pairs, or None
VARIANTS = {
    "source": None,
    "chunk_32mb": ("constexpr long long kChunkBytes = 64LL << 20;",
                   "constexpr long long kChunkBytes = 32LL << 20;"),
    "chunk_128mb": ("constexpr long long kChunkBytes = 64LL << 20;",
                    "constexpr long long kChunkBytes = 128LL << 20;"),
    "coeff_128x128": ("static constexpr int bn = Mode == kCoeff ? 256 : kTcN;",
                      "static constexpr int bn = kTcN;"),
    "no_coeff_stores": ("        *reinterpret_cast<uint32_t*>(p.hi + o + col) = hi;\n"
                        "        *reinterpret_cast<uint32_t*>(p.lo + o + col) = lo;",
                        "        if (hi == lo && hi == 0x7fc07fc0u) *p.lo = p.hi[0];"),
    "chunked_at_d64": ("constexpr int kFusedDim = 64;", "constexpr int kFusedDim = 0;"),
    "fwd_cols_128": ("constexpr int kFwdN = 256;", "constexpr int kFwdN = 128;"),
    "fwd_splits_8": ("constexpr int kFwdSplits = 0;", "constexpr int kFwdSplits = 8;"),
    "fwd_splits_32": _SPLITS_32,
    "fwd_splits_fast": _SPLITS_FAST,
    "fwd_splits_32_fast": [_SPLITS_32, _SPLITS_FAST],
    "fwd_expf": (_EXP2, _EXPF),
    "fwd_ex2_approx": ("{ return exp2f(v); }", "{ float y; asm(\"ex2.approx.ftz.f32 %0, %1;\" "
                       ": \"=f\"(y) : \"f\"(v)); return y; }"),
    "fp32_one_chain": [
        ("""    float part[4][4];
    zero_acc(part);
    add_logits(x_s, w_s, kChunk + 1, min(kChunk, p.d - k0), ty, tx, part);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += part[r][c];""",
         "    add_logits(x_s, w_s, kChunk + 1, min(kChunk, p.d - k0), ty, tx, acc);"),
        ("""    for (int k0 = 0; k0 < p.d; k0 += kChunk) {
      float part = 0.f;
      for (int k = k0; k < min(k0 + kChunk, p.d); ++k) part = fmaf(xr[k], wt[k], part);
      tl += part;
    }""", "    for (int k = 0; k < p.d; ++k) tl = fmaf(xr[k], wt[k], tl);")],
}
TIMING_ONLY = {"no_coeff_stores"}

_BULK_HELPERS = """#include <type_traits>

#include "sm90.cuh"

namespace {
__shared__ uint64_t bulk_bars[4];
__shared__ unsigned char* bulk_ring;
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(sm90::smem_addr(dst)), "l"(src), "r"(bytes), "r"(sm90::smem_addr(bar)) : "memory");
}
}  // namespace"""
# Scores of only the stage's live (beam, position) pairs, spread evenly over
# the block, a thread a pair at a time (K row reread for each beam), the dot
# in four partial sums.
_COMPACT_SCORES = """template <int HD>
__device__ __forceinline__ void stage_scores_compact(const unsigned char* stage,
                                                     const float* q_s, float* sc_s, int Kb,
                                                     int t0, int n, int seq_len, float scale,
                                                     int tid) {
  using F = Stage<float, HD>;
  for (int i = tid; i < Kb * n; i += kThreads) {
    const int b = i / n;
    const int t = i - b * n;
    const float* krow = reinterpret_cast<const float*>(stage + t * F::kKRow);
    const float* qb = q_s + b * HD;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
      const float4 q4 = *reinterpret_cast<const float4*>(qb + d);
      part[0] = fmaf(q4.x, k4.x, part[0]);
      part[1] = fmaf(q4.y, k4.y, part[1]);
      part[2] = fmaf(q4.z, k4.z, part[2]);
      part[3] = fmaf(q4.w, k4.w, part[3]);
    }
    const float dot = (part[0] + part[1]) + (part[2] + part[3]);
    sc_s[b * kScRow + t] = t0 + t >= seq_len ? kNeg : dot * scale;
  }
  const int rest = kStageTokens - n;
  for (int i = tid; i < Kb * rest; i += kThreads) {
    const int b = i / rest;
    sc_s[b * kScRow + n + (i - b * rest)] = -INFINITY;
  }
}

"""
# The first design's softmax and e.V: a warp a beam (beams warp, warp + 8,
# ...), 2 positions a lane in the reductions, then the stage's positions in
# turn, each beam of the warp in turn, lanes across head_dim (2 floats a
# lane at hd 64).
_WARP_BEAMS = """template <int HD>
struct WarpBeams {
  static constexpr int kSlots = kMaxBeams / kWarps;
  static constexpr int kLane = HD / 32;
  float m[kSlots], l[kSlots], acc[kSlots][kLane];
  int warp, lane;

  __device__ __forceinline__ explicit WarpBeams(int tid) : warp(tid >> 5), lane(tid & 31) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      m[j] = -INFINITY;
      l[j] = 0.f;
#pragma unroll
      for (int w = 0; w < kLane; ++w) acc[j][w] = 0.f;
    }
  }

  __device__ __forceinline__ bool low(int Kb) const {
    bool r = false;
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (warp + kWarps * j < Kb && m[j] <= kNeg + kSkipMargin) r = true;
    return r;
  }

  __device__ __forceinline__ void stage(float* sc_s, const unsigned char* vrows, int n,
                                        int Kb) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int b = warp + kWarps * j;
      if (b < Kb) {
        float* row = sc_s + b * kScRow;
        float mx = -INFINITY;
#pragma unroll
        for (int k = lane; k < kStageTokens; k += 32) mx = fmaxf(mx, row[k]);
        const float m_new = fmaxf(m[j], warp_max(mx));
        const float corr = expf(m[j] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int k = lane; k < kStageTokens; k += 32) {
          const float e = expf(row[k] - m_new);
          row[k] = e;
          sum += e;
        }
        l[j] = l[j] * corr + warp_sum(sum);
        m[j] = m_new;
#pragma unroll
        for (int w = 0; w < kLane; ++w) acc[j][w] *= corr;
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      float v[kLane];
      lane_floats<kLane>(reinterpret_cast<const float*>(vrows + t * Stage<float, HD>::kVRow),
                         lane, v);
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int b = warp + kWarps * j;
        if (b < Kb) {
          const float e = sc_s[b * kScRow + t];
#pragma unroll
          for (int w = 0; w < kLane; ++w) acc[j][w] = fmaf(e, v[w], acc[j][w]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(const Params& p, int s, int h, int b_lo,
                                        int Kb) const {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int b = warp + kWarps * j;
      if (b < Kb) {
        const size_t o = (size_t)(s * p.K + b_lo + b) * p.H + h;
#pragma unroll
        for (int w = 0; w < kLane; ++w) {
          const int d = lane * kLane + w;
          if (d < p.hd) p.acc[o * p.hd + d] = acc[j][w];
        }
        if (lane == 0) {
          p.m[o] = m[j];
          p.l[o] = l[j];
        }
      }
    }
  }
};

"""
# name -> the (text of paged_attention.cu replaced, its replacement) pairs, or None
PAGED_VARIANTS = {
    "source": None,
    "all_pages": ("const int n_live = seq_len > 0 ? min(seq_len, cap) : cap;",
                  "const int n_live = cap;"),
    "splits_2": ("p.beams_per_block = min(p.K, kMaxBeams);",
                 "p.beams_per_block = min((p.K + 1) / 2, kMaxBeams);"),
    "lb_1": ("__global__ void __launch_bounds__(kThreads)",
             "__global__ void __launch_bounds__(kThreads, 1)"),
    "lb_2": ("__global__ void __launch_bounds__(kThreads)",
             "__global__ void __launch_bounds__(kThreads, 2)"),
    "lb_3": ("__global__ void __launch_bounds__(kThreads)",
             "__global__ void __launch_bounds__(kThreads, 3)"),
    "warps_4": ("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),
    "pages_from_global": [
        ("(((size_t)pages[pi] * p.page + (pos - pi * p.page)) * p.H + h) * p.hd * sizeof(T) + b0;",
         "(((size_t)min(max(__ldg(p.block_tables + (size_t)blockIdx.x * p.Pm + pi), 0), p.P - 1)"
         " * p.page + (pos - pi * p.page)) * p.H + h) * p.hd * sizeof(T) + b0;"),
        ("const size_t at = (size_t)pages[pi] * p.page + (pos - pi * p.page);",
         "const size_t at = (size_t)min(max(__ldg(p.block_tables + (size_t)blockIdx.x * p.Pm + pi),"
         " 0), p.P - 1) * p.page + (pos - pi * p.page);")],
    "runtime_hd": [
        ("  if (p.hd <= 32) return launch_hd<T, 32>(p, S, st);\n"
         "  if (p.hd <= 64) return launch_hd<T, 64>(p, S, st);\n", ""),
        ("float scale, int tid) {", "float scale, int tid, int hd) {"),
        ("seq_len, p.scale, tid);", "seq_len, p.scale, tid, p.hd);"),
        ("for (int d = 0; d < HD; d += 4) {", "for (int d = 0; d < hd; d += 4) {")],
    "compact_pairs": [
        ("template <typename T, int HD>\n__global__",
         _COMPACT_SCORES + "template <typename T, int HD>\n__global__"),
        ("stage_scores<HD>(rows,", "stage_scores_compact<HD>(rows,")],
    "tma_bulk": [
        ("#include <type_traits>", _BULK_HELPERS),
        ("  for (int i = tid; i < n * L::kUnits; i += kThreads) {", """  if (p.copy_bytes == 16) {
    if (tid < 32) {
      uint64_t* bar = &bulk_bars[(stage - bulk_ring) / L::kBytes];
      if (tid == 0) sm90::mbar_expect_tx(bar, 2 * n * row_bytes);
      __syncwarp();
      for (int r = tid; r < n; r += 32) {
        const int pos = t0 + r;
        const int pi = pos / p.page;
        const size_t row =
            (((size_t)pages[pi] * p.page + (pos - pi * p.page)) * p.H + h) * row_bytes;
        bulk_copy(stage + r * L::kKRow, static_cast<const char*>(p.k_pool) + row, row_bytes, bar);
        bulk_copy(stage + L::kV + r * L::kVRow, static_cast<const char*>(p.v_pool) + row,
                  row_bytes, bar);
      }
    }
  } else
  for (int i = tid; i < n * L::kUnits; i += kThreads) {"""),
        ("  unsigned char* ring = reinterpret_cast<unsigned char*>(sc_s + Kb * kScRow);",
         """  unsigned char* ring = reinterpret_cast<unsigned char*>(sc_s + Kb * kScRow);
  if (tid == 0) {
    for (int i = 0; i < kMaxStages; ++i) sm90::mbar_init(&bulk_bars[i], 1);
    sm90::fence_barrier_init();
    bulk_ring = ring;
  }
  __syncthreads();
  uint32_t bulk_phase = 0;"""),
        ("      cp_async_wait(p.stages - 1);\n", """      cp_async_wait(p.stages - 1);
      if (p.copy_bytes == 16) {
        sm90::mbar_wait(&bulk_bars[st % p.stages], (bulk_phase >> (st % p.stages)) & 1);
        bulk_phase ^= 1u << (st % p.stages);
      }
""")],
    "warp_per_beam": [
        ("template <int HD>\nusing Beams", _WARP_BEAMS + "template <int HD>\nusing Beams"),
        ("using Beams = HalfWarpBeams<HD>;", "using Beams = WarpBeams<HD>;")],
    # Timing only: the kernel returns at once (a launch inside the graph),
    # or copies and waits for the live positions and does no math.
    "empty": ("  if (Kb <= 0) return;", "  if (Kb <= 0 || p.K > 0) return;"),
    "copies_only": [
        ("      __syncthreads();  // every thread's copies of stage st have landed\n",
         "      __syncthreads();  // every thread's copies of stage st have landed\n"
         "      if (p.K > 0) { cp_async_commit(); continue; }\n"),
        ("if (!__syncthreads_or(beams.low(Kb)) || n_live == cap) break;",
         "if (!__syncthreads_or(false) || n_live == cap) break;")],
}
PAGED_VARIANTS["no_ev"] = ("      if (b < Kb) {\n        const float* e = sc_s",
                           "      if (b < Kb && Kb < 0) {\n        const float* e = sc_s")
# The bf16-q kernel (paged_attention_mma_kernel): e in two bf16 planes,
# not three; __launch_bounds__ asking for 3 or 5 blocks an SM at hd <= 64
# (not 4 over bf16 pages and 3 over int8); acc by streaming stores
# (st.global.cs); at most 8 warps holding tiles (2 blocks an SM asked
# for) or 2, not 4; at most 64, 192, 256 or 1,024 nodes a block, not 128;
# __expf (ex2.approx) for the weights; no helper warps issuing copies;
# and, timed only, the kernel returning at once, or copying q and the
# stages and storing with no math, or with no acc stores.
_MMA_WARPS = "constexpr int kMmaWarps = 4;"
_MMA_NODES = "constexpr int kMmaNodes = 128;"
PAGED_VARIANTS.update({
    "planes_2": ("constexpr int kEPlanes = 3;", "constexpr int kEPlanes = 2;"),
    "mma_lb_3": ("return hd > 64 ? 1 : int8 ? 3 : 4;", "return hd > 64 ? 1 : 3;"),
    "mma_lb_5": ("return hd > 64 ? 1 : int8 ? 3 : 4;", "return hd > 64 ? 1 : 5;"),
    "mma_warps_8": [(_MMA_WARPS, "constexpr int kMmaWarps = 8;"),
                    ("return hd > 64 ? 1 : int8 ? 3 : 4;", "return hd > 64 ? 1 : 2;")],
    "mma_warps_2": (_MMA_WARPS, "constexpr int kMmaWarps = 2;"),
    "mma_nodes_64": (_MMA_NODES, "constexpr int kMmaNodes = 64;"),
    "mma_nodes_256": (_MMA_NODES, "constexpr int kMmaNodes = 256;"),
    "mma_fast_exp": ("        sc[j][e] = expf(sc[j][e] - m[e >> 1]);",
                     "        sc[j][e] = __expf(sc[j][e] - m[e >> 1]);"),
    "mma_nodes_192": (_MMA_NODES, "constexpr int kMmaNodes = 192;"),
    "mma_nodes_1024": (_MMA_NODES, "constexpr int kMmaNodes = 1024;"),
    "mma_min_warps_1": ("return hd > 64 ? 2 : 4;", "return hd > 64 ? 1 : 1;"),
    "mma_empty": ("  if (Kb < 1) return;", "  if (Kb < 1 || p.K > 0) return;"),
    "mma_no_stores": ("          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);",
                      "          if (src[0] == 12345.f)\n"
                      "            *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);"),
    "mma_stcs": ("          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);",
                 "          __stcs(reinterpret_cast<float4*>(dst), *reinterpret_cast<const float4*>(src));"),
    "mma_copies_only": ("    const int mi = lane >> 3, rr = lane & 7;\n    float sc[kSTiles][4];",
                        "    if (scale > 0.f) { m[0] = m[1] = 0.f; return; }\n"
                        "    const int mi = lane >> 3, rr = lane & 7;\n    float sc[kSTiles][4];"),
})
PAGED_TIMING_ONLY = {"empty", "copies_only", "no_ev", "mma_empty", "mma_copies_only",
                     "mma_no_stores"}
# The time bucket with a log (int32 wrap, the float32 log taken in double and
# rounded), as the kernels read it before the edge table: put in before
# sigmoid() by the log_every_pair variants.
_LOG_BUCKET = (
    "__device__ __forceinline__ float sigmoid(float s)",
    "__device__ __forceinline__ int time_bucket(int tq, int tk, int ntb) {\n"
    "  const int diff = (int)((unsigned)tq - (unsigned)tk);\n"
    "  const int a = (int)(diff < 0 ? 0u - (unsigned)diff : (unsigned)diff);\n"
    "  const float lg = (float)log((double)(float)(a > 1 ? a : 1));\n"
    "  const int b = (int)(lg / 0.693f);\n"
    "  return b < 0 ? 0 : (b > ntb - 1 ? ntb - 1 : b);\n"
    "}\n\n"
    "__device__ __forceinline__ float sigmoid(float s)")
# name -> the (text of hstu_attention.cu replaced, its replacement) pairs, or None
HSTU_VARIANTS = {
    "source": None,
    "one_rounding": ("constexpr int kPlanes = 2;", "constexpr int kPlanes = 1;"),
    "log_every_pair": [_LOG_BUCKET,
                       ("              tb = time_bucket_edges(qr.x, kr.x, edges, p.ntb);",
                        "              tb = time_bucket(qr.x, kr.x, p.ntb);")],
    "bucket_visible_only": ("            if (use_time) {\n              tb = time_bucket_edges",
                            "            if (use_time && vis) {\n              tb = time_bucket_edges"),
    # Timing only: the kernel returns at once (a launch inside the graph);
    # loads its tiles and waits for them and does no math; stops after the
    # scores, dS and the bins; or skips dk and dv.
    "empty": ("  // Every visible pair has key <= query, so rel <= 0 reads the bucket of 0.\n",
              "  if (p.L > 0) return;\n"),
    "loads_only": ("      cp_async_wait_all();\n      __syncthreads();\n",
                   "      cp_async_wait_all();\n      __syncthreads();\n      if (p.L > 0) continue;\n"),
    "scores_only": ("      // dq of the warp's rows:", "      if (p.L > 0) continue;\n      // dq of the warp's rows:"),
    "no_dk_dv": ("      if (kw < L) {", "      if (kw < L && p.L < 0) {"),
    "no_stores": ("  if (col >= hd) return;\n", "  if (col >= hd || acc[0] != 12345.f) return;\n"),
}
HSTU_TIMING_ONLY = {"empty", "loads_only", "scores_only", "no_dk_dv", "no_stores"}
_HSTU = ["source", "one_rounding", "log_every_pair", "bucket_visible_only", "empty", "loads_only",
         "scores_only", "no_dk_dv", "no_stores", "source"]
# The bf16 forward (hstu_fwd_tc_kernel): name -> replacements, as above.
HSTU_FWD_VARIANTS = {
    "source": None,
    "log_every_pair": [_LOG_BUCKET, (
        "          s = s + __int_as_float(a >= tb.x ? tb.z : tb.y);",
        "          s = s + __int_as_float(time_bucket(qr.x, kr.x, 64) > 31 - __clz(a > 1 ? a : 1)"
        " ? tb.z : tb.y);")],
    "split_1": ("  static constexpr int kSplit = HDP <= 64 ? 2 : 1;",
                "  static constexpr int kSplit = 1;"),
    "split_2_lb1": [("  static constexpr int kSplit = HDP <= 64 ? 2 : 1;",
                     "  static constexpr int kSplit = 2;"),
                    ("__launch_bounds__(FwdCfg<HDP>::kThreads, 2)",
                     "__launch_bounds__(FwdCfg<HDP>::kThreads, 1)")],
    "exact_silu": ("        x[e] = vis ? silu_fast(s) : 0.f;",
                   "        x[e] = vis ? s * sigmoid(s) : 0.f;"),
    "tile_32": ("constexpr int kFwdTile = 64;", "constexpr int kFwdTile = 32;"),
    "heads_2": [("constexpr int kFwdHeads = 1;", "constexpr int kFwdHeads = 2;"),
                ("__launch_bounds__(FwdCfg<HDP>::kThreads, 2)",
                 "__launch_bounds__(FwdCfg<HDP>::kThreads, 1)")],
    # Timing only: the kernel returns at once; loads its tiles and waits for
    # them and does no math; computes S and P and folds P into the sums
    # without P.V; or stores nothing.
    "empty": ("  float pbias = 0.f;  // a visible pair has key <= query: position bucket of 0\n",
              "  if (p.L > 0) return;\n"
              "  float pbias = 0.f;  // a visible pair has key <= query: position bucket of 0\n"),
    "loads_only": ("    if (!rows_in) continue;\n", "    if (!rows_in || p.L > 0) continue;\n"),
    "scores_only": ("      // out += P.V over the step's 16 keys, two dim tiles a B load.\n",
                    "      if (p.L > 0) {\n"
                    "        for (int e = 0; e < 4; ++e) oacc[0][e] += __uint_as_float(pf[e]);\n"
                    "        continue;\n"
                    "      }\n"
                    "      // out += P.V over the step's 16 keys, two dim tiles a B load.\n"),
    "no_stores": ("      emit_frag(oacc[dn], q0 + rw, 8 * dn, lane,",
                  "      if (oacc[dn][0] == 12345.f) emit_frag(oacc[dn], q0 + rw, 8 * dn, lane,"),
}
HSTU_FWD_TIMING_ONLY = {"empty", "loads_only", "scores_only", "no_stores"}
_HSTU_FWD = ["source", "log_every_pair", "split_1", "split_2_lb1", "exact_silu", "tile_32",
             "heads_2", "empty", "loads_only", "scores_only", "no_stores", "source"]
# name -> the (text of rq_cascade.cu replaced, its replacement) pairs, or None
RQ_VARIANTS = {
    "source": None,
    "per_level": ("const int staged = smem_bytes(L, K, D) <= (size_t)optin ? L : 1;",
                  "const int staged = 1;"),
    "tile_1x8": ("constexpr int kTileRows = 4;", "constexpr int kTileRows = 1;"),
    "tile_8x8": ("constexpr int kTileRows = 4;", "constexpr int kTileRows = 8;"),
    "rows_16": ("constexpr int kBlockRows = 32;", "constexpr int kBlockRows = 16;"),
    # Timing only: the kernel returns at once, or after staging the
    # codebooks and their norms.
    "empty": ("  __shared__ uint64_t bars[2];", "  if (B > 0) return;\n  __shared__ uint64_t bars[2];"),
    "staging_only": ("    if (r0 >= nrows) continue;", "    if (r0 >= nrows || B > 0) continue;"),
}
RQ_VARIANTS["cp_async"] = ("  int tma = staged == L && D == 32 && K <= 256 && K % 8 == 0;",
                            "  int tma = 0;")
RQ_TIMING_ONLY = {"empty", "staging_only"}
_RQ = ["source", "cp_async", "per_level", "tile_1x8", "tile_8x8", "rows_16", "empty",
       "staging_only", "source"]
# B1 and B2 cells: name -> (S slots, shape): TIGER's serving shape, COBRA's
# and TIGER's speculative tree (chip_smoke.py's, with its served lengths).
PAGED_CELLS = {"s64": (64, "tiger"), "s16": (16, "tiger"), "cobra_s64": (64, "cobra"),
               "tree_s64": (64, "tree")}
_PAGED = ["source", "all_pages", "tma_bulk", "splits_2", "warps_4", "runtime_hd",
          "pages_from_global", "compact_pairs", "warp_per_beam", "lb_1", "lb_2", "lb_3", "empty",
          "copies_only", "no_ev", "planes_2", "mma_lb_3", "mma_lb_5", "mma_stcs", "mma_warps_8", "mma_warps_2",
          "mma_nodes_64", "mma_nodes_192", "mma_nodes_256", "mma_nodes_1024", "mma_fast_exp",
          "mma_min_warps_1", "mma_empty", "mma_copies_only",
          "mma_no_stores", "source"]
_FWD = ["source", "fwd_cols_128", "fwd_splits_8", "fwd_splits_32", "fwd_splits_fast",
        "fwd_splits_32_fast", "fwd_expf", "fwd_ex2_approx", "source"]
AT = {"bwd": {"shard": ["source", "chunk_32mb", "chunk_128mb", "coeff_128x128",
                        "no_coeff_stores", "source"],
              "hstu": ["source", "chunked_at_d64", "source"]},
      "fwd": {"shard": _FWD, "hstu": _FWD},
      "fp32": {"fp32_shard": ["source", "fp32_one_chain", "source"]},
      "paged": {cell: _PAGED for cell in PAGED_CELLS},
      "hstu": {"trainer_bf16": _HSTU}, "hstu_fwd": {"trainer_bf16": _HSTU_FWD},
      "rq": {"export_chunk": _RQ}}
# Each mode's source stem (csrc/<stem>.cu) and variants, where not fused_ce's.
STEMS = {"paged": ("paged_attention", PAGED_VARIANTS), "hstu": ("hstu_attention", HSTU_VARIANTS),
         "hstu_fwd": ("hstu_attention", HSTU_FWD_VARIANTS), "rq": ("rq_cascade", RQ_VARIANTS)}
FP32_WIDE = (33, 700, 2048)
# The kernels each mode reports ptxas numbers of: a fragment of the name.
PTXAS_OF = {"bwd": ("ce_tc_kernel", "ce_fused_kernel"), "fwd": ("ce_fwd",),
            "fp32": ("ce_fwd_kernel", "ce_lse", "wide"), "paged": ("paged_attention",),
            "hstu": ("hstu_bwd",), "hstu_fwd": ("hstu_fwd",), "rq": ("rq_cascade",)}


def build(name: str, replace, stem: str = "fused_ce", csrc: Path | None = None
          ) -> tuple[Path, str]:
    """The variant's library of csrc/<stem>.cu (of another checkout's
    csrc where given) and what ptxas printed."""
    from genrec_tpu_torch.kernels import build as kb

    csrc = csrc or kb.CSRC
    out = HERE / "build" / "ce_bwd_ab" / f"{stem}-{name}"
    out.mkdir(parents=True, exist_ok=True)
    src = (csrc / f"{stem}.cu").read_text()
    for old, new in ([replace] if isinstance(replace, tuple) else replace or []):
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not in {stem}.cu once: {old}")
        src = src.replace(old, new)
    (out / f"{stem}.cu").write_text(src)
    for header in csrc.glob("*.cuh"):  # a variant may include one the source does not
        (out / header.name).write_text(header.read_text())
    lib = out / f"lib{stem}.so"
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                           str(out / f"{stem}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    return lib, proc.stdout + proc.stderr


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_ce_workspace.argtypes = [i32] * 5
    lib.fused_ce_workspace.restype = ctypes.c_longlong
    lib.fused_ce_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr, i32]
    lib.fused_ce_fwd.restype = i32
    for fn in (lib.fused_ce_dx, lib.fused_ce_dw):
        fn.argtypes = [ptr] * 7 + [i32] * 6 + [ptr, i32]
        fn.restype = i32
    return lib


def inputs(dev, R, V, d, seed, dtype=torch.bfloat16, w_std=0.02, g_normal=False):
    """x ~ N(0, 1), w ~ N(0, w_std), 20% of rows at the ignored id 0, the
    mean loss's g (or g ~ N(0, 1) a row); lse from the plain forward."""
    from genrec_tpu_torch.kernels.fused_ce import fused_linear_ce_ref

    rng = np.random.default_rng(seed)
    t = rng.integers(0, V, R).astype(np.int32)
    t[rng.random(R) < 0.2] = 0
    x = torch.as_tensor(rng.normal(size=(R, d)).astype(np.float32), device=dev).to(dtype)
    w = torch.as_tensor((rng.normal(size=(V, d)) * w_std).astype(np.float32), device=dev)
    w = w.to(dtype)
    targets = torch.as_tensor(t, device=dev)
    g = (torch.as_tensor(rng.normal(size=R).astype(np.float32), device=dev) if g_normal
         else torch.full((R,), 1.0 / R, device=dev))
    return dict(x=x, w=w, targets=targets, g=g, lse=fused_linear_ce_ref(x, w, targets)[1])


def fp64_errors(lib, a) -> dict:
    """max |version - fp64| / max |fp64| of loss, lse, dx and dW, for the
    kernels of ``lib`` and for the plain versions: the fp64 side evaluates
    the same formulas (dx and dW from the plain version's lse, as both
    versions get it)."""
    from genrec_tpu_torch.kernels import fused_ce as fc

    x, w, t, g, lse = (a[k] for k in ("x", "w", "targets", "g", "lse"))
    l64 = x.double() @ w.double().T
    lse64 = torch.logsumexp(l64, -1)
    tl64 = l64.gather(1, t.long()[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(t.long(), w.shape[0]).double()
    c64 = torch.where(t == 0, 0.0, g.double())[:, None] * (
        torch.exp(l64 - lse.double()[:, None]) - onehot)
    want = dict(loss=torch.where(t == 0, 0.0, lse64 - tl64), lse=lse64, dx=c64 @ w.double(),
                dw=c64.T @ x.double())
    (loss, lse_k), _ = call(lib, "fwd", a)
    got = {"kernel": dict(loss=loss, lse=lse_k, dx=call(lib, "dx", a)[0],
                          dw=call(lib, "dw", a)[0]),
           "plain": dict(zip(("loss", "lse"), fc.fused_linear_ce_ref(x, w, t)),
                         dx=fc.fused_linear_ce_dx_ref(x, w, t, lse, g),
                         dw=fc.fused_linear_ce_dw_ref(x, w, t, lse, g))}
    return {who: {k: float((v.double() - want[k]).abs().max() / want[k].abs().max())
                  for k, v in outs.items()} for who, outs in got.items()}


def call(lib, which, a, ws=None):
    R, d = a["x"].shape
    V = a["w"].shape[0]
    bf16 = int(a["x"].dtype == torch.bfloat16)
    if ws is None:
        n = lib.fused_ce_workspace(("fwd", "dx", "dw").index(which), R, V, d, bf16)
        ws = torch.empty((max(n, 1),), dtype=torch.float32, device=a["x"].device)
    if which == "fwd":
        loss, lse = (torch.empty((R,), dtype=torch.float32, device=a["x"].device)
                     for _ in range(2))
        rc = lib.fused_ce_fwd(
            a["x"].data_ptr(), a["w"].data_ptr(), a["targets"].data_ptr(), loss.data_ptr(),
            lse.data_ptr(), ws.data_ptr(), R, V, d, 0, V, bf16,
            torch.cuda.current_stream().cuda_stream, a["x"].device.index)
        if rc != 0:
            raise RuntimeError(f"fused_ce_fwd failed: {rc}")
        return (loss, lse), ws
    out = torch.empty_like(a["x"] if which == "dx" else a["w"])
    rc = getattr(lib, f"fused_ce_{which}")(
        a["x"].data_ptr(), a["w"].data_ptr(), a["targets"].data_ptr(), a["lse"].data_ptr(),
        a["g"].data_ptr(), out.data_ptr(), ws.data_ptr(), R, V, d, 0, V, bf16,
        torch.cuda.current_stream().cuda_stream, a["x"].device.index)
    if rc != 0:
        raise RuntimeError(f"fused_ce_{which} failed: {rc}")
    return out, ws


def check(lib, which, a) -> float:
    from genrec_tpu_torch.kernels import fused_ce as fc

    got, _ = call(lib, which, a)
    if which == "fwd":
        err = 0.0
        for name, g, p in zip(("loss", "lse"), got,
                              fc.fused_linear_ce_ref(a["x"], a["w"], a["targets"])):
            scale = float(p.abs().max())
            e = float((g - p).abs().max())
            if not e <= FP32_TOL * scale:
                raise RuntimeError(f"{name}: max abs err {e} > {FP32_TOL} x {scale}")
            err = max(err, e)
        return err
    plain = (fc.fused_linear_ce_dx_ref if which == "dx" else fc.fused_linear_ce_dw_ref)(
        a["x"], a["w"], a["targets"], a["lse"], a["g"])
    scale = float(plain.float().abs().max())
    err = float((got.float() - plain.float()).abs().max())
    tol = BF16_TOL if got.dtype == torch.bfloat16 else FP32_TOL
    if not err <= tol * scale:
        raise RuntimeError(f"{which}: max abs err {err} > {tol} x {scale}")
    return err


def timed(lib, which, a, reps) -> dict:
    from torch.profiler import ProfilerActivity, profile

    _, ws = call(lib, which, a)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call(lib, which, a, ws)
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call(lib, which, a, ws)
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            m = re.search(r"ce_\w+(<[^>]*>)?", ev.key)
            by_kernel[m.group(0) if m else ev.key[:60]] = ev.device_time_total / reps / 1e3
    return dict(ms=start.elapsed_time(end) / reps, ms_by_kernel=by_kernel,
                workspace_bytes=ws.numel() * 4)


def paged_check_cases():
    """name -> (S, K, H, hd, page, Pm, seq_lens, null_tail): the serving
    shape, a shape that streams 4 stages through a ring of 2, and hd 8 and
    6 (4-byte and, for int8, byte copies)."""
    import chip_smoke as cs

    return {"serving": (cs.PAGED["max_slots"], cs.BEAMS, 6, 64, 16, 4, served_lens(), True),
            "multi_stage": (2, 10, 2, 128, 16, 16, [256, 130], False),
            "hd8": (5, 3, 2, 8, 8, 3, [24, 0, 9, 1, 17], True),
            "hd6": (4, 1, 3, 6, 8, 2, [3, 16, 0, 9], False)}


def served_lens(seed: int = 0):
    """chip_smoke.py's served KV lengths of the 64 slots (its kernel phase)."""
    import chip_smoke as cs

    rng = np.random.default_rng(seed)
    return 1 + cs.TIGER_AMAZON["sem_id_dim"] * rng.integers(1, cs.MAX_ITEMS + 1,
                                                          cs.PAGED["max_slots"])


def paged_cell(cell):
    """(S, K, H, hd, page, Pm) and the served lengths of a PAGED_CELLS cell."""
    import chip_smoke as cs

    S, which = PAGED_CELLS[cell]
    if which == "cobra":
        return (S, *cs.COBRA_SHAPE), cs.cobra_served_lens(0, S)
    K = cs.tree_nodes("tiger") if which == "tree" else cs.BEAMS
    return (S, K, 6, 64, 16, 4), served_lens()[:S]


def paged_ab(dev, libs, order, reps, add, only_kinds=None) -> None:
    """Check every variant of the paged kernels, then time them in turns
    (``only_kinds``: these of the page and q types alone)."""
    import chip_smoke as cs
    from genrec_tpu_torch.kernels import paged_attention as pa

    kinds = {"f32": (cs.paged_inputs, pa.paged_attention_stats_cuda,
                     pa.paged_attention_stats_ref),
             "int8": (cs.quantized_inputs, pa.paged_attention_stats_quantized_cuda,
                      pa.paged_attention_stats_quantized_ref),
             "bf16": (cs.bf16_inputs, pa.paged_attention_stats_bf16_cuda,
                      pa.paged_attention_stats_ref),
             "int8_bf16q": (cs.quantized_bf16q_inputs,
                            pa.paged_attention_stats_quantized_bf16q_cuda,
                            pa.paged_attention_stats_quantized_ref)}
    kinds = {k: v for k, v in kinds.items() if only_kinds is None or k in only_kinds}
    original = pa._library
    failed = set()
    try:
        for name in dict.fromkeys(order):
            if name in PAGED_TIMING_ONLY:
                continue
            pa._library = lambda lib=libs[name]: lib
            errs = {}
            for case, (S, K, H, hd, page, Pm, lens, null_tail) in paged_check_cases().items():
                for kind, (make, fn, ref) in kinds.items():
                    x = make(dev, 7, S, K, H, hd, page, Pm, lens, null_tail)
                    got, want = fn(**x), ref(**x)
                    torch.cuda.synchronize()
                    for out, g, w in zip(("acc", "m", "l"), got, want):
                        scale = float(w.abs().max())
                        e = float((g - w).abs().max())
                        errs[f"{case}/{kind}/{out}"] = e
                        if not e <= FP32_TOL * scale:
                            failed.add(name)
            add(phase="check", variant=name, ok=name not in failed,
                max_abs_err=max(errs.values()), max_abs_err_by_case=errs)
        if "source" in failed:
            raise RuntimeError("the source disagrees with the plain versions")
        order = [n for n in order if n not in failed]
        for cell in PAGED_CELLS:
            shape, lens = paged_cell(cell)
            for kind, (make, fn, _) in kinds.items():
                base = make(dev, 0, *shape, lens, True)
                per_copy = cs.nbytes(*(t for v in base.values()
                                       for t in (getattr(v, "data", v), getattr(v, "scale", None))))
                copies = [base] + cs.cold_copies(
                    lambda c: make(dev, 100 + c, *shape, lens, True), per_copy)[1:]
                bound_ms, bound_by, work = (cs.quantized_bound if kind.startswith("int8")
                                            else cs.paged_attention_bound)(base)
                for turn, name in enumerate(order):
                    pa._library = lambda lib=libs[name]: lib
                    add(phase="time", cell=cell, kind=kind, variant=name, turn=turn,
                        shape=dict(zip(("S", "K", "H", "hd", "page", "Pm"), shape)),
                        ms=cs.device_ms(fn, copies, reps), bound_ms=bound_ms,
                        bound_by=bound_by, kv_tokens=work["kv_tokens"], timed_by="cuda_graph")
                del base, copies
                torch.cuda.empty_cache()
    finally:
        pa._library = original


def paged_burst(dev, libs, n, add) -> None:
    """chip_smoke.py's cobra_serve_bf16 phase (the bf16 COBRA burst over
    bf16 pages, n requests) with the source's library, then the parent's
    (where given), then the source's again: B1's share of the profiled
    burst's device time (``prefill_device_share``) under each."""
    import chip_smoke as cs
    from genrec_tpu_torch.kernels import paged_attention as pa

    original = pa._library
    try:
        for name in [n_ for n_ in ("source", "parent", "source") if n_ in libs]:
            pa._library = lambda lib=libs[name]: lib
            line = cs.cobra_serve_phase(dev, 0, n, dtype=torch.bfloat16)[0]
            add(phase="burst", variant=name, requests=n, **{
                k: line[k] for k in ("paged_attention_share_of_device_time",
                                     "paged_attention_device_ms", "burst_device_ms",
                                     "prefill_share_of_device_time", "paged_attention_launches",
                                     "qps")})
    finally:
        pa._library = original


def parent_hstu(path: Path, checkout: Path):
    """The parent checkout's HSTU wrapper module on its own build ``path``,
    typed by that module's own ``bind`` (its entry points' signatures are
    its own): its kernels are timed as that module calls them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_hstu_attention", checkout / "genrec_tpu_torch" / "kernels" / "hstu_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.bind(ctypes.CDLL(str(path)))
    mod._library = lambda: lib
    return mod


def _rel_errs(got, want, prefix, errs) -> bool:
    """Each output's max |got - want| / max |want| into errs; whether all
    are within their tolerance (bf16 outputs BF16_TOL, tables 1e-4). The
    backward's outputs are a tuple, the forward's one tensor."""
    ok = True
    names = ("dq", "dk", "dv", "dpos", "dtime") if isinstance(got, tuple) else ("out",)
    for out, g, w in zip(names, *((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        if w is None:
            continue
        rel = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        errs[f"{prefix}/{out}"] = rel
        ok &= rel <= (1e-4 if out in ("dpos", "dtime") else BF16_TOL)
    return ok


def _same_bits(a, b) -> bool:
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    return all(torch.equal(x, y) for x, y in pairs if x is not None)


def hstu_ab(dev, libs, order, reps, add, direction="bwd") -> None:
    """Check every variant of a bf16 HSTU kernel, the backward (B6) or
    with direction "fwd" the forward (B5), against the plain version and
    the source's bits, then time them in turns at the trainer's shape."""
    import chip_smoke as cs
    from genrec_tpu_torch.kernels import hstu_attention as ha

    fwd = direction == "fwd"
    timing_only = HSTU_FWD_TIMING_ONLY if fwd else HSTU_TIMING_ONLY
    ref = ha.hstu_attention_ref if fwd else ha.hstu_attention_bwd_ref
    wrapper = f"hstu_attention_{direction}_cuda"

    def inputs(seed, **kw):
        x = cs.hstu_inputs(dev, seed, torch.bfloat16, **kw)
        return cs._fwd(x) if fwd else x

    cases = {"trainer": dict(), "left_padded": dict(packed=False), "no_time": dict(timestamps=False),
             "L200": dict(B=16, L=200), "hd13": dict(B=16, hd=13)}
    original = ha._library
    failed, first = set(), {}
    try:
        def kernel(name):  # the variant's wrapper; the parent's is its own module's
            if isinstance(libs[name], ctypes.CDLL):
                ha._library = lambda lib=libs[name]: lib
                return getattr(ha, wrapper)
            return getattr(libs[name], wrapper)

        for name in dict.fromkeys(order):
            if name in timing_only:
                continue
            fn = kernel(name)
            errs, ok, same = {}, True, True
            for i, (case, kw) in enumerate(cases.items()):
                x = inputs(7 + i, **kw)
                got = fn(**x)
                torch.cuda.synchronize()
                ok &= _rel_errs(got, ref(**x), case, errs)
                same &= _same_bits(got, first.setdefault(case, got))
            if not ok:
                failed.add(name)
            add(phase="check", variant=name, ok=ok, rel_err_of_max=errs,
                below_a_tenth_of_bf16_tol=all(v <= BF16_TOL / 10 for k, v in errs.items()
                                              if k.endswith(("dq", "dk", "dv", "out"))),
                bit_equal_to_source=same)
        if "source" in failed:
            raise RuntimeError("the source disagrees with the plain version")
        order = [n for n in order if n not in failed]
        base = inputs(0)
        per_copy = cs.nbytes(*(v for v in base.values() if v is not None))
        copies = [base] + cs.cold_copies(lambda c: inputs(100 + c), per_copy)[1:]
        bound_ms, bound_by = cs.hstu_bounds(base)[direction]
        for turn, name in enumerate(order):
            fn = kernel(name)
            add(phase="time", cell="trainer_bf16", variant=name, turn=turn,
                ms=cs.device_ms(fn, copies, reps), ms_by_kernel=cs.device_ms_by_kernel(fn, copies),
                bound_ms=bound_ms, bound_by=bound_by, timed_by="cuda_graph")
    finally:
        ha._library = original


def rq_ab(dev, libs, order, reps, add) -> None:
    """Check every variant of the RQ cascade (B7) against the plain version
    (ids exact outside near ties) and the source's bits, then time them in
    turns at one export chunk."""
    import chip_smoke as cs
    from genrec_tpu_torch.kernels import rq_cascade as rq

    cases = {"export_chunk": (cs.SEM_ID_CHUNK, 3, 256, 32), "ragged_B": (1000, 3, 256, 32),
             "L1_K45": (777, 1, 45, 32), "K300_D40": (300, 3, 300, 40),
             "K512_D64": (517, 3, 512, 64), "D10": (100, 2, 70, 10)}
    original = rq._library
    failed, first = set(), {}
    try:
        for name in dict.fromkeys(order):
            if name in RQ_TIMING_ONLY:
                continue
            rq._library = lambda lib=libs[name]: lib
            ties, ok, same = {}, True, True
            for i, (case, (B, L, K, D)) in enumerate(cases.items()):
                x = cs.rq_inputs(dev, 20 + i, B, L, K, D)
                got = rq.rq_cascade_cuda(**x)
                torch.cuda.synchronize()
                try:
                    ties[case] = cs.check_sem_ids(f"{name} {case}", x["x"], x["codebooks"],
                                                  got[0], rq.rq_cascade_ref(**x)[0])
                except RuntimeError as e:
                    ok, ties[case] = False, str(e)
                same &= _same_bits(got, first.setdefault(case, got))
            if not ok:
                failed.add(name)
            add(phase="check", variant=name, ok=ok, sem_ids_by_case=ties,
                bit_equal_to_source=same)
        if "source" in failed:
            raise RuntimeError("the source disagrees with the plain version")
        order = [n for n in order if n not in failed]
        B, L, K, D = cases["export_chunk"]
        base = cs.rq_inputs(dev, 0, B, L, K, D)
        copies = [base] + cs.cold_copies(lambda c: cs.rq_inputs(dev, 100 + c, B, L, K, D),
                                         cs.nbytes(*base.values()))[1:]
        bound_ms, bound_by = cs.bound(cs.nbytes(*base.values()) + B * L * 4 + B * D * 4,
                                      2 * B * K * D * L, cs.FP32_FLOPS)
        for turn, name in enumerate(order):
            rq._library = lambda lib=libs[name]: lib
            add(phase="time", cell="export_chunk", variant=name, turn=turn,
                ms=cs.device_ms(rq.rq_cascade_cuda, copies, reps), bound_ms=bound_ms,
                bound_by=bound_by, timed_by="cuda_graph")
    finally:
        rq._library = original


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=tuple(AT), default="bwd")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--variants", help="comma-separated: only these of the mode's variants "
                                       "(the source is always built and timed first and last)")
    ap.add_argument("--kinds", help="--mode paged: comma-separated, only these of f32, int8, "
                                    "bf16, int8_bf16q")
    ap.add_argument("--burst", type=int, default=0,
                    help="--mode paged: then serve chip_smoke.py's bf16 COBRA burst of this many "
                         "requests with the source's library and the parent's, each profiled: "
                         "the paged attention kernel's share of the burst's device time")
    ap.add_argument("--parent", type=Path,
                    help="another checkout (e.g. the parent commit's): its source of the "
                         "mode's kernel is built, checked and timed as variant `parent`, "
                         "second in turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ce_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import ptxas_by_kernel

    dev = torch.device("cuda", 0)
    at = AT[args.mode]
    if args.variants:
        keep = {"source", *args.variants.split(",")}
        at = {cell: [n for n in order if n in keep] for cell, order in at.items()}
    if args.parent:
        at = {cell: order[:1] + ["parent"] + order[1:] for cell, order in at.items()}
    paged = args.mode == "paged"
    stem, variants = STEMS.get(args.mode, ("fused_ce", VARIANTS))
    names = list(dict.fromkeys(n for cell in at.values() for n in cell))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: build(n, None, stem, args.parent / "genrec_tpu_torch" / "csrc")
            if n == "parent" else build(n, variants[n], stem), names)))
    if args.mode in STEMS:
        from genrec_tpu_torch.kernels import hstu_attention, paged_attention, rq_cascade

        bind = {"paged": paged_attention.bind, "hstu": hstu_attention.bind,
                "hstu_fwd": hstu_attention.bind, "rq": rq_cascade.bind}[args.mode]
        libs = {}
        for name, (path, _) in built.items():
            libs[name] = (parent_hstu(path, args.parent) if name == "parent" and
                          args.mode.startswith("hstu") else bind(ctypes.CDLL(str(path))))
    else:
        libs = {name: load(path) for name, (path, _) in built.items()}
    lines = []

    def add(**line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    add(phase="build", seconds=time.perf_counter() - t0)
    for name, (_, log) in built.items():
        add(phase="ptxas", variant=name, kernels={
            k: v for k, v in ptxas_by_kernel(log).items()
            if any(f in k for f in PTXAS_OF[args.mode])})
    if paged:
        paged_ab(dev, libs, at["s64"], args.reps, add,
                 args.kinds.split(",") if args.kinds else None)
        if args.burst:
            paged_burst(dev, libs, args.burst, add)
    if args.mode in ("hstu", "hstu_fwd"):
        hstu_ab(dev, libs, at["trainer_bf16"], args.reps, add,
                "fwd" if args.mode == "hstu_fwd" else "bwd")
    if args.mode == "rq":
        rq_ab(dev, libs, at["export_chunk"], args.reps, add)
    if args.mode == "fp32":
        for seed in range(4):
            a = inputs(dev, *FP32_WIDE, seed, torch.float32, w_std=0.1, g_normal=True)
            for name in names:
                add(phase="fp64", shape=dict(zip("RVd", FP32_WIDE)), seed=seed, variant=name,
                    rel_err_of_max=fp64_errors(libs[name], a))
    kernels = {"fwd": ("fwd",), "bwd": ("dx", "dw"), "fp32": ("fwd", "dx", "dw")}.get(
        args.mode, ())
    for cell in () if args.mode in STEMS else at:
        R, V, d = SHAPES[cell]
        a = inputs(dev, R, V, d, seed=0, dtype=torch.float32 if args.mode == "fp32" else
                   torch.bfloat16)
        for name in dict.fromkeys(at[cell]):
            if name not in TIMING_ONLY:
                errs = {w: check(libs[name], w, a) for w in kernels}
                add(phase="check", cell=cell, variant=name, max_abs_err=errs)
        for turn, name in enumerate(at[cell]):
            for which in kernels:
                add(phase="time", cell=cell, shape=dict(R=R, V=V, d=d), variant=name,
                    turn=turn, which=which, **timed(libs[name], which, a, args.reps))
        del a
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
