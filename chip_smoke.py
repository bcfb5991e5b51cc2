#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (genrec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--requests 384] [--out FILE] [--profile]

Needs a CUDA device, nvcc (PATH or /usr/local/cuda/bin) and the repo
checkout beside this script; it imports nothing of JAX. Phases, one JSON
line each; any failure ends the run with a traceback and a non-zero exit:

1. env      the card, its power limit (nvidia-smi), torch and CUDA versions;
2. build    nvcc builds every kernel library of the port from
            genrec_tpu_torch/csrc/ into build/, for sm_90a, one nvcc per
            source, all started together;
3. kernel   each kernel against its plain PyTorch version on the card, in
            its edge cases and at the shapes its main path gives it (B1 and
            B2 at the TIGER serving shapes; B3-B6 at the HSTU training
            shapes; B7 at the RQ-VAE export's), then timed by device time
            (CUDA-graph replay of calls on inputs cold in L2): the kernel,
            the plain version, one PyTorch library call computing the same
            function where there is one (a yardstick only), and the least
            time the card could take (bytes over 3.35 TB/s, or operations
            over the data-sheet peak of the inputs' type: 67 TFLOP/s fp32,
            989 TFLOP/s bf16);
4. train    HSTU at the widths of config/hstu/amazon.gin through the port's
            trainer (hstu_trainer.train, 2 epochs with eval, synthetic data
            with Amazon-Beauty's 12,101 items), then a fixed number of steps
            through make_train_step + PackedTrainLoop on SyntheticSeqDataset
            with Amazon-Beauty's item and user counts: steps/s, tokens/s,
            p50 step time, first and last loss, valid Recall@10/NDCG@10, and
            the kernels' launches per step, which must be exactly 2 (B5),
            2 (B6), 1 (B3), 1 (B4 dx), 1 (B4 dW); with --profile, more steps
            under torch.profiler (device idle share, top kernels);
5. parity   20 steps from one init on the same batches, dropout 0 and fp32,
            through the kernels (use_pallas=use_fused_ce=True) and through
            the plain path (both False): the loss trajectories must agree;
6. rqvae    the RQ-VAE at the widths of config/tiger/amazon/rqvae.gin:
            rqvae_trainer.train through that file (synthetic item
            embeddings at Amazon-Beauty's 12,101 items x 768, epochs cut to
            RQVAE_EPOCHS), whose loss must fall; fixed steps (steps/s, p50
            step); the sem-id export over the 12,101 items, which must launch
            B7 exactly ceil(12,101 / 4096) = 3 times and equal the model
            path's get_semantic_ids outside near ties (counted);
7. serve    TIGER at the Amazon widths of config/tiger/amazon/tiger.gin,
            random weights from --seed, answering --requests requests through
            ServingEngine + TigerGenerativeHead, with float32 pages (B1, 4
            launches a decode step) and then the same requests with int8
            pages (B2, 4 launches a decode step, B1 none); every answer must
            be a catalog item, and a sample must equal offline
            tiger_generate_paged of the same page type on the card (fp32:
            also on the CPU). With --profile the traffic is served once
            more under torch.profiler, and the RQ-VAE runs one more epoch
            under it;
8. lcrec    LCRec SFT at tensor_parallel=2 at Qwen2.5-1.5B widths
            (QwenConfig() with config/lcrec/amazon/lcrec.gin): first B3 and
            B4 at one rank's shard of the head (8 x 511 rows, 76,608 vocab
            rows, d 1,536, bf16; a full and a ragged live-vocab limit) and
            at d = 64, 1,000, 1,536, 2,048 at a small size, held to their
            plain versions and timed (part of phase 3); then the tp=1 side
            of a parity run and the library yardstick of B8 here, and 2
            ranks through parallel.mesh.spawn (gloo with both ranks on the
            one card, NCCL where each has its own): (a) B8 against its plain
            twin at the full-width head (targets on the other shard, all
            rows ignored, an empty shard); (b) 5 fp32 steps of 2 layers at
            full widths and vocab against the tp=1 run, losses within 1e-4
            relative; (c) all 28 layers, bf16, batch 8 x 512, LCREC["steps"]
            fixed steps with B3, B4 dx and B4 dW launched exactly once a
            step a rank, no non-finite skip and the same loss on both ranks
            (steps/s, tokens/s, p50 step, collectives and bytes a step,
            peak memory a rank; with --profile the device idle share and
            top kernels of 3 more steps); (d) lcrec_trainer.train through
            config/lcrec/synthetic.gin at tensor_parallel=2, whose loss
            must fall.

Each phase that drives a main path sets every kernel's launch counter to 0
just before and reads it just after. Then the kernels line, the card's
name and power limit as nvidia-smi prints them, and, last,
{"ok": true, "device": {...}}.

TF32 is off for matrix products and convolutions, as the JAX package's
CPU reference computes.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (NVIDIA): HBM bytes/s, float32 FLOP/s outside
# the tensor cores, dense bf16 FLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
L2_BYTES = 50 * 2**20

# TIGER, config/tiger/amazon/tiger.gin (dim_feedforward from
# genrec_tpu/models/tiger.py:119). Depth is not cut.
TIGER_AMAZON = dict(
    embedding_dim=128, attn_dim=384, num_heads=6, n_layers=8,
    num_item_embeddings=256, num_user_embeddings=10000, sem_id_dim=3,
    dim_feedforward=1024,
)
MAX_ITEMS = 20  # train.max_items: histories of <= 20 items, 61 KV tokens
CATALOG_ITEMS = 12101  # items of Amazon-Beauty (the 2014 5-core split)
BEAMS = 10
PAGED = dict(max_slots=64, page_size=16, pages_per_slot=4)
KERNEL_RTOL = KERNEL_ATOL = 1e-5  # fp32 both sides, summation order differs

# HSTU, config/hstu/amazon.gin; depth not cut. Amazon-Beauty (2014 5-core):
# 12,101 items, 22,363 users.
HSTU_AMAZON = dict(embed_dim=64, num_heads=2, num_blocks=2, max_seq_len=50,
                   num_position_buckets=32, num_time_buckets=64,
                   max_position_distance=128)
HSTU_BATCH = 128
BEAUTY_ITEMS, BEAUTY_USERS = 12101, 22363
# Measured steps of the fixed-step run, after 3 warm-up steps, all inside the
# first epoch (~50 steps of 128 packed rows at Amazon-Beauty's size).
TRAIN_STEPS = 40
PARITY_STEPS = 20
# Kernel against plain version, max |diff| <= tol * max |plain|:
# fp32 on both sides differs only in summation order; with bf16 inputs
# both accumulate in fp32 and round the result to bf16 (2^-8 relative),
# where a different order can flip the rounding by one bf16 step.
FP32_TOL = 1e-5
BF16_TOL = 1e-2
# The bias-table gradients are fp32 sums of ~4e4 terms of ds per head (every
# visible pair of the batch) in other orders (the plain version adds with
# index_add_), so their rounding grows with the count.
TABLE_TOL = 1e-4
# Loss trajectories, kernels vs plain path, fp32: the paths sum in other
# orders (GEMM blocking, online logsumexp), and Adam carries the ~1e-7
# differences of each step's gradients into the next step's weights.
PARITY_RTOL = 1e-4
# Launches of each kernel in one training step of the 2-block model.
LAUNCHES_PER_STEP = {"hstu_attention_fwd": 2, "hstu_attention_bwd": 2,
                     "fused_linear_ce_fwd": 1, "fused_linear_ce_bwd_dx": 1,
                     "fused_linear_ce_bwd_dw": 1}

# The kernels line: name -> (source, the TPU kernel it replaces, its function).
KERNELS = {
    "paged_attention_stats": ("genrec_tpu_torch/csrc/paged_attention.cu",
                              "genrec_tpu/kernels/paged_attention.py:182",
                              "paged_attention_stats_pallas"),
    "hstu_attention_fwd": ("genrec_tpu_torch/csrc/hstu_attention.cu",
                           "genrec_tpu/kernels/hstu_attention.py:148",
                           "hstu_attention_pallas"),
    "hstu_attention_bwd": ("genrec_tpu_torch/csrc/hstu_attention.cu",
                           "genrec_tpu/kernels/hstu_attention.py:294",
                           "hstu_attention_bwd_pallas"),
    "fused_linear_ce_fwd": ("genrec_tpu_torch/csrc/fused_ce.cu",
                            "genrec_tpu/kernels/fused_ce.py:137", "fused_linear_ce_fwd"),
    "fused_linear_ce_bwd_dx": ("genrec_tpu_torch/csrc/fused_ce.cu",
                               "genrec_tpu/kernels/fused_ce.py:180",
                               "fused_linear_ce_bwd (_dx_kernel)"),
    "fused_linear_ce_bwd_dw": ("genrec_tpu_torch/csrc/fused_ce.cu",
                               "genrec_tpu/kernels/fused_ce.py:180",
                               "fused_linear_ce_bwd (_dw_kernel)"),
    "paged_attention_stats_quantized": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                        "genrec_tpu/kernels/paged_attention.py:112",
                                        "paged_attention_stats_pallas_quantized"),
    "rq_cascade": ("genrec_tpu_torch/csrc/rq_cascade.cu",
                   "genrec_tpu/kernels/rq_cascade.py:75", "rq_cascade_pallas"),
    "fused_linear_ce_fwd_lcrec": ("genrec_tpu_torch/csrc/fused_ce.cu",
                                  "genrec_tpu/kernels/fused_ce.py:137",
                                  "fused_linear_ce_fwd, per shard of sharded_fused_linear_ce"),
    "fused_linear_ce_bwd_dx_lcrec": ("genrec_tpu_torch/csrc/fused_ce.cu",
                                     "genrec_tpu/kernels/fused_ce.py:180",
                                     "fused_linear_ce_bwd (_dx_kernel), per shard"),
    "fused_linear_ce_bwd_dw_lcrec": ("genrec_tpu_torch/csrc/fused_ce.cu",
                                     "genrec_tpu/kernels/fused_ce.py:180",
                                     "fused_linear_ce_bwd (_dw_kernel), per shard"),
    "sharded_fused_linear_ce": ("genrec_tpu_torch/kernels/fused_ce.py",
                                "genrec_tpu/kernels/fused_ce.py:328",
                                "sharded_fused_linear_ce (_tp_vjp_fwd :350, _tp_vjp_bwd :375)"),
}
LIBRARY_ATOL = 1e-4  # the library call normalises; checked, never used
# Scores are sums of 3 log-softmaxes of logits / 0.2. Across batch shapes
# and devices the full-width logits differ by ~1e-5 (GEMM blocking and
# summation order), which moves the scores by up to ~1e-4 (measured on the
# CPU); sem-ids must be equal.
SAMPLE_ATOL = 1e-3
# int8 pages: the same, plus quantisation's rounding edges. A K/V element
# whose x / scale lies within the projections' last-bit noise of a .5
# edge lands one int8 step (its row's amax / 127) apart between batch
# shapes (the engine's prefill batch against offline decoding of one
# request), and moves the beams' scores by up to ~1e-2 at T = 0.2
# (tests/test_torch_quant.py). Two beams whose scores are that close may
# then trade ranks, so int8 answers are matched tuple by tuple
# (int8_answers_agree) instead of rank by rank.
INT8_SAMPLE_ATOL = 2e-2

# RQ-VAE, config/tiger/amazon/rqvae.gin (input 768, hidden 512-256-128-64,
# embed 32, 3 levels x 256, STE + Sinkhorn, AdamW 1e-3 wd 1e-4, batch 1024,
# Gumbel temperature 0.2, 20,000-row k-means warm-up). Only the depth is
# cut: RQVAE_EPOCHS of the file's 5,000 epochs (11 steps each at 12,101
# items), and RQVAE_STEPS fixed steps after RQVAE_WARM.
RQVAE_EPOCHS = 20
RQVAE_WARM, RQVAE_STEPS = 3, 40
SEM_ID_CHUNK = 4096  # compute_sem_ids' batch: one B7 launch a chunk
# Sem-id comparisons: exact outside rows whose two nearest codewords at some
# level are within NEAR_TIE_REL x max |dist| (another summation order may
# pick either); at most NEAR_TIE_MAX_SHARE of the rows may be near ties.
NEAR_TIE_REL = 1e-5
NEAR_TIE_MAX_SHARE = 0.02

# LCRec SFT at tensor_parallel=2: QwenConfig()'s defaults, Qwen2.5-1.5B
# (genrec_tpu/models/backbones/qwen.py:32-47; config/base.gin:10: hidden
# 1,536, 28 layers, 12 heads of 128, 2 KV heads, FFN 8,960, vocab 151,936,
# tied head, RoPE theta 1e6), trained by config/lcrec/amazon/lcrec.gin: 5
# codebooks x 256 appended (live vocab 153,216, a multiple of 8, so 76,608
# rows a shard), max_text_len 512, bf16, AdamW 2e-5 with weight decay 0.01
# after a 50-step warm-up, clip 1.0; batch 8 (lcrec_debug.gin). Random
# weights from --seed (the HF checkpoint is not in the repository). Cut:
# the fixed steps (LCREC["steps"] after LCREC["warm"]); the parity run's
# depth (2 layers), batch and lr; the trainer run's epochs and eval sets.
LCREC = dict(base_vocab=151936, codebooks=5, codebook_size=256, layers=28, batch=8, seq=512,
             lr=2e-5, warmup=50, wd=0.01, warm=2, steps=10, profile_steps=3,
             parity_layers=2, parity_steps=5, parity_batch=4, parity_seq=128, parity_lr=1e-3,
             trainer_epochs=2, trainer_eval=64)
LCREC_TP = 2
LCREC_LIVE = LCREC["base_vocab"] + LCREC["codebooks"] * LCREC["codebook_size"]
LCREC_SHARD = LCREC_LIVE // LCREC_TP
LCREC_DIMS = (64, 1000, 1536, 2048)  # B3/B4 checked at each d at a small size
LCREC_REPS = 3  # graph replays per timing at the shard shape (each call takes ms)
LCREC_TIMEOUT_S = 900  # the ranks' time limit, spawn included
# tp=1 against tp=2, fp32: the paths sum in other orders (the row-parallel
# all-reduce, the sharded logsumexp merge) and Adam carries the differences.
LCREC_PARITY_RTOL = 1e-4
# Launches of each kernel per train step per rank.
LCREC_LAUNCHES_PER_STEP = {"fused_linear_ce_fwd": 1, "fused_linear_ce_bwd_dx": 1,
                           "fused_linear_ce_bwd_dw": 1}


def check(ok, what) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase: str, **fields) -> dict:
    print(json.dumps({"phase": phase, **fields}), flush=True)
    return fields


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, arg_sets, reps: int = 10) -> float:
    """Mean device time of one ``fn(**args)`` in ms: the calls over
    ``arg_sets`` are captured once in a CUDA graph and the graph is
    replayed ``reps`` times between two events, so the host's cost of
    issuing a call is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: allocator, handles
        for args in arg_sets:
            fn(**args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for args in arg_sets:
            fn(**args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def cold_copies(make, per_copy_bytes: int) -> list:
    """Enough input sets ``make(i)`` that together they exceed the L2 cache
    three times, so each call finds its inputs in device memory."""
    return [make(i) for i in range(max(2, -(-3 * L2_BYTES // per_copy_bytes)))]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def assert_near(what, got, want, tol) -> float:
    """max |got - want| <= tol * max |want|, NaN failing, so an output of
    zeros fails wherever the plain version is not all zeros; returns the
    max error."""
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    err = float((got.float() - want.float()).abs().max()) if want.numel() else 0.0
    check(err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}")
    return err


def bound(bytes_, flops, peak) -> tuple[float, str]:
    """(least ms for these bytes and operations, what bounds it)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---- phase 3: the paged-attention kernel -----------------------------------


def paged_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, null_tail):
    """Pools with 1 + S*Pm pages, slot s owning pages 1 + s*Pm ..; with
    ``null_tail`` a slot's entries past its last used page point at the
    null page 0, as KVPagePool pads them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = 1 + S * Pm
    seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=dev)
    bt = (1 + torch.arange(S * Pm, device=dev, dtype=torch.int32)).reshape(S, Pm)
    if null_tail:
        used = (seq_lens.clamp_min(1) + page - 1) // page
        bt = bt.masked_fill(torch.arange(Pm, device=dev)[None] >= used[:, None], 0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    return dict(q=randn(S, K, H, hd), k_pool=randn(P, page, H, hd),
                v_pool=randn(P, page, H, hd), block_tables=bt.contiguous(),
                seq_lens=seq_lens)


def paged_attention_bound(x) -> tuple[float, str, dict]:
    """Least time for one call on these inputs: each input byte the
    function needs read once, each output written once. A slot needs the
    K/V rows of its first seq_len positions (masked positions weigh
    exactly 0); a fully masked slot needs all Pm*page of them."""
    S, K, H, hd = x["q"].shape
    Pm, page = x["block_tables"].shape[1], x["k_pool"].shape[1]
    sl = x["seq_lens"].long()
    tokens = int(torch.where(sl > 0, sl.clamp_max(Pm * page), Pm * page).sum())
    f32 = 4
    bytes_ = (tokens * H * hd * 2 * f32                 # K and V rows
              + S * K * H * hd * f32                    # q
              + S * (Pm + 1) * 4                        # block tables, seq_lens
              + S * K * H * (hd + 2) * f32)             # acc, m, l
    flops = 4 * K * H * hd * tokens                     # q.k and p.v
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, dict(bytes=bytes_, flops=flops,
                                               kv_tokens=tokens)


def library_paged_attention(q, k, v, mask):
    """One PyTorch call computing the normalised paged attention from
    pre-gathered K/V: the yardstick, never called by the port."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def library_inputs(x):
    from genrec_tpu_torch.ops.paged import NEG, gather_pages

    S, K, H, hd = x["q"].shape
    k = gather_pages(x["k_pool"], x["block_tables"]).permute(0, 2, 1, 3).contiguous()
    v = gather_pages(x["v_pool"], x["block_tables"]).permute(0, 2, 1, 3).contiguous()
    tok = torch.arange(k.shape[2], device=k.device)
    mask = torch.zeros((S, 1, 1, k.shape[2]), device=k.device)
    mask = mask.masked_fill(tok >= x["seq_lens"].long()[:, None, None, None], NEG)
    return dict(q=x["q"].permute(0, 2, 1, 3).contiguous(), k=k, v=v, mask=mask)


def kernel_phase(dev, seed) -> dict:
    from genrec_tpu_torch.kernels.paged_attention import (
        paged_attention_stats_cuda,
        paged_attention_stats_ref,
    )

    S, K = PAGED["max_slots"], BEAMS
    H = TIGER_AMAZON["num_heads"]
    hd = TIGER_AMAZON["attn_dim"] // H
    page, Pm = PAGED["page_size"], PAGED["pages_per_slot"]
    rng = np.random.default_rng(seed)
    # KV tokens of served requests: the user token + 3 per history item.
    served_lens = 1 + TIGER_AMAZON["sem_id_dim"] * rng.integers(1, MAX_ITEMS + 1, S)
    masked_lens = served_lens.copy()
    masked_lens[::5] = 0  # free slots: every entry the null page
    cases = {
        "serving": (served_lens, True),
        "fully_masked_slots": (masked_lens, True),
        "every_page_full": (np.full(S, Pm * page), False),
    }
    errs = {}
    for i, (name, (lens, null_tail)) in enumerate(cases.items()):
        x = paged_inputs(dev, seed + i, S, K, H, hd, page, Pm, lens, null_tail)
        got = paged_attention_stats_cuda(**x)
        torch.cuda.synchronize()
        want = paged_attention_stats_ref(**x)
        for out, g, w in zip(("acc", "m", "l"), got, want):
            torch.testing.assert_close(g, w, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                                       msg=lambda m, c=name, o=out: f"{c}/{o}: {m}")
        errs[name] = max(float((g - w).abs().max()) for g, w in zip(got, want))

    # Timing at the serving case, each call on inputs cold in L2.
    base = paged_inputs(dev, seed, S, K, H, hd, page, Pm, served_lens, True)
    per_copy = sum(t.numel() * t.element_size() for t in base.values())
    n_copies = max(2, -(-3 * L2_BYTES // per_copy))
    copies = [base] + [
        paged_inputs(dev, seed + 100 + c, S, K, H, hd, page, Pm, served_lens, True)
        for c in range(n_copies - 1)
    ]
    lib = [library_inputs(x) for x in copies]
    acc, _, l = paged_attention_stats_cuda(**base)
    torch.testing.assert_close(library_paged_attention(**lib[0]),
                               (acc / l[..., None]).permute(0, 2, 1, 3),
                               rtol=0, atol=LIBRARY_ATOL)
    ms = device_ms(paged_attention_stats_cuda, copies)
    plain_ms = device_ms(paged_attention_stats_ref, copies)
    library_ms = device_ms(library_paged_attention, lib)
    ms_again = device_ms(paged_attention_stats_cuda, copies)
    clocks = nvidia_smi_line("clocks.sm,clocks.mem,power.draw,temperature.gpu")
    bound_ms, bound_by, work = paged_attention_bound(base)
    walked = S * Pm * page * H * hd * 2 * 4
    return emit(
        "kernel", name="paged_attention_stats",
        shape=dict(S=S, K=K, H=H, hd=hd, page=page, Pm=Pm),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        tolerance=dict(rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
        ms=ms, ms_repeat=ms_again, plain_ms=plain_ms, library_ms=library_ms,
        timed_by="cuda_graph",
        library="torch.nn.functional.scaled_dot_product_attention on pre-gathered K/V",
        bound_ms=bound_ms, bound_by=bound_by, work=work,
        kv_bytes_walked=walked, walked_bound_ms=1e3 * walked / HBM_BYTES_PER_S,
        cold_copies=n_copies, clocks_after_timing=clocks,
    )


def quantized_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, null_tail):
    """``paged_inputs`` with int8 pools (QuantizedKVPool, quantised as the
    serving path's write_pages quantises); every third row of page 1 is all
    zeros, so its scale is 1e-12 / 127."""
    from genrec_tpu_torch.ops.quant import QuantizedKVPool, quantize_symmetric

    x = paged_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, null_tail)
    for name in ("k_pool", "v_pool"):
        pool = x[name]
        pool[1, ::3] = 0.0
        x[name] = QuantizedKVPool(*quantize_symmetric(pool, (-2, -1)))
    return x


def quantized_bound(x) -> tuple[float, str, dict]:
    """``paged_attention_bound`` for int8 pools: a K or V row is H*hd bytes
    plus its 4-byte scale, and each element is dequantised (one convert and
    one multiply) before the fp32 dot products."""
    S, K, H, hd = x["q"].shape
    Pm, page = x["block_tables"].shape[1], x["k_pool"].data.shape[1]
    sl = x["seq_lens"].long()
    tokens = int(torch.where(sl > 0, sl.clamp_max(Pm * page), Pm * page).sum())
    bytes_ = (tokens * (H * hd + 4) * 2 + S * K * H * hd * 4 + S * (Pm + 1) * 4
              + S * K * H * (hd + 2) * 4)
    flops = 4 * K * H * hd * tokens + 2 * 2 * H * hd * tokens
    ms, by = bound(bytes_, flops, FP32_FLOPS)
    return ms, by, dict(bytes=bytes_, flops=flops, kv_tokens=tokens)


def quantized_kernel_phase(dev, seed) -> dict:
    """B2 against its plain version (dequantise after the gather) and timed."""
    from genrec_tpu_torch.kernels.paged_attention import (
        paged_attention_stats_quantized_cuda,
        paged_attention_stats_quantized_ref,
    )

    S, K = PAGED["max_slots"], BEAMS
    H = TIGER_AMAZON["num_heads"]
    hd = TIGER_AMAZON["attn_dim"] // H
    page, Pm = PAGED["page_size"], PAGED["pages_per_slot"]
    rng = np.random.default_rng(seed + 1)
    served_lens = 1 + TIGER_AMAZON["sem_id_dim"] * rng.integers(1, MAX_ITEMS + 1, S)
    masked_lens = served_lens.copy()
    masked_lens[::5] = 0  # free slots: seq_len 0, every entry the null page
    cases = {  # name: (K, seq_lens, null tail); served lens end in partial pages
        "serving_k10": (K, served_lens, True),
        "seq_len_0_slots_k10": (K, masked_lens, True),
        "k1": (1, served_lens, True),
        "every_page_full_k10": (K, np.full(S, Pm * page), False),
    }
    errs = {}
    for i, (name, (k, lens, null_tail)) in enumerate(cases.items()):
        x = quantized_inputs(dev, seed + 10 + i, S, k, H, hd, page, Pm, lens, null_tail)
        got = paged_attention_stats_quantized_cuda(**x)
        torch.cuda.synchronize()
        want = paged_attention_stats_quantized_ref(**x)
        errs[name] = max(assert_near(f"B2 {name}/{out}", g, w, FP32_TOL)
                         for out, g, w in zip(("acc", "m", "l"), got, want))

    base = quantized_inputs(dev, seed, S, K, H, hd, page, Pm, served_lens, True)
    per_copy = nbytes(base["q"], base["k_pool"].data, base["k_pool"].scale,
                      base["v_pool"].data, base["v_pool"].scale, base["block_tables"],
                      base["seq_lens"])
    copies = [base] + cold_copies(
        lambda c: quantized_inputs(dev, seed + 100 + c, S, K, H, hd, page, Pm, served_lens,
                                   True), per_copy)[1:]
    lib = [library_inputs(x) for x in copies]  # gather_pages dequantises
    acc, _, l = paged_attention_stats_quantized_cuda(**base)
    torch.testing.assert_close(library_paged_attention(**lib[0]),
                               (acc / l[..., None]).permute(0, 2, 1, 3),
                               rtol=0, atol=LIBRARY_ATOL)
    ms = device_ms(paged_attention_stats_quantized_cuda, copies)
    plain_ms = device_ms(paged_attention_stats_quantized_ref, copies)
    library_ms = device_ms(library_paged_attention, lib)
    bound_ms, bound_by, work = quantized_bound(base)
    return emit(
        "kernel", name="paged_attention_stats_quantized",
        shape=dict(S=S, K=K, H=H, hd=hd, page=page, Pm=Pm, pools="int8 + fp32 row scales"),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        tolerance=dict(rel=FP32_TOL, relative_to="max|plain|"),
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, timed_by="cuda_graph",
        library="torch.nn.functional.scaled_dot_product_attention on pre-gathered, "
                "dequantised K/V",
        bound_ms=bound_ms, bound_by=bound_by, work=work, cold_copies=len(copies),
    )


# ---- phase 3: the residual-quantisation cascade (B7) ------------------------


def rq_inputs(dev, seed, B, L, K, D, duplicate=False):
    """x ~ N(0, 0.3^2) (an encoder output's scale) and codebooks (L, K, D)
    ~ N(0, 0.2^2); with ``duplicate`` the second half of every level
    repeats the first, so every argmin ties exactly."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 0.3 * torch.randn((B, D), generator=gen, device=dev)
    cb = 0.2 * torch.randn((L, K, D), generator=gen, device=dev)
    if duplicate:
        cb[:, K // 2:] = cb[:, :K - K // 2].clone()
    return dict(x=x, codebooks=cb.contiguous())


def check_sem_ids(what, x, codebooks, got, want) -> dict:
    """Sem-ids equal to ``want`` on every row outside the near ties (the
    rows are counted, and their share bounded)."""
    from genrec_tpu_torch.kernels.rq_cascade import near_tie_rows

    near = near_tie_rows(x, codebooks, want, NEAR_TIE_REL)
    differ = (got != want).any(dim=1)
    outside = int((differ & ~near).sum())
    share = float(near.float().mean())
    check(outside == 0, f"{what}: {outside} rows differ outside the near ties")
    check(share <= NEAR_TIE_MAX_SHARE, f"{what}: near-tie share {share}")
    return dict(rows=len(got), near_tie_rows=int(near.sum()), differing_rows=int(differ.sum()),
                differing_outside_near_ties=outside)


def rq_kernel_phase(dev, seed) -> dict:
    """B7 against its plain version (TF32 off) and timed."""
    from genrec_tpu_torch.kernels.rq_cascade import rq_cascade_cuda, rq_cascade_ref

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for the plain cascade")
    cases = {  # name: (B, L, K, D, duplicated codewords)
        "export_chunk": (SEM_ID_CHUNK, 3, 256, 32, False),
        "ragged_B": (1000, 3, 256, 32, False),
        "L1_K45": (777, 1, 45, 32, False),
        "K300_D40": (300, 3, 300, 40, False),
        "duplicated_codewords": (512, 3, 256, 32, True),
    }
    errs, ties = {}, {}
    for i, (name, (B, L, K, D, dup)) in enumerate(cases.items()):
        x = rq_inputs(dev, seed + 20 + i, B, L, K, D, dup)
        ids, qsum = rq_cascade_cuda(**x)
        torch.cuda.synchronize()
        want_ids, want_q = rq_cascade_ref(**x)
        if dup:  # every row ties exactly: ids must be equal everywhere
            check(torch.equal(ids, want_ids) and int(ids.max()) < K - K // 2,
                  "duplicated codewords: the lower index must win on every row")
            ties[name] = dict(rows=B, differing_rows=0)
        else:
            ties[name] = check_sem_ids(f"B7 {name}", x["x"], x["codebooks"], ids, want_ids)
        same = ~(ids != want_ids).any(dim=1)
        errs[name] = assert_near(f"B7 {name}/qsum", qsum[same], want_q[same], FP32_TOL)

    B, L, K, D = cases["export_chunk"][:4]
    base = rq_inputs(dev, seed, B, L, K, D)
    copies = [base] + cold_copies(lambda c: rq_inputs(dev, seed + 100 + c, B, L, K, D),
                                  nbytes(*base.values()))[1:]
    ms = device_ms(rq_cascade_cuda, copies)
    plain_ms = device_ms(rq_cascade_ref, copies)
    bytes_ = nbytes(*base.values()) + B * L * 4 + B * D * 4
    flops = 2 * B * K * D * L
    bound_ms, bound_by = bound(bytes_, flops, FP32_FLOPS)
    return emit(
        "kernel", name="rq_cascade", shape=dict(B=B, L=L, K=K, D=D, dtype="fp32"),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs, sem_ids_by_case=ties,
        tolerance=dict(qsum_rel=FP32_TOL, relative_to="max|plain|", ids="exact outside "
                       f"near ties ({NEAR_TIE_REL} x max|dist|)"),
        ms=ms, plain_ms=plain_ms, library_ms=None, library="none (no single call)",
        timed_by="cuda_graph", bound_ms=bound_ms, bound_by=bound_by,
        work=dict(bytes=bytes_, flops=flops), cold_copies=len(copies),
    )


# ---- phase 3: the HSTU training kernels (B3-B6) -----------------------------


def hstu_inputs(dev, seed, dtype, *, timestamps=True, packed=True, B=HSTU_BATCH):
    """Inputs of one HSTU attention call at the trainer's shapes: q, k, v
    and a cotangent g (B, H, L, hd); packed rows (segments of 2-28 tokens
    from slot 0, pad at the tail, as pack_examples lays them out) or
    left-padded rows (as eval rows); row 0 all padding; synthetic
    timestamps (~1 event a day from 1.5e9 s, int32)."""
    rng = np.random.default_rng(seed)
    H = HSTU_AMAZON["num_heads"]
    L = HSTU_AMAZON["max_seq_len"]
    hd = HSTU_AMAZON["embed_dim"] // H
    seg = np.zeros((B, L), np.int32)
    pad = np.zeros((B, L), bool)
    for b in range(B):
        if packed:
            at, s = 0, 1
            while at < L:
                n = int(rng.integers(2, 29))
                if at + n > L and s > 1:
                    break
                seg[b, at:at + n] = s
                at, s = at + n, s + 1
            pad[b] = seg[b] == 0
        else:
            pad[b, :L - int(rng.integers(1, L + 1))] = True
    pad[0] = True
    seg[0] = 0
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    normal = lambda *shape: t(rng.normal(size=shape).astype(np.float32)).to(dtype)  # noqa: E731
    ts = np.cumsum(rng.integers(3600, 172800, size=(B, L)), axis=1) + 1_500_000_000
    return dict(
        q=normal(B, H, L, hd), k=normal(B, H, L, hd), v=normal(B, H, L, hd),
        timestamps=t(ts, torch.int32) if timestamps else None, padding_mask=t(pad),
        pos_table=t(rng.normal(size=(H, 32)).astype(np.float32) * 0.1),
        time_table=(t(rng.normal(size=(H, 64)).astype(np.float32) * 0.1)
                    if timestamps else None),
        segment_ids=t(seg) if packed else None, g=normal(B, H, L, hd),
    )


def _fwd(x):
    return {k: v for k, v in x.items() if k != "g"}


def visible_pairs(x) -> int:
    """(query, key) pairs the attention does not mask, over all heads."""
    pad = x["padding_mask"]
    L = pad.shape[1]
    vis = torch.tril(torch.ones((L, L), dtype=torch.bool, device=pad.device))[None]
    vis = vis & ~pad[:, None, :]
    if x["segment_ids"] is not None:
        vis = vis & (x["segment_ids"][:, :, None] == x["segment_ids"][:, None, :])
    return int(vis.sum()) * x["q"].shape[1]


def hstu_bounds(x) -> dict:
    """Least time for one forward and one backward call on these inputs:
    every input byte read once and every output written once; operations
    over the visible pairs (q.k and p.v forward: 4*hd each; backward also
    g.v, dq, dk, dv: 10*hd each) at the inputs' type's peak."""
    q = x["q"]
    hd = q.shape[-1]
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    side = nbytes(x["timestamps"], x["padding_mask"], x["segment_ids"], x["pos_table"],
                  x["time_table"])
    pairs = visible_pairs(x)
    fwd_bytes = 4 * nbytes(q) + side
    bwd_bytes = 7 * nbytes(q) + side + nbytes(x["pos_table"], x["time_table"])
    f_ms, f_by = bound(fwd_bytes, 4 * hd * pairs, peak)
    b_ms, b_by = bound(bwd_bytes, 10 * hd * pairs, peak)
    work = dict(visible_pairs=pairs, fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes,
                fwd_flops=4 * hd * pairs, bwd_flops=10 * hd * pairs)
    return dict(fwd=(f_ms, f_by), bwd=(b_ms, b_by), work=work)


def time_bucket_sweep(dev) -> dict:
    """The forward kernel's time buckets against the CPU's hstu_log_bucket
    (the JAX function's port, equal to it on every value of this sweep in
    tests/test_torch_hstu_attention.py): every |dt| within 300 of each
    bucket edge exp(0.693 n) and of each 2^k, and 0..70000, of both signs,
    and int32's extremes (t_q - t_k wraps). Each dt is a row of two
    positions, t = (0, dt), with q = k = 0, v = (1, 0), no position bias
    and time_table[n] = n, so the output of position 1 is
    silu(time_table[bucket(dt)]) and names the bucket."""
    from genrec_tpu_torch.kernels.hstu_attention import hstu_attention_fwd_cuda
    from genrec_tpu_torch.ops.buckets import hstu_log_bucket

    edges = {int(np.exp(0.693 * n)) for n in range(32)} | {2**k for k in range(31)}
    dts = sorted({e + d for e in edges for d in range(-300, 301)
                  if 0 <= e + d < 2**31} | set(range(70000)))
    dts = dts + [-v for v in dts] + [2**31 - 1, -(2**31)]
    dt = torch.tensor(dts, dtype=torch.int32)
    B = len(dts)
    ts = torch.stack([torch.zeros_like(dt), dt], dim=1).to(dev)
    v = torch.zeros((B, 1, 2, 1), device=dev)
    v[:, :, 0] = 1.0
    zeros = torch.zeros((B, 1, 2, 1), device=dev)
    nb = torch.arange(64, dtype=torch.float32, device=dev)[None]
    out = hstu_attention_fwd_cuda(zeros, zeros.clone(), v, ts,
                                  torch.zeros((B, 2), dtype=torch.bool, device=dev),
                                  torch.zeros((1, 32), device=dev), nb.contiguous())
    silu = nb * torch.sigmoid(nb)
    got = (out[:, 0, 1, 0][:, None] - silu).abs().argmin(dim=1).cpu()
    want = hstu_log_bucket(dt, 64).long()
    mismatched = int((got != want).sum())
    check(mismatched == 0, f"time buckets: {mismatched} of {B} differ from the CPU's")
    return dict(values=B, mismatched=mismatched, top_bucket_reached=int(want.max()))


def hstu_kernel_phase(dev, seed) -> dict:
    """B5 and B6 against their plain versions and timed."""
    from genrec_tpu_torch.kernels.hstu_attention import (
        hstu_attention_bwd_cuda,
        hstu_attention_bwd_ref,
        hstu_attention_fwd_cuda,
        hstu_attention_ref,
    )

    cases = {  # name: (dtype, timestamps, packed)
        "packed_time_bf16": (torch.bfloat16, True, True),
        "packed_time_fp32": (torch.float32, True, True),
        "packed_no_time_fp32": (torch.float32, False, True),
        "left_padded_time_fp32": (torch.float32, True, False),
    }
    errs_f, errs_b = {}, {}
    for i, (name, (dtype, with_time, packed)) in enumerate(cases.items()):
        x = hstu_inputs(dev, seed + i, dtype, timestamps=with_time, packed=packed)
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        got = hstu_attention_fwd_cuda(**_fwd(x))
        torch.cuda.synchronize()
        check(got.dtype == dtype and float(got[0].float().abs().max()) == 0.0,
              f"{name}: the all-pad row must be 0 in {dtype}")
        errs_f[name] = assert_near(f"hstu fwd {name}", got, hstu_attention_ref(**_fwd(x)), tol)
        got_b = hstu_attention_bwd_cuda(**x)
        torch.cuda.synchronize()
        for out, g, w in zip(("dq", "dk", "dv", "dpos", "dtime"), got_b,
                             hstu_attention_bwd_ref(**x)):
            if w is None:
                check(g is None, f"{name}/{out}: expected None")
                continue
            errs_b[f"{name}/{out}"] = assert_near(f"hstu bwd {name}/{out}", g, w,
                                                  TABLE_TOL if out in ("dpos", "dtime") else tol)
    sweep = time_bucket_sweep(dev)

    # Timing at the trainer's type and layout: bf16, packed, timestamps.
    base = hstu_inputs(dev, seed, torch.bfloat16)
    copies = cold_copies(lambda c: hstu_inputs(dev, seed + 100 + c, torch.bfloat16),
                         nbytes(*(v for v in base.values() if v is not None)))
    fwd_copies = [_fwd(x) for x in copies]
    bounds = hstu_bounds(base)
    out = {}
    for name, fn, ref, sets, errs in (
        ("hstu_attention_fwd", hstu_attention_fwd_cuda, hstu_attention_ref, fwd_copies, errs_f),
        ("hstu_attention_bwd", hstu_attention_bwd_cuda, hstu_attention_bwd_ref, copies, errs_b),
    ):
        ms, plain_ms = device_ms(fn, sets), device_ms(ref, sets)
        bound_ms, bound_by = bounds["fwd" if name.endswith("fwd") else "bwd"]
        out[name] = emit(
            "kernel", name=name, shape=dict(B=HSTU_BATCH, H=2, L=50, hd=32, dtype="bf16"),
            max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
            tolerance=dict(fp32=FP32_TOL, bf16=BF16_TOL, bias_tables=TABLE_TOL,
                           relative_to="max|plain|"),
            ms=ms, plain_ms=plain_ms, library_ms=None,
            library="none: no single PyTorch call computes biased SiLU attention",
            timed_by="cuda_graph", bound_ms=bound_ms,
            bound_by=bound_by, work=bounds["work"], cold_copies=len(sets),
            time_bucket_sweep=sweep,
        )
    return out


def ce_inputs(dev, seed, dtype, *, all_ignored=False, mean_g=False, R=HSTU_BATCH * 50,
              V=BEAUTY_ITEMS + 1, d=64):
    """Inputs of the fused CE at the trainer's shapes: x (R, d) ~ N(0, 1)
    (a LayerNorm output), w (V, d) ~ N(0, 0.1), targets in [1, V) with 3%
    at the ignored id 0 (the pad slots of packed rows), and a cotangent g
    (R,): ~ N(0, 1) per row, so that dx and dW are of order 1 and each
    row's share is checked, or with ``mean_g`` the mean loss's 1 / valid
    rows (the trainer's; the timing sets)."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    tgt = rng.integers(1, V, R).astype(np.int32)
    tgt[rng.random(R) < 0.03] = 0
    if all_ignored:
        tgt[:] = 0
    valid = max(int((tgt != 0).sum()), 1)
    return dict(x=t(rng.normal(size=(R, d)).astype(np.float32)).to(dtype),
                w=t((rng.normal(size=(V, d)) * 0.1).astype(np.float32)).to(dtype),
                targets=t(tgt),
                g=t(np.full(R, 1.0 / valid, np.float32) if mean_g
                    else rng.normal(size=R).astype(np.float32)))


def library_ce(x, w, targets):
    return torch.nn.functional.cross_entropy(
        torch.nn.functional.linear(x, w), targets.long(), ignore_index=0, reduction="none")


def library_ce_dx(x, w, targets, g):
    x = x.detach().requires_grad_()
    return torch.autograd.grad(library_ce(x, w, targets), x, g)


def library_ce_dw(x, w, targets, g):
    w = w.detach().requires_grad_()
    return torch.autograd.grad(library_ce(x, w, targets), w, g)


def ce_kernel_phase(dev, seed) -> dict:
    """B3 and B4 (dx, dW) against their plain versions and timed."""
    from genrec_tpu_torch.kernels.fused_ce import (
        fused_linear_ce_dw_cuda,
        fused_linear_ce_dw_ref,
        fused_linear_ce_dx_cuda,
        fused_linear_ce_dx_ref,
        fused_linear_ce_fwd_cuda,
        fused_linear_ce_ref,
    )

    cases = {  # V = 12,102 is a multiple neither of the 64-column tile nor of 512
        "train_bf16": (torch.bfloat16, False),
        "train_fp32": (torch.float32, False),
        "all_ignored_fp32": (torch.float32, True),
    }
    errs = {"fwd": {}, "dx": {}, "dw": {}}
    for i, (name, (dtype, all_ignored)) in enumerate(cases.items()):
        x = ce_inputs(dev, seed + i, dtype, all_ignored=all_ignored)
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        fwd = dict(x=x["x"], w=x["w"], targets=x["targets"])
        loss, lse = fused_linear_ce_fwd_cuda(**fwd)
        torch.cuda.synchronize()
        want_loss, want_lse = fused_linear_ce_ref(**fwd)
        errs["fwd"][name] = max(assert_near(f"ce loss {name}", loss, want_loss, FP32_TOL),
                                assert_near(f"ce lse {name}", lse, want_lse, FP32_TOL))
        bwd = dict(fwd, lse=want_lse, g=x["g"])
        dx, dw = fused_linear_ce_dx_cuda(**bwd), fused_linear_ce_dw_cuda(**bwd)
        torch.cuda.synchronize()
        errs["dx"][name] = assert_near(f"ce dx {name}", dx, fused_linear_ce_dx_ref(**bwd), tol)
        errs["dw"][name] = assert_near(f"ce dW {name}", dw, fused_linear_ce_dw_ref(**bwd), tol)
        if all_ignored:
            check(float(loss.abs().max()) == 0.0 and float(dx.float().abs().max()) == 0.0
                  and float(dw.float().abs().max()) == 0.0,
                  "all rows ignored: loss, dx and dW must be exactly 0")

    base = ce_inputs(dev, seed, torch.bfloat16, mean_g=True)
    copies = cold_copies(
        lambda c: ce_inputs(dev, seed + 100 + c, torch.bfloat16, mean_g=True),
        nbytes(*base.values()))
    fwd_sets = [dict(x=c["x"], w=c["w"], targets=c["targets"]) for c in copies]
    bwd_sets = [dict(f, lse=fused_linear_ce_ref(**f)[1], g=c["g"])
                for f, c in zip(fwd_sets, copies)]
    lib_bwd_sets = [dict(f, g=c["g"]) for f, c in zip(fwd_sets, copies)]
    got_loss, _ = fused_linear_ce_fwd_cuda(**fwd_sets[0])
    # A sanity check of the yardstick only: its logits and loss are bf16.
    library_err = assert_near("library CE vs kernel", library_ce(**fwd_sets[0]), got_loss,
                              2 * BF16_TOL)

    R, d = base["x"].shape
    V = base["w"].shape[0]
    x_bytes, w_bytes = nbytes(base["x"]), nbytes(base["w"])
    rows = nbytes(base["targets"])  # one int32 / fp32 per row
    logits = 2 * R * V * d
    lib_fwd_ms = device_ms(library_ce, fwd_sets)
    # name: (kernel, its sets, plain version, library call and its sets,
    #        bytes each input read and output written once, operations)
    specs = {
        "fused_linear_ce_fwd": (fused_linear_ce_fwd_cuda, fwd_sets, fused_linear_ce_ref,
                                library_ce, fwd_sets, x_bytes + w_bytes + 3 * rows, logits),
        "fused_linear_ce_bwd_dx": (fused_linear_ce_dx_cuda, bwd_sets, fused_linear_ce_dx_ref,
                                   library_ce_dx, lib_bwd_sets,
                                   2 * x_bytes + w_bytes + 3 * rows, 2 * logits),
        "fused_linear_ce_bwd_dw": (fused_linear_ce_dw_cuda, bwd_sets, fused_linear_ce_dw_ref,
                                   library_ce_dw, lib_bwd_sets,
                                   x_bytes + 2 * w_bytes + 3 * rows, 2 * logits),
    }
    out = {}
    for name, (fn, sets, plain, lib, lib_sets, bytes_, ops) in specs.items():
        key = name.rsplit("_", 1)[-1]
        ms, plain_ms = device_ms(fn, sets), device_ms(plain, sets)
        if key == "fwd":
            library_ms = lib_fwd_ms
            library = "F.cross_entropy(F.linear(x, w), t, ignore_index=0, reduction='none')"
        else:
            library_ms = device_ms(lib, lib_sets) - lib_fwd_ms
            library = (f"autograd of the same call for {key} alone: its forward+backward "
                       "time less its forward time")
        bound_ms, bound_by = bound(bytes_, ops, BF16_FLOPS)
        out[name] = emit(
            "kernel", name=name, shape=dict(R=R, V=V, d=d, dtype="bf16"),
            max_abs_err=max(errs[key].values()), max_abs_err_by_case=errs[key],
            tolerance=dict(fp32=FP32_TOL, bf16=BF16_TOL, loss_lse=FP32_TOL,
                           relative_to="max|plain|"),
            ms=ms, plain_ms=plain_ms, plain=plain.__name__,
            library_ms=library_ms, library=library, library_vs_kernel_loss_err=library_err,
            timed_by="cuda_graph", bound_ms=bound_ms, bound_by=bound_by,
            cold_copies=len(sets),
            work=dict(bytes=bytes_, flops=ops, exps=R * V),
        )
    return out


# ---- phases 4 and 5: HSTU training ------------------------------------------


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by its name in the kernels line."""
    from genrec_tpu_torch.kernels import fused_ce, hstu_attention, paged_attention, rq_cascade

    return {
        "paged_attention_stats": paged_attention.paged_attention_stats_cuda,
        "paged_attention_stats_quantized": paged_attention.paged_attention_stats_quantized_cuda,
        "rq_cascade": rq_cascade.rq_cascade_cuda,
        "hstu_attention_fwd": hstu_attention.hstu_attention_fwd_cuda,
        "hstu_attention_bwd": hstu_attention.hstu_attention_bwd_cuda,
        "fused_linear_ce_fwd": fused_ce.fused_linear_ce_fwd_cuda,
        "fused_linear_ce_bwd_dx": fused_ce.fused_linear_ce_dx_cuda,
        "fused_linear_ce_bwd_dw": fused_ce.fused_linear_ce_dw_cuda,
        "sharded_fused_linear_ce": fused_ce.sharded_fused_linear_ce,
    }


def reset_counters() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def trainer_run(dev, seed) -> dict:
    """hstu_trainer.train through config/hstu/amazon.gin, 2 epochs, eval
    on: the user's entry point."""
    from genrec_tpu_torch import configlib
    from genrec_tpu_torch.trainers import hstu_trainer

    configlib.clear_bindings()
    configlib.clear_macros()
    configlib.parse_file(str(HERE / "config/hstu/amazon.gin"),
                         substitutions={"split": "beauty"})
    with tempfile.TemporaryDirectory() as tmp:
        for binding in ('train.dataset = "synthetic"', f"train.num_items = {BEAUTY_ITEMS}",
                        "train.wandb_logging = False", f'train.save_dir_root = "{tmp}"',
                        "train.do_eval = True", "train.epochs = 2", f"train.seed = {seed}",
                        f'train.device = "{dev}"'):
            configlib.parse_binding(binding)
        reset_counters()
        t0 = time.perf_counter()
        valid, test = hstu_trainer.train()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counters()
    configlib.clear_bindings()
    configlib.clear_macros()
    for name in LAUNCHES_PER_STEP:
        check(launches[name] > 0, f"train(): {name} was never launched")
    check(all(np.isfinite(v) for v in (*valid.values(), *test.values())), (valid, test))
    return dict(wall_s=wall_s, valid=valid, test=test, launches=launches)


def train_setup(dev, seed, *, dtype, dropout, use_kernels):
    """A model at the amazon.gin widths, its step function and state, and
    the packing closure over SyntheticSeqDataset with Amazon-Beauty's item
    and user counts (the trainer's own recipe)."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.hstu import HSTU
    from genrec_tpu_torch.trainers.hstu_trainer import make_loss_fn

    model = HSTU(num_items=BEAUTY_ITEMS, dropout=dropout, use_pallas=use_kernels,
                 fused_ce=use_kernels, dtype=dtype, device=dev, seed=seed, **HSTU_AMAZON)
    optimizer = Adam(1e-3, b2=0.98)
    step_fn = make_train_step(make_loss_fn(), optimizer, clip_norm=None)
    return model, step_fn, TrainState.create(model, optimizer, seed)


@functools.cache
def beauty_data(seed):
    from genrec_tpu_torch.data.batching import pack_examples
    from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset

    ds = SyntheticSeqDataset(num_items=BEAUTY_ITEMS, num_users=BEAUTY_USERS,
                             max_seq_len=HSTU_AMAZON["max_seq_len"], seed=seed)
    examples = ds.train_examples(with_time=True)

    def repack(epoch):
        arrays, rep = pack_examples(examples, row_len=HSTU_AMAZON["max_seq_len"],
                                    seed=(seed, epoch))
        arrays.pop("positions")
        arrays.pop("segment_valid")
        return arrays, rep

    return ds, repack


def train_phase(dev, seed, profile) -> dict:
    from genrec_tpu_torch.core.logging import Tracker, setup_logger
    from genrec_tpu_torch.trainers.hstu_trainer import evaluate, make_eval_step
    from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop

    trainer = trainer_run(dev, seed)
    t0 = time.perf_counter()
    ds, repack = beauty_data(seed)
    data_s = time.perf_counter() - t0
    model, step_fn, state = train_setup(dev, seed, dtype=torch.bfloat16, dropout=0.2,
                                        use_kernels=True)
    events, losses, tokens = [], [], []

    def hook(state, m, global_step):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(m["loss"])
        tokens.append(m["real_tokens"])

    loop = PackedTrainLoop(logger=setup_logger(None), tracker=Tracker(), device=dev,
                           rows_per_step=HSTU_BATCH, row_len=HSTU_AMAZON["max_seq_len"],
                           seed=seed, pack_sequences=True, repack=repack, step_hook=hook)
    warm = 3  # first calls: kernel libraries, cuBLAS handles, allocator
    loop.run_epoch(state, step_fn, 0, 0, max_steps=warm)
    steps_per_epoch = loop.pack_report.n_rows // HSTU_BATCH
    check(steps_per_epoch >= warm + TRAIN_STEPS, (steps_per_epoch, warm + TRAIN_STEPS))
    events.clear()
    losses.clear()
    tokens.clear()
    torch.cuda.synchronize()
    first = torch.cuda.Event(enable_timing=True)
    reset_counters()
    t0 = time.perf_counter()
    first.record()
    loop.run_epoch(state, step_fn, 0, warm, start_batch=warm, max_steps=warm + TRAIN_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    n = len(events)
    check(n == TRAIN_STEPS, (n, TRAIN_STEPS))
    for name, per_step in LAUNCHES_PER_STEP.items():
        check(launches[name] == per_step * n,
              f"{name}: {launches[name]} launches in {n} steps, want {per_step} per step")
    step_ms = [a.elapsed_time(b) for a, b in zip([first] + events[:-1], events)]
    loss = [float(v) for v in losses]
    real_tokens = float(sum(float(v) for v in tokens))
    check(all(np.isfinite(loss)), loss)
    check(np.mean(loss[-5:]) < np.mean(loss[:5]), ("loss did not fall", loss))
    metrics = evaluate(make_eval_step(model), ds.eval_arrays_with_time("valid"), 256, dev)
    out = emit(
        "train", card=torch.cuda.get_device_name(dev), trainer=trainer,
        config="config/hstu/amazon.gin widths, synthetic data", rows_per_step=HSTU_BATCH,
        data_build_s=data_s, packing=loop.pack_report.as_dict(), steps=n,
        steps_per_s=n / wall_s, real_tokens_per_s=real_tokens / wall_s,
        real_tokens_per_step=real_tokens / n, wall_s=wall_s,
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p90=float(np.percentile(step_ms, 90)),
        first_loss=loss[0], last_loss=loss[-1], losses=loss,
        valid_recall_at_10=metrics["Recall@10"], valid_ndcg_at_10=metrics["NDCG@10"],
        launches=launches,
        launches_per_step={k: launches[k] / n for k in LAUNCHES_PER_STEP},
    )
    if not profile:
        return out
    # The profiled steps run in the second epoch, after its repack and one
    # step outside the window.
    more, step = 20, warm + n + 1
    loop.run_epoch(state, step_fn, 1, warm + n, max_steps=step)

    def run_more():
        t = time.perf_counter()
        loop.run_epoch(state, step_fn, 1, step, start_batch=1, max_steps=step + more)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    prof = emit("train_profile", steps=more, **device_profile(run_more))
    return {**out, "profile": prof}


def parity_phase(dev, seed) -> dict:
    """The kernels' path against the plain path end to end: same init,
    same batches, dropout 0, fp32."""
    from genrec_tpu_torch.data.batching import batch_iterator

    _, repack = beauty_data(seed)
    arrays, _ = repack(0)
    batches = []
    for batch, _ in batch_iterator(arrays, HSTU_BATCH, drop_last=True):
        batches.append({k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        if len(batches) == PARITY_STEPS:
            break
    traj = {}
    init = None
    for use_kernels in (True, False):
        model, step_fn, state = train_setup(dev, seed, dtype=torch.float32, dropout=0.0,
                                            use_kernels=use_kernels)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        traj[use_kernels] = [float(step_fn(state, b)[1]["loss"]) for b in batches]
    k, p = np.asarray(traj[True]), np.asarray(traj[False])
    rel = float(np.max(np.abs(k - p) / np.abs(p)))
    check(np.isfinite(k).all() and rel <= PARITY_RTOL,
          f"kernel vs plain loss trajectories: max relative diff {rel} > {PARITY_RTOL}")
    return emit("parity", steps=len(batches), dtype="fp32", dropout=0.0,
                max_rel_diff=rel, rtol=PARITY_RTOL, kernel_losses=traj[True],
                plain_losses=traj[False])


# ---- phase 6: RQ-VAE semantic ids -------------------------------------------


def rqvae_trainer_run(dev, seed) -> dict:
    """rqvae_trainer.train through config/tiger/amazon/rqvae.gin with
    synthetic item embeddings at Amazon-Beauty's size, RQVAE_EPOCHS epochs:
    the user's entry point. Its epoch losses and collision rate come back
    from the run's metrics.jsonl."""
    from genrec_tpu_torch import configlib
    from genrec_tpu_torch.models.rqvae import count_distinct
    from genrec_tpu_torch.trainers import rqvae_trainer

    configlib.clear_bindings()
    configlib.clear_macros()
    configlib.parse_file(str(HERE / "config/tiger/amazon/rqvae.gin"),
                         substitutions={"split": "beauty"})
    with tempfile.TemporaryDirectory() as tmp:
        for binding in ('train.dataset = "synthetic"', f"train.num_items = {CATALOG_ITEMS}",
                        "train.wandb_logging = False", f'train.save_dir_root = "{tmp}"',
                        f'train.sem_ids_path = "{tmp}/sem_ids.npz"',
                        f"train.epochs = {RQVAE_EPOCHS}", f"train.seed = {seed}",
                        f'train.device = "{dev}"'):
            configlib.parse_binding(binding)
        reset_counters()
        t0 = time.perf_counter()
        model, sem_ids = rqvae_trainer.train()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counters()["rq_cascade"]
        logged = [json.loads(line) for line in open(f"{tmp}/metrics.jsonl")]
    configlib.clear_bindings()
    configlib.clear_macros()
    epoch_loss = [m["train/loss"] for m in logged if "epoch" in m and "train/loss" in m]
    collision = [m["collision_rate"] for m in logged if "collision_rate" in m]
    check(len(epoch_loss) == RQVAE_EPOCHS and np.isfinite(epoch_loss).all(), epoch_loss)
    check(np.mean(epoch_loss[-3:]) < np.mean(epoch_loss[:3]), ("loss did not fall", epoch_loss))
    check(sem_ids.shape == (CATALOG_ITEMS, 3) and collision, (sem_ids.shape, collision))
    # The collision eval and the export each run B7 once a 4096-item chunk.
    chunks = -(-CATALOG_ITEMS // SEM_ID_CHUNK)
    check(launches == chunks * (1 + len(collision)), (launches, chunks, len(collision)))
    distinct = int(count_distinct(torch.as_tensor(sem_ids)))
    return dict(wall_s=wall_s, epochs=RQVAE_EPOCHS, epoch_loss=epoch_loss,
                collision_rate=collision[-1], export_collision_rate=1 - distinct / len(sem_ids),
                rq_cascade_launches=launches)


def rqvae_phase(dev, seed, profile=False) -> dict:
    """The trainer run, fixed steps at the file's widths, and the sem-id
    export over Amazon-Beauty's 12,101 items through B7. With ``profile``,
    one more epoch of steps under torch.profiler."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.logging import Tracker, setup_logger
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.data.items import SyntheticItemEmbeddings
    from genrec_tpu_torch.models.rqvae import QuantizeForwardMode, RqVae, kmeans_init_params
    from genrec_tpu_torch.ops.schedules import linear_schedule_with_warmup
    from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop
    from genrec_tpu_torch.trainers.rqvae_trainer import compute_sem_ids, make_loss_fn

    trainer = rqvae_trainer_run(dev, seed)
    src = SyntheticItemEmbeddings(num_items=CATALOG_ITEMS, dim=768, seed=seed)
    train_x, _ = src.arrays()
    model = RqVae(input_dim=768, embed_dim=32, hidden_dims=(512, 256, 128, 64),
                  codebook_size=256, codebook_mode=QuantizeForwardMode.STE,
                  codebook_last_layer_mode=QuantizeForwardMode.SINKHORN, n_layers=3,
                  commitment_weight=0.25, n_cat_features=0, device=dev, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kmeans_init_params(model, torch.as_tensor(train_x[:20000], device=dev),
                       torch.Generator(device=dev).manual_seed(seed + 1))
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    steps_per_epoch = len(train_x) // 1024
    optimizer = Adam(linear_schedule_with_warmup(1e-3, 50 * steps_per_epoch,
                                                 5000 * steps_per_epoch), weight_decay=1e-4)
    step_fn = make_train_step(make_loss_fn(0.2), optimizer, clip_norm=1.0)
    state = TrainState.create(model, optimizer, seed)
    events, losses = [], []

    def hook(state, m, global_step):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(m["loss"])

    loop = PackedTrainLoop(logger=setup_logger(None), tracker=Tracker(), device=dev,
                           rows_per_step=1024, row_len=1, seed=seed, pack_sequences=False,
                           train_arrays={"x": train_x}, step_hook=hook)
    loop.run_epoch(state, step_fn, 0, 0, max_steps=RQVAE_WARM)
    events.clear()
    losses.clear()
    torch.cuda.synchronize()
    first = torch.cuda.Event(enable_timing=True)
    first.record()
    t0 = time.perf_counter()
    step, epoch = RQVAE_WARM, 0
    while step < RQVAE_WARM + RQVAE_STEPS:  # across epochs: 11 steps an epoch
        start = RQVAE_WARM if epoch == 0 else 0
        res = loop.run_epoch(state, step_fn, epoch, step, start_batch=start,
                             max_steps=RQVAE_WARM + RQVAE_STEPS)
        step, epoch = res.global_step, epoch + 1
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip([first] + events[:-1], events)]
    loss = [float(v) for v in losses]
    check(len(loss) == RQVAE_STEPS and np.isfinite(loss).all(), loss)
    check(np.mean(loss[-5:]) < np.mean(loss[:5]), ("loss did not fall", loss))

    # The export: B7 through compute_sem_ids, against the model path.
    reset_counters()
    t0 = time.perf_counter()
    sem_ids = compute_sem_ids(model, src.embeddings, batch_size=SEM_ID_CHUNK, use_pallas=True)
    export_s = time.perf_counter() - t0
    launches = read_counters()["rq_cascade"]
    chunks = -(-CATALOG_ITEMS // SEM_ID_CHUNK)
    check(launches == chunks, f"export: {launches} B7 launches, want {chunks}")
    model_ids = compute_sem_ids(model, src.embeddings, batch_size=SEM_ID_CHUNK,
                                use_pallas=False)
    with torch.no_grad():
        enc = model.encode(torch.as_tensor(src.embeddings, device=dev))
    ties = check_sem_ids("export vs get_semantic_ids", enc, model.codebooks().detach(),
                         torch.as_tensor(sem_ids, device=dev),
                         torch.as_tensor(model_ids, device=dev))
    distinct = len({tuple(r) for r in sem_ids.tolist()})
    prof = None
    if profile:
        def run_more():
            t = time.perf_counter()
            loop.run_epoch(state, step_fn, epoch, step, max_steps=step + steps_per_epoch)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        prof = emit("rqvae_profile", steps=steps_per_epoch, **device_profile(run_more))
    return emit(
        "rqvae", card=torch.cuda.get_device_name(dev), trainer=trainer, profile=prof,
        config="config/tiger/amazon/rqvae.gin widths, synthetic item embeddings "
               f"({CATALOG_ITEMS} x 768)", kmeans_init_s=kmeans_s, rows_per_step=1024,
        steps=len(loss), steps_per_s=len(loss) / wall_s, wall_s=wall_s,
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p90=float(np.percentile(step_ms, 90)),
        first_loss=loss[0], last_loss=loss[-1], losses=loss,
        export=dict(items=CATALOG_ITEMS, chunk=SEM_ID_CHUNK, rq_cascade_launches=launches,
                    wall_s=export_s, collision_rate=1 - distinct / CATALOG_ITEMS,
                    vs_model_path=ties),
    )


# ---- phase 7: the serving slice --------------------------------------------


def make_requests(rng, n, n_items):
    from genrec_tpu_torch.serving.types import Request

    return [
        Request(head="tiger", history=rng.integers(0, n_items, int(k)),
                user_id=int(rng.integers(0, 2**31 - 1)))
        for k in rng.integers(1, MAX_ITEMS + 1, n)
    ]


def serve(engine, reqs):
    t0 = time.perf_counter()
    futures = [engine.submit(r) for r in reqs]
    responses = [f.result(timeout=300) for f in futures]
    return responses, time.perf_counter() - t0


def offline_answer(model, head, trie, req, L, kv_dtype="float32"):
    from genrec_tpu_torch.models.tiger import tiger_generate_paged

    user, ids, types, mask = (t.to(model.device) for t in head.make_batch([req], 1, L))
    out = tiger_generate_paged(model, trie, user, ids, types, mask,
                               n_top_k_candidates=BEAMS,
                               page_size=PAGED["page_size"], kv_dtype=kv_dtype)
    return out.sem_ids[0].cpu().numpy(), out.log_probas[0].cpu().numpy()


def int8_answers_agree(sem, logp, got_sem, got_scores, atol) -> tuple[float, int]:
    """Offline (sem, logp) against an engine answer, both (BEAMS, D) tuples
    with descending scores: every tuple in both has scores within
    ``atol``; a tuple in one only scores within ``atol`` of the other's
    last (it sat at the cut-off); every answer's scores sort descending.
    Returns (max score difference of the shared tuples, beams whose rank
    differs)."""
    want = {tuple(t): float(v) for t, v in zip(sem.tolist(), logp)}
    got = {tuple(t): float(v) for t, v in zip(got_sem.tolist(), got_scores)}
    check(len(want) == len(got) == BEAMS, (want, got))
    err = max([abs(want[t] - got[t]) for t in want.keys() & got.keys()] or [0.0])
    check(err <= atol, ("int8 scores of the same tuples", err, want, got))
    for a, b in ((want, got), (got, want)):
        floor = min(b.values())
        check(all(a[t] <= floor + atol for t in a.keys() - b.keys()),
              ("a tuple of one answer only, above the other's cut-off", want, got))
    check(bool((np.diff(got_scores) <= 0).all()), got_scores)
    moved = int(sum(tuple(x) != tuple(y) for x, y in zip(sem.tolist(), got_sem.tolist())))
    return err, moved


def device_profile(serve_once) -> dict:
    """Device time by CUDA kernel over one ``serve_once()`` under
    torch.profiler. The profiler slows the host, so the idle share it
    shows is an upper bound on the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = serve_once()
        torch.cuda.synchronize()
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(ms for _, ms, _ in kernels)
    return dict(
        wall_ms=1e3 * wall_s, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / (1e3 * wall_s),
        kernel_launches=sum(n for _, _, n in kernels),
        top_kernels=[dict(name=k[:90], ms=ms, launches=n) for k, ms, n in kernels[:12]],
    )


def serve_phase(dev, seed, n_requests, profile=False, kv_dtype="float32",
                fp32_answers=None) -> tuple[dict, dict | None, list]:
    """The serving burst with ``kv_dtype`` pages. The same seed gives the
    same catalog, weights and requests for both page types; with
    ``fp32_answers`` (the float32 burst's responses) the int8 answers'
    top-10 agreement with them is reported. Returns (the phase's line, the
    profile's line or None, the responses)."""
    from genrec_tpu_torch.models.tiger import Tiger
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import TigerGenerativeHead
    from genrec_tpu_torch.serving.kv_pool import PagedConfig

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, TIGER_AMAZON["num_item_embeddings"],
                         (2 * CATALOG_ITEMS, TIGER_AMAZON["sem_id_dim"]))
    catalog = np.unique(codes, axis=0)
    catalog = catalog[rng.permutation(len(catalog))[:CATALOG_ITEMS]]
    check(len(catalog) == CATALOG_ITEMS, len(catalog))

    model = Tiger(**TIGER_AMAZON, device=dev, seed=seed).eval()
    head = TigerGenerativeHead(model, item_sem_ids=catalog, top_k=BEAMS)
    ladder = BucketLadder((1, 2, 4, 8, 16), (4, 8, 16, MAX_ITEMS))

    cfg = PagedConfig(**PAGED, kv_dtype=kv_dtype)

    def engine():
        return ServingEngine([head], device=dev, ladder=ladder, max_batch=16,
                             max_wait_ms=2.0, paged_config=cfg, kv_dtype=kv_dtype).start()

    warm = engine()  # first calls: cuBLAS handles, allocator, kernel library
    serve(warm, make_requests(rng, 32, CATALOG_ITEMS))
    warm.stop()

    reqs = make_requests(rng, n_requests, CATALOG_ITEMS)
    eng = engine()
    reset_counters()
    responses, wall_s = serve(eng, reqs)
    counts = read_counters()
    stats = eng.stop()
    kernel, other = "paged_attention_stats", "paged_attention_stats_quantized"
    if kv_dtype == "int8":
        kernel, other = other, kernel
    launches = counts[kernel]
    check(counts[other] == 0, f"{kv_dtype} burst launched {other} {counts[other]} times")
    pool = eng.runner(head.name).pool
    pool.check_invariants()
    check(pool.allocator.pages_in_use == 0 and pool.active_slot_count == 0, pool.stats())

    decode_layers = TIGER_AMAZON["n_layers"] // 2
    steps = stats["decode_steps"]
    check(stats["completed"] == len(reqs) and stats["failed"] == 0, stats)
    check(launches > 0 and launches == decode_layers * steps, (launches, steps))
    index = head.catalog.item_index()
    for resp in responses:
        check(resp.sem_ids.shape == (BEAMS, TIGER_AMAZON["sem_id_dim"]), resp.sem_ids.shape)
        check(np.isfinite(resp.scores).all() and (resp.scores > -1e30).all(), resp.scores)
        check(all(tuple(int(c) for c in t) in index for t in resp.sem_ids)
              and (resp.items >= 0).all(), ("not catalog items", resp.sem_ids))

    # A sample against offline decoding of the same page type: on the card
    # (the same kernel, one request per batch) and, for fp32, on the CPU
    # (the plain version, CPU GEMMs).
    on_cpu = 4 if kv_dtype == "float32" else 0
    atol = SAMPLE_ATOL if kv_dtype == "float32" else INT8_SAMPLE_ATOL
    if on_cpu:
        cpu_model = Tiger(**TIGER_AMAZON, device="cpu").eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        cpu_trie = head.catalog.device_trie("cpu")
    sample = rng.choice(len(reqs), 12, replace=False)
    sample_err, moved = 0.0, 0
    for i, j in enumerate(sample):
        req, resp = reqs[j], responses[j]
        refs = [("cuda", model, head.trie)] + ([("cpu", cpu_model, cpu_trie)] if i < on_cpu
                                               else [])
        for where, m, trie in refs:
            sem, logp = offline_answer(m, head, trie, req, resp.bucket[1], kv_dtype)
            if kv_dtype == "int8":
                err, n = int8_answers_agree(sem, logp, resp.sem_ids, resp.scores, atol)
                moved += n
            else:
                check((sem == resp.sem_ids).all(), (where, j, sem, resp.sem_ids))
                err = float(np.abs(logp - resp.scores).max())
                check(err <= atol, (where, j, logp, resp.scores))
            sample_err = max(sample_err, err)
    agreement = None
    if fp32_answers is not None:
        agreement = float(np.mean([
            len({tuple(t) for t in a.sem_ids.tolist()} & {tuple(t) for t in b.sem_ids.tolist()})
            / BEAMS for a, b in zip(responses, fp32_answers)]))

    total_ms = np.asarray([r.total_s for r in responses]) * 1e3
    compute_ms = np.asarray([r.compute_s for r in responses]) * 1e3
    geometry = (decode_layers, TIGER_AMAZON["num_heads"],
                TIGER_AMAZON["attn_dim"] // TIGER_AMAZON["num_heads"])
    served = emit(
        "serve" if kv_dtype == "float32" else "serve_int8", kv_dtype=kv_dtype,
        card=torch.cuda.get_device_name(dev), requests=len(reqs),
        qps=len(reqs) / wall_s, wall_s=wall_s,
        p50_ms=float(np.percentile(total_ms, 50)),
        p99_ms=float(np.percentile(total_ms, 99)),
        compute_p50_ms=float(np.percentile(compute_ms, 50)),
        compute_p99_ms=float(np.percentile(compute_ms, 99)),
        decode_steps=steps,
        prefill_batches=stats["batches"], bucket_hits=stats["bucket_hits"],
        kernel=kernel, paged_attention_launches=launches,
        launches_per_decode_step=launches / steps,
        catalog_items=CATALOG_ITEMS, catalog_version=head.catalog_version,
        sample_checked=len(sample), sample_checked_on_cpu=on_cpu,
        sample_max_abs_score_err=sample_err, sample_atol=atol,
        sample_beams_in_another_rank=moved,
        pool_bytes=cfg.hbm_bytes(*geometry),
        pool_bytes_fp32=PagedConfig(**PAGED).hbm_bytes(*geometry),
        top10_agreement_with_fp32=agreement,
    )
    if not profile:
        return served, None, responses
    # The same traffic again, a fresh request set, under the profiler.
    again = make_requests(rng, n_requests, CATALOG_ITEMS)
    eng = engine()
    prof = emit("profile" if kv_dtype == "float32" else "profile_int8", requests=n_requests,
                **device_profile(lambda: serve(eng, again)[1]))
    eng.stop()
    return served, prof, responses


# ---- phases 8 and 9: LCRec SFT at tensor_parallel=2 ---------------------------


def lcrec_cfg(layers: int):
    """QwenConfig()'s Qwen2.5-1.5B widths at ``layers`` layers (tied head)."""
    from genrec_tpu_torch.models.backbones.qwen import QwenConfig

    return QwenConfig(vocab_size=LCREC["base_vocab"], num_hidden_layers=layers)


def lcrec_shard_inputs(dev, seed, *, R, V, d, vlim, dtype=torch.bfloat16):
    """One rank's per-shard inputs of B3/B4 under B8: x (R, d) ~ N(0, 1)
    (the final RMSNorm's output), the shard's rows w (V, d) ~ N(0, 0.02)
    (the embedding's init), local targets below vlim or -1 (held on the
    other shard, half the rows), and g: the mean loss's 1 / valid, 0 on
    the 20% of rows whose label is -100 (B8 zeroes their cotangent)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    tgt = rng.integers(0, max(vlim, 1), R).astype(np.int32)
    tgt[rng.random(R) < 0.5] = -1
    if vlim == 0:
        tgt[:] = -1
    g = np.full(R, 1.0 / R, np.float32)
    g[rng.random(R) < 0.2] = 0.0
    return dict(x=t(rng.normal(size=(R, d)).astype(np.float32)).to(dtype),
                w=t((rng.normal(size=(V, d)) * 0.02).astype(np.float32)).to(dtype),
                targets=t(tgt), g=t(g), vlim=vlim)


def lcrec_library_ce(x, w, targets):
    """The yardstick of the per-shard forward: the same logits and
    logsumexp by one PyTorch call (targets of the other shard read
    column 0)."""
    return torch.nn.functional.cross_entropy(
        torch.nn.functional.linear(x, w), targets.long().clamp_min(0), reduction="none")


def ce_lcrec_kernel_phase(dev, seed) -> dict:
    """B3 and B4 (dx, dW) at an LCRec shard (R = 8 x 511 rows, 76,608
    vocab rows, d 1,536, bf16) with the full shard live and with a ragged
    live-vocab limit, and at d in LCREC_DIMS at a small size, each against
    its plain version; then timed at the shard shape."""
    from genrec_tpu_torch.kernels import fused_ce as fc

    R, V, d = LCREC["batch"] * (LCREC["seq"] - 1), LCREC_SHARD, lcrec_cfg(1).hidden_size
    cases = {"shard_full": dict(R=R, V=V, d=d, vlim=V),
             "shard_ragged": dict(R=R, V=V, d=d, vlim=V * 63 // 64)}
    cases.update({f"small_d{dd}": dict(R=300, V=2000, d=dd, vlim=1900) for dd in LCREC_DIMS})
    errs = {"fwd": {}, "dx": {}, "dw": {}}
    for i, (name, shape) in enumerate(cases.items()):
        x = lcrec_shard_inputs(dev, seed + i, **shape)
        fwd = dict(x=x["x"], w=x["w"], targets=x["targets"], ignore_index=-2, vlim=x["vlim"])
        loss, lse = fc.fused_linear_ce_fwd_cuda(**fwd)
        torch.cuda.synchronize()
        want_loss, want_lse = fc.fused_linear_ce_ref(**fwd)
        errs["fwd"][name] = max(assert_near(f"ce loss {name}", loss, want_loss, FP32_TOL),
                                assert_near(f"ce lse {name}", lse, want_lse, FP32_TOL))
        bwd = dict(fwd, lse=want_lse, g=x["g"])
        dx = fc.fused_linear_ce_dx_cuda(**bwd)
        torch.cuda.synchronize()
        errs["dx"][name] = assert_near(f"ce dx {name}", dx, fc.fused_linear_ce_dx_ref(**bwd),
                                       BF16_TOL)
        del dx
        dw = fc.fused_linear_ce_dw_cuda(**bwd)
        torch.cuda.synchronize()
        errs["dw"][name] = assert_near(f"ce dW {name}", dw, fc.fused_linear_ce_dw_ref(**bwd),
                                       BF16_TOL)
        check(zero_tail(dw, x["vlim"]), f"{name}: pad rows past vlim must get exactly zero dW")
        del dw, x, fwd, bwd
        torch.cuda.empty_cache()

    base = lcrec_shard_inputs(dev, seed, **cases["shard_full"])
    copies = cold_copies(lambda c: lcrec_shard_inputs(dev, seed + 100 + c,
                                                      **cases["shard_full"]),
                         nbytes(base["x"], base["w"], base["targets"], base["g"]))
    fwd_sets = [dict(x=c["x"], w=c["w"], targets=c["targets"], ignore_index=-2,
                     vlim=c["vlim"]) for c in copies]
    bwd_sets = [dict(f, lse=fc.fused_linear_ce_ref(**f)[1], g=c["g"])
                for f, c in zip(fwd_sets, copies)]
    lib_sets = [dict(x=c["x"], w=c["w"], targets=c["targets"]) for c in copies]
    lib_fwd_ms = device_ms(lcrec_library_ce, lib_sets, reps=LCREC_REPS)
    x_bytes, w_bytes, rows = nbytes(base["x"]), nbytes(base["w"]), nbytes(base["targets"])
    logits = 2 * R * V * d
    specs = {
        "fused_linear_ce_fwd": (fc.fused_linear_ce_fwd_cuda, fwd_sets, fc.fused_linear_ce_ref,
                                x_bytes + w_bytes + 3 * rows, logits),
        "fused_linear_ce_bwd_dx": (fc.fused_linear_ce_dx_cuda, bwd_sets,
                                   fc.fused_linear_ce_dx_ref,
                                   2 * x_bytes + w_bytes + 3 * rows, 2 * logits),
        "fused_linear_ce_bwd_dw": (fc.fused_linear_ce_dw_cuda, bwd_sets,
                                   fc.fused_linear_ce_dw_ref,
                                   x_bytes + 2 * w_bytes + 3 * rows, 2 * logits),
    }
    out = {}
    for name, (fn, sets, plain, bytes_, ops) in specs.items():
        key = name.rsplit("_", 1)[-1]
        ms = device_ms(fn, sets, reps=LCREC_REPS)
        plain_ms = device_ms(plain, sets, reps=LCREC_REPS)
        if key == "fwd":
            library_ms = lib_fwd_ms
            library = "F.cross_entropy(F.linear(x, w_shard), reduction='none')"
        else:
            wrt = "x" if key == "dx" else "w"
            library_ms = device_ms(functools.partial(library_grad, wrt=wrt), [
                dict(s, g=c["g"]) for s, c in zip(lib_sets, copies)],
                reps=LCREC_REPS) - lib_fwd_ms
            library = (f"autograd of the same call for {key} alone: its forward+backward "
                       "time less its forward time")
        bound_ms, bound_by = bound(bytes_, ops, BF16_FLOPS)
        out[name + "_lcrec"] = emit(
            "kernel", name=name + "_lcrec", kernel=name,
            shape=dict(R=R, V=V, d=d, dtype="bf16", vlim=V,
                       what="one rank's shard of the LCRec head at tensor_parallel=2"),
            max_abs_err=max(errs[key].values()), max_abs_err_by_case=errs[key],
            tolerance=dict(bf16=BF16_TOL, loss_lse=FP32_TOL, relative_to="max|plain|"),
            ms=ms, plain_ms=plain_ms, plain=plain.__name__, library_ms=library_ms,
            library=library, timed_by="cuda_graph", bound_ms=bound_ms, bound_by=bound_by,
            cold_copies=len(sets), reps=LCREC_REPS, work=dict(bytes=bytes_, flops=ops),
        )
    del copies, fwd_sets, bwd_sets, lib_sets, base
    torch.cuda.empty_cache()
    return out


def zero_tail(t, start: int) -> bool:
    """Rows start.. of t are exactly zero (true when there are none)."""
    tail = t[start:]
    return tail.numel() == 0 or float(tail.float().abs().max()) == 0.0


def library_grad(x, w, targets, g, wrt):
    """The gradient of sum(g * the library CE) in x or w (autograd)."""
    x = x.detach().requires_grad_(wrt == "x")
    w = w.detach().requires_grad_(wrt == "w")
    return torch.autograd.grad(lcrec_library_ce(x, w, targets), x if wrt == "x" else w, g)


def lcrec_tokens(seed, B, L, live_vocab):
    """Seeded SFT batches over the whole live vocab: each row's first 25-75%
    are prompt (label -100), every position valid."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, live_vocab, (B, L)).astype(np.int32)
    labels = ids.copy()
    for b, p in enumerate(rng.integers(L // 4, 3 * L // 4, B)):
        labels[b, :p] = -100
    return {"input_ids": ids, "attention_mask": np.ones((B, L), np.int32), "labels": labels}


def lcrec_model(cfg, dev, seed, dtype, group):
    """The rank's shard of the full parameters made from ``seed`` (every
    rank builds the same full tensors on its card), the codebook tokens
    appended and the vocab padded to lcm(8, tp), as the trainer does."""
    from genrec_tpu_torch.models.backbones.qwen import QwenLM, qwen_init_params
    from genrec_tpu_torch.models.lcrec import extend_vocab
    from genrec_tpu_torch.parallel.shardings import shard_qwen_params

    tp = 1 if group is None else group.size
    full = qwen_init_params(cfg, seed, dev)
    cfg, full, base = extend_vocab(cfg, full, LCREC["codebooks"], LCREC["codebook_size"],
                                   torch.Generator(device=dev).manual_seed(seed + 1),
                                   pad_to=math.lcm(8, tp))
    model = QwenLM(cfg, dtype=dtype, group=group, device=dev)
    model.load_state_dict(shard_qwen_params(full, 0 if group is None else group.rank, tp))
    del full
    torch.cuda.empty_cache()
    return model, base + LCREC["codebooks"] * LCREC["codebook_size"]


def lcrec_stepper(model, live, group, lr, warmup, total, wd):
    """``run(batches, hook=None) -> metrics per step``: train steps through
    the trainer's recipe, one optimizer state across calls: AdamW after a
    cosine warm-up, clip 1.0 (its norm over the group), the SFT loss
    through B8 (a group) or the fused CE (none)."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.lcrec import make_tp_sharded_fused_sft_loss, sft_loss
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup

    if group is None:
        def loss(b):
            return sft_loss(model, b["input_ids"], b["attention_mask"], b["labels"],
                            valid_vocab=live, use_fused_ce=True)
    else:
        loss = make_tp_sharded_fused_sft_loss(model, live)
    opt = Adam(cosine_schedule_with_warmup(lr, warmup, total), weight_decay=wd)
    step = make_train_step(lambda m, b, g: (loss(b), {}), opt, clip_norm=1.0, group=group)
    state = TrainState.create(model, opt, 0)
    dev = model.norm.weight.device

    def run(batches, hook=None):
        out = []
        for b in batches:
            _, m = step(state, {k: torch.as_tensor(v, device=dev) for k, v in b.items()})
            out.append({k: float(v) for k, v in m.items()})
            if hook is not None:
                hook()
        return out

    return run


def lcrec_parity_batches(seed):
    return [lcrec_tokens(seed + 10 + i, LCREC["parity_batch"], LCREC["parity_seq"],
                         LCREC_LIVE) for i in range(LCREC["parity_steps"])]


def lcrec_parity_tp1(dev, seed) -> list:
    """tensor_parallel=1 side of the parity run: fp32, the fused CE (B3/B4)."""
    model, live = lcrec_model(lcrec_cfg(LCREC["parity_layers"]), dev, seed, torch.float32,
                              None)
    run = lcrec_stepper(model, live, None, LCREC["parity_lr"], 1, LCREC["parity_steps"],
                        LCREC["wd"])
    losses = [m["loss"] for m in run(lcrec_parity_batches(seed))]
    del model, run
    torch.cuda.empty_cache()
    return losses


def lcrec_b8_inputs(dev, seed):
    """B8 at the full-width head, bf16: x (8 x 511 rows, 1,536), the whole
    padded head (153,216 rows) and, per case, (global targets, valid
    vocab); -100 is ignored."""
    R, d = LCREC["batch"] * (LCREC["seq"] - 1), lcrec_cfg(1).hidden_size
    rng = np.random.default_rng(seed + 7)
    x = torch.as_tensor(rng.normal(size=(R, d)).astype(np.float32), device=dev)
    w = torch.as_tensor((rng.normal(size=(LCREC_LIVE, d)) * 0.02).astype(np.float32),
                        device=dev)
    t = rng.integers(0, LCREC_LIVE, R).astype(np.int32)
    t[rng.random(R) < 0.2] = -100
    cases = {"mixed": (t, LCREC_LIVE),
             "other_shard": (rng.integers(LCREC_SHARD, LCREC_LIVE, R).astype(np.int32),
                             LCREC_LIVE),
             "all_ignored": (np.full(R, -100, np.int32), LCREC_LIVE),
             "empty_shard": (rng.integers(0, LCREC_SHARD, R).astype(np.int32), LCREC_SHARD)}
    return x.to(torch.bfloat16), w.to(torch.bfloat16), cases


def lcrec_b8(group, seed) -> dict:
    """(a) B8 against its plain twin on this rank, every case; B8 and the
    twin timed (forward and backward, both ranks running) on "mixed"."""
    from genrec_tpu_torch.kernels import fused_ce as fc

    dev = group.device
    Vs = LCREC_SHARD
    errs, times = {}, {}
    x, w, cases = lcrec_b8_inputs(dev, seed)
    w_shard = w[group.rank * Vs:(group.rank + 1) * Vs].contiguous()
    del w
    for name, (t, vv) in cases.items():
        outs = {}
        for fn in (fc.sharded_fused_linear_ce, fc.sharded_fused_linear_ce_ref):
            reps = []
            for _ in range(LCREC_REPS if name == "mixed" else 1):
                xx = x.detach().clone().requires_grad_()
                ww = w_shard.detach().clone().requires_grad_()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = fn(xx, ww, torch.as_tensor(t, device=dev), group, -100, vv)
                (loss.sum() / max(int((t != -100).sum()), 1)).backward()
                torch.cuda.synchronize()
                reps.append(1e3 * (time.perf_counter() - t0))
            outs[fn.__name__] = (loss.detach(), xx.grad, ww.grad)
            times.setdefault(name, {})[fn.__name__] = float(np.median(reps))
        (k_loss, k_dx, k_dw), (p_loss, p_dx, p_dw) = outs.values()
        errs[name] = max(assert_near(f"B8 loss {name}", k_loss, p_loss, FP32_TOL),
                         assert_near(f"B8 dx {name}", k_dx, p_dx, BF16_TOL),
                         assert_near(f"B8 dW {name}", k_dw, p_dw, BF16_TOL))
        check(zero_tail(k_dw, min(max(vv - group.rank * Vs, 0), Vs)),
              f"B8 {name}: pad rows must get exactly zero dW")
        if name == "all_ignored":
            check(float(k_loss.abs().max()) == 0.0 and float(k_dx.float().abs().max()) == 0.0,
                  "B8 all rows ignored: loss and dx must be exactly 0")
        del outs
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
                ms=times["mixed"]["sharded_fused_linear_ce"],
                plain_ms=times["mixed"]["sharded_fused_linear_ce_ref"], ms_by_case=times)


def lcrec_fixed_steps(group, seed, profile) -> dict:
    """(c) All layers at full width, bf16, batch 8 x 512: LCREC["warm"]
    steps, then LCREC["steps"] measured with every launch counter at 0
    before and read after."""
    from genrec_tpu_torch.kernels import fused_ce as fc

    dev = group.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, live = lcrec_model(lcrec_cfg(LCREC["layers"]), dev, seed, torch.bfloat16, group)
    init_s = time.perf_counter() - t0
    n, warm = LCREC["steps"], LCREC["warm"]
    batches = [lcrec_tokens(seed + 100 + i, LCREC["batch"], LCREC["seq"], live)
               for i in range(warm + n + (LCREC["profile_steps"] if profile else 0))]
    stamps = []

    def hook():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    run = lcrec_stepper(model, live, group, LCREC["lr"], LCREC["warmup"], len(batches),
                        LCREC["wd"])
    run(batches[:warm])
    torch.cuda.synchronize()
    reset_counters()
    calls0, bytes0 = group.calls, group.bytes
    t_start = time.perf_counter()
    metrics = run(batches[warm:warm + n], hook)
    wall_s = time.perf_counter() - t_start
    launches = read_counters()
    calls, nbytes_ = group.calls - calls0, group.bytes - bytes0
    step_ms = 1e3 * np.diff([t_start] + stamps)
    tokens = LCREC["batch"] * LCREC["seq"]
    out = dict(init_s=init_s, steps=n, wall_s=wall_s, steps_per_s=n / wall_s,
               tokens_per_s=n * tokens / wall_s,
               label_tokens_per_step=float(np.mean(
                   [(b["labels"][:, 1:] != -100).sum() for b in batches[warm:warm + n]])),
               step_ms_p50=float(np.percentile(step_ms, 50)),
               step_ms_p90=float(np.percentile(step_ms, 90)),
               losses=[m["loss"] for m in metrics], grad_norms=[m["grad_norm"] for m in metrics],
               nonfinite=sum(m["nonfinite"] for m in metrics),
               collectives_per_step=calls / n, collective_bytes_per_step=nbytes_ / n,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               launches=launches, b8_calls=fc.sharded_fused_linear_ce.launches)
    if profile:
        def more():
            t = time.perf_counter()
            run(batches[warm + n:])
            torch.cuda.synchronize()
            return time.perf_counter() - t

        out["profile"] = dict(steps=LCREC["profile_steps"], **device_profile(more))
    del model, run
    torch.cuda.empty_cache()
    return out


def lcrec_trainer_run(group, seed) -> dict:
    """(d) lcrec_trainer.train at tensor_parallel=2 through
    config/lcrec/synthetic.gin, epochs and eval sets cut; the per-step
    losses come back from rank 0's metrics.jsonl."""
    from genrec_tpu_torch import configlib
    from genrec_tpu_torch.trainers import lcrec_trainer

    configlib.clear_bindings()
    configlib.clear_macros()
    configlib.parse_file(str(HERE / "config/lcrec/synthetic.gin"))
    with tempfile.TemporaryDirectory() as tmp:
        for binding in ("train.tensor_parallel = 2", f'train.device = "{group.device}"',
                        f'train.save_dir_root = "{tmp}"', "train.wandb_log_interval = 1",
                        f"train.epochs = {LCREC['trainer_epochs']}",
                        f"train.max_eval_samples = {LCREC['trainer_eval']}",
                        f"train.eval_items_limit = {LCREC['trainer_eval']}",
                        f"train.seed = {seed}"):
            configlib.parse_binding(binding)
        reset_counters()
        t0 = time.perf_counter()
        valid, test = lcrec_trainer.train()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counters()
        logged = ([json.loads(line) for line in open(f"{tmp}/metrics.jsonl")]
                  if group.rank == 0 else [])
    configlib.clear_bindings()
    configlib.clear_macros()
    losses = [m["train/loss"] for m in logged if "global_step" in m]
    return dict(wall_s=wall_s, valid=valid, test=test, launches=launches, losses=losses)


def gloo_takes_cuda(group) -> str:
    """Whether gloo all-reduces a CUDA tensor by itself: recorded only, the
    group stages every gloo collective through host memory either way."""
    import torch.distributed as dist

    if group.backend != "gloo" or group.device.type != "cuda":
        return "not asked"
    t = torch.ones(4, device=group.device)
    try:
        dist.all_reduce(t, group=group.pg)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - the answer is the exception
        return f"no: {type(e).__name__}: {str(e)[:160]}"
    return "yes" if t.tolist() == [float(group.size)] * 4 else f"wrong sum {t.tolist()}"


def lcrec_rank(group, seed, profile) -> dict:
    """One tensor-parallel rank of the lcrec_tp phase: (a) B8 against its
    twin, (b) the tp=2 side of the parity run, (c) the fixed steps at full
    width, (d) the trainer."""
    torch.backends.cuda.matmul.allow_tf32 = False  # as in main(): a fresh process
    out = {"backend": group.backend, "device": str(group.device),
           "gloo_takes_cuda_tensors": gloo_takes_cuda(group), "b8": lcrec_b8(group, seed)}
    model, live = lcrec_model(lcrec_cfg(LCREC["parity_layers"]), group.device, seed,
                              torch.float32, group)
    run = lcrec_stepper(model, live, group, LCREC["parity_lr"], 1, LCREC["parity_steps"],
                        LCREC["wd"])
    out["parity_losses"] = [m["loss"] for m in run(lcrec_parity_batches(seed))]
    del model, run
    torch.cuda.empty_cache()
    out["steps"] = lcrec_fixed_steps(group, seed, profile)
    out["trainer"] = lcrec_trainer_run(group, seed)
    return out


def lcrec_library_b8(x, w, targets):
    """The yardstick of B8: the same loss and gradients by one PyTorch call
    over the whole head on one card."""
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    loss = torch.nn.functional.cross_entropy(torch.nn.functional.linear(x, w),
                                             targets.long(), ignore_index=-100)
    return torch.autograd.grad(loss, (x, w))


def lcrec_tp_phase(dev, seed, profile, rank_fn=None) -> dict:
    """LCRec SFT at tensor_parallel=2: the tp=1 side of the parity run and
    the library yardstick of B8 here, then 2 ranks through parallel.spawn
    (gloo on one card, NCCL where each rank has its own). ``rank_fn``
    stands in for ``lcrec_rank`` in a rehearsal on the CPU, which must
    patch each fresh rank process itself."""
    from genrec_tpu_torch.parallel.mesh import choose_backend, rank_device, spawn

    t0 = time.perf_counter()
    tp1 = lcrec_parity_tp1(dev, seed)
    parity_tp1_s = time.perf_counter() - t0
    x, w, cases = lcrec_b8_inputs(dev, seed)
    lib_sets = [dict(x=x, w=w, targets=torch.as_tensor(cases["mixed"][0], device=dev))]
    library_ms = device_ms(lcrec_library_b8, lib_sets, reps=LCREC_REPS)
    del x, w, lib_sets
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share this card: hand back the cache
    backend = choose_backend(rank_device(0, LCREC_TP, dev.type), LCREC_TP)
    emit("lcrec_tp_start", backend=backend, ranks=LCREC_TP,
         device_count=torch.cuda.device_count(),
         parent_reserved_gb=torch.cuda.memory_reserved(dev) / 1e9)
    t0 = time.perf_counter()
    ranks = spawn(rank_fn or lcrec_rank, LCREC_TP, (seed, profile), device=dev.type,
                  timeout_s=LCREC_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    r0, r1 = ranks
    tp2 = r0["parity_losses"]
    check(r1["parity_losses"] == tp2, ("ranks disagree on the parity losses", tp2,
                                       r1["parity_losses"]))
    rel = float(np.max(np.abs(np.asarray(tp2) - tp1) / np.abs(tp1)))
    check(np.isfinite(tp2).all() and rel <= LCREC_PARITY_RTOL,
          f"tp=1 vs tp=2 losses: max relative diff {rel} > {LCREC_PARITY_RTOL}")
    steps = r0["steps"]
    for r in ranks:
        s = r["steps"]
        check(s["nonfinite"] == 0, f"non-finite steps: {s['nonfinite']}")
        check(all(np.isfinite(s["losses"])), s["losses"])
        for name in LCREC_LAUNCHES_PER_STEP:
            check(s["launches"][name] == LCREC["steps"],
                  f"{name}: {s['launches'][name]} launches in {LCREC['steps']} steps, want 1 "
                  "per step per rank")
        check(s["b8_calls"] == LCREC["steps"], ("B8 calls", s["b8_calls"]))
    check(r1["steps"]["losses"] == steps["losses"], "the ranks' losses differ")
    trainer = r0["trainer"]
    losses = trainer["losses"]
    check(len(losses) >= 10 and np.isfinite(losses).all(), losses)
    check(np.mean(losses[-5:]) < np.mean(losses[:5]), ("trainer loss did not fall", losses))
    for name in LCREC_LAUNCHES_PER_STEP:
        check(trainer["launches"][name] > 0, f"train(): {name} was never launched")
    check(all(np.isfinite(v) for v in (*trainer["valid"].values(), *trainer["test"].values())),
          trainer)
    b8 = r0["b8"]
    R, d, V = LCREC["batch"] * (LCREC["seq"] - 1), lcrec_cfg(1).hidden_size, LCREC_LIVE
    # Both ranks' B3 + B4 dx + B4 dW over the whole head, on the one card.
    b8_bound_ms, b8_bound_by = bound(2 * R * d * 2 + V * d * 2 * 2, 5 * 2 * R * V * d,
                                     BF16_FLOPS)
    return emit(
        "lcrec_tp", backend=r0["backend"], devices=[r["device"] for r in ranks],
        gloo_takes_cuda_tensors=r0["gloo_takes_cuda_tensors"],
        config=("QwenConfig() (Qwen2.5-1.5B widths), config/lcrec/amazon/lcrec.gin: "
                f"{LCREC['codebooks']} x {LCREC['codebook_size']} codebook tokens, "
                f"max_text_len {LCREC['seq']}, bf16, AdamW {LCREC['lr']} wd {LCREC['wd']}, "
                f"clip 1.0; batch {LCREC['batch']}; random weights from --seed"),
        live_vocab=LCREC_LIVE, shard_rows=LCREC_SHARD,
        b8=dict(b8, library_ms=library_ms, bound_ms=b8_bound_ms, bound_by=b8_bound_by,
                rank1=r1["b8"]),
        parity=dict(layers=LCREC["parity_layers"], steps=LCREC["parity_steps"], dtype="fp32",
                    batch=[LCREC["parity_batch"], LCREC["parity_seq"]], tp1_losses=tp1,
                    tp2_losses=tp2, max_rel_diff=rel, rtol=LCREC_PARITY_RTOL,
                    tp1_s=parity_tp1_s),
        steps=steps, steps_rank1={k: r1["steps"][k] for k in
                                  ("step_ms_p50", "peak_memory_gb", "losses")},
        trainer=dict(trainer, rank1_valid=r1["trainer"]["valid"]), spawn_s=spawn_s,
    )


def build_all() -> dict:
    """Every kernel library, one nvcc per source, all started together."""
    from genrec_tpu_torch.kernels.build import LIBRARIES, NVCC_FLAGS, build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = dict(zip(LIBRARIES, pool.map(lambda n: build_library(n, verbose=True),
                                             LIBRARIES)))
    return dict(
        wall_s=time.perf_counter() - t0, flags=list(NVCC_FLAGS),
        libraries={n: dict(path=str(path.relative_to(HERE)), seconds=sec,
                           ptxas=[ln.strip() for ln in log.splitlines()
                                  if "Used" in ln or "spill" in ln])
                   for n, (path, sec, log) in built.items()},
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=384)
    ap.add_argument("--out", type=Path, help="also write every phase's JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="run more HSTU, RQ-VAE and LCRec train steps and serve the "
                         "traffic once more (fp32 and int8) under torch.profiler, and report "
                         "device time by kernel")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    import genrec_tpu_torch

    if Path(genrec_tpu_torch.__file__).resolve().parents[1] != HERE:
        print(f"chip_smoke: genrec_tpu_torch imported from {genrec_tpu_torch.__file__}, "
              f"not from the checkout beside this script", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    t_start = time.perf_counter()
    phases = {"env": emit(
        "env", nvidia_smi=smi, device=torch.cuda.get_device_name(dev),
        capability=list(torch.cuda.get_device_capability(dev)),
        device_count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
    )}
    phases["build"] = emit("build", **build_all())
    kernels = {"paged_attention_stats": kernel_phase(dev, args.seed),
               "paged_attention_stats_quantized": quantized_kernel_phase(dev, args.seed),
               "rq_cascade": rq_kernel_phase(dev, args.seed)}
    kernels.update(hstu_kernel_phase(dev, args.seed))
    kernels.update(ce_kernel_phase(dev, args.seed))
    kernels.update(ce_lcrec_kernel_phase(dev, args.seed))
    phases["kernel_phases"] = kernels
    phases["train"] = train_phase(dev, args.seed, args.profile)
    phases["parity"] = parity_phase(dev, args.seed)
    phases["rqvae"] = rqvae_phase(dev, args.seed, args.profile)
    phases["serve"], profiled, fp32_answers = serve_phase(dev, args.seed, args.requests,
                                                          args.profile)
    if profiled:
        phases["serve_profile"] = profiled
    phases["serve_int8"], profiled, _ = serve_phase(dev, args.seed, args.requests,
                                                    args.profile, kv_dtype="int8",
                                                    fp32_answers=fp32_answers)
    if profiled:
        phases["serve_int8_profile"] = profiled
    phases["lcrec_tp"] = lcrec_tp_phase(dev, args.seed, args.profile)
    kernels["sharded_fused_linear_ce"] = phases["lcrec_tp"]["b8"]
    phases["wall_s"] = time.perf_counter() - t_start

    launches = {"paged_attention_stats": phases["serve"]["paged_attention_launches"],
                "paged_attention_stats_quantized":
                    phases["serve_int8"]["paged_attention_launches"],
                "rq_cascade": phases["rqvae"]["export"]["rq_cascade_launches"],
                **{k: phases["train"]["launches"][k] for k in LAUNCHES_PER_STEP},
                **{k + "_lcrec": phases["lcrec_tp"]["steps"]["launches"][k]
                   for k in LCREC_LAUNCHES_PER_STEP},
                "sharded_fused_linear_ce": phases["lcrec_tp"]["steps"]["b8_calls"]}
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "replaces_function": function, "launches": launches[name],
        "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
        "plain_ms": kernels[name]["plain_ms"], "bound_ms": kernels[name]["bound_ms"],
        "bound_by": kernels[name]["bound_by"], "library_ms": kernels[name]["library_ms"],
    } for name, (source, replaces, function) in KERNELS.items()]}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({**phases, **line}, indent=1))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
