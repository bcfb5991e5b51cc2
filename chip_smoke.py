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
            its edge cases and at the shapes its main path gives it (B1 at
            the TIGER serving shapes; B3-B6 at the HSTU training shapes),
            then timed by device time (CUDA-graph replay of calls on
            inputs cold in L2): the kernel, the plain version, one PyTorch
            library call computing the same function where there is one (a
            yardstick only), and the least time the card could take (bytes
            over 3.35 TB/s, or operations over the data-sheet peak of the
            inputs' type: 67 TFLOP/s fp32, 989 TFLOP/s bf16);
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
6. serve    TIGER at the Amazon widths of config/tiger/amazon/tiger.gin,
            random weights from --seed, answering --requests requests through
            ServingEngine + TigerGenerativeHead; every answer must be a
            catalog item, and a sample must equal offline
            tiger_generate_paged on the card and on the CPU. With
            --profile the traffic is served once more under torch.profiler.

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
import json
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
}
LIBRARY_ATOL = 1e-4  # the library call normalises; checked, never used
# Scores are sums of 3 log-softmaxes of logits / 0.2. Across batch shapes
# and devices the full-width logits differ by ~1e-5 (GEMM blocking and
# summation order), which moves the scores by up to ~1e-4 (measured on the
# CPU); sem-ids must be equal.
SAMPLE_ATOL = 1e-3


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
    from genrec_tpu_torch.kernels import fused_ce, hstu_attention, paged_attention

    return {
        "paged_attention_stats": paged_attention.paged_attention_stats_cuda,
        "hstu_attention_fwd": hstu_attention.hstu_attention_fwd_cuda,
        "hstu_attention_bwd": hstu_attention.hstu_attention_bwd_cuda,
        "fused_linear_ce_fwd": fused_ce.fused_linear_ce_fwd_cuda,
        "fused_linear_ce_bwd_dx": fused_ce.fused_linear_ce_dx_cuda,
        "fused_linear_ce_bwd_dw": fused_ce.fused_linear_ce_dw_cuda,
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


# ---- phase 6: the serving slice --------------------------------------------


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


def offline_answer(model, head, trie, req, L):
    from genrec_tpu_torch.models.tiger import tiger_generate_paged

    user, ids, types, mask = (t.to(model.device) for t in head.make_batch([req], 1, L))
    out = tiger_generate_paged(model, trie, user, ids, types, mask,
                               n_top_k_candidates=BEAMS,
                               page_size=PAGED["page_size"])
    return out.sem_ids[0].cpu().numpy(), out.log_probas[0].cpu().numpy()


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


def serve_phase(dev, seed, n_requests, profile=False) -> tuple[dict, dict | None]:
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

    def engine():
        return ServingEngine([head], device=dev, ladder=ladder, max_batch=16,
                             max_wait_ms=2.0, paged_config=PagedConfig(**PAGED)).start()

    warm = engine()  # first calls: cuBLAS handles, allocator, kernel library
    serve(warm, make_requests(rng, 32, CATALOG_ITEMS))
    warm.stop()

    reqs = make_requests(rng, n_requests, CATALOG_ITEMS)
    eng = engine()
    reset_counters()
    responses, wall_s = serve(eng, reqs)
    launches = read_counters()["paged_attention_stats"]
    stats = eng.stop()
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

    # A sample against offline decoding: on the card (the same kernel, one
    # request per batch) and on the CPU (the plain version, CPU GEMMs).
    cpu_model = Tiger(**TIGER_AMAZON, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_trie = head.catalog.device_trie("cpu")
    sample = rng.choice(len(reqs), 12, replace=False)
    for i, j in enumerate(sample):
        req, resp = reqs[j], responses[j]
        refs = [("cuda", model, head.trie)] + ([("cpu", cpu_model, cpu_trie)] if i < 4 else [])
        for where, m, trie in refs:
            sem, logp = offline_answer(m, head, trie, req, resp.bucket[1])
            check((sem == resp.sem_ids).all(), (where, j, sem, resp.sem_ids))
            check(np.abs(logp - resp.scores).max() <= SAMPLE_ATOL, (where, j, logp, resp.scores))

    total_ms = np.asarray([r.total_s for r in responses]) * 1e3
    compute_ms = np.asarray([r.compute_s for r in responses]) * 1e3
    served = emit(
        "serve", card=torch.cuda.get_device_name(dev), requests=len(reqs),
        qps=len(reqs) / wall_s, wall_s=wall_s,
        p50_ms=float(np.percentile(total_ms, 50)),
        p99_ms=float(np.percentile(total_ms, 99)),
        compute_p50_ms=float(np.percentile(compute_ms, 50)),
        compute_p99_ms=float(np.percentile(compute_ms, 99)),
        decode_steps=steps,
        prefill_batches=stats["batches"], bucket_hits=stats["bucket_hits"],
        paged_attention_launches=launches,
        launches_per_decode_step=launches / steps,
        catalog_items=CATALOG_ITEMS, catalog_version=head.catalog_version,
        sample_checked=len(sample), sample_checked_on_cpu=4,
        pool_bytes=PagedConfig(**PAGED).hbm_bytes(
            decode_layers, TIGER_AMAZON["num_heads"],
            TIGER_AMAZON["attn_dim"] // TIGER_AMAZON["num_heads"]),
    )
    if not profile:
        return served, None
    # The same traffic again, a fresh request set, under the profiler.
    again = make_requests(rng, n_requests, CATALOG_ITEMS)
    eng = engine()
    prof = emit("profile", requests=n_requests,
                **device_profile(lambda: serve(eng, again)[1]))
    eng.stop()
    return served, prof


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
                    help="run more train steps and serve the traffic once more under "
                         "torch.profiler, and report device time by kernel")
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
    kernels = {"paged_attention_stats": kernel_phase(dev, args.seed)}
    kernels.update(hstu_kernel_phase(dev, args.seed))
    kernels.update(ce_kernel_phase(dev, args.seed))
    phases["kernel_phases"] = kernels
    phases["train"] = train_phase(dev, args.seed, args.profile)
    phases["parity"] = parity_phase(dev, args.seed)
    phases["serve"], profiled = serve_phase(dev, args.seed, args.requests, args.profile)
    if profiled:
        phases["serve_profile"] = profiled
    phases["wall_s"] = time.perf_counter() - t_start

    launches = {"paged_attention_stats": phases["serve"]["paged_attention_launches"],
                **{k: phases["train"]["launches"][k] for k in LAUNCHES_PER_STEP}}
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
