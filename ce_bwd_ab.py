#!/usr/bin/env python3
"""A/B of design variants of the fused CE kernels (B3, B4) on one NVIDIA card.

    python3 ce_bwd_ab.py [--mode bwd|fwd|fp32] [--reps 3] [--out FILE]

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

Inputs are seeded, warm in L2 between calls (unlike chip_smoke.py's
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
_FWD = ["source", "fwd_cols_128", "fwd_splits_8", "fwd_splits_32", "fwd_splits_fast",
        "fwd_splits_32_fast", "fwd_expf", "fwd_ex2_approx", "source"]
AT = {"bwd": {"shard": ["source", "chunk_32mb", "chunk_128mb", "coeff_128x128",
                        "no_coeff_stores", "source"],
              "hstu": ["source", "chunked_at_d64", "source"]},
      "fwd": {"shard": _FWD, "hstu": _FWD},
      "fp32": {"fp32_shard": ["source", "fp32_one_chain", "source"]}}
FP32_WIDE = (33, 700, 2048)
# The kernels each mode reports ptxas numbers of: a fragment of the name.
PTXAS_OF = {"bwd": ("ce_tc_kernel", "ce_fused_kernel"), "fwd": ("ce_fwd",),
            "fp32": ("ce_fwd_kernel", "ce_lse", "wide")}


def build(name: str, replace) -> tuple[Path, str]:
    """The variant's library and what ptxas printed."""
    from genrec_tpu_torch.kernels import build as kb

    out = HERE / "build" / "ce_bwd_ab" / name
    out.mkdir(parents=True, exist_ok=True)
    src = (kb.CSRC / "fused_ce.cu").read_text()
    for old, new in ([replace] if isinstance(replace, tuple) else replace or []):
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the line to replace is not in fused_ce.cu once: {old}")
        src = src.replace(old, new)
    (out / "fused_ce.cu").write_text(src)
    for header in kb.included_headers(kb.CSRC / "fused_ce.cu"):
        (out / header.name).write_text(header.read_text())
    lib = out / "libfused_ce.so"
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                           str(out / "fused_ce.cu")], capture_output=True, text=True)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=tuple(AT), default="bwd")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ce_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import ptxas_by_kernel

    dev = torch.device("cuda", 0)
    at = AT[args.mode]
    kernels = {"fwd": ("fwd",), "bwd": ("dx", "dw"), "fp32": ("fwd", "dx", "dw")}[args.mode]
    names = list(dict.fromkeys(n for cell in at.values() for n in cell))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build(n, VARIANTS[n]), names)))
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
    if args.mode == "fp32":
        for seed in range(4):
            a = inputs(dev, *FP32_WIDE, seed, torch.float32, w_std=0.1, g_normal=True)
            for name in names:
                add(phase="fp64", shape=dict(zip("RVd", FP32_WIDE)), seed=seed, variant=name,
                    rel_err_of_max=fp64_errors(libs[name], a))
    for cell in at:
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
