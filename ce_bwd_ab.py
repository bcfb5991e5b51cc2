#!/usr/bin/env python3
"""A/B of design variants of the bf16 CE backward (B4) on one NVIDIA card.

    python3 ce_bwd_ab.py [--reps 3] [--out FILE]

Builds genrec_tpu_torch/csrc/fused_ce.cu as it is and in variants made
by replacing a line or two of it (each a copy under build/ce_bwd_ab/, one nvcc
each, all started together), holds every variant but `no_coeff_stores`
to the plain versions at bf16 tolerance, then times dx and dW by CUDA
events over `--reps` calls, variants in turns (the source first and
last), with device time by kernel from torch.profiler:

- at an LCRec shard (R 4,088, V 76,608, d 1,536): the source; vocab
  chunks of 32 and 128 MB instead of 64; the coeff kernel on 128 x 128
  tiles instead of 128 x 256; the coeff kernel without its stores
  (timing only: what the stores cost);
- at the HSTU shape (R 6,400, V 12,102, d 64): the fused kernels against
  the chunked path.

Inputs are seeded, warm in L2 between calls (unlike chip_smoke.py's
cold copies). Prints one JSON line per measurement, then the card's
name and power limit. Imports nothing of JAX.
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
SHARD = (4088, 76608, 1536)
HSTU = (6400, 12102, 64)
BF16_TOL = 1e-2  # of max |plain|, as chip_smoke.py

# name -> (the line of fused_ce.cu replaced, its replacement), or None
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
}
TIMING_ONLY = {"no_coeff_stores"}
AT = {"shard": ["source", "chunk_32mb", "chunk_128mb", "coeff_128x128", "no_coeff_stores",
                "source"],
      "hstu": ["source", "chunked_at_d64", "source"]}


def build(name: str, replace) -> Path:
    from genrec_tpu_torch.kernels import build as kb

    out = HERE / "build" / "ce_bwd_ab" / name
    out.mkdir(parents=True, exist_ok=True)
    src = (kb.CSRC / "fused_ce.cu").read_text()
    if replace is not None:
        old, new = replace
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the line to replace is not in fused_ce.cu once: {old}")
        src = src.replace(old, new)
    (out / "fused_ce.cu").write_text(src)
    for header in kb.included_headers(kb.CSRC / "fused_ce.cu"):
        (out / header.name).write_text(header.read_text())
    lib = out / "libfused_ce.so"
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(lib), str(out / "fused_ce.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    return lib


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_ce_workspace.argtypes = [i32] * 5
    lib.fused_ce_workspace.restype = ctypes.c_longlong
    for fn in (lib.fused_ce_dx, lib.fused_ce_dw):
        fn.argtypes = [ptr] * 7 + [i32] * 6 + [ptr, i32]
        fn.restype = i32
    return lib


def inputs(dev, R, V, d, seed):
    """x ~ N(0, 1), w ~ N(0, 0.02), 20% of rows at the ignored id 0, the
    mean loss's g; lse from the plain forward."""
    from genrec_tpu_torch.kernels.fused_ce import fused_linear_ce_ref

    rng = np.random.default_rng(seed)
    t = rng.integers(0, V, R).astype(np.int32)
    t[rng.random(R) < 0.2] = 0
    x = torch.as_tensor(rng.normal(size=(R, d)).astype(np.float32), device=dev).bfloat16()
    w = torch.as_tensor((rng.normal(size=(V, d)) * 0.02).astype(np.float32), device=dev)
    w = w.bfloat16()
    targets = torch.as_tensor(t, device=dev)
    g = torch.full((R,), 1.0 / R, device=dev)
    return dict(x=x, w=w, targets=targets, g=g, lse=fused_linear_ce_ref(x, w, targets)[1])


def call(lib, which, a, ws=None):
    R, d = a["x"].shape
    V = a["w"].shape[0]
    if ws is None:
        n = lib.fused_ce_workspace(1 if which == "dx" else 2, R, V, d, 1)
        ws = torch.empty((max(n, 1),), dtype=torch.float32, device=a["x"].device)
    out = torch.empty_like(a["x"] if which == "dx" else a["w"])
    rc = getattr(lib, f"fused_ce_{which}")(
        a["x"].data_ptr(), a["w"].data_ptr(), a["targets"].data_ptr(), a["lse"].data_ptr(),
        a["g"].data_ptr(), out.data_ptr(), ws.data_ptr(), R, V, d, 0, V, 1,
        torch.cuda.current_stream().cuda_stream, a["x"].device.index)
    if rc != 0:
        raise RuntimeError(f"fused_ce_{which} failed: {rc}")
    return out, ws


def check(lib, which, a) -> float:
    from genrec_tpu_torch.kernels import fused_ce as fc

    got, _ = call(lib, which, a)
    plain = (fc.fused_linear_ce_dx_ref if which == "dx" else fc.fused_linear_ce_dw_ref)(
        a["x"], a["w"], a["targets"], a["lse"], a["g"])
    scale = float(plain.float().abs().max())
    err = float((got.float() - plain.float()).abs().max())
    if not err <= BF16_TOL * scale:
        raise RuntimeError(f"{which}: max abs err {err} > {BF16_TOL} x {scale}")
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
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ce_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    libs = {name: load(path) for name, path in paths.items()}
    lines = [dict(phase="build", seconds=time.perf_counter() - t0)]
    for cell, (R, V, d) in (("shard", SHARD), ("hstu", HSTU)):
        a = inputs(dev, R, V, d, seed=0)
        for name in dict.fromkeys(AT[cell]):
            if name not in TIMING_ONLY:
                errs = {w: check(libs[name], w, a) for w in ("dx", "dw")}
                lines.append(dict(phase="check", cell=cell, variant=name, max_abs_err=errs))
        for turn, name in enumerate(AT[cell]):
            for which in ("dx", "dw"):
                lines.append(dict(phase="time", cell=cell, shape=dict(R=R, V=V, d=d),
                                  variant=name, turn=turn, which=which,
                                  **timed(libs[name], which, a, args.reps)))
        del a
        torch.cuda.empty_cache()
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
