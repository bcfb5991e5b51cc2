#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (genrec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--requests 384] [--out FILE] [--profile]

Needs a CUDA device, nvcc (PATH or /usr/local/cuda/bin) and the repo
checkout beside this script; it imports nothing of JAX. Phases, one JSON
line each; any failure ends the run with a traceback and a non-zero exit:

1. env     the card, its power limit (nvidia-smi), torch and CUDA versions;
2. build   nvcc builds every kernel of the port from genrec_tpu_torch/csrc/
           into build/, for sm_90a;
3. kernel  each kernel against its plain PyTorch version on the card, at the
           serving shapes and in its edge cases, then timed: the kernel, the
           plain version, one PyTorch library call computing the same
           function (a yardstick only), and the least time the card could
           take (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s,
           the H100 SXM data-sheet rates);
4. serve   TIGER at the Amazon widths of config/tiger/amazon/tiger.gin,
           random weights from --seed, answering --requests requests through
           ServingEngine + TigerGenerativeHead; the kernels' launch counters
           are set to 0 just before and read just after, every answer must
           be a catalog item, and a sample must equal offline
           tiger_generate_paged on the card and on the CPU. With
           --profile the traffic is served once more under torch.profiler
           (device time by kernel, the device's idle share).

Then the kernels line, the card's name and power limit as nvidia-smi prints
them, and, last, {"ok": true, "device": {...}}.

float32 throughout, with TF32 off for matrix products and convolutions, as
the JAX package's CPU reference computes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (NVIDIA): HBM bytes/s and float32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
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


def cuda_time_ms(fn, arg_sets, rounds: int) -> float:
    """Mean device time of one ``fn(**args)``, cycling through
    ``arg_sets`` (copies whose bytes together exceed the L2 cache, so each
    call finds its inputs in device memory, as a decode step does)."""
    for args in arg_sets:  # warm-up: allocator, library handles
        fn(**args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        for args in arg_sets:
            fn(**args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * len(arg_sets))


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
    ms = cuda_time_ms(paged_attention_stats_cuda, copies, rounds=20)
    plain_ms = cuda_time_ms(paged_attention_stats_ref, copies, rounds=5)
    library_ms = cuda_time_ms(library_paged_attention, lib, rounds=20)
    ms_again = cuda_time_ms(paged_attention_stats_cuda, copies, rounds=20)
    clocks = nvidia_smi_line("clocks.sm,clocks.mem,power.draw,temperature.gpu")
    bound_ms, bound_by, work = paged_attention_bound(base)
    walked = S * Pm * page * H * hd * 2 * 4
    return emit(
        "kernel", name="paged_attention_stats",
        shape=dict(S=S, K=K, H=H, hd=hd, page=page, Pm=Pm),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        tolerance=dict(rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
        ms=ms, ms_repeat=ms_again, plain_ms=plain_ms, library_ms=library_ms,
        library="torch.nn.functional.scaled_dot_product_attention on pre-gathered K/V",
        bound_ms=bound_ms, bound_by=bound_by, work=work,
        kv_bytes_walked=walked, walked_bound_ms=1e3 * walked / HBM_BYTES_PER_S,
        cold_copies=n_copies, clocks_after_timing=clocks,
    )


# ---- phase 4: the serving slice --------------------------------------------


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
    from genrec_tpu_torch.kernels.paged_attention import paged_attention_stats_cuda
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
    paged_attention_stats_cuda.launches = 0
    responses, wall_s = serve(eng, reqs)
    launches = paged_attention_stats_cuda.launches
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=384)
    ap.add_argument("--out", type=Path, help="also write every phase's JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="serve the traffic once more under torch.profiler and "
                         "report device time by kernel")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    import genrec_tpu_torch
    from genrec_tpu_torch.kernels import paged_attention as pa

    if Path(genrec_tpu_torch.__file__).resolve().parents[1] != HERE:
        print(f"chip_smoke: genrec_tpu_torch imported from {genrec_tpu_torch.__file__}, "
              f"not from the checkout beside this script", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    phases = {"env": emit(
        "env", nvidia_smi=smi, device=torch.cuda.get_device_name(dev),
        capability=list(torch.cuda.get_device_capability(dev)),
        device_count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
    )}
    path, seconds, log = pa.build_library(verbose=True)
    phases["build"] = emit("build", library=str(path.relative_to(HERE)),
                           seconds=seconds, flags=list(pa.NVCC_FLAGS),
                           ptxas=[ln for ln in log.splitlines() if "ptxas info" in ln])
    phases["kernel"] = kernel_phase(dev, args.seed)
    phases["serve"], profiled = serve_phase(dev, args.seed, args.requests, args.profile)
    if profiled:
        phases["profile"] = profiled

    k = phases["kernel"]
    kernels = {"kernels": [{
        "name": "paged_attention_stats",
        "route": "cuda",
        "source": "genrec_tpu_torch/csrc/paged_attention.cu",
        "replaces": "genrec_tpu/kernels/paged_attention.py:182",
        "replaces_function": "paged_attention_stats_pallas",
        "launches": phases["serve"]["paged_attention_launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    }]}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({**phases, **kernels}, indent=1))
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
