"""HSTU attention, port against the JAX package.

genrec_tpu_torch/kernels/hstu_attention.py pairs with
genrec_tpu/kernels/hstu_attention.py: the plain forward
(``hstu_attention_ref``) with ``hstu_attention_xla`` and with the Pallas
kernel run as the JAX package's own tests run it (interpret mode), the
plain backward (``hstu_attention_bwd_ref``) with the Pallas backward, and
the port's autograd function with ``jax.grad`` through the JAX
``custom_vjp``. The buckets of ops/buckets.py pair with their JAX
twins. Inputs come from a numpy seed and go to both sides.

Tolerance: 1e-5 absolute plus 1e-5 relative, fp32 on both sides (only
the summation order differs); the bias-table gradients are sums over
every visible pair of the batch and get 1e-4 relative. Buckets are
exact. The bf16 backward kernel's products, emulated here (dS and
silu(S) as bf16 hi + lo pairs times bf16 inputs, fp32 sums), are held
to the Pallas backward at 1e-4 of its largest element: the pair keeps
~16 bits of each factor, so each product is off by ~2^-17 of itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.kernels import hstu_attention as jk
from genrec_tpu.ops.buckets import hstu_log_bucket as jax_log_bucket
from genrec_tpu.ops.buckets import hstu_position_bucket as jax_position_bucket
from genrec_tpu_torch.kernels import hstu_attention as tk
from genrec_tpu_torch.ops.buckets import hstu_log_bucket, hstu_position_bucket

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
TABLE_TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(B=2, H=2, L=24, hd=16, use_time=True, use_seg=False, seed=0):
    """Numpy inputs: left padding on row 0, an all-pad row 1 when B > 2,
    and with ``use_seg`` packed rows (segments from slot 0, pad at the
    tail, as pack_examples lays them out)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)  # noqa: E731
    pad = np.zeros((B, L), bool)
    pad[0, :5] = True
    seg = None
    if use_seg:
        seg = np.zeros((B, L), np.int32)
        for b in range(B):
            at, s = 0, 1
            while at < L - 3:
                n = int(rng.integers(2, 9))
                seg[b, at:at + n] = s
                at, s = at + n, s + 1
        pad = seg == 0
    if B > 2:
        pad[1] = True
        if seg is not None:
            seg[1] = 0
    ts = (np.cumsum(rng.integers(3600, 200_000, size=(B, L)), axis=1)
          + 1_500_000_000).astype(np.int32) if use_time else None
    return dict(
        q=f(B, H, L, hd), k=f(B, H, L, hd), v=f(B, H, L, hd), timestamps=ts,
        padding_mask=pad, pos_table=(rng.normal(size=(H, 32)) * 0.1).astype(np.float32),
        time_table=(rng.normal(size=(H, 64)) * 0.1).astype(np.float32) if use_time else None,
        segment_ids=seg, g=f(B, H, L, hd),
    )


def _jax(x, *names):
    return [None if x[n] is None else jnp.asarray(x[n]) for n in names]


def _torch(x, *names):
    return [None if x[n] is None else torch.as_tensor(x[n]) for n in names]


ARGS = ("q", "k", "v", "timestamps", "padding_mask", "pos_table", "time_table")
_STATIC = ("max_position_distance", "blk_q", "interpret")
pallas_fwd = jax.jit(jk.hstu_attention_pallas, static_argnames=_STATIC)
pallas_bwd = jax.jit(jk.hstu_attention_bwd_pallas, static_argnames=_STATIC)
xla_fwd = jax.jit(jk.hstu_attention_xla, static_argnames=_STATIC[:1])

# (time, segments, B, L, hd, Pallas q block): odd L, several q blocks, an
# all-pad row (B = 3).
CASES = {
    "time": (True, False, 2, 24, 16, 128),
    "no_time": (False, False, 2, 24, 16, 128),
    "segments": (True, True, 3, 40, 16, 128),
    "odd_L": (True, False, 3, 37, 24, 128),
    "q_blocks": (True, True, 2, 70, 8, 32),
}


@pytest.mark.parametrize("case", CASES)
def test_forward_twin_matches_pallas_and_xla(case):
    use_time, use_seg, B, L, hd, blk_q = CASES[case]
    x = _inputs(B=B, L=L, hd=hd, use_time=use_time, use_seg=use_seg)
    got = tk.hstu_attention_ref(*_torch(x, *ARGS),
                                segment_ids=_torch(x, "segment_ids")[0]).numpy()
    (seg,) = _jax(x, "segment_ids")
    pallas = pallas_fwd(*_jax(x, *ARGS), blk_q=blk_q, interpret=True, segment_ids=seg)
    xla = xla_fwd(*_jax(x, *ARGS), segment_ids=seg)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)
    if B > 2:
        assert np.abs(got[1]).max() == 0.0  # the all-pad row


# bf16 forward cases: (time, segments, B, L, hd, Pallas q block): the
# trainer's packed, time-biased rows at L 50 and hd 32, and a case over
# several q blocks.
BF16_CASES = {
    "trainer": (True, True, 3, 50, 32, 128),
    "q_blocks": (True, True, 2, 70, 8, 32),
}
# One bf16 step of the output (2^-7 of it) plus 2e-3: the scores' sums run
# in another order, which can move silu(S) across a bf16 rounding edge and
# the output across its own.
BF16_TOL = dict(atol=2e-3, rtol=2.0**-7)


def _bf16_inputs(case, seed):
    use_time, use_seg, B, L, hd, blk_q = BF16_CASES[case]
    x = _inputs(B=B, L=L, hd=hd, use_time=use_time, use_seg=use_seg, seed=seed)
    bf = {n: torch.as_tensor(x[n]).to(torch.bfloat16) for n in ("q", "k", "v")}
    jx = {n: jnp.asarray(x[n]).astype(jnp.bfloat16) for n in ("q", "k", "v")}
    (seg,) = _jax(x, "segment_ids")
    pallas = pallas_fwd(jx["q"], jx["k"], jx["v"], *_jax(x, *ARGS[3:]), blk_q=blk_q,
                        interpret=True, segment_ids=seg)
    assert pallas.dtype == jnp.bfloat16
    return x, bf, np.asarray(pallas.astype(jnp.float32))


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_forward_twin_matches_pallas(case):
    """The contract of the bf16 tensor-core forward: fp32 scores of the
    bf16 inputs, silu(S) rounded once to bf16, fp32 sums of its products
    with v, the output in bf16; the plain version against the Pallas
    forward on the same bf16 inputs."""
    x, bf, want = _bf16_inputs(case, seed=7)
    got = tk.hstu_attention_ref(bf["q"], bf["k"], bf["v"], *_torch(x, *ARGS[3:]),
                                segment_ids=_torch(x, "segment_ids")[0])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    if x["q"].shape[0] > 2:
        assert float(got[1].float().abs().max()) == 0.0  # the all-pad row


def test_bf16_forward_rounds_silu_once_as_pallas():
    """silu(S) rounded once to bf16 before P.V (the tensor-core forward's
    one plane) gives the Pallas output's bits on nearly every element;
    keeping silu(S) in fp32, as a bf16 hi + lo pair would, is further off."""
    x, bf, want = _bf16_inputs("trainer", seed=8)
    q, k, v = (bf[n].float() for n in ("q", "k", "v"))
    ts, pad, ptab, ttab, seg = _torch(x, "timestamps", "padding_mask", "pos_table",
                                      "time_table", "segment_ids")
    s, _, _, _ = tk._masked_scores(q, k, ts, pad, ptab, ttab, 128, seg)
    attn = s * torch.sigmoid(s)
    once = (attn.to(torch.bfloat16).float() @ v).to(torch.bfloat16).float().numpy()
    fp32 = (attn @ v).to(torch.bfloat16).float().numpy()
    off_once = float(np.mean(once != want))
    off_fp32 = float(np.mean(fp32 != want))
    print(f"share of outputs off Pallas's bits: rounded once {off_once}, fp32 {off_fp32}")
    np.testing.assert_allclose(once, want, **BF16_TOL)
    assert off_once < 0.01
    assert off_fp32 > 2 * off_once


@pytest.mark.parametrize("case", ["time", "no_time", "segments", "q_blocks"])
def test_backward_twin_matches_pallas(case):
    use_time, use_seg, B, L, hd, blk_q = CASES[case]
    x = _inputs(B=B, L=L, hd=hd, use_time=use_time, use_seg=use_seg, seed=1)
    got = tk.hstu_attention_bwd_ref(*_torch(x, *ARGS, "g"),
                                    segment_ids=_torch(x, "segment_ids")[0])
    (seg,) = _jax(x, "segment_ids")
    want = pallas_bwd(*_jax(x, *ARGS, "g"), blk_q=blk_q, interpret=True, segment_ids=seg)
    for name, g, w in zip(("dq", "dk", "dv", "dpos", "dtime"), got, want):
        if w is None:
            assert g is None, name
            continue
        tol = TABLE_TOL if name in ("dpos", "dtime") else TOL
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **tol)


@pytest.mark.parametrize("case", ["time", "segments"])
def test_autograd_function_matches_jax_grad(case):
    """The port's autograd function on CPU tensors (plain versions) against
    jax.grad through the JAX custom_vjp (Pallas forward and backward)."""
    use_time, use_seg, B, L, hd, _ = CASES[case]
    x = _inputs(B=B, L=L, hd=hd, use_time=use_time, use_seg=use_seg, seed=2)
    diff = ("q", "k", "v", "pos_table", "time_table")

    def jax_loss(q, k, v, ptab, ttab):
        ts, pad, seg = _jax(x, "timestamps", "padding_mask", "segment_ids")
        out = jk.hstu_attention(q, k, v, ts, pad, ptab, ttab, seg, 128)
        return jnp.sum(out * jnp.asarray(x["g"]))

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4)))(*_jax(x, *diff))
    q, k, v, ptab, ttab = (t.requires_grad_() for t in _torch(x, *diff))
    ts, pad, seg = _torch(x, "timestamps", "padding_mask", "segment_ids")
    launches = (tk.hstu_attention_fwd_cuda.launches, tk.hstu_attention_bwd_cuda.launches)
    out = tk.hstu_attention(q, k, v, ts, pad, ptab, ttab, seg, 128)
    (out * torch.as_tensor(x["g"])).sum().backward()
    for name, t, w in zip(diff, (q, k, v, ptab, ttab), want):
        tol = TABLE_TOL if name.endswith("table") else TOL
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, **tol)
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert (tk.hstu_attention_fwd_cuda.launches,
            tk.hstu_attention_bwd_cuda.launches) == launches


def test_autograd_function_without_timestamps_gives_zero_time_table_grad():
    """As the JAX custom_vjp: a time table passed without timestamps takes
    no part and gets a zero gradient."""
    x = _inputs(use_time=True, seed=3)
    q, k, v, ptab, ttab = (t.requires_grad_() for t in _torch(
        x, "q", "k", "v", "pos_table", "time_table"))
    out = tk.hstu_attention(q, k, v, None, torch.as_tensor(x["padding_mask"]), ptab, ttab)
    out.sum().backward()
    assert ttab.grad is not None and float(ttab.grad.abs().max()) == 0.0
    assert float(ptab.grad.abs().max()) > 0.0


def _sweep():
    """Every |dt| within 300 of each time-bucket edge exp(0.693 n) and of
    each 2^k that int32 holds (int32 reaches bucket 31 of the 64), of
    both signs, plus 0..5000 and the int32 extremes."""
    edges = {int(np.exp(0.693 * n)) for n in range(32)} | {2**k for k in range(31)}
    dts = {e + d for e in edges for d in range(-300, 301)} | set(range(5001))
    dts = np.asarray(sorted(v for v in dts if 0 <= v < 2**31), np.int64)
    extremes = np.asarray([2**31 - 1, -(2**31 - 1), -(2**31)], np.int64)
    return np.concatenate([dts, -dts, extremes]).astype(np.int32)


def test_time_bucket_sweep_matches_jax():
    dt = _sweep()
    want = np.asarray(jax_log_bucket(jnp.asarray(dt), 64))
    got = hstu_log_bucket(torch.as_tensor(dt), 64).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.max() == 31  # the sweep reaches int32's top bucket


def test_time_bucket_edges_give_the_log_bucket_of_jax():
    """The bf16 backward kernel reads a time bucket as e + (|dt| >=
    edges[e + 1]), e = floor(log2 |dt|), the edges found on the port's
    plain bucket; on the sweep that equals the JAX package's bucket."""
    dt = _sweep()
    a = np.abs(dt)  # int32: |INT_MIN| wraps negative, as in the kernel
    edges = np.asarray(list(tk.time_bucket_edges()), np.int64)
    e = np.floor(np.log2(np.maximum(a, 1).astype(np.float64))).astype(np.int64)
    got = np.minimum(e + (a >= edges[e + 1]), 63)
    np.testing.assert_array_equal(got, np.asarray(jax_log_bucket(jnp.asarray(dt), 64)))


def test_time_bucket_of_wrapped_differences_matches_jax():
    """t_q - t_k wraps in int32 on both sides, as the kernels compute it."""
    rng = np.random.default_rng(4)
    t = rng.integers(-(2**31), 2**31, size=(4000, 2)).astype(np.int32)
    want = np.asarray(jax_log_bucket(jnp.asarray(t[:, 0]) - jnp.asarray(t[:, 1]), 64))
    tt = torch.as_tensor(t)
    np.testing.assert_array_equal(hstu_log_bucket(tt[:, 0] - tt[:, 1], 64).numpy(), want)


@pytest.mark.parametrize("nb,mpd", [(32, 128), (16, 64), (7, 40)])
def test_position_bucket_matches_jax(nb, mpd):
    rel = np.arange(-400, 401)[None, :] - np.arange(0, 3)[:, None]
    want = np.asarray(jax_position_bucket(jnp.asarray(rel, jnp.int32), nb, mpd))
    got = hstu_position_bucket(torch.as_tensor(rel), nb, mpd).numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On CPU tensors the CUDA wrappers raise before building anything; the
    autograd function is what routes CPU tensors to the plain versions."""
    x = _inputs(seed=5)
    args = _torch(x, *ARGS)
    g = torch.as_tensor(x["g"])
    before = (tk.hstu_attention_fwd_cuda.launches, tk.hstu_attention_bwd_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.hstu_attention_fwd_cuda(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk.hstu_attention_bwd_cuda(*args, g)
    assert (tk.hstu_attention_fwd_cuda.launches,
            tk.hstu_attention_bwd_cuda.launches) == before


def _bf16_planes(x, planes):
    """x as bf16 planes whose sum approximates it: the rounded value, then
    (with 2 planes) the rounded remainder."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()][:planes]


def _tc_products(x, planes):
    """dq, dk, dv as the bf16 backward kernel forms them: fp32 scores,
    silu(S) and dS as the plain backward computes them, then each split
    into ``planes`` bf16 planes, multiplied by the bf16 inputs (exact in
    fp32) and summed in fp32."""
    q, k, v, g, ts, pad, ptab, ttab, seg = _torch(
        x, "q", "k", "v", "g", "timestamps", "padding_mask", "pos_table", "time_table",
        "segment_ids")
    s, masked, _, _ = tk._masked_scores(q, k, ts, pad, ptab, ttab, 128, seg)
    sig = torch.sigmoid(s)
    attn = s * sig
    ds = torch.where(masked, 0.0, (g @ v.transpose(-1, -2)) * sig * (1.0 + s * (1.0 - sig)))
    dq = sum(p @ k for p in _bf16_planes(ds, planes))
    dk = sum(p.transpose(-1, -2) @ q for p in _bf16_planes(ds, planes))
    dv = sum(p.transpose(-1, -2) @ g for p in _bf16_planes(attn, planes))
    return dq, dk, dv


def test_bf16_kernel_products_with_hi_lo_planes_match_pallas():
    """The tensor-core backward's numerics on the CPU: with hi + lo planes
    its dq, dk and dv stay within 1e-4 of max |JAX| of the Pallas backward
    on the same bf16-exact inputs; one bf16 rounding of dS and silu(S) is
    further off."""
    x = _inputs(B=2, H=2, L=50, hd=32, use_time=True, use_seg=True, seed=6)
    for n in ("q", "k", "v", "g"):
        x[n] = torch.as_tensor(x[n]).to(torch.bfloat16).float().numpy()
    (seg,) = _jax(x, "segment_ids")
    want = pallas_bwd(*_jax(x, *ARGS, "g"), blk_q=128, interpret=True, segment_ids=seg)[:3]
    errs = {}
    for planes in (2, 1):
        for name, got, w in zip(("dq", "dk", "dv"), _tc_products(x, planes), want):
            w = np.asarray(w)
            errs[planes, name] = float(np.abs(got.numpy() - w).max() / np.abs(w).max())
    print("max |err| / max |JAX|, hi + lo:", {n: errs[2, n] for n in ("dq", "dk", "dv")},
          "one rounding:", {n: errs[1, n] for n in ("dq", "dk", "dv")})
    for name in ("dq", "dk", "dv"):
        assert errs[2, name] <= 1e-4, (name, errs[2, name])
        assert errs[1, name] > errs[2, name], (name, errs)
