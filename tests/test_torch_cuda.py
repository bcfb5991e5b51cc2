"""The hand-written CUDA kernels on the card, held to their plain versions.

Needs an NVIDIA card of compute capability 9.0 (the kernels are built for
sm_90a) and the CUDA toolkit's nvcc; every test here is marked ``cuda``
and skips without them. This file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the
suite.) Tolerance for float32 inputs: rtol 1e-5, atol 1e-5. Kernel and
plain version both sum in fp32 and differ only in order (the paged kernel
runs an online softmax over 64-position stages, the plain version one max
and one sum). The HSTU bias-table gradients sum every visible pair of the
batch, so they get rtol 1e-4. With bfloat16 inputs both sides accumulate
in fp32 and round the result to bfloat16, where another order can move
the rounding by one bfloat16 step: rtol and atol 1e-2 (the bf16 HSTU
backward multiplies dS and silu(S) as bf16 hi + lo pairs on the tensor
cores, ~16 bits of each, so the same holds; the bf16 HSTU forward rounds
silu(S) once to bf16, as its plain version does, and is also held within
1e-2 of max |plain|). The int8 paged
kernel dequantises with the same product as its plain version, so it
too is held at 1e-5, and so are B1 over bf16 pages and B2 with a bf16 q:
bf16 mma.sync whose products are exact in fp32, the weights in three bf16
planes that carry all their bits (tests/test_torch_paged_bf16_mma.py). The residual cascade's ids are held exactly outside
near ties (rows whose two nearest codewords are within 1e-5 x max |dist|,
where another summation order may pick the other one), and at most 2%
of the rows may be near ties; qsum 1e-5 of its largest element. The
vocab-sharded CE (B8) runs on 2 ranks sharing the card over gloo and is
held to its plain twin at 1e-5. The fused CE's loss and lse are fp32
sums of exact bf16 products in either dtype: 1e-5, and two calls give
equal bits. The fp32 CE at d = 2,048 with unscaled inputs is also held,
with its plain version, to an fp64 evaluation of the same formulas.
"""

import numpy as np
import pytest
import torch

from genrec_tpu_torch.kernels import fused_ce as fc
from genrec_tpu_torch.kernels import hstu_attention as ha
from genrec_tpu_torch.kernels import paged_attention as pa
from genrec_tpu_torch.kernels import rq_cascade as rq
from genrec_tpu_torch.kernels.paged_attention import (
    paged_attention_stats_cuda,
    paged_attention_stats_quantized_cuda,
    paged_attention_stats_quantized_ref,
    paged_attention_stats_ref,
)
from genrec_tpu_torch.ops.quant import QuantizedKVPool, quantize_symmetric
from genrec_tpu_torch.parallel.mesh import spawn

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _inputs(dev, S, K, H, hd, page, Pm, seq_lens, null_tail=False, seed=0):
    rng = np.random.default_rng(seed)
    P = 1 + S * Pm
    bt = (1 + np.arange(S * Pm)).reshape(S, Pm).astype(np.int32)
    if null_tail:  # unused entries point at the null page, as the pool pads
        used = -(-np.maximum(np.asarray(seq_lens), 1) // page)
        bt[np.arange(Pm)[None, :] >= used[:, None]] = 0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return dict(
        q=t(rng.normal(size=(S, K, H, hd)).astype(np.float32)),
        k_pool=t(rng.normal(size=(P, page, H, hd)).astype(np.float32)),
        v_pool=t(rng.normal(size=(P, page, H, hd)).astype(np.float32)),
        block_tables=t(bt),
        seq_lens=t(np.asarray(seq_lens, np.int32)),
    )


@pytest.mark.parametrize("shape,lens,null_tail", [
    # TIGER Amazon serving shapes: 64 slots, 10 beams, 6 heads of 64, 4 pages of 16.
    ((64, 10, 6, 64, 16, 4), "random", False),
    ((64, 10, 6, 64, 16, 4), "random", True),
    ((5, 3, 2, 8, 8, 3), [24, 0, 9, 1, 17], True),  # a fully masked slot
    ((3, 32, 1, 128, 40, 2), [80, 41, 0], False),  # a full block of 32 beams, hd at its limit
])
def test_kernel_matches_plain_version(card, shape, lens, null_tail):
    S, K, H, hd, page, Pm = shape
    if lens == "random":
        lens = np.random.default_rng(1).integers(4, Pm * page + 1, S)
    x = _inputs(card, S, K, H, hd, page, Pm, lens, null_tail)
    before = paged_attention_stats_cuda.launches
    got = paged_attention_stats_cuda(**x)
    torch.cuda.synchronize()
    assert paged_attention_stats_cuda.launches == before + 1
    want = paged_attention_stats_ref(**x)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


def test_kernel_wrapper_refuses_what_it_does_not_take(card):
    x = _inputs(card, 2, 3, 2, 8, 8, 2, [5, 9])
    before = paged_attention_stats_cuda.launches
    bad = [
        dict(x, q=x["q"].double()),
        dict(x, block_tables=x["block_tables"].long()),
        dict(x, k_pool=x["k_pool"].transpose(0, 1).contiguous().transpose(0, 1)),
        dict(x, k_pool=x["k_pool"].cpu()),
        dict(x, q=torch.zeros((2, 0, 2, 8), device=card)),  # K = 0
    ]
    for kwargs in bad:
        with pytest.raises(ValueError):
            paged_attention_stats_cuda(**kwargs)
    wide = _inputs(card, 2, 3, 2, 129, 8, 2, [5, 9])  # hd > 128
    with pytest.raises(ValueError):
        paged_attention_stats_cuda(**wide)
    assert paged_attention_stats_cuda.launches == before


def _hstu_inputs(dev, B, H, L, hd, dtype, use_time, use_seg, seed=0, seg_edge=None):
    """Left padding on row 0 and an all-pad last row; with ``use_seg``
    packed rows of 2-11 tokens, one segment ending at ``seg_edge`` where
    given."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    f = lambda *s: t((rng.normal(size=s) * 0.5).astype(np.float32)).to(dtype)  # noqa: E731
    pad = np.zeros((B, L), bool)
    pad[0, :5] = True
    pad[-1] = True  # an all-pad row
    seg = None
    if use_seg:
        seg = np.zeros((B, L), np.int32)
        for b in range(B - 1):
            at, s = 0, 1
            while at < L - 3:
                n = int(rng.integers(2, 12))
                if seg_edge is not None and at < seg_edge < at + n:
                    n = seg_edge - at
                seg[b, at:at + n] = s
                at, s = at + n, s + 1
        pad = seg == 0
    ts = (np.cumsum(rng.integers(3600, 200_000, size=(B, L)), axis=1)
          + 1_500_000_000).astype(np.int32)
    return dict(
        q=f(B, H, L, hd), k=f(B, H, L, hd), v=f(B, H, L, hd),
        timestamps=t(ts) if use_time else None, padding_mask=t(pad),
        pos_table=t((rng.normal(size=(H, 32)) * 0.1).astype(np.float32)),
        time_table=t((rng.normal(size=(H, 64)) * 0.1).astype(np.float32)) if use_time else None,
        segment_ids=t(seg) if use_seg else None, g=f(B, H, L, hd),
    )


def _tol(dtype):
    return dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,use_time,use_seg,seg_edge", [
    ((4, 2, 50, 32), True, True, None),    # the trainer's layout: packed, timestamps
    ((4, 2, 50, 32), False, False, None),  # no timestamps, left padding
    ((3, 1, 77, 24), True, False, None),   # odd L over three 32-position tiles
    ((2, 2, 40, 128), True, True, None),   # hd at its limit
    ((3, 2, 64, 32), True, True, None),    # one full 64-position tile (bf16 backward)
    ((3, 1, 65, 32), True, False, None),   # one position past it
    ((3, 1, 128, 32), True, True, 64),     # two tiles, a segment ending on their edge
    ((2, 1, 200, 32), True, True, None),   # four tiles, the last ragged
    ((3, 2, 50, 16), True, True, None),    # hd 16
    ((2, 1, 30, 12), False, True, None),   # hd not a multiple of 8: no 16-byte copies
    ((2, 1, 30, 13), True, True, None),    # odd hd: no paired stores either
])
def test_hstu_kernels_match_plain_versions(card, shape, use_time, use_seg, seg_edge, dtype):
    x = _hstu_inputs(card, *shape, dtype, use_time, use_seg, seg_edge=seg_edge)
    fwd = {k: v for k, v in x.items() if k != "g"}
    launches = (ha.hstu_attention_fwd_cuda.launches, ha.hstu_attention_bwd_cuda.launches)
    got = ha.hstu_attention_fwd_cuda(**fwd)
    got_b = ha.hstu_attention_bwd_cuda(**x)
    torch.cuda.synchronize()
    assert (ha.hstu_attention_fwd_cuda.launches,
            ha.hstu_attention_bwd_cuda.launches) == (launches[0] + 1, launches[1] + 1)
    assert got.dtype == dtype and float(got[-1].float().abs().max()) == 0.0
    want = ha.hstu_attention_ref(**fwd)
    torch.testing.assert_close(got, want, **_tol(dtype))
    if dtype == torch.bfloat16:  # and within 1e-2 of max |plain| everywhere
        err = float((got.float() - want.float()).abs().max())
        assert err <= 1e-2 * float(want.float().abs().max()), err
    for name, g, w in zip(("dq", "dk", "dv", "dpos", "dtime"), got_b,
                          ha.hstu_attention_bwd_ref(**x)):
        if w is None:
            assert g is None and not use_time
            continue
        tol = dict(rtol=1e-4, atol=1e-4) if name.startswith(("dpos", "dtime")) else _tol(dtype)
        torch.testing.assert_close(g, w, msg=name, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_hstu_backward_gives_equal_bits_over_two_calls(card, dtype):
    x = _hstu_inputs(card, 128, 2, 50, 32, dtype, True, True, seed=3)
    a, b = ha.hstu_attention_bwd_cuda(**x), ha.hstu_attention_bwd_cuda(**x)
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_hstu_forward_gives_equal_bits_over_two_calls(card, dtype):
    x = _hstu_inputs(card, 128, 2, 50, 32, dtype, True, True, seed=3)
    fwd = {k: v for k, v in x.items() if k != "g"}
    a, b = ha.hstu_attention_fwd_cuda(**fwd), ha.hstu_attention_fwd_cuda(**fwd)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _time_sweep_dts():
    """Every |dt| within 300 of each time-bucket edge exp(0.693 n) and of
    each 2^k, 0..70000, of both signs, and int32's extremes."""
    edges = {int(np.exp(0.693 * n)) for n in range(32)} | {2**k for k in range(31)}
    dts = sorted({e + d for e in edges for d in range(-300, 301) if 0 <= e + d < 2**31}
                 | set(range(70000)))
    return dts + [-v for v in dts] + [2**31 - 1, -(2**31)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_hstu_backward_time_buckets_match_the_cpu(card, dtype):
    """The backward kernel's time buckets: each dt is a row of two
    positions, t = (0, dt), key 1 padded and g_0 = 0, so the one pair that
    carries a gradient is (1, 0), and its row's dtime partials are
    nonzero in its bucket only."""
    from genrec_tpu_torch.ops.buckets import hstu_log_bucket

    dt = torch.tensor(_time_sweep_dts(), dtype=torch.int32)
    B, hd = len(dt), 8
    zeros = torch.zeros((B, 1, 2, hd), device=card, dtype=dtype)
    v, g = zeros.clone(), zeros.clone()
    v[:, :, 0, 0] = 1.0
    g[:, :, 1, 0] = 1.0
    pad = torch.zeros((B, 2), dtype=torch.bool, device=card)
    pad[:, 1] = True
    _, _, _, _, dtt = ha.hstu_attention_bwd_partials_cuda(
        zeros, zeros.clone(), v, torch.stack([torch.zeros_like(dt), dt], 1).to(card), pad,
        torch.zeros((1, 32), device=card), torch.ones((1, 64), device=card), g)
    torch.cuda.synchronize()
    assert int((dtt != 0).sum(1).ne(1).sum()) == 0
    got = dtt.abs().argmax(1).cpu()
    assert int((got != hstu_log_bucket(dt, 64).long()).sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_hstu_forward_time_buckets_match_the_cpu(card, dtype):
    """The forward kernel's time buckets: each dt is a row of two
    positions, t = (0, dt), q = k = 0, v_0 = (1, 0, ...), no position bias
    and time_table[n] = n, so the output of position 1 is silu(n) of its
    bucket n, rounded to the dtype."""
    from genrec_tpu_torch.ops.buckets import hstu_log_bucket

    dt = torch.tensor(_time_sweep_dts(), dtype=torch.int32)
    B, hd = len(dt), 8
    zeros = torch.zeros((B, 1, 2, hd), device=card, dtype=dtype)
    v = zeros.clone()
    v[:, :, 0, 0] = 1.0
    table = torch.arange(64, dtype=torch.float32, device=card)[None]
    out = ha.hstu_attention_fwd_cuda(
        zeros, zeros.clone(), v, torch.stack([torch.zeros_like(dt), dt], 1).to(card),
        torch.zeros((B, 2), dtype=torch.bool, device=card), torch.zeros((1, 32), device=card),
        table)
    silu = (table * torch.sigmoid(table)).to(dtype).float()
    got = (out[:, 0, 1, 0].float()[:, None] - silu).abs().argmin(1).cpu()
    assert int((got != hstu_log_bucket(dt, 64).long()).sum()) == 0


def test_hstu_log_bucket_on_the_card_matches_the_cpu(card):
    """The plain time bucket on a CUDA tensor gives the CPU's buckets on the
    sweep (it takes its log in float64: CUDA's float32 log is one ulp off
    on some |dt| next to a bucket edge)."""
    from genrec_tpu_torch.ops.buckets import hstu_log_bucket

    dt = torch.tensor(_time_sweep_dts(), dtype=torch.int32)
    got = hstu_log_bucket(dt.to(card), 64).cpu()
    assert int((got != hstu_log_bucket(dt, 64)).sum()) == 0


def test_hstu_autograd_function_on_the_card_matches_the_cpu(card):
    """The autograd function launches one forward and one backward kernel
    and gives the gradients its plain versions give on the CPU."""
    x = _hstu_inputs(card, 3, 2, 50, 32, torch.float32, True, True, seed=1)
    names = ("q", "k", "v", "pos_table", "time_table")
    grads = {}
    for where in ("cuda", "cpu"):
        leaves = {n: x[n].detach().to(where).requires_grad_() for n in names}
        out = ha.hstu_attention(leaves["q"], leaves["k"], leaves["v"],
                                x["timestamps"].to(where), x["padding_mask"].to(where),
                                leaves["pos_table"], leaves["time_table"],
                                x["segment_ids"].to(where))
        before = ha.hstu_attention_bwd_cuda.launches
        (out * x["g"].to(where)).sum().backward()
        assert ha.hstu_attention_bwd_cuda.launches == before + (where == "cuda")
        grads[where] = {n: leaves[n].grad.cpu() for n in names}
    for n in names:
        torch.testing.assert_close(grads["cuda"][n], grads["cpu"][n], rtol=1e-4, atol=1e-4,
                                   msg=n)


def test_hstu_wrappers_refuse_what_they_do_not_take(card):
    x = _hstu_inputs(card, 2, 2, 16, 8, torch.float32, True, False)
    fwd = {k: v for k, v in x.items() if k != "g"}
    before = ha.hstu_attention_fwd_cuda.launches
    for bad in (dict(fwd, q=fwd["q"].double()), dict(fwd, k=fwd["k"].to(torch.bfloat16)),
                dict(fwd, timestamps=fwd["timestamps"].long()),
                dict(fwd, padding_mask=fwd["padding_mask"].int()),
                dict(fwd, v=fwd["v"].transpose(2, 3).contiguous().transpose(2, 3)),
                dict(fwd, q=torch.zeros((2, 2, 16, 129), device=card))):
        with pytest.raises(ValueError):
            ha.hstu_attention_fwd_cuda(**bad)
    assert ha.hstu_attention_fwd_cuda.launches == before


def _ce_inputs(dev, R, V, d, dtype, all_ignored=False, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    tgt = rng.integers(0, V, R).astype(np.int32)
    tgt[rng.random(R) < 0.2] = 0
    if all_ignored:
        tgt[:] = 0
    return dict(x=t(rng.normal(size=(R, d)).astype(np.float32)).to(dtype),
                w=t((rng.normal(size=(V, d)) * 0.1).astype(np.float32)).to(dtype),
                targets=t(tgt), g=t(rng.normal(size=R).astype(np.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,all_ignored", [
    ((6400, 12102, 64), False),  # the trainer's shapes: V a multiple of neither tile
    ((37, 700, 48), False),      # ragged rows
    ((64, 300, 16), True),       # every row ignored
    ((5, 70, 64), False),        # smaller than one tile of either forward
    ((33, 65, 128), False),      # d at the fp32 narrow kernels' limit
    # bf16 backward: R a multiple of neither 64 nor 128, V over several vocab
    # chunks, the LCRec hidden size
    ((4100, 9000, 1536), False),
    ((130, 1100, 1536), False),   # 2 rows in the last row tile, 76 columns in the last
    ((300, 2000, 37), False),     # d not a multiple of 8: padded for TMA
    ((33, 700, 2048), False),     # d at its limit
    ((300, 5000, 1536), True),    # every row ignored, d wide
])
def test_fused_ce_kernels_match_plain_versions(card, shape, all_ignored, dtype):
    x = _ce_inputs(card, *shape, dtype, all_ignored)
    d = shape[2]
    if d > 128:  # logits of std ~0.8 at every d, as at d = 64 (and in the vlim test)
        x["x"] = (x["x"].float() * (64 / d) ** 0.5).to(dtype)
    fwd = dict(x=x["x"], w=x["w"], targets=x["targets"])
    loss, lse = fc.fused_linear_ce_fwd_cuda(**fwd)
    want_loss, want_lse = fc.fused_linear_ce_ref(**fwd)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    loss2, lse2 = fc.fused_linear_ce_fwd_cuda(**fwd)
    assert torch.equal(loss2, loss) and torch.equal(lse2, lse)  # splits merged in order
    bwd = dict(fwd, lse=want_lse, g=x["g"])
    counts = (fc.fused_linear_ce_dx_cuda.launches, fc.fused_linear_ce_dw_cuda.launches)
    dx, dw = fc.fused_linear_ce_dx_cuda(**bwd), fc.fused_linear_ce_dw_cuda(**bwd)
    torch.cuda.synchronize()
    assert (fc.fused_linear_ce_dx_cuda.launches,
            fc.fused_linear_ce_dw_cuda.launches) == (counts[0] + 1, counts[1] + 1)
    want_dx, want_dw = fc.fused_linear_ce_bwd_ref(**bwd)
    assert dx.dtype == dtype and dw.dtype == dtype
    assert dx.shape == x["x"].shape and dw.shape == x["w"].shape
    torch.testing.assert_close(dx, want_dx, **_tol(dtype))
    torch.testing.assert_close(dw, want_dw, **_tol(dtype))
    if all_ignored:
        assert float(loss.abs().max()) == float(dx.abs().max()) == float(dw.abs().max()) == 0
    # Every sum has one fixed order: a second call gives the same bits.
    assert torch.equal(fc.fused_linear_ce_dx_cuda(**bwd), dx)
    assert torch.equal(fc.fused_linear_ce_dw_cuda(**bwd), dw)


@pytest.mark.parametrize("d", [64, 1536])
@pytest.mark.parametrize("outside", [-1, -100])
def test_fused_ce_bf16_targets_outside_the_vocab(card, d, outside):
    """bf16, ignore_index=-100: targets of -100 are ignored rows (loss 0),
    targets of -1 have target logit 0 (loss = lse), as the plain versions
    and the Pallas sum-select give."""
    x = _ce_inputs(card, 300, 2000, d, torch.bfloat16, seed=3)
    x["x"] = (x["x"].float() * min(1.0, (64 / d) ** 0.5)).to(torch.bfloat16)
    t = x["targets"].clone()
    t[::3] = outside
    fwd = dict(x=x["x"], w=x["w"], targets=t, ignore_index=-100)
    loss, lse = fc.fused_linear_ce_fwd_cuda(**fwd)
    want_loss, want_lse = fc.fused_linear_ce_ref(**fwd)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    if outside == -100:
        assert float(loss[::3].abs().max()) == 0.0
    else:
        torch.testing.assert_close(loss[::3], lse[::3], rtol=1e-5, atol=1e-5)
    bwd = dict(fwd, lse=want_lse, g=x["g"])
    dx, dw = fc.fused_linear_ce_dx_cuda(**bwd), fc.fused_linear_ce_dw_cuda(**bwd)
    torch.cuda.synchronize()
    torch.testing.assert_close(dx, fc.fused_linear_ce_dx_ref(**bwd), **_tol(torch.bfloat16))
    torch.testing.assert_close(dw, fc.fused_linear_ce_dw_ref(**bwd), **_tol(torch.bfloat16))


def _fp64_ce(x, w, t, lse, g):
    """loss, lse, dx and dW of the same formulas in fp64 (targets inside
    [1, V), 0 ignored; dx and dW from the given lse)."""
    logits = x.double() @ w.double().T
    lse64 = torch.logsumexp(logits, -1)
    tl = logits.gather(1, t.long()[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(t.long(), w.shape[0]).double()
    coeff = torch.where(t == 0, 0.0, g.double())[:, None] * (
        torch.exp(logits - lse.double()[:, None]) - onehot)
    return (torch.where(t == 0, 0.0, lse64 - tl), lse64, coeff @ w.double(),
            coeff.T @ x.double())


# Of max |fp64|, by output. ce_bwd_ab.py --mode fp32 on an H100 measured,
# at (33, 700, 2048) over 4 seeds: loss and lse <= 0.26e-6 for the kernels
# and the plain versions; dx and dW <= 1.6e-6 for the kernels, <= 3.3e-6
# for the plain versions; one fmaf chain over all of d up to 1.6e-6 and
# 8.9e-6.
FP64_REL = dict(loss=1e-6, lse=1e-6, dx=5e-6, dW=5e-6)


@pytest.mark.parametrize("seed", range(4))
def test_fused_ce_fp32_wide_d_unscaled_matches_fp64(card, seed):
    """The fp32 kernels at d = 2,048 with x ~ N(0, 1) and w ~ N(0, 0.1)
    unscaled (logits of std ~4.5, where summation order shows) against an
    fp64 evaluation of the same formulas: the kernels sum each 64-wide
    chunk of d as one fmaf chain and add the chunks, and lie within
    FP64_REL of max |fp64| on loss, lse, dx and dW, as the plain versions
    (cuBLAS) do; kernel against plain version at the same 1e-5 as the
    other cases."""
    x = _ce_inputs(card, 33, 700, 2048, torch.float32, seed=seed)
    args = (x["x"], x["w"], x["targets"])
    loss, lse = fc.fused_linear_ce_fwd_cuda(*args)
    want_loss, want_lse = fc.fused_linear_ce_ref(*args)
    bwd = (*args, want_lse, x["g"])
    got = (loss, lse, fc.fused_linear_ce_dx_cuda(*bwd), fc.fused_linear_ce_dw_cuda(*bwd))
    plain = (want_loss, want_lse, *fc.fused_linear_ce_bwd_ref(*bwd))
    for name, a, b, ref in zip(("loss", "lse", "dx", "dW"), got, plain, _fp64_ce(*bwd)):
        scale = float(ref.abs().max())
        for who, v in (("kernel", a), ("plain", b)):
            err = float((v.double() - ref).abs().max())
            tol = FP64_REL[name]
            assert err <= tol * scale, f"{name} {who}: {err} > {tol} x {scale}"
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


def test_fused_ce_mean_loss_on_the_card_matches_the_cpu(card):
    x = _ce_inputs(card, 300, 1000, 32, torch.float32, seed=2)
    grads = {}
    for where in ("cuda", "cpu"):
        xx = x["x"].detach().to(where).requires_grad_()
        ww = x["w"].detach().to(where).requires_grad_()
        loss = fc.fused_ce_mean_loss(xx, ww, x["targets"].to(where))
        loss.backward()
        grads[where] = (loss.detach().cpu(), xx.grad.cpu(), ww.grad.cpu())
    for name, a, b in zip(("loss", "dx", "dW"), grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


def test_fused_ce_wrappers_refuse_what_they_do_not_take(card):
    x = _ce_inputs(card, 8, 20, 4, torch.float32)
    fwd = dict(x=x["x"], w=x["w"], targets=x["targets"])
    before = fc.fused_linear_ce_fwd_cuda.launches
    for bad in (dict(fwd, x=fwd["x"].double()), dict(fwd, w=fwd["w"].to(torch.bfloat16)),
                dict(fwd, targets=fwd["targets"].long()),
                dict(fwd, x=torch.zeros((8, 2049), device=card),
                     w=torch.zeros((20, 2049), device=card)),
                dict(fwd, targets=fwd["targets"][:4])):
        with pytest.raises(ValueError):
            fc.fused_linear_ce_fwd_cuda(**bad)
    assert fc.fused_linear_ce_fwd_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,vlim", [
    ((37, 700, 64), 650),     # HSTU's width, narrow backward
    ((70, 300, 1000), 290),   # wide backward, d not a multiple of any chunk
    ((300, 900, 1536), 880),  # the Qwen2.5-1.5B hidden size, several groups a split
    ((33, 130, 2048), 129),   # d at its limit
    ((40, 200, 1536), 0),     # a shard of pad rows only
    ((4100, 9000, 1536), 5000),  # vlim inside a vocab chunk of the bf16 backward
    ((1000, 3000, 64), 1300),    # vlim inside a 256-column tile of the bf16 forward
])
def test_fused_ce_kernels_with_vlim_match_plain_versions(card, shape, vlim, dtype):
    """Columns at or past vlim read -1e30 inside the softmax; targets stay
    below vlim, or lie on another shard (-1) when vlim is 0. Held to the
    plain versions with the same lse and g."""
    R, V, d = shape
    x = _ce_inputs(card, R, V, d, dtype)
    x["x"] = (x["x"].float() / d ** 0.5).to(dtype)
    t = x["targets"]
    x["targets"] = torch.where(t > 0, t % vlim, 0).to(torch.int32) if vlim else torch.full_like(t, -1)
    fwd = dict(x=x["x"], w=x["w"], targets=x["targets"], ignore_index=0, vlim=vlim)
    loss, lse = fc.fused_linear_ce_fwd_cuda(**fwd)
    want_loss, want_lse = fc.fused_linear_ce_ref(**fwd)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    bwd = dict(fwd, lse=want_lse, g=x["g"])
    dx, dw = fc.fused_linear_ce_dx_cuda(**bwd), fc.fused_linear_ce_dw_cuda(**bwd)
    torch.cuda.synchronize()
    torch.testing.assert_close(dx, fc.fused_linear_ce_dx_ref(**bwd), **_tol(dtype))
    torch.testing.assert_close(dw, fc.fused_linear_ce_dw_ref(**bwd), **_tol(dtype))
    if vlim:
        assert float(dw[vlim:].float().abs().max()) == 0.0  # pad rows: exactly zero dW


def _b8_ranks(group, x, w, t, valid_vocab):
    """Rank side: B8 on the card and its plain twin on the same inputs."""
    Vs = w.shape[0] // group.size
    dev = group.device
    out = []
    for fn in (fc.sharded_fused_linear_ce, fc.sharded_fused_linear_ce_ref):
        xt = torch.as_tensor(x, device=dev).requires_grad_()
        ws = torch.as_tensor(w[group.rank * Vs:(group.rank + 1) * Vs], device=dev)
        ws.requires_grad_()
        loss = fn(xt, ws, torch.as_tensor(t, device=dev), group, -100, valid_vocab)
        loss.sum().backward()
        out.append([a.detach().cpu() for a in (loss, xt.grad, ws.grad)])
    return out


def test_sharded_fused_ce_two_ranks_on_one_card_match_twin(card, tmp_path):
    """B8 over gloo with both ranks on cuda:0 (NCCL refuses two ranks on
    one device): loss, dx and each rank's dW equal the plain twin's."""
    rng = np.random.default_rng(3)
    R, V, d, vv = 300, 1024, 1536, 1000
    x = (rng.normal(size=(R, d)) / d ** 0.5).astype(np.float32)
    w = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    t = rng.integers(0, vv, R).astype(np.int32)
    t[rng.random(R) < 0.2] = -100
    for kernel, twin in spawn(_b8_ranks, 2, (x, w, t, vv), device="cuda",
                              timeout_s=300, store_dir=tmp_path):
        for name, a, b in zip(("loss", "dx", "dW"), kernel, twin):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


def _quantized(x):
    """The fp32 inputs' pools as int8 pools; every third row of page 1
    all zeros (scale 1e-12 / 127)."""
    out = dict(x)
    for name in ("k_pool", "v_pool"):
        pool = x[name].clone()
        pool[1, ::3] = 0.0
        out[name] = QuantizedKVPool(*quantize_symmetric(pool, (-2, -1)))
    return out


@pytest.mark.parametrize("shape,lens,null_tail", [
    ((64, 10, 6, 64, 16, 4), "random", True),     # the serving shapes
    ((5, 3, 2, 8, 8, 3), [24, 0, 9, 1, 17], True),  # seq_len 0, partial pages
    ((4, 1, 3, 6, 8, 2), [3, 16, 0, 9], False),    # K = 1; hd % 4 != 0: bytewise loads
    ((3, 32, 1, 128, 40, 2), [80, 41, 0], False),  # a full block of 32 beams, hd at its limit
])
def test_quantized_kernel_matches_plain_version(card, shape, lens, null_tail):
    S, K, H, hd, page, Pm = shape
    if lens == "random":
        lens = np.random.default_rng(2).integers(4, Pm * page + 1, S)
    x = _quantized(_inputs(card, S, K, H, hd, page, Pm, lens, null_tail, seed=3))
    before = paged_attention_stats_quantized_cuda.launches
    got = paged_attention_stats_quantized_cuda(**x)
    torch.cuda.synchronize()
    assert paged_attention_stats_quantized_cuda.launches == before + 1
    want = paged_attention_stats_quantized_ref(**x)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


def test_quantized_kernel_wrapper_refuses_what_it_does_not_take(card):
    x = _quantized(_inputs(card, 2, 3, 2, 8, 8, 2, [5, 9]))
    k = x["k_pool"]
    before = paged_attention_stats_quantized_cuda.launches
    for bad in (dict(x, k_pool=QuantizedKVPool(k.data.float(), k.scale)),
                dict(x, k_pool=QuantizedKVPool(k.data, k.scale[:, :4].contiguous())),
                dict(x, k_pool=QuantizedKVPool(k.data.cpu(), k.scale.cpu())),
                dict(x, q=x["q"].double())):
        with pytest.raises(ValueError):
            paged_attention_stats_quantized_cuda(**bad)
    assert paged_attention_stats_quantized_cuda.launches == before


# COBRA's serving shape (config/cobra/amazon.gin): 20 beams, 6 heads of 128,
# 5 pages of 16 (20 items x (3 codes + 1 dense) = 80 positions); slot 0 at
# seq_len 0 (a free slot: every entry the null page) and slot 1 at full
# capacity, the rest served lengths (whole items of 4 positions).
def _cobra_lens():
    lens = 4 * np.random.default_rng(9).integers(1, 21, 64)
    lens[0], lens[1] = 0, 80
    return lens


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_kernels_at_cobra_shape_match_plain_versions(card, int8):
    kernel, plain = _b1_b2(int8)
    x = _maybe_int8(_inputs(card, 64, 20, 6, 128, 16, 5, _cobra_lens(), null_tail=True,
                            seed=9), int8)
    before = kernel.launches
    got = kernel(**x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(**x)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


def test_quantize_symmetric_on_the_card_matches_the_cpu(card):
    """C1: data and scale bit-equal between the card and the CPU over a
    sweep of row maxima from 1e-30 to 1e30 (every scale's float32
    mantissa pattern many times over), all-zero rows included."""
    rng = np.random.default_rng(10)
    n, width = 200_000, 96
    amax = 10.0 ** rng.uniform(-30, 30, n)
    x = rng.uniform(-1, 1, (n, width)) * amax[:, None]
    x[np.arange(n), rng.integers(0, width, n)] = amax * rng.choice([-1, 1], n)
    x[::997] = 0.0
    x = torch.as_tensor(x.astype(np.float32))
    data_cpu, scale_cpu = quantize_symmetric(x, (-1,))
    data, scale = quantize_symmetric(x.to(card), (-1,))
    assert torch.equal(scale.cpu(), scale_cpu)
    assert torch.equal(data.cpu(), data_cpu)
    rows = x.reshape(-1, 6, 16)  # the KV pools' (page row, heads, head_dim) reduction
    for a, b in zip(quantize_symmetric(rows, (-2, -1)),
                    quantize_symmetric(rows.to(card), (-2, -1))):
        assert torch.equal(b.cpu(), a)


@pytest.mark.parametrize("fn", ["t5_bidirectional", "t5_causal", "hstu"])
def test_position_buckets_on_the_card_match_the_cpu(card, fn):
    """C2: the T5 (both directions) and HSTU position buckets equal on the
    card and on the CPU over |rel| < 5,000, |rel| = 64 included (the
    bidirectional T5 bucket's log lands within an ulp of a cut there)."""
    from genrec_tpu_torch.ops.buckets import hstu_position_bucket, t5_relative_position_bucket

    rel = torch.arange(-4999, 5000)
    assert (rel.abs() == 64).any()
    for nb, md in ((32, 128), (64, 256), (16, 64)):
        if fn == "hstu":
            f = lambda r: hstu_position_bucket(r, nb, md)  # noqa: E731
        else:
            f = lambda r: t5_relative_position_bucket(  # noqa: E731
                r, nb, md, bidirectional=fn == "t5_bidirectional")
        torch.testing.assert_close(f(rel.to(card)).cpu(), f(rel), rtol=0, atol=0)


def _near_neg(dev, S, K, H, page, Pm, lens, int8, seed=0):
    """Inputs whose scores are exact in any summation order (integer K,
    q a multiple of 512, hd 64 so hd^-0.5 = 1/8) and put each beam's max
    over its live positions at -1e9 - 64, -1e9 or -1e9 + 64: every beam
    is within 128 of -1e9, so the kernel must walk the masked positions
    too, and where the max is -1e9 or below they carry real weight."""
    hd = 64
    x = _inputs(dev, S, K, H, hd, page, Pm, lens, seed=seed)
    rng = np.random.default_rng(seed)
    bt = x["block_tables"].cpu().numpy()
    P, cap = x["k_pool"].shape[0], Pm * page
    k = rng.integers(-1, 2, size=(P, page, H, hd)).astype(np.float32)
    k[..., 0] = 1.0
    qn = rng.integers(-1, 2, size=(S, K, H, hd)).astype(np.float32)
    qn[..., 0] = 0.0
    sums = np.einsum("skhd,slhd->skhl", qn, k[bt].reshape(S, cap, H, hd))
    lens = np.asarray(lens)
    live = np.arange(cap)[None, :] < np.where(lens > 0, np.minimum(lens, cap), cap)[:, None]
    top = np.where(live[:, None, None, :], sums, -(10**6)).max(-1)
    q = 512.0 * qn
    q[..., 0] = -8e9 - 512.0 * (top - rng.integers(-1, 2, size=top.shape))
    x["q"] = torch.as_tensor(q.astype(np.float32), device=dev)
    if int8:
        x = _quantized(x)
        x["k_pool"] = QuantizedKVPool(torch.as_tensor(k.astype(np.int8), device=dev),
                                      torch.ones((P, page), device=dev))
    else:
        x["k_pool"] = torch.as_tensor(k, device=dev)
    return x


def _b1_b2(int8):
    return ((paged_attention_stats_quantized_cuda, paged_attention_stats_quantized_ref)
            if int8 else (paged_attention_stats_cuda, paged_attention_stats_ref))


# The redesigned kernels' edges (B1 and B2 both): scores within 128 of
# -1e9 (the walk past the live positions), seq_len above Pm * page with
# block-table entries outside [0, P) (clamped on both sides), S = 1 and
# S = 16 at the serving widths, and a shape whose positions stream through
# the ring in 4 stages.
EDGE_CASES = {
    "near_neg_partial": lambda dev, int8: _near_neg(dev, 3, 10, 2, 16, 4, [40, 5, 17], int8),
    "near_neg_full": lambda dev, int8: _near_neg(dev, 2, 10, 2, 16, 4, [64, 80], int8),
    "seq_len_over_cap_bt_outside": lambda dev, int8: _out_of_range(
        _inputs(dev, 3, 10, 6, 64, 16, 4, [100, 7, 64], seed=4), int8),
    "s1_serving_widths": lambda dev, int8: _maybe_int8(
        _inputs(dev, 1, 10, 6, 64, 16, 4, [61], null_tail=True, seed=5), int8),
    "s16_serving_widths": lambda dev, int8: _maybe_int8(
        _inputs(dev, 16, 10, 6, 64, 16, 4, np.random.default_rng(6).integers(4, 62, 16),
                null_tail=True, seed=6), int8),
    "multi_stage": lambda dev, int8: _maybe_int8(
        _inputs(dev, 2, 10, 2, 128, 16, 16, [256, 130], seed=7), int8),
}


def _maybe_int8(x, int8):
    return _quantized(x) if int8 else x


def _out_of_range(x, int8):
    P = x["k_pool"].shape[0]
    bt = x["block_tables"].clone()
    bt[0, -1], bt[1, 0], bt[2, 1] = -5, P + 7, P
    return _maybe_int8(dict(x, block_tables=bt), int8)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_paged_kernels_edge_cases_match_plain_versions(card, case, int8):
    kernel, plain = _b1_b2(int8)
    x = EDGE_CASES[case](card, int8)
    before = kernel.launches
    got = kernel(**x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(**x)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


# The speculative tree's node axis where the beams were: K past the 32 a
# block holds, spread over ceil(K / 32) blocks along z. K 33 and 90 (one
# and two blocks past a full one) and COBRA's 180 at hd 128, TIGER's 730
# (10 beams, fanout 8, depth 2) at hd 64, at the serving shapes (page 16,
# Pm 5 and 4) with free slots at seq_len 0 beside full ones.
TREE_SHAPES = {
    "k33_hd128": (8, 33, 6, 128, 16, 5),
    "k90_hd128": (8, 90, 6, 128, 16, 5),
    "k180_hd128": (16, 180, 6, 128, 16, 5),
    "k730_hd64": (16, 730, 6, 64, 16, 4),
}


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", sorted(TREE_SHAPES))
def test_paged_kernels_take_the_tree_node_axis(card, name, int8):
    kernel, plain = _b1_b2(int8)
    S, K, H, hd, page, Pm = TREE_SHAPES[name]
    lens = np.random.default_rng(K).integers(4, Pm * page + 1, S)
    lens[::5], lens[1::5] = 0, Pm * page
    x = _maybe_int8(_inputs(card, S, K, H, hd, page, Pm, lens, null_tail=True, seed=K), int8)
    before = kernel.launches
    got = kernel(**x)
    again = kernel(**x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    want = plain(**x)
    for out, g, w in zip(("acc", "m", "l"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=out)
    # Each node's row is the one it gets alone in a block of <= 32.
    part = kernel(**dict(x, q=x["q"][:, 32:64].contiguous()))
    torch.testing.assert_close(part[0], got[0][:, 32:64], rtol=0, atol=0)


# The edge cases above with the node axis of a tree: near -1e9 at K 90,
# block-table entries outside [0, P) at K 180, S = 1 at K 730, the ring
# streaming at K 33.
TREE_EDGE_CASES = {
    "near_neg_k90": lambda dev, int8: _near_neg(dev, 3, 90, 2, 16, 4, [40, 5, 17], int8),
    "seq_len_over_cap_bt_outside_k180": lambda dev, int8: _out_of_range(
        _inputs(dev, 3, 180, 6, 128, 16, 4, [100, 7, 64], seed=4), int8),
    "s1_k730": lambda dev, int8: _maybe_int8(
        _inputs(dev, 1, 730, 6, 64, 16, 4, [61], null_tail=True, seed=5), int8),
    "multi_stage_k33": lambda dev, int8: _maybe_int8(
        _inputs(dev, 2, 33, 2, 128, 16, 16, [256, 130], seed=7), int8),
}


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(TREE_EDGE_CASES))
def test_paged_kernels_tree_edge_cases_match_plain_versions(card, case, int8):
    kernel, plain = _b1_b2(int8)
    x = TREE_EDGE_CASES[case](card, int8)
    before = kernel.launches
    got = kernel(**x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for name, g, w in zip(("acc", "m", "l"), got, plain(**x)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_kernels_give_equal_bits_over_two_calls(card, int8):
    kernel, _ = _b1_b2(int8)
    lens = np.random.default_rng(8).integers(4, 62, 64)
    x = _maybe_int8(_inputs(card, 64, 10, 6, 64, 16, 4, lens, null_tail=True, seed=8), int8)
    before = kernel.launches
    a, b = kernel(**x), kernel(**x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(a, b))


# ---- B1 over bf16 pages, B2 with a bf16 q -------------------------------------
#
# A bf16 model serves bf16 pages with a bf16 q (paged_attention_stats_bf16_cuda)
# or int8 pages with a bf16 q (paged_attention_stats_quantized_bf16q_cuda).
# Both run the mma kernel: q.k as bf16 products, exact in fp32, summed in
# fp32 on the tensor cores (int8 K converted exactly to bf16, its row scale
# applied to the dot); e.V with e in three bf16 planes that carry all of
# its fp32 bits. Only the order of the fp32 sums differs from the plain
# versions: held at the fp32 variants' 1e-5.


def _bf16(x, q8):
    """The fp32 inputs with q in bf16, and the pools in bf16 or (``q8``)
    as int8 pools."""
    out = _quantized(x) if q8 else dict(x, k_pool=x["k_pool"].to(torch.bfloat16),
                                         v_pool=x["v_pool"].to(torch.bfloat16))
    out["q"] = x["q"].to(torch.bfloat16)
    return out


def _bf16_variant(q8):
    if q8:
        return (pa.paged_attention_stats_quantized_bf16q_cuda,
                paged_attention_stats_quantized_ref)
    return pa.paged_attention_stats_bf16_cuda, paged_attention_stats_ref


def _bf16_terms(x, n=4):
    """``n`` bf16-exact float32 arrays summing exactly to ``x`` (multiples
    of 512 below 2^33 in magnitude), greedily: each the nearest bf16 value
    to what is left."""
    terms, rest = [], x.astype(np.float64)
    for _ in range(n):
        t = torch.as_tensor(rest, dtype=torch.float32).to(torch.bfloat16).float().numpy()
        terms.append(t)
        rest = rest - t.astype(np.float64)
    assert (rest == 0).all()
    return terms


def _near_neg_bf16(dev, S, K, H, page, Pm, lens, q8, seed=0):
    """``_near_neg`` with every q and K value exact in bf16: the -8e9 offset
    split over q's first 4 dims (K 1 there), so each beam's live max again
    lands at -1e9 - 64, -1e9 or -1e9 + 64, and every partial sum is a
    multiple of 512 below 2^33, exact in fp32 in any order."""
    hd = 64
    x = _inputs(dev, S, K, H, hd, page, Pm, lens, seed=seed)
    rng = np.random.default_rng(seed)
    bt = x["block_tables"].cpu().numpy()
    P, cap = x["k_pool"].shape[0], Pm * page
    k = rng.integers(-1, 2, size=(P, page, H, hd)).astype(np.float32)
    k[..., :4] = 1.0
    qn = rng.integers(-1, 2, size=(S, K, H, hd)).astype(np.float32)
    qn[..., :4] = 0.0
    sums = np.einsum("skhd,slhd->skhl", qn, k[bt].reshape(S, cap, H, hd))
    lens = np.asarray(lens)
    live = np.arange(cap)[None, :] < np.where(lens > 0, np.minimum(lens, cap), cap)[:, None]
    top = np.where(live[:, None, None, :], sums, -(10**6)).max(-1)
    q = 512.0 * qn
    target = -8e9 - 512.0 * (top - rng.integers(-1, 2, size=top.shape))
    for i, t in enumerate(_bf16_terms(target)):
        q[..., i] = t
    x["q"] = torch.as_tensor(q, device=dev)
    x["k_pool"] = torch.as_tensor(k, device=dev)
    out = _bf16(x, q8)
    if q8:
        out["k_pool"] = QuantizedKVPool(torch.as_tensor(k.astype(np.int8), device=dev),
                                        torch.ones((P, page), device=dev))
    assert torch.equal(out["q"].float(), x["q"])  # exact in bf16
    return out


BF16_SHAPES = {  # name: (S, K, H, hd, page, Pm), seq_lens, null tail
    "tiger_serving": ((64, 10, 6, 64, 16, 4), "random", True),
    "cobra_serving": ((64, 20, 6, 128, 16, 5), "cobra", True),
    "seq_len_0_partial_pages": ((5, 3, 2, 8, 8, 3), [24, 0, 9, 1, 17], True),
    "k1_hd5_bytewise": ((4, 1, 3, 5, 8, 2), [3, 16, 0, 9], False),
    "hd10_4_byte_copies": ((3, 4, 2, 10, 8, 2), [7, 16, 11], False),
    "full_block_hd128": ((3, 32, 1, 128, 40, 2), [80, 41, 0], False),
    "streams_8_stages": ((2, 10, 2, 128, 16, 32), [400, 130], False),
    "hd32": ((8, 10, 6, 32, 16, 4), "random", True),
    "hd48_not_a_multiple_of_16": ((8, 20, 6, 48, 16, 5), "random", True),
    "k37_hd48_tree_not_a_multiple_of_16": ((6, 37, 6, 48, 16, 4), "random", True),
}


@pytest.mark.parametrize("q8", [False, True], ids=["bf16_pages", "int8_pages_bf16q"])
@pytest.mark.parametrize("name", sorted(BF16_SHAPES))
def test_bf16_kernels_match_plain_versions(card, name, q8):
    kernel, plain = _bf16_variant(q8)
    (S, K, H, hd, page, Pm), lens, null_tail = BF16_SHAPES[name]
    if lens == "random":
        lens = np.random.default_rng(1).integers(4, Pm * page + 1, S)
    elif lens == "cobra":
        lens = _cobra_lens()
    x = _bf16(_inputs(card, S, K, H, hd, page, Pm, lens, null_tail, seed=11), q8)
    before = kernel.launches
    got = kernel(**x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for out, g, w in zip(("acc", "m", "l"), got, plain(**x)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=out)


BF16_EDGE_CASES = {
    "near_neg_partial": lambda dev, q8: _near_neg_bf16(dev, 3, 10, 2, 16, 4, [40, 5, 17], q8),
    "near_neg_full": lambda dev, q8: _near_neg_bf16(dev, 2, 10, 2, 16, 4, [64, 80], q8),
    "seq_len_over_cap_bt_outside": lambda dev, q8: _bf16(_out_of_range(
        _inputs(dev, 3, 10, 6, 64, 16, 4, [100, 7, 64], seed=4), False), q8),
    "s1_serving_widths": lambda dev, q8: _bf16(
        _inputs(dev, 1, 10, 6, 64, 16, 4, [61], null_tail=True, seed=5), q8),
    "s16_serving_widths": lambda dev, q8: _bf16(
        _inputs(dev, 16, 10, 6, 64, 16, 4, np.random.default_rng(6).integers(4, 62, 16),
                null_tail=True, seed=6), q8),
    "multi_stage": lambda dev, q8: _bf16(
        _inputs(dev, 2, 10, 2, 128, 16, 16, [256, 130], seed=7), q8),
}


@pytest.mark.parametrize("q8", [False, True], ids=["bf16_pages", "int8_pages_bf16q"])
@pytest.mark.parametrize("case", sorted(BF16_EDGE_CASES))
def test_bf16_kernels_edge_cases_match_plain_versions(card, case, q8):
    kernel, plain = _bf16_variant(q8)
    x = BF16_EDGE_CASES[case](card, q8)
    before = kernel.launches
    got = kernel(**x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for name, g, w in zip(("acc", "m", "l"), got, plain(**x)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16_pages", "int8_pages_bf16q"])
@pytest.mark.parametrize("name", sorted(TREE_SHAPES))
def test_bf16_kernels_take_the_tree_node_axis(card, name, q8):
    """TIGER's 730 nodes at hd 64, COBRA's 180 at hd 128, and K 33 / 90:
    equal bits over two calls, each node's row the one it gets alone."""
    kernel, plain = _bf16_variant(q8)
    S, K, H, hd, page, Pm = TREE_SHAPES[name]
    lens = np.random.default_rng(K).integers(4, Pm * page + 1, S)
    lens[::5], lens[1::5] = 0, Pm * page
    x = _bf16(_inputs(card, S, K, H, hd, page, Pm, lens, null_tail=True, seed=K), q8)
    before = kernel.launches
    got, again = kernel(**x), kernel(**x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    for out, g, w in zip(("acc", "m", "l"), got, plain(**x)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=out)
    part = kernel(**dict(x, q=x["q"][:, 32:64].contiguous()))
    torch.testing.assert_close(part[0], got[0][:, 32:64], rtol=0, atol=0)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16_pages", "int8_pages_bf16q"])
def test_bf16_kernels_fit_three_blocks_an_sm_at_cobra_shape(card, q8):
    """The bf16-q kernel keeps COBRA's block (K 20: two warps of 16 nodes)
    in a raw ring of the slot's 80 positions: three or more blocks an SM,
    so the 384 (slot, head) blocks run in one wave. TIGER's tree (730
    nodes) takes 6 blocks of <= 128 nodes along z, each walking the slot's
    pages once, its 4 warps taking 16-node tiles in turn."""
    pages = "int8" if q8 else "bfloat16"
    cobra = pa.block_shape(20, 128, 16, 5, pages, "bfloat16")
    assert cobra["nodes_per_block"] == 32 and cobra["blocks_z"] == 1
    assert cobra["smem_bytes"] <= 75 * 1024 and cobra["blocks_per_sm"] >= 3
    tree = pa.block_shape(730, 64, 16, 4, pages, "bfloat16")
    assert tree["blocks_z"] == 6 and tree["nodes_per_block"] <= 128


@pytest.mark.parametrize("q8", [False, True], ids=["bf16_pages", "int8_pages_bf16q"])
def test_bf16_kernels_give_equal_bits_over_two_calls(card, q8):
    kernel, _ = _bf16_variant(q8)
    lens = np.random.default_rng(8).integers(4, 62, 64)
    x = _bf16(_inputs(card, 64, 10, 6, 64, 16, 4, lens, null_tail=True, seed=8), q8)
    a, b = kernel(**x), kernel(**x)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_paged_wrappers_route_bf16_and_refuse_mixed_types(card):
    """The fp32 entry points hand a bf16 q to the bf16 variants (which
    count those launches, the fp32 counters none); a bf16 q over fp32
    pools, an fp32 q over bf16 pools, or fp16 anywhere raises and counts
    nothing."""
    x = _inputs(card, 2, 3, 2, 8, 8, 2, [5, 9])
    counters = (paged_attention_stats_cuda, pa.paged_attention_stats_bf16_cuda,
                paged_attention_stats_quantized_cuda, pa.paged_attention_stats_quantized_bf16q_cuda)
    before = [c.launches for c in counters]
    paged_attention_stats_cuda(**_bf16(x, False))
    paged_attention_stats_quantized_cuda(**_bf16(x, True))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 1, 0, 1]
    bf = _bf16(x, False)
    for fn, kwargs in ((paged_attention_stats_cuda, dict(x, q=bf["q"])),
                       (paged_attention_stats_cuda, dict(bf, q=x["q"])),
                       (pa.paged_attention_stats_bf16_cuda, x),
                       (paged_attention_stats_cuda, dict(x, q=x["q"].half())),
                       (paged_attention_stats_quantized_cuda,
                        dict(_bf16(x, True), q=x["q"].half()))):
        with pytest.raises(ValueError):
            fn(**kwargs)
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 1, 0, 1]


@pytest.mark.parametrize("B,L,K,D,dup", [
    (4096, 3, 256, 32, False),   # one export chunk at the RQ-VAE's widths
    (1000, 3, 256, 32, False),   # B not a multiple of the 32-row block
    (517, 3, 512, 64, False),    # codebooks past a block's shared memory: a level at a time
    (4096, 5, 256, 64, False),   # LCRec's export chunk: 5 levels of 256 at D 64
    (100, 2, 70, 10, False),     # D not a multiple of 4
    (77, 1, 45, 16, False),      # L = 1, K not a multiple of 32
    (300, 3, 300, 40, False),    # K above a 256-codeword chunk, D above a warp
    (128, 3, 64, 8, True),       # duplicated codewords: the lower index wins
])
def test_rq_cascade_kernel_matches_plain_version(card, B, L, K, D, dup):
    rng = np.random.default_rng(B + K)
    x = torch.as_tensor(rng.normal(size=(B, D)).astype(np.float32), device=card)
    cb = (rng.normal(size=(L, K, D)) * 0.7).astype(np.float32)
    if dup:
        cb[:, K // 2:] = cb[:, :K - K // 2]
    cb = torch.as_tensor(cb, device=card)
    before = rq.rq_cascade_cuda.launches
    ids, qsum = rq.rq_cascade_cuda(x, cb)
    torch.cuda.synchronize()
    assert rq.rq_cascade_cuda.launches == before + 1
    want_ids, want_q = rq.rq_cascade_ref(x, cb)
    if dup:  # every row ties exactly: equal everywhere, the lower index
        assert torch.equal(ids, want_ids) and int(ids.max()) < K - K // 2
        return
    near = rq.near_tie_rows(x, cb, want_ids)
    differ = (ids != want_ids).any(dim=1)
    assert not (differ & ~near).any() and float(near.float().mean()) <= 0.02
    same = ~differ
    torch.testing.assert_close(qsum[same], want_q[same], rtol=0,
                               atol=1e-5 * float(want_q.abs().max()))


def test_rq_cascade_gives_equal_bits_over_two_calls(card):
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(size=(4096, 32)).astype(np.float32), device=card)
    cb = torch.as_tensor((rng.normal(size=(3, 256, 32)) * 0.7).astype(np.float32), device=card)
    a, b = rq.rq_cascade_cuda(x, cb), rq.rq_cascade_cuda(x, cb)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_rq_cascade_wrapper_refuses_what_it_does_not_take(card):
    x = torch.zeros((8, 16), device=card)
    cb = torch.zeros((3, 32, 16), device=card)
    before = rq.rq_cascade_cuda.launches
    for bx, bcb in ((x.double(), cb), (x, cb[:, :, :8].contiguous()), (x.cpu(), cb),
                    (x, cb.transpose(1, 2))):
        with pytest.raises(ValueError):
            rq.rq_cascade_cuda(bx, bcb)
    assert rq.rq_cascade_cuda.launches == before


# ---- the retrieval serving shapes of B5, and SASRec on the fused CE ------------


def _serving_inputs(dev, B, L, dtype, n_real, seed=0):
    """B5's inputs as the retrieval head gives them: H 2, hd 32, histories
    right-aligned (the padding in front), lengths 1 to L, rows past the
    ``n_real`` requests all padding, timestamps ~1 event a day."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    f = lambda *s: t((rng.normal(size=s) * 0.5).astype(np.float32)).to(dtype)  # noqa: E731
    pad = np.ones((B, L), bool)
    for b in range(n_real):
        pad[b, L - int(rng.integers(1, L + 1)):] = False
    pad[0, : L - 1] = True  # a one-item history
    ts = (np.cumsum(rng.integers(3600, 200_000, size=(B, L)), axis=1)
          + 1_500_000_000).astype(np.int32)
    ts[pad] = 0
    return dict(q=f(B, 2, L, 32), k=f(B, 2, L, 32), v=f(B, 2, L, 32), timestamps=t(ts),
                padding_mask=t(pad),
                pos_table=t((rng.normal(size=(2, 32)) * 0.1).astype(np.float32)),
                time_table=t((rng.normal(size=(2, 64)) * 0.1).astype(np.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("L", [8, 16, 32, 50])
@pytest.mark.parametrize("B,n_real", [(1, 1), (4, 3), (16, 11), (16, 16)])
def test_hstu_forward_at_serving_shapes_matches_plain_version(card, B, n_real, L, dtype):
    x = _serving_inputs(card, B, L, dtype, n_real, seed=B * L)
    got = ha.hstu_attention_fwd_cuda(**x)
    torch.cuda.synchronize()
    want = ha.hstu_attention_ref(**x)
    torch.testing.assert_close(got, want, **_tol(dtype))
    err = float((got.float() - want.float()).abs().max())
    assert err <= _tol(dtype)["rtol"] * float(want.float().abs().max()), err
    pad = x["padding_mask"]
    # Padded query rows, the all-padding rows among them, are exactly 0.
    assert float(got.float().abs().permute(0, 2, 1, 3)[pad].max()) == 0.0
    if n_real < B:
        assert float(got[n_real:].float().abs().max()) == 0.0


def test_hstu_last_hidden_on_the_card_matches_the_plain_path(card):
    """HSTU.last_hidden at the retrieval head's largest bucket (B 16, L 50,
    bf16, right-aligned histories, the last four rows all padding): the
    kernel path against use_pallas=False on the same weights, within 1e-2
    of max |plain|, and B5 launched once a block."""
    from genrec_tpu_torch.models.hstu import HSTU

    rng = np.random.default_rng(0)
    ids = np.zeros((16, 50), np.int32)
    for b in range(12):
        n = int(rng.integers(1, 51))
        ids[b, 50 - n:] = rng.integers(1, 12102, n)
    ts = (np.cumsum(rng.integers(3600, 172800, (16, 50)), axis=1) + 1_500_000_000)
    ids_t, ts_t = (torch.as_tensor(a.astype(np.int32), device=card) for a in (ids, ts))
    out = {}
    for kernels in (True, False):
        m = HSTU(num_items=12101, use_pallas=kernels, dtype=torch.bfloat16, dropout=0.0,
                 device=card, seed=0).eval()
        before = ha.hstu_attention_fwd_cuda.launches
        with torch.no_grad():
            out[kernels] = m.last_hidden(ids_t, ts_t).float()
        torch.cuda.synchronize()
        assert ha.hstu_attention_fwd_cuda.launches - before == (2 if kernels else 0)
    err = float((out[True] - out[False]).abs().max())
    assert err <= 1e-2 * float(out[False].abs().max()), err


def test_sasrec_fused_ce_on_the_card_matches_the_plain_path(card):
    """SASRec at config/sasrec/amazon.gin's widths (fewer rows), packed
    rows, fp32: the fused CE (B3, B4 on the card) against the materialised
    logits and CE. Loss within 1e-5 relative; every parameter's gradient,
    the tied item table's included, within 1e-4 of its max |plain| (the
    CE kernels' 1e-5 carried through the backward) plus 1e-6 (the key
    biases' gradients are rounding noise: softmax ignores them). bf16
    losses within 1e-2 relative."""
    from genrec_tpu_torch.models.sasrec import SASRec

    rng = np.random.default_rng(1)
    B, L, V = 32, 50, 12101
    seg = np.zeros((B, L), np.int32)
    pos = np.zeros((B, L), np.int32)
    for b in range(B):
        at, s = 0, 1
        while at < L - 2:
            n = min(int(rng.integers(2, 29)), L - at)
            seg[b, at:at + n], pos[b, at:at + n] = s, np.arange(n)
            at, s = at + n, s + 1
    ids = np.where(seg > 0, rng.integers(1, V + 1, (B, L)), 0)
    tgt = np.where(seg > 0, rng.integers(1, V + 1, (B, L)), 0)
    batch = [torch.as_tensor(a.astype(np.int32), device=card) for a in (ids, tgt, seg, pos)]
    for dtype in (torch.float32, torch.bfloat16):
        got = {}
        for fused in (True, False):
            m = SASRec(num_items=V, dropout=0.0, fused_ce=fused, dtype=dtype, device=card,
                       seed=0)
            launches = fc.fused_linear_ce_fwd_cuda.launches
            _, loss = m(batch[0], batch[1], segment_ids=batch[2], positions=batch[3])
            loss.backward()
            torch.cuda.synchronize()
            assert fc.fused_linear_ce_fwd_cuda.launches - launches == (1 if fused else 0)
            got[fused] = (float(loss.detach()), {n: p.grad for n, p in m.named_parameters()})
        rel = abs(got[True][0] - got[False][0]) / abs(got[False][0])
        if dtype == torch.bfloat16:
            assert rel <= 1e-2, rel
            continue
        assert rel <= 1e-5, rel
        for name, g in got[True][1].items():
            w = got[False][1][name]
            err = float((g - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()) + 1e-6, (name, err)


def test_hstu_trainer_resumes_exactly_on_the_card(card, tmp_path):
    """The trainers' fault tolerance on the card (chip_smoke's resume phase,
    (a), at a small size): hstu_trainer.train at config/hstu/amazon.gin's
    widths (bf16, dropout 0.2, B3-B6) on the default synthetic set, batch
    16 (9 steps an epoch), killed by SIGTERM at step 13 and resumed. Held
    exactly: the logged steps (none twice), the per-step losses and the
    final resume point (parameters, moments, counters, the generator's
    state); the resumed steps launch B5, B6, B3, B4 dx, B4 dW 2, 2, 1, 1, 1
    times each (B5 also twice an eval batch of the final evaluation)."""
    import json
    import os

    from genrec_tpu_torch.core import chaos
    from genrec_tpu_torch.core.checkpoint import read_record
    from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset
    from genrec_tpu_torch.trainers import hstu_trainer

    cfg = dict(epochs=2, batch_size=16, max_seq_len=50, embed_dim=64, num_heads=2,
               num_blocks=2, dropout=0.2, do_eval=False, save_every_epoch=1,
               wandb_log_interval=1, amp=True, seed=0, device=str(card))

    def losses(d):
        out = {}
        for line in open(os.path.join(d, "metrics.jsonl")):
            rec = json.loads(line)
            if "train/loss" in rec and "global_step" in rec:
                assert rec["global_step"] not in out, "a step logged twice"
                out[rec["global_step"]] = rec["train/loss"]
        return out

    def final(d):
        ck = os.path.join(d, "checkpoints")
        step = max(int(s) for s in os.listdir(ck) if s.isdigit())
        flat = read_record(os.path.join(ck, str(step)))
        return step, {k: v for k, v in flat.items() if k.startswith("state/")}

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    hstu_trainer.train(**cfg, save_dir_root=a)
    with chaos.inject(chaos.ChaosPlan(kill_at_step=13)):
        assert hstu_trainer.train(**cfg, save_dir_root=b) == ({}, {})
    counters = (ha.hstu_attention_fwd_cuda, ha.hstu_attention_bwd_cuda,
                fc.fused_linear_ce_fwd_cuda, fc.fused_linear_ce_dx_cuda,
                fc.fused_linear_ce_dw_cuda)
    before = [f.launches for f in counters]
    hstu_trainer.train(**cfg, save_dir_root=b, resume_from_checkpoint=True)
    torch.cuda.synchronize()
    launched = [f.launches - n for f, n in zip(counters, before)]
    assert losses(a) == losses(b) and len(losses(a)) == 18
    (step_a, fa), (step_b, fb) = final(a), final(b)
    assert step_a == step_b == 18 and fa.keys() == fb.keys()
    differ = [k for k in fa if not torch.equal(fa[k], fb[k])]
    assert not differ, differ
    ds = SyntheticSeqDataset(max_seq_len=50, seed=0)
    eval_batches = sum(-(-len(ds.eval_arrays_with_time(s)["input_ids"]) // 256)
                       for s in ("valid", "test"))
    assert launched == [2 * 5 + 2 * eval_batches, 2 * 5, 5, 5, 5]


def test_amazon_parse_on_the_card_host(card, tmp_path):
    """chip_smoke's amazon phase, (a), at a small size on the machine with
    the card: a seeded SNAP-layout dump parsed by the native parser (built
    from the checkout's source into build/) and by Python, the caches
    equal, the counts those written."""
    import chip_smoke

    chip_smoke.write_amazon_dump(tmp_path, users=300, items=200, reviews=2000, seed=0,
                                 emb_dim=16)
    out = chip_smoke.amazon_parse(tmp_path)
    assert out["parser"] == "native", out["native_build_error"]
    assert (out["users"], out["items"], out["reviews"]) == (300, 200, 2000)
    assert out["min_user_reviews"] >= 5


def _tiny_qwen(dev, vocab, seed=0, tie=False):
    from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM, qwen_init_params

    cfg = QwenConfig(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                     max_position_embeddings=96, rope_theta=10000.0, tie_word_embeddings=tie)
    return cfg, qwen_init_params(cfg, seed, "cpu")


def test_lora_step_launches_b3_and_b4_dx_never_dw(card):
    """The LCRec LoRA step (fp32, fused CE) on the card: B3 and B4 dx once a
    step, B4 dW never (the head is frozen), the base bit-unchanged, and the
    losses of the CPU's plain versions within 1e-5."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.lora import LoraAdapters, lora_init
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.backbones.qwen import QwenLM
    from genrec_tpu_torch.models.lcrec import extend_vocab, sft_loss
    from genrec_tpu_torch.trainers.lcrec_trainer import lora_loss_fn

    cfg, full = _tiny_qwen("cpu", 90)
    cfg, full, base = extend_vocab(cfg, full, 3, 8, torch.Generator().manual_seed(1), pad_to=8)
    live = base + 24
    lora = lora_init(full, torch.Generator().manual_seed(2), 4)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, live, (4, 40)).astype(np.int32)
    labels = np.where(rng.random((4, 40)) < 0.4, -100, ids).astype(np.int32)
    out = {}
    for where in ("cpu", "cuda"):
        model = QwenLM(cfg, device=where)
        model.load_state_dict(full)
        for p in model.parameters():
            p.requires_grad_(False)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        # A copy each: the adapters are trained in place.
        adapters = LoraAdapters({n: {k: v.to(where, copy=True) for k, v in f.items()}
                                 for n, f in lora.items()})
        opt = Adam(1e-2, weight_decay=0.01)
        step = make_train_step(lora_loss_fn(model, lambda m, b: sft_loss(
            m, b["input_ids"], b["attention_mask"], b["labels"], valid_vocab=live,
            use_fused_ce=True), 16.0, 4), opt, clip_norm=1.0)
        state = TrainState.create(adapters, opt, 0)
        batch = {"input_ids": torch.as_tensor(ids, device=where),
                 "attention_mask": torch.ones((4, 40), dtype=torch.int32, device=where),
                 "labels": torch.as_tensor(labels, device=where)}
        counts = [fc.fused_linear_ce_fwd_cuda.launches, fc.fused_linear_ce_dx_cuda.launches,
                  fc.fused_linear_ce_dw_cuda.launches]
        out[where] = [float(step(state, batch)[1]["loss"]) for _ in range(3)]
        launched = [fc.fused_linear_ce_fwd_cuda.launches - counts[0],
                    fc.fused_linear_ce_dx_cuda.launches - counts[1],
                    fc.fused_linear_ce_dw_cuda.launches - counts[2]]
        assert launched == ([3, 3, 0] if where == "cuda" else [0, 0, 0])
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-5)


def test_qwen_heads_on_the_card_match_the_cpu(card):
    """One engine with an LCRec and a NoteLLM head on the card against the
    same engine on the CPU, from the same weights and catalog: sem-ids and
    items equal, scores within 1e-4."""
    from genrec_tpu_torch.catalog.snapshot import CatalogSnapshot
    from genrec_tpu_torch.models.backbones.qwen import QwenLM
    from genrec_tpu_torch.models.lcrec import extend_vocab
    from genrec_tpu_torch.models.notellm import add_emb_token
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import LCRecGenerativeHead, NoteLLMRetrievalHead
    from genrec_tpu_torch.serving.types import Request

    cfg, full = _tiny_qwen("cpu", 60)
    lc_cfg, lc_full, base = extend_vocab(cfg, full, 3, 8, torch.Generator().manual_seed(1))
    nl_cfg, nl_full, emb_id = add_emb_token(cfg, full, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(0)
    valid = np.unique(rng.integers(0, 8, (60, 3)), axis=0)
    vecs = rng.standard_normal((len(valid), 64)).astype(np.float32)
    reqs = [Request(head="lcrec", history=rng.integers(0, len(valid), n)) for n in (1, 3, 6)]
    reqs += [Request(head="notellm", history=rng.integers(3, emb_id, n)) for n in (2, 5, 8)]
    answers = {}
    for where in ("cpu", "cuda"):
        lc_model = QwenLM(lc_cfg, device=where)
        lc_model.load_state_dict(lc_full)
        nl_model = QwenLM(nl_cfg, device=where)
        nl_model.load_state_dict(nl_full)
        heads = [LCRecGenerativeHead(lc_model.eval(), base, 3, 8, item_sem_ids=valid, top_k=4),
                 NoteLLMRetrievalHead(nl_model.eval(), emb_id, catalog=CatalogSnapshot.build(
                     valid, 8, item_vecs=vecs), top_k=5)]
        eng = ServingEngine(heads, device=where, ladder=BucketLadder((1,), (4, 8)), max_batch=1,
                            handle_signals=False).start()
        answers[where] = [eng.serve(r) for r in reqs]
        eng.stop()
    for got, want in zip(answers["cuda"], answers["cpu"]):
        np.testing.assert_array_equal(got.items, want.items)
        if want.sem_ids is not None:
            np.testing.assert_array_equal(got.sem_ids, want.sem_ids)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["tiger", "cobra"])
def test_dense_route_on_the_card_matches_the_paged_route(card, name):
    """TIGER and COBRA each served on the card by an engine built with
    ``paged=False`` (one whole-generate call a micro-batch, no B1) and by a
    paged engine (B1 in every decode step), every request alone: sem-ids
    and items equal, scores within 1e-4 / T."""
    from genrec_tpu_torch.kernels.paged_attention import paged_attention_stats_cuda
    from genrec_tpu_torch.models.cobra import Cobra
    from genrec_tpu_torch.models.tiger import Tiger
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import CobraGenerativeHead, TigerGenerativeHead
    from genrec_tpu_torch.serving.kv_pool import PagedConfig
    from genrec_tpu_torch.serving.types import Request

    rng = np.random.default_rng(0)
    catalog = np.unique(rng.integers(0, 16, (80, 3)), axis=0)
    if name == "tiger":
        model = Tiger(embedding_dim=32, attn_dim=64, num_heads=2, n_layers=4,
                      num_item_embeddings=16, num_user_embeddings=50, sem_id_dim=3,
                      device=card, seed=0).eval()
        head = TigerGenerativeHead(model, catalog, top_k=5)
        paged_config, temperature = PagedConfig(max_slots=4, page_size=16, pages_per_slot=2), 0.2
    else:
        model = Cobra(encoder_n_layers=1, encoder_hidden_dim=32, encoder_num_heads=2,
                      encoder_vocab_size=60, id_vocab_size=16, n_codebooks=3, d_model=64,
                      max_len=64, temperature=0.2, decoder_n_layers=2, decoder_num_heads=2,
                      decoder_dropout=0.0, device=card, seed=0).eval()
        head = CobraGenerativeHead(model, item_sem_ids=catalog, top_k=5,
                                   item_text_tokens=rng.integers(1, 60, (len(catalog), 6)))
        paged_config, temperature = PagedConfig(max_slots=4, page_size=16, pages_per_slot=2), 1.0
    reqs = [Request(head=name, history=rng.integers(0, len(catalog), n), user_id=i)
            for i, n in enumerate((1, 3, 5, 8))]
    answers, launches = {}, {}
    for paged in (True, False):
        eng = ServingEngine([head], device=card, ladder=BucketLadder((1, 2), (4, 8)), max_batch=2,
                            handle_signals=False, paged=paged, paged_config=paged_config,
                            prefix_cache=False).start()
        paged_attention_stats_cuda.launches = 0
        answers[paged] = [eng.serve(r) for r in reqs]
        launches[paged] = paged_attention_stats_cuda.launches
        eng.stop()
    assert launches[True] > 0 and launches[False] == 0, launches
    for got, want in zip(answers[False], answers[True]):
        assert got.bucket == want.bucket
        np.testing.assert_array_equal(got.sem_ids, want.sem_ids)
        np.testing.assert_array_equal(got.items, want.items)
        np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-4 / temperature)
