"""The hand-written CUDA kernels on the card, held to their plain versions.

Needs an NVIDIA card of compute capability 9.0 (the kernels are built for
sm_90a) and the CUDA toolkit's nvcc; every test here is marked ``cuda``
and skips without them. This file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the
suite.) Tolerance for float32 inputs: rtol 1e-5, atol 1e-5. Kernel and
plain version both sum in fp32 and differ only in order (the paged kernel
runs an online softmax over 32-position chunks, the plain version one max
and one sum). The HSTU bias-table gradients sum every visible pair of the
batch, so they get rtol 1e-4. With bfloat16 inputs both sides accumulate
in fp32 and round the result to bfloat16, where another order can move
the rounding by one bfloat16 step: rtol and atol 1e-2. The int8 paged
kernel dequantises with the same product as its plain version, so it
too is held at 1e-5. The residual cascade's ids are held exactly outside
near ties (rows whose two nearest codewords are within 1e-5 x max |dist|,
where another summation order may pick the other one), and at most 2%
of the rows may be near ties; qsum 1e-5 of its largest element. The
vocab-sharded CE (B8) runs on 2 ranks sharing the card over gloo and is
held to its plain twin at 1e-5.
"""

import numpy as np
import pytest
import torch

from genrec_tpu_torch.kernels import fused_ce as fc
from genrec_tpu_torch.kernels import hstu_attention as ha
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
    ((3, 32, 1, 128, 40, 2), [80, 41, 0], False),  # K and hd at their limits
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
        dict(x, q=torch.zeros((2, 33, 2, 8), device=card)),  # K > 32
    ]
    for kwargs in bad:
        with pytest.raises(ValueError):
            paged_attention_stats_cuda(**kwargs)
    assert paged_attention_stats_cuda.launches == before


def _hstu_inputs(dev, B, H, L, hd, dtype, use_time, use_seg, seed=0):
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
@pytest.mark.parametrize("shape,use_time,use_seg", [
    ((4, 2, 50, 32), True, True),    # the trainer's layout: packed, timestamps
    ((4, 2, 50, 32), False, False),  # no timestamps, left padding
    ((3, 1, 77, 24), True, False),   # odd L over three 32-position tiles
    ((2, 2, 40, 128), True, True),   # hd at its limit
])
def test_hstu_kernels_match_plain_versions(card, shape, use_time, use_seg, dtype):
    x = _hstu_inputs(card, *shape, dtype, use_time, use_seg)
    fwd = {k: v for k, v in x.items() if k != "g"}
    launches = (ha.hstu_attention_fwd_cuda.launches, ha.hstu_attention_bwd_cuda.launches)
    got = ha.hstu_attention_fwd_cuda(**fwd)
    got_b = ha.hstu_attention_bwd_cuda(**x)
    torch.cuda.synchronize()
    assert (ha.hstu_attention_fwd_cuda.launches,
            ha.hstu_attention_bwd_cuda.launches) == (launches[0] + 1, launches[1] + 1)
    assert got.dtype == dtype and float(got[-1].float().abs().max()) == 0.0
    torch.testing.assert_close(got, ha.hstu_attention_ref(**fwd), **_tol(dtype))
    for name, g, w in zip(("dq", "dk", "dv", "dpos", "dtime"), got_b,
                          ha.hstu_attention_bwd_ref(**x)):
        if w is None:
            assert g is None and not use_time
            continue
        tol = dict(rtol=1e-4, atol=1e-4) if name.startswith(("dpos", "dtime")) else _tol(dtype)
        torch.testing.assert_close(g, w, msg=name, **tol)


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
    ((33, 65, 128), False),      # d at its limit
])
def test_fused_ce_kernels_match_plain_versions(card, shape, all_ignored, dtype):
    x = _ce_inputs(card, *shape, dtype, all_ignored)
    fwd = dict(x=x["x"], w=x["w"], targets=x["targets"])
    loss, lse = fc.fused_linear_ce_fwd_cuda(**fwd)
    want_loss, want_lse = fc.fused_linear_ce_ref(**fwd)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    bwd = dict(fwd, lse=want_lse, g=x["g"])
    counts = (fc.fused_linear_ce_dx_cuda.launches, fc.fused_linear_ce_dw_cuda.launches)
    dx, dw = fc.fused_linear_ce_dx_cuda(**bwd), fc.fused_linear_ce_dw_cuda(**bwd)
    torch.cuda.synchronize()
    assert (fc.fused_linear_ce_dx_cuda.launches,
            fc.fused_linear_ce_dw_cuda.launches) == (counts[0] + 1, counts[1] + 1)
    want_dx, want_dw = fc.fused_linear_ce_bwd_ref(**bwd)
    assert dx.dtype == dtype and dw.dtype == dtype
    torch.testing.assert_close(dx, want_dx, **_tol(dtype))
    torch.testing.assert_close(dw, want_dw, **_tol(dtype))
    if all_ignored:
        assert float(loss.abs().max()) == float(dx.abs().max()) == float(dw.abs().max()) == 0


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
    ((3, 32, 1, 128, 40, 2), [80, 41, 0], False),  # K and hd at their limits
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


@pytest.mark.parametrize("B,L,K,D,dup", [
    (4096, 3, 256, 32, False),   # one export chunk at the RQ-VAE's widths
    (1000, 3, 256, 32, False),   # B not a multiple of the 32-row block
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


def test_rq_cascade_wrapper_refuses_what_it_does_not_take(card):
    x = torch.zeros((8, 16), device=card)
    cb = torch.zeros((3, 32, 16), device=card)
    before = rq.rq_cascade_cuda.launches
    for bx, bcb in ((x.double(), cb), (x, cb[:, :, :8].contiguous()), (x.cpu(), cb),
                    (x, cb.transpose(1, 2))):
        with pytest.raises(ValueError):
            rq.rq_cascade_cuda(bx, bcb)
    assert rq.rq_cascade_cuda.launches == before
