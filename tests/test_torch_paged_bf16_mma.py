"""The numerics of the bf16-q paged attention kernel on the CPU.

B1 over bf16 pages and B2 over int8 pages with a bf16 q run
``paged_attention_mma_kernel`` of genrec_tpu_torch/csrc/paged_attention.cu,
which only the card runs (tests/test_torch_cuda.py holds it to the plain
versions there). Its arithmetic departs from the plain versions' in four
places, each held here:

- int8 K and V enter the bf16 tensor cores as bf16: every int8 value is
  exact in bf16;
- an int8 row's scale multiplies the fp32 dot (scale * (q . k8)), where
  the plain version dots q with the dequantised row (q . (k8 * scale));
- the fp32 weights e enter e.V as three bf16 planes (hi, mid, lo), which
  carry every bit of e, where two would miss the 1e-5 elementwise bound;
- the nodes (beams, or a speculative tree's nodes) are cut into 16-row
  tiles and the tiles spread over blocks, and a row's result must not
  depend on that cut.

``_mma_emulation`` repeats the kernel's walk in torch with its tile sizes
(16-node tiles, 64-position stages, the online softmax across stages, e
split into planes, the rows still within 128 of -1e9 given the masked
positions in closed form). It is held to the plain versions at 1e-5 of
max |plain| and elementwise at rtol = atol = 1e-5, as on the card, and to
JAX's Pallas kernels in interpret mode (the TPU kernels the CUDA kernel
replaces) at atol 1e-5, as tests/test_torch_bf16_serving.py holds the
plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.kernels.paged_attention import (
    paged_attention_stats_pallas,
    paged_attention_stats_pallas_quantized,
)
from genrec_tpu.ops.quant import QuantizedKVPool as JaxQuantizedKVPool
from genrec_tpu_torch.kernels import paged_attention as pa
from genrec_tpu_torch.ops.quant import QuantizedKVPool, quantize_symmetric

torch.set_num_threads(1)

BF16 = torch.bfloat16
TOL = 1e-5
NEG = -1e9
ROWS, STAGE = 16, 64  # a tile's nodes, a stage's positions
NODES, STREAM_NODES = 128, 64  # nodes a block at most (positions in the ring / streaming)
RING_BYTES, MAX_STAGES = 72 * 1024, 4


def _bf16_planes(w, n):
    """``w`` (fp32) as ``n`` bf16-exact fp32 planes, each the bf16 rounding
    of what the planes before it left, as the kernel splits e."""
    planes, rest = [], w
    for _ in range(n):
        plane = rest.to(BF16).float()
        planes.append(plane)
        rest = rest - plane
    return planes


def _streams(hd, page, Pm, int8):
    """Whether a slot's positions stream through the kernel's ring: more
    64-position stages than fit its 72 KB."""
    HD = 32 if hd <= 32 else 64 if hd <= 64 else 128
    row = HD * (1 if int8 else 2) + 16
    stage = 2 * STAGE * row + (8 * STAGE if int8 else 0)
    need = -(-Pm * page // STAGE)
    return max(1, min(MAX_STAGES, RING_BYTES // stage)) < need


def _nodes_per_block(K, streams):
    most = STREAM_NODES if streams else NODES
    blocks = -(-K // most)
    return -(-(-(-K // blocks)) // ROWS) * ROWS


def _mma_emulation(q, k_pool, v_pool, block_tables, seq_lens, nodes=None):
    """The kernel's (acc, m, l) in torch: for each (slot, head), the nodes
    in blocks of ``nodes`` (the kernel's rule by default) and 16-row
    tiles; each tile walks the live positions in 64-position stages (q.k
    in fp32 from exact bf16 values; an int8 row's scale on the dot), an
    online softmax across stages, e.V with e (times v_scale for int8) in
    three bf16 planes; then the rows whose max is within 128 of -1e9 take
    the masked positions (each scoring exactly -1e9) in closed form."""
    int8 = isinstance(k_pool, QuantizedKVPool)
    S, K, H, hd = q.shape
    Pm = block_tables.shape[1]
    kd = k_pool.data if int8 else k_pool
    P, page = kd.shape[:2]
    cap = Pm * page
    idx = block_tables.long().clamp(0, P - 1)

    def rows(pool):
        data = pool.data if int8 else pool
        vals = data[idx].float().reshape(S, cap, H, hd)
        scales = (pool.scale[idx].reshape(S, cap) if int8 else torch.ones(S, cap))
        return vals, scales

    kv, ks = rows(k_pool)
    vv, vs = rows(v_pool)
    nodes = nodes or _nodes_per_block(K, _streams(hd, page, Pm, int8))
    scale = hd ** -0.5
    acc = torch.empty(S, K, H, hd)
    m_out = torch.empty(S, K, H)
    l_out = torch.empty(S, K, H)
    for s in range(S):
        sl = int(seq_lens[s])
        live = min(sl, cap) if sl > 0 else cap
        for h in range(H):
            for b0 in range(0, K, nodes):
                for t0_node in range(b0, min(b0 + nodes, K), ROWS):
                    tile = torch.zeros(ROWS, hd)
                    n_rows = min(ROWS, min(b0 + nodes, K) - t0_node)
                    tile[:n_rows] = q[s, t0_node:t0_node + n_rows, h].float()
                    m = torch.full((ROWS,), -float("inf"))
                    l = torch.zeros(ROWS)
                    o = torch.zeros(ROWS, hd)
                    for t0 in range(0, live, STAGE):
                        n = min(STAGE, live - t0)
                        k_st, v_st = kv[s, t0:t0 + n, h], vv[s, t0:t0 + n, h]
                        dot = (tile[:, None, :] * k_st[None, :, :]).sum(-1)
                        sc = dot * ks[s, t0:t0 + n] * scale if int8 else dot * scale
                        pos = torch.arange(t0, t0 + n)
                        sc = torch.where(pos[None, :] >= sl, torch.tensor(NEG), sc)
                        m_new = torch.maximum(m, sc.amax(-1))
                        corr = torch.exp(m - m_new)
                        p = torch.exp(sc - m_new[:, None])
                        l = l * corr + p.sum(-1)
                        w = p * vs[s, t0:t0 + n] if int8 else p
                        o = o * corr[:, None] + sum(pl @ v_st for pl in _bf16_planes(w, 3))
                        m = m_new
                    low = m <= NEG + 128
                    if live < cap and bool(low.any()):
                        vsum = (vv[s, live:cap, h] * vs[s, live:cap, None]).sum(0)
                        m_new = torch.maximum(m, torch.tensor(NEG))
                        corr, e = torch.exp(m - m_new), torch.exp(NEG - m_new)
                        o = torch.where(low[:, None], o * corr[:, None] + e[:, None] * vsum, o)
                        l = torch.where(low, l * corr + (cap - live) * e, l)
                        m = torch.where(low, m_new, m)
                    sel = slice(t0_node, t0_node + n_rows)
                    acc[s, sel, h], m_out[s, sel, h], l_out[s, sel, h] = (
                        o[:n_rows], m[:n_rows], l[:n_rows])
    return acc, m_out, l_out


def _inputs(seed, S, K, H, hd, page, Pm, seq_lens, int8, null_tail=True):
    """bf16 q and pools (or int8 pools quantised from the bf16 values),
    slot s owning pages 1 + s*Pm ..; with ``null_tail`` entries past a
    slot's last used page point at the null page 0."""
    rng = np.random.default_rng(seed)
    P = 1 + S * Pm
    bt = (1 + np.arange(S * Pm)).reshape(S, Pm).astype(np.int32)
    if null_tail:
        used = -(-np.maximum(np.asarray(seq_lens), 1) // page)
        bt[np.arange(Pm)[None, :] >= used[:, None]] = 0
    t = lambda a: torch.as_tensor(a.astype(np.float32)).to(BF16)  # noqa: E731
    x = dict(q=t(rng.normal(size=(S, K, H, hd))), k_pool=t(rng.normal(size=(P, page, H, hd))),
             v_pool=t(rng.normal(size=(P, page, H, hd))), block_tables=torch.as_tensor(bt),
             seq_lens=torch.as_tensor(np.asarray(seq_lens, np.int32)))
    if int8:
        for name in ("k_pool", "v_pool"):
            x[name] = QuantizedKVPool(*quantize_symmetric(x[name], (-2, -1)))
    return x


def _near_neg(seed, S, K, H, page, Pm, seq_lens, int8):
    """Scores exact in any order (q and K integers, hd 64) with each node's
    live max at -1e9 - 64, -1e9 or -1e9 + 64: the -8e9 offset split over
    q's first four dims in bf16-exact terms, K 1 there. The kernel must
    give these rows the masked positions."""
    hd = 64
    x = _inputs(seed, S, K, H, hd, page, Pm, seq_lens, False, null_tail=False)
    rng = np.random.default_rng(seed)
    bt = x["block_tables"].numpy()
    P, cap = x["k_pool"].shape[0], Pm * page
    k = rng.integers(-1, 2, size=(P, page, H, hd)).astype(np.float32)
    k[..., :4] = 1.0
    qn = rng.integers(-1, 2, size=(S, K, H, hd)).astype(np.float32)
    qn[..., :4] = 0.0
    sums = np.einsum("skhd,slhd->skhl", qn, k[bt].reshape(S, cap, H, hd))
    lens = np.asarray(seq_lens)
    live = np.arange(cap)[None, :] < np.where(lens > 0, np.minimum(lens, cap), cap)[:, None]
    top = np.where(live[:, None, None, :], sums, -(10**6)).max(-1)
    qv = 512.0 * qn
    rest = (-8e9 - 512.0 * (top - rng.integers(-1, 2, size=top.shape))).astype(np.float64)
    for i in range(4):  # bf16-exact terms summing to the offset
        term = torch.as_tensor(rest, dtype=torch.float32).to(BF16).float().numpy()
        qv[..., i] = term
        rest = rest - term
    assert (rest == 0).all()
    x["q"] = torch.as_tensor(qv).to(BF16)
    assert torch.equal(x["q"].float(), torch.as_tensor(qv, dtype=torch.float32))
    x["k_pool"] = torch.as_tensor(k).to(BF16)
    if int8:
        x["k_pool"] = QuantizedKVPool(torch.as_tensor(k.astype(np.int8)), torch.ones((P, page)))
        x["v_pool"] = QuantizedKVPool(*quantize_symmetric(x["v_pool"], (-2, -1)))
    return x


def _plain(x):
    if isinstance(x["k_pool"], QuantizedKVPool):
        return pa.paged_attention_stats_quantized_ref(**x)
    return pa.paged_attention_stats_ref(**x)


def _assert_kernel_tolerance(got, want, what):
    for name, g, w in zip(("acc", "m", "l"), got, want):
        err = float((g - w).abs().max())
        assert err <= TOL * float(w.abs().max()), (what, name, err)
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL, msg=f"{what}/{name}")


def test_int8_values_round_trip_through_bf16_exactly():
    """Every int8 value is exact in bf16 (|x| <= 127 needs at most 7 of its
    8 significant bits), and the kernel's conversion gets it: the byte xor
    0x80 in the low bits of 2^23's float bits, less 2^23 + 128, is the
    value, and that float's top half is its bf16."""
    v = torch.arange(-127, 128, dtype=torch.int8)
    assert torch.equal(v.to(BF16).float(), v.float())
    u = (v.numpy().view(np.uint8) ^ 0x80).astype(np.uint32)
    f = (u | np.uint32(0x4B000000)).view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, v.numpy().astype(np.float32))
    top = (f.view(np.uint32) >> 16).astype(np.uint16)
    as_bf16 = torch.from_numpy(top.view(np.int16)).view(BF16).float()
    assert torch.equal(as_bf16, v.float())


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_row_scale_after_the_dot_matches_the_dequantised_dot(hd):
    """scale * (q . k8) * hd^-0.5, the kernel's order, against (q . (k8 *
    scale)) * hd^-0.5, the plain version's, over seeded bf16 q and int8 rows
    with their quantisation scales: within 1e-5 of max |plain|."""
    rng = np.random.default_rng(hd)
    q = torch.as_tensor(rng.normal(size=(64, hd)).astype(np.float32)).to(BF16).float()
    rows = torch.as_tensor(rng.normal(size=(80, hd)).astype(np.float32)).to(BF16)
    k8, ks = quantize_symmetric(rows, (-1,))
    kernel = (q @ k8.float().T) * ks[None, :] * hd ** -0.5
    plain = (q @ (k8.float() * ks[:, None]).T) * hd ** -0.5
    assert float((kernel - plain).abs().max()) <= TOL * float(plain.abs().max())


def test_three_bf16_planes_carry_fp32_weights_exactly():
    """e split into hi + mid + lo bf16 planes reproduces fp32 e.V within
    1e-5 of max |plain| and elementwise, on seeded weights that include e
    near 1, mid-range and near the subnormal edge: the planes sum to e
    exactly down to 2^-100 (3 x 8 significant bits hold fp32's 24), and
    lose less than bf16's smallest subnormal (2^-133) below; their
    products with bf16 V are exact in fp32."""
    rng = np.random.default_rng(0)
    e = rng.uniform(0, 1, size=(16, 64)).astype(np.float32)
    e[:, 0] = 1.0
    e[:, 1] = np.nextafter(np.float32(1.0), np.float32(0.0))
    e[:, 2] = np.float32(1.2e-38)  # the smallest normal's neighbourhood
    e[:, 3] = np.float32(3e-39)  # subnormal
    e[:, 4] = np.exp(rng.uniform(-80, 0, size=16)).astype(np.float32)
    e = torch.as_tensor(e)
    v = torch.as_tensor(rng.normal(size=(64, 128)).astype(np.float32)).to(BF16).float()
    planes = _bf16_planes(e, 3)
    total = planes[0] + planes[1] + planes[2]
    normal = e >= 2.0 ** -100
    assert torch.equal(total[normal], e[normal])
    assert float((total - e).abs().max()) < 2.0 ** -133
    got = sum(p.double() @ v.double() for p in planes)
    want = e @ v
    _assert_kernel_tolerance((got.float(),), (want,), "planes")


def test_two_bf16_planes_miss_the_elementwise_bound():
    """Why three: at TIGER's serving width (hd 64, 64 positions, scores of
    unit spread) two planes (~16 bits of e) leave e.V beyond rtol = atol =
    1e-5 somewhere, though within 1e-5 of max |plain|; three do not."""
    rng = np.random.default_rng(1)
    s = torch.as_tensor(rng.normal(size=(640, 64)).astype(np.float32))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    v = torch.as_tensor(rng.normal(size=(64, 64)).astype(np.float32)).to(BF16).float()
    want = e.double() @ v.double()
    bound = 1e-5 + 1e-5 * want.abs()
    two = sum(p.double() @ v.double() for p in _bf16_planes(e, 2))
    three = sum(p.double() @ v.double() for p in _bf16_planes(e, 3))
    assert bool(((two - want).abs() > bound).any())
    assert float((two - want).abs().max()) <= TOL * float(want.abs().max())
    assert bool(((three - want).abs() <= bound).all())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
def test_node_rows_do_not_depend_on_the_split(int8):
    """TIGER's speculative tree (730 nodes; hd 64, Pm 4 at one head): the
    kernel's cut, 6 blocks of <= 128 nodes in 16-node tiles, gives every
    node the bits it gets in blocks of 16, 64 or 256 nodes, or alone in a
    32-node call; and stays within the plain version's tolerance."""
    assert _nodes_per_block(730, False) == 128 and -(-730 // 128) == 6
    x = _inputs(2, 1, 730, 1, 64, 16, 4, [37], int8)
    got = _mma_emulation(**x)
    for nodes in (16, 64, 256):
        other = _mma_emulation(**x, nodes=nodes)
        assert all(torch.equal(a, b) for a, b in zip(got, other)), nodes
    part = _mma_emulation(**dict(x, q=x["q"][:, 32:64].contiguous()))
    assert all(torch.equal(a, b[:, 32:64]) for a, b in zip(part, got))
    _assert_kernel_tolerance(got, _plain(x), "tree")


# name: (S, K, H, hd, page, Pm, seq_lens, null tail): the kernel's paths.
CASES = {
    "tiger_serving": (4, 10, 2, 64, 16, 4, [37, 4, 64, 19], True),
    "cobra_k20_hd128": (3, 20, 1, 128, 16, 5, [80, 33, 9], True),
    "seq_len_0_partial_pages": (5, 3, 2, 8, 8, 3, [24, 0, 9, 1, 17], True),
    "hd48_k37": (2, 37, 1, 48, 16, 4, [64, 21], True),
    "over_cap": (2, 10, 1, 64, 16, 4, [100, 64], False),
    "streams_8_stages": (2, 10, 1, 128, 16, 32, [400, 130], False),
}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mma_emulation_matches_the_plain_versions(case, int8):
    S, K, H, hd, page, Pm, lens, null_tail = CASES[case]
    x = _inputs(3, S, K, H, hd, page, Pm, lens, int8, null_tail)
    _assert_kernel_tolerance(_mma_emulation(**x), _plain(x), case)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("lens", [[40, 5, 17], [64, 80]], ids=["partial", "full"])
def test_mma_emulation_walks_the_masked_positions_near_minus_1e9(lens, int8):
    """Every node's live max within 128 of -1e9: the masked positions, in
    closed form, against the plain version over all of them."""
    x = _near_neg(4, len(lens), 10, 2, 16, 4, lens, int8)
    _assert_kernel_tolerance(_mma_emulation(**x), _plain(x), "near -1e9")


def _jax_args(x):
    def conv(v):
        if isinstance(v, QuantizedKVPool):
            return JaxQuantizedKVPool(jnp.asarray(v.data.numpy()), jnp.asarray(v.scale.numpy()))
        if v.dtype == BF16:
            return jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(v.numpy())

    return {k: conv(v) for k, v in x.items()}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
def test_mma_emulation_matches_the_pallas_kernels(int8):
    """Against the TPU kernels the CUDA kernel replaces, in interpret mode,
    on the same bf16 values: a free slot, a partial one and a full one."""
    x = _inputs(5, 3, 4, 2, 32, 8, 3, [0, 11, 24], int8)
    kernel = paged_attention_stats_pallas_quantized if int8 else paged_attention_stats_pallas
    want = kernel(**_jax_args(x), interpret=True)
    for name, g, w in zip(("acc", "m", "l"), _mma_emulation(**x), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
