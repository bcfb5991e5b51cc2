"""Paged decode attention, port against the JAX package.

genrec_tpu_torch/kernels/paged_attention.py pairs with
genrec_tpu/kernels/paged_attention.py, and genrec_tpu_torch/ops/paged.py
with genrec_tpu/ops/paged.py. The port's plain version
(``paged_attention_stats_ref``) is held to the JAX Pallas kernel, run in
interpret mode as tests/test_kv_pool.py runs it, and to the JAX gather
fallback ``_stats_fallback``. Tolerance: atol 1e-5 on acc, m and l (fp32
on both sides; only the summation order differs). The CUDA kernel itself
is held to the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.kernels.paged_attention import paged_attention_stats_pallas
from genrec_tpu.ops import paged as jpaged
from genrec_tpu_torch.kernels.paged_attention import (
    paged_attention_stats_cuda,
    paged_attention_stats_ref,
)
from genrec_tpu_torch.ops import paged as tpaged

torch.set_num_threads(1)

# Block tables and seq_lens of three layouts. "mixed": slots of different
# lengths, short rows padded with the null page 0. "masked": a free slot
# (seq_len 0, every entry the null page) beside live ones. "full": every
# slot uses every page to the last position.
CASES = {
    "mixed": ([[1, 2, 3], [4, 0, 0], [5, 6, 0], [7, 8, 9]], [24, 3, 9, 17]),
    "masked": ([[1, 2, 3], [0, 0, 0], [5, 6, 0], [7, 8, 0]], [20, 0, 16, 1]),
    "full": ([[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 3]], [24, 24, 24, 24]),
}


def _inputs(seed, case, K=5, H=3, hd=8, page=8, P=12):
    rng = np.random.default_rng(seed)
    bt, sl = (np.asarray(x, np.int32) for x in CASES[case])
    S = bt.shape[0]
    return dict(
        q=rng.normal(size=(S, K, H, hd)).astype(np.float32),
        k_pool=rng.normal(size=(P, page, H, hd)).astype(np.float32),
        v_pool=rng.normal(size=(P, page, H, hd)).astype(np.float32),
        block_tables=bt,
        seq_lens=sl,
    )


def _as(fn, x):
    return {k: fn(v) for k, v in x.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats_ref_matches_pallas_kernel_and_fallback(case):
    x = _inputs(0, case)
    want_kernel = paged_attention_stats_pallas(**_as(jnp.asarray, x))
    want_fallback = jpaged._stats_fallback(**_as(jnp.asarray, x))
    got = paged_attention_stats_ref(**_as(torch.as_tensor, x))
    for name, g, wk, wf in zip(("acc", "m", "l"), got, want_kernel, want_fallback):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(wf), atol=1e-5, err_msg=name)


def test_fully_masked_slot_is_the_mean_of_v_over_all_positions():
    """The -1e9 fill keeps masked positions inside the softmax: a slot
    with seq_len 0 weighs every one of its Pm*page positions equally,
    null page included."""
    x = _as(torch.as_tensor, _inputs(1, "masked"))
    out = tpaged.paged_attention(**x)
    pages = x["block_tables"][1].long()
    mean_v = x["v_pool"][pages].reshape(-1, *x["v_pool"].shape[2:]).mean(0)
    torch.testing.assert_close(out[1], mean_v.expand_as(out[1]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["mixed", "masked"])
def test_paged_attention_matches_jax(case):
    x = _inputs(2, case)
    want = jpaged.paged_attention(**_as(jnp.asarray, x), use_kernel=False)
    got = tpaged.paged_attention(**_as(torch.as_tensor, x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    x = _as(torch.as_tensor, _inputs(3, "mixed"))
    before = paged_attention_stats_cuda.launches
    for a, b in zip(tpaged.paged_attention_stats(**x), paged_attention_stats_ref(**x)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert paged_attention_stats_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back: a tensor that is not on the card is
    an error, and nothing is counted as a launch."""
    x = _as(torch.as_tensor, _inputs(4, "mixed"))
    before = paged_attention_stats_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_attention_stats_cuda(**x)
    assert paged_attention_stats_cuda.launches == before


def test_gather_and_write_pages_match_jax():
    rng = np.random.default_rng(5)
    P, page, H, hd = 9, 4, 2, 3
    bt = np.asarray([[3, 1, 0], [2, 5, 7]], np.int32)
    kv = rng.normal(size=(2, H, 10, hd)).astype(np.float32)  # L=10 < 3*4
    pool = rng.normal(size=(P, page, H, hd)).astype(np.float32)
    want = np.asarray(jpaged.write_pages(jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(kv)))
    got_pool = torch.as_tensor(pool.copy())
    got = tpaged.write_pages(got_pool, torch.as_tensor(bt), torch.as_tensor(kv))
    assert got is got_pool  # updated in place
    # Page 0 absorbs both rows' padded tails in an unspecified order; it
    # is never read unmasked, so only the real pages are compared.
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    np.testing.assert_array_equal(
        tpaged.gather_pages(torch.as_tensor(pool), torch.as_tensor(bt)).numpy(),
        np.asarray(jpaged.gather_pages(jnp.asarray(pool), jnp.asarray(bt))),
    )
    with pytest.raises(ValueError, match="exceeds"):
        tpaged.write_pages(got_pool, torch.as_tensor(bt[:, :2]), torch.as_tensor(kv))
