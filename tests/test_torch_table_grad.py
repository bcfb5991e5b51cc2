"""The table-lookup gradient (``kernels.table_grad``) against JAX.

``models.t5transformer._TableLookup`` reads TIGER's relative-bias grid with
``table.reshape(-1)[idx]``; its backward sums each entry's gradient in one
histogram pass, through ``kernels.table_grad`` (the fixed-order CUDA
kernel on the card, ``torch.bincount`` on the CPU). Here the CPU twin is
held to ``jax.grad`` of the same gather on numpy-seeded inputs, at 1e-5
relative to the largest entry (fp32 on both sides, sums in other orders),
at a small grid and at tiger.gin's 6 heads x 32 buckets. The kernel itself
is held to fp64 sums on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.models.t5transformer import T5Attention as JaxT5Attention
from genrec_tpu_torch.kernels.table_grad import table_grad, table_grad_cuda, table_grad_ref
from genrec_tpu_torch.models.t5transformer import T5Attention, _TableLookup


def _case(seed, n, bins):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(bins, 1)).astype(np.float32)
    idx = rng.integers(0, bins, n).astype(np.int64)
    g = rng.normal(size=n).astype(np.float32)
    return table, idx, g


@pytest.mark.parametrize("n, bins", [(1, 4), (1000, 7), (200_000, 192)])
def test_twin_matches_jax_grad_of_the_gather(n, bins):
    table, idx, g = _case(n, n, bins)
    want = jax.grad(lambda t: jnp.sum(t.reshape(-1)[jnp.asarray(idx)] * jnp.asarray(g)))(
        jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    out = _TableLookup.apply(t, torch.as_tensor(idx))
    (out * torch.as_tensor(g)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_rel_bias_gradient_matches_jax():
    """The bias grid's gradient through a whole T5 self-attention at
    tiger.gin's head and bucket counts, packed positions included."""
    rng = np.random.default_rng(3)
    d, H, B, L = 48, 6, 2, 13
    x = rng.normal(size=(B, L, d)).astype(np.float32)
    pos = np.stack([np.r_[np.arange(5), np.arange(8)], np.arange(L)]).astype(np.int32)
    jm = JaxT5Attention(d_model=d, n_heads=H)
    params = jm.init(jax.random.key(0), jnp.asarray(x), positions=jnp.asarray(pos))["params"]

    def jloss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x), positions=jnp.asarray(pos)) ** 2)

    want = np.asarray(jax.grad(jloss)(params)["rel_bias"])
    tm = T5Attention(d, H, device="cpu")
    with torch.no_grad():
        tm.q.weight.copy_(torch.as_tensor(np.asarray(params["q"]["kernel"]).T))
        tm.kv.weight.copy_(torch.as_tensor(np.asarray(params["kv"]["kernel"]).T))
        tm.o.weight.copy_(torch.as_tensor(np.asarray(params["o"]["kernel"]).T))
        tm.rel_bias.copy_(torch.as_tensor(np.asarray(params["rel_bias"])))
    (tm(torch.as_tensor(x), positions=torch.as_tensor(pos).long()) ** 2).sum().backward()
    np.testing.assert_allclose(tm.rel_bias.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_routes_by_device_and_the_kernel_wrapper_refuses_cpu_tensors():
    _, idx, g = _case(0, 50, 5)
    idx, g = torch.as_tensor(idx), torch.as_tensor(g)
    torch.testing.assert_close(table_grad(idx, g, 5), table_grad_ref(idx, g, 5))
    before = table_grad_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        table_grad_cuda(idx, g, 5)
    assert table_grad_cuda.launches == before
