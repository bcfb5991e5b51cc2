"""Fused linear cross-entropy, port against the JAX package.

genrec_tpu_torch/kernels/fused_ce.py pairs with
genrec_tpu/kernels/fused_ce.py: the plain forward (``fused_linear_ce_ref``)
with the Pallas forward run in interpret mode (as the JAX package's own
tests run it) and with ``linear_ce_xla``; the plain backward
(``fused_linear_ce_bwd_ref``) with the Pallas backward; the port's
``fused_ce_mean_loss`` gradients with ``jax.grad`` through the JAX
``custom_vjp``. Inputs come from a numpy seed and go to both sides.

Tolerance: 1e-5 absolute plus 1e-5 relative, fp32 on both sides (the
Pallas kernels take an online logsumexp over 512-column tiles, the plain
version one max and one sum).
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.kernels import fused_ce as jf
from genrec_tpu_torch.kernels import fused_ce as tf

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test fails after 120 s instead of hanging."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _inputs(R=300, V=1000, d=48, seed=0, ignore_frac=0.2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, d)).astype(np.float32)
    w = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    tgt = rng.integers(0, V, size=(R,)).astype(np.int32)
    tgt[rng.random(R) < ignore_frac] = 0  # ignore_index rows
    g = rng.normal(size=(R,)).astype(np.float32)
    return x, w, tgt, g


# V = 1000 and 700 are not multiples of the Pallas kernel's 512-column
# tile (nor 1000 of the CUDA kernel's 64); R = 37 is not a multiple of
# either kernel's row tile.
SHAPES = [(300, 1000, 48), (37, 700, 64), (128, 512, 32)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_twin_matches_pallas_and_xla(shape):
    x, w, tgt, _ = _inputs(*shape)
    loss, lse = tf.fused_linear_ce_ref(torch.as_tensor(x), torch.as_tensor(w),
                                       torch.as_tensor(tgt))
    want_loss, want_lse = jf.fused_linear_ce_fwd(jnp.asarray(x), jnp.asarray(w),
                                                 jnp.asarray(tgt), interpret=True)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    xla = jf.linear_ce_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(tgt))
    np.testing.assert_allclose(loss.numpy(), np.asarray(xla), **TOL)
    assert (loss.numpy()[tgt == 0] == 0).all()


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_backward_twin_matches_pallas(shape):
    x, w, tgt, g = _inputs(*shape, seed=1)
    _, lse = jf.fused_linear_ce_fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(tgt),
                                    interpret=True)
    want = jf.fused_linear_ce_bwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(tgt), lse,
                                  jnp.asarray(g), interpret=True)
    args = (torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(tgt),
            torch.tensor(np.asarray(lse)), torch.as_tensor(g))
    got = tf.fused_linear_ce_bwd_ref(*args)
    for name, a, b in zip(("dx", "dW"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    # The dx and dW kernels' own plain versions give the same.
    torch.testing.assert_close(tf.fused_linear_ce_dx_ref(*args), got[0], rtol=0, atol=0)
    torch.testing.assert_close(tf.fused_linear_ce_dw_ref(*args), got[1], rtol=0, atol=0)


def test_all_rows_ignored():
    x, w, _, g = _inputs(R=64, V=300, d=16, seed=2)
    tgt = np.zeros(64, np.int32)
    xt, wt, tt = torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(tgt)
    loss, lse = tf.fused_linear_ce_ref(xt, wt, tt)
    want_loss, want_lse = jf.fused_linear_ce_fwd(jnp.asarray(x), jnp.asarray(w),
                                                 jnp.asarray(tgt), interpret=True)
    assert float(loss.abs().max()) == 0.0 == float(jnp.abs(want_loss).max())
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    dx, dw = tf.fused_linear_ce_bwd_ref(xt, wt, tt, lse, torch.as_tensor(g))
    assert float(dx.abs().max()) == 0.0 and float(dw.abs().max()) == 0.0
    mean = tf.fused_ce_mean_loss(xt.requires_grad_(), wt, tt)
    mean.backward()
    assert float(mean.detach()) == 0.0 and float(xt.grad.abs().max()) == 0.0


def test_mean_loss_grads_match_jax_grad():
    """fused_ce_mean_loss over (B, L, d) activations, its value and its
    gradients in x and in the head, against jax.grad of the JAX
    fused_ce_mean_loss (Pallas forward and backward, interpret mode)."""
    x, w, tgt, _ = _inputs(R=4 * 25, V=900, d=32, seed=3)
    x, tgt = x.reshape(4, 25, 32), tgt.reshape(4, 25)

    def jax_loss(x, w):
        return jf.fused_ce_mean_loss(x, w, jnp.asarray(tgt))

    want, (want_dx, want_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.as_tensor(x).requires_grad_(), torch.as_tensor(w).requires_grad_()
    launches = tf.fused_linear_ce_fwd_cuda.launches
    got = tf.fused_ce_mean_loss(xt, wt, torch.as_tensor(tgt))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw), **TOL)
    assert tf.fused_linear_ce_fwd_cuda.launches == launches  # plain versions on the CPU


def test_kernel_wrappers_refuse_cpu_tensors():
    x, w, tgt, g = (torch.as_tensor(a) for a in _inputs(R=8, V=20, d=4))
    lse = torch.zeros(8)
    before = [f.launches for f in (tf.fused_linear_ce_fwd_cuda, tf.fused_linear_ce_dx_cuda,
                                   tf.fused_linear_ce_dw_cuda)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tf.fused_linear_ce_fwd_cuda(x, w, tgt)
    for fn in (tf.fused_linear_ce_dx_cuda, tf.fused_linear_ce_dw_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, w, tgt, lse, g)
    assert [f.launches for f in (tf.fused_linear_ce_fwd_cuda, tf.fused_linear_ce_dx_cuda,
                                 tf.fused_linear_ce_dw_cuda)] == before


def _jax_fwd_bwd(x, w, tgt, g, ignore_index, vlim=None):
    """JAX forward and backward (Pallas, interpret mode), one jit."""

    @jax.jit
    def run(x, w, t, g):
        loss, lse = jf.fused_linear_ce_fwd(x, w, t, ignore_index, interpret=True, vlim=vlim)
        dx, dw = jf.fused_linear_ce_bwd(x, w, t, lse, g, ignore_index, interpret=True,
                                        vlim=vlim)
        return loss, lse, dx, dw

    return [np.asarray(a) for a in run(*(jnp.asarray(a) for a in (x, w, tgt, g)))]


def _port_fwd_bwd(x, w, tgt, g, ignore_index, vlim=None):
    args = (torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(tgt))
    loss, lse = tf.fused_linear_ce_ref(*args, ignore_index, vlim)
    dx = tf.fused_linear_ce_dx_ref(*args, lse, torch.as_tensor(g), ignore_index, vlim)
    dw = tf.fused_linear_ce_dw_ref(*args, lse, torch.as_tensor(g), ignore_index, vlim)
    return [a.numpy() for a in (loss, lse, dx, dw)]


@pytest.mark.parametrize("ignore_index,outside", [(-100, -100), (-2, -1)],
                         ids=["ignored_minus_100", "other_shard_minus_1"])
def test_targets_outside_the_vocab_match_pallas(ignore_index, outside):
    """A target outside [0, V) has target logit 0 and no one-hot column
    (the Pallas sum-select): -100 targets at ignore_index=-100 (LCRec's
    SFT labels) and -1 targets at ignore_index=-2 (B8's targets held on
    another shard, not ignored). The plain versions used to raise on
    them (an out-of-range gather)."""
    x, w, tgt, g = _inputs(R=70, V=300, d=24, seed=4)
    tgt[::3] = outside
    got = _port_fwd_bwd(x, w, tgt, g, ignore_index)
    want = _jax_fwd_bwd(x, w, tgt, g, ignore_index)
    for name, a, b in zip(("loss", "lse", "dx", "dW"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    if ignore_index == -2:  # not ignored: the loss is the whole lse
        np.testing.assert_allclose(got[0][::3], got[1][::3], **TOL)


@pytest.mark.parametrize("vlim", [250, 0], ids=["pad_rows", "empty"])
def test_vlim_matches_pallas(vlim):
    """Columns at or past vlim read -1e30 inside the softmax (JAX
    ``_tile_logits``); vlim 0 is a shard of pad rows only."""
    x, w, tgt, g = _inputs(R=45, V=300, d=32, seed=5)
    tgt = np.where(tgt > 0, tgt % max(vlim, 1), 0).astype(np.int32)
    if vlim == 0:
        tgt[tgt > 0] = -1
    got = _port_fwd_bwd(x, w, tgt, g, 0, vlim)
    want = _jax_fwd_bwd(x, w, tgt, g, 0, vlim)
    for name, a, b in zip(("loss", "lse", "dx", "dW"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    if vlim:
        ref = jf.linear_ce_xla(jnp.asarray(x), jnp.asarray(w[:vlim]), jnp.asarray(tgt))
        np.testing.assert_allclose(got[0], np.asarray(ref), atol=1e-4, rtol=1e-5)
        assert np.abs(got[3][vlim:]).max() == 0.0  # pad rows: exactly zero dW


def test_lcrec_width_matches_pallas():
    """d = 1536 (the Qwen2.5-1.5B hidden state) at small R and V, with a
    live-vocab limit."""
    x, w, tgt, g = _inputs(R=20, V=130, d=1536, seed=6)
    x /= np.sqrt(1536.0)
    tgt = np.minimum(tgt, 119).astype(np.int32)
    got = _port_fwd_bwd(x, w, tgt, g, 0, 120)
    want = _jax_fwd_bwd(x, w, tgt, g, 0, 120)
    for name, a, b in zip(("loss", "lse", "dx", "dW"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
