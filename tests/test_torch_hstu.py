"""The HSTU model, port against the JAX package.

genrec_tpu_torch/models/hstu.py pairs with genrec_tpu/models/hstu.py: the
same Flax init is carried across by ``convert.hstu_params_from_flax`` and
both models see the same numpy-seeded batches, left-padded with
timestamps (the eval layout) and packed with segment ids (the training
layout). Both flag settings are covered: ``use_pallas=fused_ce=False``
(materialised bias and logits) and ``True`` (the port's autograd
functions, their plain versions on the CPU, against the JAX Pallas
kernels in interpret mode).

Tolerance: 1e-5 absolute plus 1e-5 relative on logits, losses, hidden
states and parameter gradients, fp32 on both sides (only the summation
order differs). In bf16 the two frameworks round at other places inside
the matrix products, so the bf16 loss is held to 2e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.models.hstu import HSTU as JaxHSTU
from genrec_tpu_torch.convert import hstu_params_from_flax
from genrec_tpu_torch.models.hstu import HSTU, HSTULayer

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(num_items=60, max_seq_len=16, embed_dim=32, num_heads=2, num_blocks=2,
           dropout=0.0)


def _batch(packed, seed=0, B=3, L=16):
    """Numpy batch: packed rows (segments from slot 0, pad at the tail) or
    left-padded rows; timestamps ~1 event a day from 1.5e9 s."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    for b in range(B):
        if packed:
            at, s = 0, 1
            while at < L - 2:
                n = int(rng.integers(2, 7))
                seg[b, at:at + n] = s
                at, s = at + n, s + 1
        else:
            seg[b, L - int(rng.integers(3, L + 1)):] = 1
    ids[seg > 0] = rng.integers(1, CFG["num_items"] + 1, int((seg > 0).sum()))
    targets = np.where(seg > 0, rng.integers(1, CFG["num_items"] + 1, (B, L)), 0)
    ts = (np.cumsum(rng.integers(3600, 172800, (B, L)), axis=1)
          + 1_500_000_000).astype(np.int32)
    return dict(input_ids=ids, timestamps=ts, targets=targets.astype(np.int32),
                segment_ids=seg if packed else None)


def _models(flags, dtype="float32", jax_flags=False):
    """(JAX model, its init, the port's model on the CPU with those
    weights). The port takes ``flags`` for use_pallas and fused_ce; the
    JAX model ``jax_flags`` (its Pallas kernels run in interpret mode, so
    they are asked for only where they are the point)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JaxHSTU(**CFG, use_pallas=jax_flags, fused_ce=jax_flags, dtype=jdt)
    L = CFG["max_seq_len"]
    params = jm.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32),
                     jnp.zeros((1, L), jnp.int32))["params"]
    tm = HSTU(**CFG, use_pallas=flags, fused_ce=flags, dtype=tdt, device="cpu")
    tm.load_state_dict(hstu_params_from_flax(jax.device_get(params), tm))
    return jm, params, tm


def _jax_args(b):
    return [None if b[k] is None else jnp.asarray(b[k])
            for k in ("input_ids", "timestamps", "targets")], (
        None if b["segment_ids"] is None else jnp.asarray(b["segment_ids"]))


def _torch_args(b):
    return [None if b[k] is None else torch.as_tensor(b[k])
            for k in ("input_ids", "timestamps", "targets")], (
        None if b["segment_ids"] is None else torch.as_tensor(b["segment_ids"]))


@pytest.mark.parametrize("flags", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("packed", [False, True], ids=["left_padded", "packed"])
def test_forward_and_loss_match_jax(flags, packed):
    jm, params, tm = _models(flags, jax_flags=flags and packed)
    b = _batch(packed)
    (ids, ts, tgt), seg = _jax_args(b)
    apply = jax.jit(jm.apply)
    j_logits, j_loss = apply({"params": params}, ids, ts, tgt, segment_ids=seg)
    (ids_t, ts_t, tgt_t), seg_t = _torch_args(b)
    t_logits, t_loss = tm(ids_t, ts_t, tgt_t, segment_ids=seg_t)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), **TOL)
    if flags:  # fused CE: no logits
        assert t_logits is None
        (ids, ts, _), seg = _jax_args(b)
        j_logits, _ = apply({"params": params}, ids, ts, segment_ids=seg)
        t_logits, _ = tm(ids_t, ts_t, segment_ids=seg_t)
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), **TOL)


@pytest.mark.parametrize("flags", [False, True], ids=["plain", "kernels"])
def test_parameter_gradients_match_jax(flags):
    """Gradients of the packed-batch loss against the JAX model's plain
    path; the JAX gradient tree goes through the same converter as the
    parameters."""
    jm, params, tm = _models(flags)
    b = _batch(True, seed=1)
    (ids, ts, tgt), seg = _jax_args(b)

    @jax.jit
    def grad(p):
        return jax.grad(lambda p: jm.apply({"params": p}, ids, ts, tgt, segment_ids=seg)[1])(p)

    want = hstu_params_from_flax(jax.device_get(grad(params)))
    (ids_t, ts_t, tgt_t), seg_t = _torch_args(b)
    tm(ids_t, ts_t, tgt_t, segment_ids=seg_t)[1].backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_bf16_loss_matches_jax():
    jm, params, tm = _models(True, "bfloat16")
    b = _batch(True, seed=2)
    (ids, ts, tgt), seg = _jax_args(b)
    (ids_t, ts_t, tgt_t), seg_t = _torch_args(b)
    _, j_loss = jax.jit(jm.apply)({"params": params}, ids, ts, tgt, segment_ids=seg)
    _, t_loss = tm(ids_t, ts_t, tgt_t, segment_ids=seg_t)
    assert t_loss.dtype == torch.float32
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=2e-2)
    # Parameters stay float32; the cast to bf16 happens where they are used.
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_last_hidden_matches_jax():
    jm, params, tm = _models(False)
    (ids, ts, _), _ = _jax_args(_batch(False, seed=3))
    want = jm.apply({"params": params}, ids, ts, method=JaxHSTU.last_hidden)
    got = tm.last_hidden(torch.tensor(np.asarray(ids)), torch.tensor(np.asarray(ts)))
    assert got.shape == (3, CFG["embed_dim"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_converter_checks_every_leaf_and_parameter():
    jm, params, tm = _models(False)
    params = jax.device_get(params)
    names = set(hstu_params_from_flax(params, tm))
    assert names == set(tm.state_dict())
    layer0 = dict(params["layer_0"])
    missing = {**params, "layer_0": {k: v for k, v in layer0.items() if k != "temporal_bias"}}
    with pytest.raises(AssertionError, match="no Flax leaf"):
        hstu_params_from_flax(missing, tm)
    extra = {**params, "extra": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(AssertionError, match="no port parameter"):
        hstu_params_from_flax(extra, tm)
    reshaped = {**params, "item_embedding": np.zeros((5, CFG["embed_dim"]), np.float32)}
    with pytest.raises(AssertionError, match="shape mismatches"):
        hstu_params_from_flax(reshaped, tm)


def test_seeded_init_follows_the_flax_initialisers():
    tm = HSTU(**CFG, device="cpu", seed=3)
    jm, params, _ = _models(False)
    ref = hstu_params_from_flax(jax.device_get(params))
    for name, p in tm.state_dict().items():
        want = ref[name].numpy()
        assert p.shape == want.shape, name
        # Same family: norms at 1 and 0, Dense biases 0, the rest truncated
        # normals of the Flax scale (checked by their spread).
        if want.std() == 0:
            np.testing.assert_array_equal(p.numpy(), want, err_msg=name)
        else:
            assert 0.7 < p.numpy().std() / want.std() < 1.4, name
    same = HSTU(**CFG, device="cpu", seed=3).state_dict()
    assert all(torch.equal(v, same[k]) for k, v in tm.state_dict().items())


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HSTU(**CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HSTULayer(32, 2, 0.0)
    assert HSTU(**CFG, device="cpu").device == torch.device("cpu")
