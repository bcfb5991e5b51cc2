"""The SASRec model, port against the golden and the JAX package.

genrec_tpu_torch/models/sasrec.py pairs with genrec_tpu/models/sasrec.py.
The reference's own weights and outputs (tests/data/sasrec_golden.npz)
reach the port through tests/test_sasrec.py::_params_from_golden and
``convert.sasrec_params_from_flax``, at that file's tolerances: logits
atol 2e-5 / rtol 1e-4, loss 1e-5 absolute, top-k equal. Against
``SASRec.apply`` the same Flax init is carried across by the converter and
both models see the same numpy-seeded batches: left-padded rows (the
original layout) and packed rows with segment ids and within-segment
positions (the trainer's); the CE plain and fused (the port's autograd
function, its plain versions on the CPU; the JAX side's Pallas kernels in
interpret mode for the packed case).

Tolerance against JAX: 1e-5 absolute plus 1e-5 relative on logits,
losses, hidden states and every parameter gradient, the tied item table's
included (fp32 on both sides, only the summation order differs). In bf16
the two frameworks round at other places, so the bf16 loss is held to
2e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.models.sasrec import SASRec as JaxSASRec
from genrec_tpu.parallel.shardings import item_topk as jax_item_topk
from genrec_tpu_torch.convert import sasrec_params_from_flax
from genrec_tpu_torch.models.sasrec import SASRec, SASRecBlock

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(num_items=60, max_seq_len=16, embed_dim=32, num_heads=2, num_blocks=2,
           ffn_dim=64, dropout=0.0)
GOLDEN_CFG = dict(num_items=20, max_seq_len=8, embed_dim=16, num_heads=2, num_blocks=2,
                  ffn_dim=32, dropout=0.0)


@pytest.fixture(scope="module")
def golden():
    return np.load("tests/data/sasrec_golden.npz")


def _golden_model(golden):
    from test_sasrec import _params_from_golden

    tm = SASRec(**GOLDEN_CFG, device="cpu")
    tm.load_state_dict(sasrec_params_from_flax(
        jax.device_get(_params_from_golden(golden)), tm))
    return tm


def test_forward_matches_the_golden(golden):
    tm = _golden_model(golden)
    logits, loss = tm(torch.as_tensor(golden["input_ids"]), torch.as_tensor(golden["targets"]))
    np.testing.assert_allclose(logits.detach().numpy(), golden["logits"], atol=2e-5, rtol=1e-4)
    assert float(loss.detach()) == pytest.approx(float(golden["loss"]), abs=1e-5)


def test_predict_matches_the_golden(golden):
    tm = _golden_model(golden)
    top = tm.predict(torch.as_tensor(golden["input_ids"]), top_k=5)
    np.testing.assert_array_equal(top.numpy(), golden["topk"])


def _batch(packed, seed=0, B=3, L=16):
    """Numpy batch: packed rows (segments from slot 0, pad at the tail,
    positions restarting at each segment) or left-padded rows."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, L), np.int32)
    pos = np.zeros((B, L), np.int32)
    for b in range(B):
        if packed:
            at, s = 0, 1
            while at < L - 2:
                n = int(rng.integers(2, 7))
                seg[b, at:at + n] = s
                pos[b, at:at + n] = np.arange(min(n, L - at))
                at, s = at + n, s + 1
        else:
            seg[b, L - int(rng.integers(3, L + 1)):] = 1
    ids = np.zeros((B, L), np.int32)
    ids[seg > 0] = rng.integers(1, CFG["num_items"] + 1, int((seg > 0).sum()))
    targets = np.where(seg > 0, rng.integers(1, CFG["num_items"] + 1, (B, L)), 0)
    return dict(input_ids=ids, targets=targets.astype(np.int32),
                segment_ids=seg if packed else None, positions=pos if packed else None)


def _models(fused, dtype="float32", jax_fused=False):
    """(JAX model, its init, the port's model on the CPU with those
    weights)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JaxSASRec(**CFG, fused_ce=jax_fused, dtype=jdt)
    params = jm.init(jax.random.key(0), jnp.zeros((1, CFG["max_seq_len"]), jnp.int32))["params"]
    tm = SASRec(**CFG, fused_ce=fused, dtype=tdt, device="cpu")
    tm.load_state_dict(sasrec_params_from_flax(jax.device_get(params), tm))
    return jm, params, tm


def _args(b, to):
    return {k: None if b[k] is None else to(b[k])
            for k in ("input_ids", "targets", "segment_ids", "positions")}


@pytest.mark.parametrize("fused", [False, True], ids=["plain_ce", "fused_ce"])
@pytest.mark.parametrize("packed", [False, True], ids=["left_padded", "packed"])
def test_forward_and_loss_match_jax(fused, packed):
    jm, params, tm = _models(fused, jax_fused=fused and packed)
    b = _batch(packed)
    ja, ta = _args(b, jnp.asarray), _args(b, torch.as_tensor)
    apply = jax.jit(jm.apply)
    j_logits, j_loss = apply({"params": params}, ja["input_ids"], ja["targets"],
                             segment_ids=ja["segment_ids"], positions=ja["positions"])
    t_logits, t_loss = tm(ta["input_ids"], ta["targets"], segment_ids=ta["segment_ids"],
                          positions=ta["positions"])
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), **TOL)
    if fused:  # fused CE: no logits
        assert t_logits is None
        j_logits, _ = apply({"params": params}, ja["input_ids"],
                            segment_ids=ja["segment_ids"], positions=ja["positions"])
        t_logits, _ = tm(ta["input_ids"], segment_ids=ta["segment_ids"],
                         positions=ta["positions"])
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), **TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain_ce", "fused_ce"])
@pytest.mark.parametrize("packed", [False, True], ids=["left_padded", "packed"])
def test_parameter_gradients_match_jax(fused, packed):
    """Gradients of the loss against the JAX model's plain path; the JAX
    gradient tree goes through the same converter as the parameters. The
    item table's gradient sums the input gather's and the tied head's."""
    jm, params, tm = _models(fused)
    b = _batch(packed, seed=1)
    ja, ta = _args(b, jnp.asarray), _args(b, torch.as_tensor)

    @jax.jit
    def grad(p):
        return jax.grad(lambda p: jm.apply(
            {"params": p}, ja["input_ids"], ja["targets"], segment_ids=ja["segment_ids"],
            positions=ja["positions"])[1])(p)

    want = sasrec_params_from_flax(jax.device_get(grad(params)))
    tm(ta["input_ids"], ta["targets"], segment_ids=ta["segment_ids"],
       positions=ta["positions"])[1].backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)
    assert float(tm.item_embedding.grad.abs().max()) > 0


def test_bf16_loss_matches_jax():
    jm, params, tm = _models(True, "bfloat16")
    b = _batch(True, seed=2)
    ja, ta = _args(b, jnp.asarray), _args(b, torch.as_tensor)
    _, j_loss = jax.jit(jm.apply)({"params": params}, ja["input_ids"], ja["targets"],
                                  segment_ids=ja["segment_ids"], positions=ja["positions"])
    _, t_loss = tm(ta["input_ids"], ta["targets"], segment_ids=ta["segment_ids"],
                   positions=ta["positions"])
    assert t_loss.dtype == torch.float32
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_dropout_draws_from_the_generator():
    """Dropout is on only when not deterministic; one generator seed gives
    one loss, another seed another."""
    tm = SASRec(**{**CFG, "dropout": 0.3}, device="cpu")
    b = _args(_batch(True, seed=4), torch.as_tensor)

    def loss(seed, deterministic=False):
        return float(tm(b["input_ids"], b["targets"], deterministic=deterministic,
                        segment_ids=b["segment_ids"], positions=b["positions"],
                        generator=torch.Generator().manual_seed(seed))[1].detach())

    assert loss(0) == loss(0) != loss(1)
    assert loss(0, True) == loss(1, True)


def test_last_hidden_and_predict_match_jax():
    jm, params, tm = _models(False)
    ids = jnp.asarray(_batch(False, seed=3)["input_ids"])
    ids_t = torch.as_tensor(np.array(ids))
    want = jm.apply({"params": params}, ids, method=JaxSASRec.last_hidden)
    got = tm.last_hidden(ids_t)
    assert got.shape == (3, CFG["embed_dim"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    top = jm.apply({"params": params}, ids, method=JaxSASRec.predict, top_k=7)
    np.testing.assert_array_equal(tm.predict(ids_t, top_k=7).numpy(), np.asarray(top))
    scores, _ = jax_item_topk(want, params["item_embedding"], 7)
    assert np.isfinite(np.asarray(scores)).all()


def test_converter_checks_every_leaf_and_parameter():
    jm, params, tm = _models(False)
    params = jax.device_get(params)
    assert set(sasrec_params_from_flax(params, tm)) == set(tm.state_dict())
    block = dict(params["block_0"])
    missing = {**params, "block_0": {k: v for k, v in block.items() if k != "norm2"}}
    with pytest.raises(AssertionError, match="no Flax leaf"):
        sasrec_params_from_flax(missing, tm)
    extra = {**params, "extra": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(AssertionError, match="no port parameter"):
        sasrec_params_from_flax(extra, tm)
    reshaped = {**params, "position_embedding": np.zeros((5, CFG["embed_dim"]), np.float32)}
    with pytest.raises(AssertionError, match="shape mismatches"):
        sasrec_params_from_flax(reshaped, tm)


def test_seeded_init_follows_the_flax_initialisers():
    tm = SASRec(**CFG, device="cpu", seed=3)
    _, params, _ = _models(False)
    ref = sasrec_params_from_flax(jax.device_get(params))
    for name, p in tm.state_dict().items():
        want = ref[name].numpy()
        assert p.shape == want.shape, name
        # Same family: norms at 1 and 0, Dense biases 0, the rest xavier
        # uniform or truncated normals of the Flax scale (by their spread).
        if want.std() == 0:
            np.testing.assert_array_equal(p.numpy(), want, err_msg=name)
        else:
            assert 0.7 < p.numpy().std() / want.std() < 1.4, name
    same = SASRec(**CFG, device="cpu", seed=3).state_dict()
    assert all(torch.equal(v, same[k]) for k, v in tm.state_dict().items())


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SASRec(**CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SASRecBlock(32, 2, 64, 0.0)
    assert SASRec(**CFG, device="cpu").device == torch.device("cpu")
