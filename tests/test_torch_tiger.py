"""TIGER's training forwards, port against the JAX package.

genrec_tpu_torch/models/tiger.py (``Tiger.forward``, ``forward_packed``)
and models/t5transformer.py pair with their JAX twins. Weights are the
JAX init (or the reference golden through tests/test_tiger.py::
_params_from_golden) carried across by genrec_tpu_torch.convert; inputs
are made from a seed with numpy. Tolerances: the golden's own (logits
atol 3e-4 / rtol 1e-3, loss rel 1e-5); 1e-5 in float32 (only the
summation order differs); in bf16 1e-2 of max |JAX| (both round every
activation to bf16, 2^-8 relative, at different points of a sum);
packed against unpacked as tests/test_packed_parity.py holds it (loss
1e-5, gradients atol 2e-5 / rtol 2e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.models import tiger as jtiger
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.data.batching import pack_examples
from genrec_tpu_torch.data.tiger_seq import synthetic_tiger_data
from genrec_tpu_torch.models import tiger as ttiger

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "tiger_golden.npz")
K_CB, D = 16, 3
CFG = dict(embedding_dim=16, attn_dim=32, num_heads=4, n_layers=4,
           num_item_embeddings=K_CB, num_user_embeddings=100, sem_id_dim=D, max_pos=64)
MAX_ITEMS = 6
L = MAX_ITEMS * D


def _jax_params(seed=0):
    jmodel = jtiger.Tiger(dropout=0.0, **CFG)
    params = jmodel.init(
        jax.random.key(seed), jnp.zeros((1,), jnp.int32), jnp.zeros((1, L), jnp.int32),
        jnp.zeros((1, L), jnp.int32), jnp.zeros((1, D), jnp.int32),
        jnp.zeros((1, D), jnp.int32), jnp.ones((1, L), jnp.int32),
    )["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port(params_np, **kw):
    model = ttiger.Tiger(device="cpu", **CFG, **kw)
    model.load_state_dict(tiger_params_from_flax(params_np, model))
    return model


@pytest.fixture(scope="module")
def params():
    return _jax_params()


@pytest.fixture(scope="module")
def data():
    return synthetic_tiger_data(num_items=40, codebook_size=K_CB, sem_id_dim=D,
                                max_items=MAX_ITEMS, seed=0, num_users=16)


def _unpacked(arrays, n=None):
    a = {k: v[:n] for k, v in arrays.items()}
    B = a["user_ids"].shape[0]
    a["target_token_type_ids"] = np.tile(np.arange(D), (B, 1))
    return a


_UNPACKED = ("user_ids", "item_input_ids", "token_type_ids", "target_ids",
             "target_token_type_ids", "seq_mask")
_PACKED = ("item_input_ids", "token_type_ids", "user_token_ids", "user_mask",
           "segment_ids", "positions", "target_ids", "segment_valid")


def _j(a, keys):
    return [jnp.asarray(a[k], jnp.int32) for k in keys]


def _t(a, keys):
    return [torch.as_tensor(a[k], dtype=torch.int64) for k in keys]


def test_forward_matches_reference_golden():
    """The reference's logits and loss (tests/data/tiger_golden.npz), the
    bar of tests/test_tiger.py::test_forward_matches_reference."""
    from test_tiger import _params_from_golden

    g = np.load(GOLDEN)
    params_np = jax.tree_util.tree_map(np.asarray, _params_from_golden(g))
    # The reference's unused out_proj: Flax's init never creates it, so the
    # port (whose parameters are the Flax init's) has no counterpart.
    params_np.pop("out_proj")
    model = ttiger.Tiger(embedding_dim=24, attn_dim=32, num_heads=4, n_layers=4,
                         num_item_embeddings=16, num_user_embeddings=50, sem_id_dim=3,
                         max_pos=64, device="cpu")
    model.load_state_dict(tiger_params_from_flax(params_np, model))
    with torch.no_grad():
        out = model(*(torch.as_tensor(g[k]).long() for k in
                      ("user", "items", "types", "tgt", "tgt_types", "seq_mask")))
    np.testing.assert_allclose(out.logits.numpy(), g["logits"], atol=3e-4, rtol=1e-3)
    assert float(out.loss) == pytest.approx(float(g["loss"]), rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(params, data, dtype):
    """``Tiger.forward`` against ``Tiger.apply`` on padded histories, in
    float32 (1e-5) and in the trainers' bf16 (1e-2 of max |JAX|)."""
    jmodel = jtiger.Tiger(dropout=0.0, dtype=getattr(jnp, dtype), **CFG)
    tmodel = _port(params, dtype=getattr(torch, dtype))
    a = _unpacked(data.train_arrays(), 24)
    jout = jax.jit(jmodel.apply)({"params": params}, *_j(a, _UNPACKED))
    with torch.no_grad():
        tout = tmodel(*_t(a, _UNPACKED))
    jl = np.asarray(jout.logits.astype(jnp.float32))
    tl = tout.logits.to(torch.float32).numpy()
    tol = 1e-5 if dtype == "float32" else 1e-2 * np.abs(jl).max()
    np.testing.assert_allclose(tl, jl, atol=tol, rtol=0 if dtype != "float32" else 1e-5)
    loss_tol = 1e-5 if dtype == "float32" else 1e-2
    assert float(tout.loss) == pytest.approx(float(jout.loss), rel=loss_tol)


@pytest.fixture(scope="module")
def packed(data):
    arrays, rep = pack_examples(data.train_examples(), 1 + L, segment_keys=("target_ids",),
                                max_segments=4)
    assert rep.n_rows < rep.padded_rows
    return arrays


def test_forward_packed_matches_jax(params, packed):
    jmodel = jtiger.Tiger(dropout=0.0, **CFG)
    tmodel = _port(params)
    jout = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a,
                                              method=jtiger.Tiger.forward_packed))(
        params, *_j(packed, _PACKED))
    with torch.no_grad():
        tout = tmodel.forward_packed(*_t(packed, _PACKED))
    np.testing.assert_allclose(tout.per_example_loss.numpy(),
                               np.asarray(jout.per_example_loss), rtol=1e-5, atol=1e-5)
    assert float(tout.loss) == pytest.approx(float(jout.loss), rel=1e-5)
    assert int(tout.real_tokens) == int(jout.real_tokens)


def test_packed_loss_and_grads_match_unpacked(params, data, packed):
    """The port's packed forward equals its unpacked forward on the same
    examples: the loss and every parameter's gradient."""
    model = _port(params)
    a = _unpacked(data.train_arrays())

    def grads(loss):
        g = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        return float(loss.detach()), [torch.zeros_like(p) if x is None else x
                             for p, x in zip(model.parameters(), g)]

    lu, gu = grads(model(*_t(a, _UNPACKED)).loss)
    lp, gp = grads(model.forward_packed(*_t(packed, _PACKED)).loss)
    assert lu == pytest.approx(lp, abs=1e-5)
    for (name, _), x, y in zip(model.named_parameters(), gu, gp):
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=2e-5, rtol=2e-4, err_msg=name)


def test_encoder_segment_boundary_leak(params, data):
    """A second segment in a packed row must not change the first
    segment's per-example loss (tests/test_packed_parity.py::
    test_tiger_encoder_segment_boundary_leak on the port)."""
    exs = data.train_examples()
    e1 = next(e for e in exs if len(e["item_input_ids"]) == 7)
    others = [e for e in exs if len(e["item_input_ids"]) == 4
              and not np.array_equal(e["target_ids"], e1["target_ids"])]
    model = _port(params)

    def loss_of_first(neighbor):
        p, _ = pack_examples([e1, neighbor], 1 + L, segment_keys=("target_ids",))
        assert p["segment_ids"].shape[0] == 1 and p["segment_ids"].max() == 2
        with torch.no_grad():
            out = model.forward_packed(*_t(p, _PACKED))
        s1 = next(s for s in range(p["target_ids"].shape[1])
                  if np.array_equal(p["target_ids"][0, s], e1["target_ids"]))
        return float(out.per_example_loss[0, s1])

    assert loss_of_first(others[0]) == loss_of_first(others[1])


def test_dropout_draws_from_the_generator(params, data):
    """With dropout on, the training forward is a function of its
    generator's state: the same seed gives the same loss, another seed
    another; deterministic=True ignores the rate."""
    model = _port(params, dropout=0.3)
    a = _t(_unpacked(data.train_arrays(), 8), _UNPACKED)

    def loss(seed, deterministic=False):
        with torch.no_grad():
            return float(model(*a, deterministic=deterministic,
                               generator=torch.Generator().manual_seed(seed)).loss)

    assert loss(1) == loss(1) != loss(2)
    with torch.no_grad():
        plain = float(_port(params)(*a).loss)
    assert loss(1, True) == pytest.approx(plain, rel=1e-6)
