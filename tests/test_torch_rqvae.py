"""The RQ-VAE slice, port against the JAX package.

genrec_tpu_torch/{models/rqvae,models/layers,ops/normalize,ops/losses,
ops/gumbel,ops/kmeans,ops/schedules,data/items}.py pair with the same
paths under genrec_tpu/ (the trainer: tests/test_torch_rqvae_trainer.py).
Inputs are made from a seed with numpy; the port's weights are the JAX
init carried across by ``convert.rqvae_params_from_flax``, and the Gumbel
mode is fed the same uniforms on both sides (the JAX function is handed
them in place of its key's draws).

Tolerances: 1e-5 on float outputs (fp32 on both sides; only the
summation order differs), exact on sem-ids, k-means assignments and
distinct counts; the reference golden (tests/data/rqvae_golden.npz) at
tests/test_rqvae.py's own tolerances.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.models import rqvae as jrq
from genrec_tpu.ops.kmeans import kmeans as jax_kmeans
from genrec_tpu.ops import schedules as jsched
from genrec_tpu.ops.losses import categorical_reconstruction_loss as jax_cat_loss
from genrec_tpu.ops.normalize import l2norm as jax_l2norm
from genrec_tpu_torch.convert import rqvae_params_from_flax
from genrec_tpu_torch.data import items as titems
from genrec_tpu_torch.models import rqvae as trq
from genrec_tpu_torch.ops import gumbel as tgumbel
from genrec_tpu_torch.ops.kmeans import kmeans
from genrec_tpu_torch.ops import schedules as tsched
from genrec_tpu_torch.ops.losses import categorical_reconstruction_loss
from genrec_tpu_torch.ops.normalize import l2norm

torch.set_num_threads(1)

M = jrq.QuantizeForwardMode
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "rqvae_golden.npz")
SMALL = dict(input_dim=24, embed_dim=8, hidden_dims=(16, 12), codebook_size=32,
             n_layers=3, commitment_weight=0.25, n_cat_features=0)


def _modes(mode, last):
    return dict(codebook_mode=mode, codebook_last_layer_mode=last)


def _pair(seed=0, **kw):
    """(jax model, jax params, port model with the same weights)."""
    cfg = {**SMALL, **kw}
    jmodel = jrq.RqVae(**{k: (jrq.QuantizeForwardMode[v.name]
                              if isinstance(v, trq.QuantizeForwardMode) else v)
                          for k, v in cfg.items()})
    params = jax.jit(jmodel.init, static_argnums=2)(
        {"params": jax.random.key(seed), "gumbel": jax.random.key(1)},
        jnp.zeros((2, cfg["input_dim"]), jnp.float32), 0.2)["params"]
    tcfg = {k: (trq.QuantizeForwardMode[v.name] if isinstance(v, jrq.QuantizeForwardMode)
                else v) for k, v in cfg.items()}
    tmodel = trq.RqVae(**tcfg, device="cpu")
    tmodel.load_state_dict(rqvae_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tmodel))
    return jmodel, params, tmodel


def _x(seed, n=64, d=24):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_converter_consumes_every_leaf_and_fills_every_parameter():
    _, params, tmodel = _pair(codebook_sim_vq=True)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    sd = rqvae_params_from_flax(params_np, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    np.testing.assert_array_equal(sd["encoder.dense_0.weight"].numpy(),
                                  params_np["encoder"]["dense_0"]["kernel"].T)
    np.testing.assert_array_equal(sd["quantize_1.out_proj.weight"].numpy(),
                                  params_np["quantize_1"]["out_proj"]["kernel"].T)
    with pytest.raises(AssertionError, match="no port parameter"):
        rqvae_params_from_flax(dict(params_np, stray={"codebook": np.zeros((2, 2))}), tmodel)


@pytest.fixture
def fed_uniforms(monkeypatch):
    """The JAX model's Gumbel draws replaced by given uniforms, one (B, K)
    array per call in level order; returns the list to fill."""
    queue = []

    def sample(key, logits, temperature):
        u = jnp.asarray(queue.pop(0))
        return jax.nn.softmax((logits - jnp.log(-jnp.log(u + 1e-20) + 1e-20)) / temperature,
                              axis=-1)

    monkeypatch.setattr(jrq, "gumbel_softmax_sample", sample)
    return queue


@pytest.mark.parametrize("mode,last,extra", [
    (M.STE, M.SINKHORN, {}),                     # the shipped configs
    (M.STE, M.ROTATION_TRICK, {}),
    (M.GUMBEL_SOFTMAX, M.GUMBEL_SOFTMAX, {}),
    (M.ROTATION_TRICK, M.STE, dict(codebook_sim_vq=True, codebook_normalize=True,
                                   n_cat_features=4)),
])
def test_forward_and_losses_match_jax(fed_uniforms, mode, last, extra):
    jmodel, params, tmodel = _pair(**_modes(mode, last), **extra)
    x = _x(1)
    if extra.get("n_cat_features"):
        x[:, -4:] = (x[:, -4:] > 0).astype(np.float32)
    u = [np.random.default_rng(10 + i).uniform(size=(64, 32)).astype(np.float32)
         for i in range(3)]
    for training in (True, False):
        fed_uniforms[:] = list(u)
        want = jmodel.apply({"params": params}, jnp.asarray(x), 0.2, training=training,
                            rngs={"gumbel": jax.random.key(0)})
        with torch.no_grad():
            got = tmodel(torch.as_tensor(x), 0.2, training=training,
                         uniforms=[torch.as_tensor(a) for a in u])
        for name in ("loss", "reconstruction_loss", "rqvae_loss", "embs_norm",
                     "p_unique_ids"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} training={training}")
        if not training:
            continue  # eval ids: the golden and the trainer tests
        fed_uniforms[:] = list(u)
        jids = jmodel.apply({"params": params}, jnp.asarray(x), 0.2, training=training,
                            rngs={"gumbel": jax.random.key(0)},
                            method=jrq.RqVae.get_semantic_ids).sem_ids
        with torch.no_grad():
            tids = tmodel.get_semantic_ids(torch.as_tensor(x), 0.2, training=training,
                                           uniforms=[torch.as_tensor(a) for a in u]).sem_ids
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("distance", ["L2", "COSINE"])
def test_quantize_level_distances_match_jax(distance):
    """One ``Quantize`` level on its own, both distances, eval and STE."""
    jq = jrq.Quantize(embed_dim=8, n_embed=16, forward_mode=M.STE,
                      distance_mode=jrq.QuantizeDistance[distance])
    x = _x(3, n=40, d=8)
    params = jax.jit(jq.init, static_argnums=2)(jax.random.key(0), jnp.asarray(x), 0.2)
    tq = trq.Quantize(embed_dim=8, n_embed=16, forward_mode=trq.QuantizeForwardMode.STE,
                      distance_mode=trq.QuantizeDistance[distance], device="cpu")
    tq.load_state_dict(rqvae_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    for training in (False, True):
        want = jq.apply(params, jnp.asarray(x), 0.2, training=training)
        with torch.no_grad():
            got = tq(torch.as_tensor(x), 0.2, training=training)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.embeddings.numpy(), np.asarray(want.embeddings),
                                   atol=1e-5)
        np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), rtol=1e-5,
                                   atol=1e-5)


def test_gradients_match_jax():
    jmodel, params, tmodel = _pair(**_modes(M.STE, M.SINKHORN))
    x = _x(2)
    g = jax.jit(jax.grad(lambda p: jmodel.apply({"params": p}, jnp.asarray(x), 0.2,
                                                training=True).loss))(params)
    tmodel(torch.as_tensor(x), 0.2, training=True).loss.backward()
    want = rqvae_params_from_flax(jax.tree_util.tree_map(np.asarray, g))
    for name, p in tmodel.named_parameters():
        scale = float(np.abs(want[name].numpy()).max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5 * max(scale, 1e-3), err_msg=name)


def _params_from_golden(g):
    """The golden's reference weights under the port's names (the same
    mapping as tests/test_rqvae.py::_params_from_golden, then the
    converter)."""
    from test_rqvae import _params_from_golden as flax_from_golden

    return rqvae_params_from_flax(flax_from_golden(g))


def test_matches_the_reference_golden():
    g = np.load(GOLDEN)
    model = trq.RqVae(input_dim=16, embed_dim=8, hidden_dims=(12,), codebook_size=16,
                      codebook_mode=trq.QuantizeForwardMode.STE,
                      codebook_last_layer_mode=trq.QuantizeForwardMode.SINKHORN,
                      n_layers=3, commitment_weight=0.25, n_cat_features=0, device="cpu")
    model.load_state_dict(_params_from_golden(g))
    x = torch.as_tensor(g["x"])
    with torch.no_grad():
        out = model(x, 0.2, training=False)
        ids = model.get_semantic_ids(x, 0.001).sem_ids
        assert float(out.loss) == pytest.approx(float(g["eval_loss"]), rel=1e-5)
        assert float(out.reconstruction_loss) == pytest.approx(float(g["eval_rec"]), rel=1e-5)
        assert float(out.rqvae_loss) == pytest.approx(float(g["eval_vq"]), rel=1e-5)
        np.testing.assert_array_equal(ids.numpy(), g["sem_ids_eval"])
        for last, key, rel in ((trq.QuantizeForwardMode.STE, "ste_loss", 1e-5),
                               (trq.QuantizeForwardMode.ROTATION_TRICK, "rot_loss", 1e-4)):
            model.quantize_2.forward_mode = last
            out = model(x, 0.2, training=True)
            assert float(out.loss) == pytest.approx(float(g[key]), rel=rel)


def test_sinkhorn_matches_jax_at_the_trainer_shape():
    """(1024, 256), 100 fp32 iterations, cost normalised by the batch's
    global max and min as the model does it."""
    rng = np.random.default_rng(3)
    dist = rng.normal(size=(1024, 256)).astype(np.float32) * 4 + 10
    mx, mn = dist.max(), dist.min()
    mid = (mx + mn) / 2
    cost = (dist - mid) / (mx - mid + 1e-5)
    want = np.asarray(jrq.sinkhorn_knopp(jnp.asarray(cost)))
    got = trq.sinkhorn_knopp(torch.as_tensor(cost)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(axis=-1), want.argmax(axis=-1))


def _jax_init_rows(key, B, k):
    """The rows JAX's kmeans starts from under ``key``."""
    init_key, _ = jax.random.split(key)
    return np.asarray(jax.random.choice(init_key, B, shape=(k,), replace=False))


def test_kmeans_matches_jax_from_the_same_rows():
    x = titems.SyntheticItemEmbeddings(num_items=400, dim=12, n_clusters=6, seed=0).embeddings
    key = jax.random.key(5)
    want = jax_kmeans(key, jnp.asarray(x), k=6)
    got = kmeans(torch.as_tensor(x), 6, init_idx=torch.as_tensor(
        _jax_init_rows(key, len(x), 6)))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), atol=1e-5)
    np.testing.assert_array_equal(got.assignment.numpy(), np.asarray(want.assignment))


def test_kmeans_init_params_matches_jax():
    jmodel, params, tmodel = _pair(**_modes(M.STE, M.STE), codebook_size=8)
    x = titems.SyntheticItemEmbeddings(num_items=300, dim=24, n_clusters=8, seed=1).embeddings
    key = jax.random.key(3)
    want = jax.jit(functools.partial(jrq.kmeans_init_params, jmodel))(
        params, jnp.asarray(x), key)
    rows = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        rows.append(torch.as_tensor(_jax_init_rows(sub, len(x), 8)))
    trq.kmeans_init_params(tmodel, torch.as_tensor(x), init_indices=rows)
    for i in range(3):
        np.testing.assert_allclose(getattr(tmodel, f"quantize_{i}").codebook.detach().numpy(),
                                   np.asarray(want[f"quantize_{i}"]["codebook"]), atol=1e-5)
    # Seeded draws are deterministic.
    again = _pair(**_modes(M.STE, M.STE), codebook_size=8)[2]
    for m in (tmodel, again):
        trq.kmeans_init_params(m, torch.as_tensor(x), torch.Generator().manual_seed(9))
    torch.testing.assert_close(tmodel.codebooks(), again.codebooks(), rtol=0, atol=0)


def test_count_distinct_is_exact():
    rng = np.random.default_rng(4)
    for n, L, K in ((100, 3, 4), (257, 2, 3), (1, 3, 5), (50, 1, 50)):
        ids = rng.integers(0, K, (n, L)).astype(np.int32)
        want = int(jrq.count_distinct(jnp.asarray(ids)))
        assert want == len({tuple(r) for r in ids})
        assert int(trq.count_distinct(torch.as_tensor(ids))) == want
        assert float(trq.count_distinct_fraction(torch.as_tensor(ids))) == pytest.approx(
            float(jrq.count_distinct_fraction(jnp.asarray(ids))), rel=0)


@pytest.mark.parametrize("name,args", [
    ("linear_schedule_with_warmup", (1e-3, 20, 100)),
    ("cosine_schedule_with_warmup", (1e-3, 20, 100)),
    ("inverse_sqrt_schedule", (1e-3, 20)),
])
def test_schedules_match_jax(name, args):
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jax.vmap(getattr(jsched, name)(*args))(jnp.asarray(steps)))
    got = getattr(tsched, name)(*args)(torch.as_tensor(steps)).numpy()
    # float32 cos and sqrt may differ in the last ulp between the libraries.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * args[0])


def test_small_pieces_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(l2norm(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_l2norm(jnp.asarray(x))), atol=1e-7)
    t = torch.as_tensor(x, dtype=torch.float32).requires_grad_()
    l2norm(t).sum().backward()
    assert torch.isfinite(t.grad).all()  # clamped before the sqrt
    lab = (rng.random((5, 7)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        categorical_reconstruction_loss(torch.as_tensor(x), torch.as_tensor(lab), 3).numpy(),
        np.asarray(jax_cat_loss(jnp.asarray(x), jnp.asarray(lab), 3)), rtol=1e-6)
    u = rng.uniform(size=(4, 9)).astype(np.float32)
    logits = rng.normal(size=(4, 9)).astype(np.float32)
    jg = -jnp.log(-jnp.log(jnp.asarray(u) + 1e-20) + 1e-20)
    np.testing.assert_allclose(tgumbel.sample_gumbel(None, uniform=torch.as_tensor(u)).numpy(),
                               np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(
        tgumbel.gumbel_softmax_sample(torch.as_tensor(logits), 0.5,
                                      uniform=torch.as_tensor(u)).numpy(),
        np.asarray(jax.nn.softmax((jnp.asarray(logits) + jg) / 0.5)), rtol=1e-5)
    # A generator's draws are reproducible.
    a = tgumbel.sample_gumbel((3, 4), torch.Generator().manual_seed(1))
    b = tgumbel.sample_gumbel((3, 4), torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
