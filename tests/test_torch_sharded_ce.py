"""The vocab-sharded fused CE (B8) and the tensor-parallel group, port
against the JAX package.

genrec_tpu_torch/kernels/fused_ce.py ``sharded_fused_linear_ce`` runs on a
2-rank gloo group on the CPU (``parallel.mesh.spawn``, a FileStore under
tmp_path) and is held to JAX ``sharded_fused_linear_ce`` on a ``model=2``
mesh of the conftest's virtual CPU devices (its Pallas kernels in
interpret mode): per-row losses, dx (replicated) and dW (each rank its
shard). One spawn serves the whole module; its ranks also exercise the
group's collectives and ``metric_allreduce``/``TopKAccumulator.reduce``.

Tolerance: 1e-5 absolute plus 1e-5 relative, fp32 on both sides (the
Pallas kernels take an online logsumexp over 512-column tiles, the plain
versions one max and one sum). Pad rows of the head get exactly zero dW.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from genrec_tpu.kernels.fused_ce import sharded_fused_linear_ce as jax_sharded
from genrec_tpu_torch.kernels import fused_ce as tf
from genrec_tpu_torch.parallel.mesh import TPGroup, metric_allreduce, spawn

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
IGNORE = -100


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


def _case(kind, R=37, V=64, d=8, valid_vocab=30, seed=0):
    """(x, w, targets, valid_vocab, g). V = 64 over 2 ranks is 32 rows a
    shard; valid_vocab 30 leaves two pad rows on rank 0 and rank 1's
    whole shard empty (vlim 0). R = 37 rows is ragged for every tile."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, d)).astype(np.float32)
    w = (rng.normal(size=(V, d)) * 0.3).astype(np.float32)
    t = rng.integers(0, valid_vocab, R).astype(np.int32)
    t[rng.random(R) < 0.3] = IGNORE
    if kind == "all_ignored":
        t[:] = IGNORE
    g = rng.normal(size=R).astype(np.float32)
    return x, w, t, valid_vocab, g


CASES = {
    "pad_rows_empty_shard": _case("mixed"),
    "all_ignored": _case("all_ignored", seed=1),
    # Both shards live: every target on rank 0 is on the other shard for rank 1.
    "both_shards_live": _case("mixed", R=20, V=48, d=16, valid_vocab=44, seed=2),
}


def _ranks(group, cases):
    """Rank side: B8's per-row loss, dx and dW for each case (its loss
    weighted by g), then the group's collectives."""
    out = {}
    for name, (x, w, t, vv, g) in cases.items():
        Vs = w.shape[0] // group.size
        xt = torch.tensor(x, requires_grad=True)
        ws = torch.tensor(w[group.rank * Vs:(group.rank + 1) * Vs], requires_grad=True)
        loss = tf.sharded_fused_linear_ce(xt, ws, torch.tensor(t), group, IGNORE, vv)
        (loss * torch.tensor(g)).sum().backward()
        out[name] = (loss.detach().numpy(), xt.grad.numpy(), ws.grad.numpy())
    r = float(group.rank)
    before = group.calls
    bf = torch.tensor([1.5 + r, -2.0], dtype=torch.bfloat16)
    out["collectives"] = dict(
        sum_bf16=group.all_reduce(bf, "sum"),
        max=group.all_reduce(torch.tensor([r, 5.0 - r]), "max"),
        gather=group.all_gather(torch.full((2, 1), r), dim=-1),
        metrics=metric_allreduce({"total": 2.0 + r, "correct": [r, 1.0]}, group),
        calls=group.calls - before,
    )
    from genrec_tpu_torch.ops.metrics import TopKAccumulator

    acc = TopKAccumulator(ks=(1, 2))
    # Rank 0 hits at rank 0, rank 1 misses: over both, Recall@1 = 1/2.
    top = torch.tensor([[[1], [2]]]) if group.rank == 0 else torch.tensor([[[3], [4]]])
    acc.accumulate(torch.tensor([[1]]), top)
    out["topk"] = acc.reduce(group)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(_ranks, 2, (CASES,), device="cpu", threads=1, timeout_s=120,
                 store_dir=tmp_path_factory.mktemp("store"))


def _mesh():
    return Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))


def _jax_b8(x, w, t, vv, g):
    mesh = _mesh()

    @jax.jit
    def run(x, w, g):
        loss, vjp = jax.vjp(
            lambda x, w: jax_sharded(x, w, jnp.asarray(t), mesh, "model", "data", IGNORE, vv),
            x, w)
        return (loss, *vjp(g))

    return [np.asarray(a) for a in run(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))]


@pytest.mark.parametrize("name", list(CASES))
def test_b8_matches_jax_sharded_fused_linear_ce(ranks, name):
    x, w, t, vv, g = CASES[name]
    want_loss, want_dx, want_dw = _jax_b8(x, w, t, vv, g)
    (loss0, dx0, dw0), (loss1, dx1, dw1) = ranks[0][name], ranks[1][name]
    np.testing.assert_allclose(loss0, want_loss, **TOL)
    np.testing.assert_array_equal(loss1, loss0)  # the merged loss is the same on each rank
    np.testing.assert_allclose(dx0, want_dx, **TOL)
    np.testing.assert_array_equal(dx1, dx0)  # dx is summed over the group
    np.testing.assert_allclose(np.concatenate([dw0, dw1]), want_dw, **TOL)
    assert np.abs(np.concatenate([dw0, dw1])[vv:]).max() == 0.0  # pad rows exactly 0
    if name == "all_ignored":
        assert np.abs(loss0).max() == 0.0 and np.abs(dx0).max() == 0.0


def test_collectives_over_gloo(ranks):
    for out in ranks:
        c = out["collectives"]
        assert c["sum_bf16"].dtype == torch.bfloat16
        assert c["sum_bf16"].tolist() == [4.0, -4.0]
        assert c["max"].tolist() == [1.0, 5.0]
        assert c["gather"].tolist() == [[0.0, 1.0], [0.0, 1.0]]
        assert c["metrics"] == {"total": 5.0, "correct": [1.0, 2.0]}
        assert c["calls"] == 4
        assert out["topk"]["Recall@1"] == 0.5 and out["topk"]["Recall@2"] == 0.5


def test_twin_is_the_same_composition_on_one_rank():
    """At one rank B8 and its twin are the plain fused CE over the head's
    first valid_vocab rows."""
    x, w, t, vv, _ = CASES["pad_rows_empty_shard"]
    group = TPGroup(0, 1, "none", torch.device("cpu"))
    group.all_reduce = lambda a, op="sum": a.clone()
    xt, wt, tt = torch.tensor(x), torch.tensor(w), torch.tensor(t)
    want, _ = tf.fused_linear_ce_ref(xt, wt[:vv], tt, IGNORE)
    for fn in (tf.sharded_fused_linear_ce, tf.sharded_fused_linear_ce_ref):
        torch.testing.assert_close(fn(xt, wt, tt, group, IGNORE, vv), want, **TOL)


def test_local_shard_targets():
    t = torch.tensor([0, 31, 32, 63, -100, 40], dtype=torch.int32)
    local, vlim = tf.local_shard_targets(t, 1, 32, 40)
    assert local.tolist() == [-1, -1, 0, 31, -1, 8] and vlim == 8
    assert tf.local_shard_targets(t, 1, 32, 30)[1] == 0
    assert tf.local_shard_targets(t, 0, 32, None)[1] is None


def _fail_on_rank_1(group):
    if group.rank == 1:
        raise ValueError("rank 1 fails")
    group.all_reduce(torch.zeros(1))  # would wait for rank 1 forever


def test_spawn_raises_when_a_rank_fails(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        spawn(_fail_on_rank_1, 2, device="cpu", threads=1, timeout_s=60, store_dir=tmp_path)
