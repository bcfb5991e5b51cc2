"""The speculative tree's helpers, held to the JAX package.

genrec_tpu_torch/ops/spec_tree.py pairs with genrec_tpu/ops/spec_tree.py,
``ops.trie.legal_topk_ragged`` and ``ops.paged.tree_suffix_stats`` with
theirs, and ``catalog.TensorTrie``'s draft weights with the JAX trie's.
Inputs are made from a seed with numpy and handed to both sides. Tables
and integer outputs are exact; float outputs within 1e-6 (gathers and
selects are exact; ``tree_suffix_stats`` sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.catalog.tensor_trie import TensorTrie as JaxTensorTrie
from genrec_tpu.ops import paged as jpaged
from genrec_tpu.ops import spec_tree as jspec
from genrec_tpu.ops import trie as jtrie
from genrec_tpu_torch.catalog.tensor_trie import TensorTrie
from genrec_tpu_torch.ops import paged as tpaged
from genrec_tpu_torch.ops import spec_tree as tspec
from genrec_tpu_torch.ops import trie as ttrie

TOL = 1e-6


@pytest.mark.parametrize("beams,fanout,depth", [
    (2, 3, 2), (4, 8, 2), (10, 8, 2), (20, 8, 1), (3, (5, 2), 2), (4, (6,), 3), (5, 4, 0),
])
def test_tree_topology_tables_equal_jax(beams, fanout, depth):
    j, t = jspec.TreeTopology(beams, fanout, depth), tspec.TreeTopology(beams, fanout, depth)
    assert t.signature() == j.signature() and t.n_nodes == j.n_nodes
    assert t.level_sizes == j.level_sizes
    for name in ("level_offsets", "level", "root_beam", "parent", "anc"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert tspec.tree_topology(beams, fanout, depth) is tspec.tree_topology(beams, fanout, depth)


def test_tree_topology_at_the_serving_shapes():
    """TIGER at 10 beams, fanout 8, depth 2: 730 nodes; COBRA at 20 beams,
    depth 1: 180 (the node axes B1/B2 take on the card)."""
    assert tspec.TreeTopology(10, 8, 2).n_nodes == 730
    assert tspec.TreeTopology(20, 8, 1).n_nodes == 180
    with pytest.raises(ValueError):
        tspec.TreeTopology(0, 8, 1)


def _rng_f(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_tree_virtual_cache_matches_jax():
    rng = np.random.default_rng(0)
    topo_j, topo_t = jspec.TreeTopology(3, 2, 2), tspec.TreeTopology(3, 2, 2)
    B, S, H, hd = 4, 5, 2, 3
    cache = _rng_f(rng, B, 3, S, H, hd)
    new = _rng_f(rng, B, topo_t.n_nodes, H, hd)
    base = np.asarray([0, 1, 2, 4])  # the last row's speculated slots run past S
    want = jspec.tree_virtual_cache(jnp.asarray(cache), jnp.asarray(new), topo_j,
                                    jnp.asarray(base))
    got = tspec.tree_virtual_cache(torch.as_tensor(cache), torch.as_tensor(new), topo_t,
                                   torch.as_tensor(base))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_commit_level_kv_matches_jax():
    rng = np.random.default_rng(1)
    B, K, N, Sc, H, hd = 3, 4, 12, 3, 2, 5
    node_kvs = [(_rng_f(rng, B, N, H, hd), _rng_f(rng, B, N, H, hd)) for _ in range(2)]
    run_ck = [_rng_f(rng, B, K, Sc, H, hd) for _ in range(2)]
    run_cv = [_rng_f(rng, B, K, Sc, H, hd) for _ in range(2)]
    flat_idx = rng.integers(0, N, (B, K))
    parent = rng.integers(0, K, (B, K))
    slot = rng.integers(0, Sc, B)
    jck, jcv = jspec.commit_level_kv(
        [tuple(map(jnp.asarray, kv)) for kv in node_kvs], list(map(jnp.asarray, run_ck)),
        list(map(jnp.asarray, run_cv)), jnp.asarray(flat_idx), jnp.asarray(parent),
        jnp.asarray(slot))
    T = torch.as_tensor
    tck, tcv = tspec.commit_level_kv(
        [tuple(map(T, kv)) for kv in node_kvs], list(map(T, run_ck)), list(map(T, run_cv)),
        T(flat_idx), T(parent), T(slot))
    for a, b in zip(tck + tcv, jck + jcv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_match_drafted_matches_jax():
    rng = np.random.default_rng(2)
    B, N, F, K = 5, 6, 3, 4
    draft = rng.integers(0, 5, (B, N, F))
    draft[0, :, 1] = draft[0, :, 0]  # a code drafted twice: the first slot wins
    parent = rng.integers(0, N, (B, K))
    sel = np.take_along_axis(draft, parent[..., None], 1)[..., 0]  # every edge drafted ...
    sel[1, 2] = 7  # ... but one selection in row 1
    jm, jf = jspec.match_drafted(jnp.asarray(draft), jnp.asarray(parent), jnp.asarray(sel))
    tm, tf = tspec.match_drafted(torch.as_tensor(draft), torch.as_tensor(parent),
                                 torch.as_tensor(sel))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(tm[0]) and not bool(tm[1])
    matched = np.asarray(jm)
    np.testing.assert_array_equal(tf.numpy()[matched], np.asarray(jf)[matched])


def _tries(valid, K, item_weights=None):
    return (JaxTensorTrie.build(valid, K, item_weights=item_weights).device(),
            TensorTrie.build(valid, K, item_weights=item_weights).to("cpu"))


def test_trie_draft_weights_match_jax():
    rng = np.random.default_rng(3)
    valid = rng.integers(0, 6, (40, 3))  # duplicate tuples count twice
    w = rng.random(40)
    for iw in (None, w):
        j, t = _tries(valid, 6, iw)
        np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights), rtol=1e-6)
        prefix = rng.integers(0, 20, (4, 3))
        steps = np.asarray([0, 1, 2, 1])
        np.testing.assert_allclose(
            t.child_weights_ragged(torch.as_tensor(prefix), torch.as_tensor(steps)).numpy(),
            np.asarray(j.child_weights_ragged(jnp.asarray(prefix), jnp.asarray(steps))),
            rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_legal_topk_ragged_matches_jax_with_planted_ties(k):
    """Draft weights with planted ties: equal weights rank the lower code
    first, illegal codes pad the tail flagged False."""
    valid = np.asarray([[0, 1], [0, 3], [0, 3], [2, 5], [2, 5], [2, 5], [2, 1], [4, 0],
                        [4, 6], [4, 6], [4, 2], [4, 2]])
    j, t = _tries(valid, 8)
    prefix = np.asarray([[0, 1], [2, 0], [0, 2]])  # ranks of roots 0, 2, 4 at depth 1
    steps = np.asarray([0, 1, 1])
    jt, jl = jtrie.legal_topk_ragged(j, jnp.asarray(prefix), jnp.asarray(steps), k)
    tt, tl = ttrie.legal_topk_ragged(t, torch.as_tensor(prefix), torch.as_tensor(steps), k)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    if k >= 3:  # root 4's children: 6 and 2 tie at weight 2 (lower code first), then 0
        np.testing.assert_array_equal(tt[2, 1, :3].numpy(), [2, 6, 0])
    # A trie without weights ranks legal codes by code alone.
    dj = jtrie.DenseTrie.build(valid, 8)
    dt = ttrie.DenseTrie.build(valid, 8, device="cpu")
    jt, jl = jtrie.legal_topk_ragged(dj, jnp.asarray(prefix[:, :1] * 0), jnp.asarray(steps * 0),
                                     k)
    tt, tl = ttrie.legal_topk_ragged(dt, torch.as_tensor(prefix[:, :1] * 0),
                                     torch.as_tensor(steps * 0), k)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_tree_suffix_stats_match_jax():
    rng = np.random.default_rng(4)
    S, N, Sc, H, hd = 3, 7, 4, 2, 8
    q = _rng_f(rng, S, N, H, hd)
    vk, vv = _rng_f(rng, S, N, Sc, H, hd), _rng_f(rng, S, N, Sc, H, hd)
    node_steps = rng.integers(0, Sc, (S, N))
    want = jpaged.tree_suffix_stats(jnp.asarray(q), jnp.asarray(vk), jnp.asarray(vv),
                                    jnp.asarray(node_steps))
    got = tpaged.tree_suffix_stats(torch.as_tensor(q), torch.as_tensor(vk),
                                   torch.as_tensor(vv), torch.as_tensor(node_steps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
