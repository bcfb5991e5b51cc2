"""What the live-plane tests share (tests/test_torch_hot_reload.py,
tests/test_torch_catalog_swap.py): a tiny TIGER in JAX and in the port on
the same weights, the JAX answer of one request, corpora, and a small
paged engine.

Sizes: 2 layers, attention 32 wide in 4 heads, 8 codes a level, 3 levels,
4 beams at T 0.2; one history bucket (8 items) and 2 slots, so requests
queue behind the slots and a staged swap meets slots in flight.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from genrec_tpu.catalog.tensor_trie import TensorTrie as JaxTensorTrie
from genrec_tpu.models import tiger as jtiger
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.models.tiger import Tiger
from genrec_tpu_torch.serving.buckets import BucketLadder
from genrec_tpu_torch.serving.engine import ServingEngine
from genrec_tpu_torch.serving.heads import TigerGenerativeHead
from genrec_tpu_torch.serving.kv_pool import PagedConfig
from genrec_tpu_torch.serving.types import Request

K_CB, D, BEAMS, TEMPERATURE, N_USERS = 8, 3, 4, 0.2, 20
CFG = dict(embedding_dim=16, attn_dim=32, num_heads=4, n_layers=2, num_item_embeddings=K_CB,
           num_user_embeddings=N_USERS, sem_id_dim=D, max_pos=64)
L_BUCKET = 8
PAGED = dict(max_slots=2, page_size=8, pages_per_slot=4)
#: Scores of the port against JAX: GEMM summation order, scaled by 1 / T.
SCORE_ATOL = 1e-5 / TEMPERATURE


def jax_tiger(seed: int = 0):
    jm = jtiger.Tiger(dropout=0.0, **CFG)
    z = jnp.zeros((2, 4 * D), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((2,), jnp.int32), z, z,
                              jnp.zeros((2, D), jnp.int32), jnp.zeros((2, D), jnp.int32),
                              z)["params"]
    return jm, params


def port_state(params, model) -> dict:
    """The port's state dict of ``model`` from the Flax ``params``."""
    return tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, params), model)


def port_tiger(params) -> Tiger:
    model = Tiger(device="cpu", **CFG).eval()
    model.load_state_dict(port_state(params, model))
    return model


@functools.cache
def _jax_generate(jm):
    return jax.jit(functools.partial(jtiger.tiger_generate_paged, jm, n_top_k_candidates=BEAMS,
                                     deterministic=True))


def jax_answer(jm, params, catalog, req, L=L_BUCKET):
    """JAX tiger_generate_paged on one request laid out as the engine's
    prefill lays it out (history bucket L, newest items, ids the catalog
    does not hold dropped)."""
    h = np.asarray(req.history)[-L:]
    h = h[h < len(catalog)]
    ids = np.zeros((1, L * D), np.int32)
    mask = np.zeros((1, L * D), np.int32)
    ids[0, : len(h) * D] = catalog[h].reshape(-1)
    mask[0, : len(h) * D] = 1
    out = _jax_generate(jm)(
        params, JaxTensorTrie.build(catalog, K_CB).device(),
        jnp.asarray([req.user_id % N_USERS], jnp.int32), jnp.asarray(ids),
        jnp.asarray(np.tile(np.arange(D, dtype=np.int32), (1, L))), jnp.asarray(mask),
        jax.random.key(0), temperature=TEMPERATURE,
    )
    return np.asarray(out.sem_ids[0]), np.asarray(out.log_probas[0])


def assert_answers_jax(resp, jm, params, catalog, req) -> None:
    sem, logp = jax_answer(jm, params, catalog, req, resp.bucket[1])
    np.testing.assert_array_equal(resp.sem_ids, sem)
    np.testing.assert_allclose(resp.scores, logp, atol=SCORE_ATOL)


def corpus(rng, n=24):
    return np.unique(rng.integers(0, K_CB, (n, D)), axis=0)


def disjoint_corpora(rng, n=24):
    """Two corpora with no shared tuple (first code 0..3 against 4..7): a
    beam that mixed trie versions would be legal in neither."""
    a = np.unique(np.concatenate([rng.integers(0, K_CB // 2, (n, 1)),
                                  rng.integers(0, K_CB, (n, D - 1))], axis=1), axis=0)
    b = np.unique(np.concatenate([rng.integers(K_CB // 2, K_CB, (n, 1)),
                                  rng.integers(0, K_CB, (n, D - 1))], axis=1), axis=0)
    return a, b


def requests(rng, n, n_items, head="tiger"):
    return [Request(head=head, history=rng.integers(0, n_items, int(k)),
                    user_id=int(rng.integers(0, 10**6)))
            for k in rng.integers(1, L_BUCKET + 1, n)]


def tiger_engine(model, heads=(), catalog=None, snapshot=None, **kw) -> ServingEngine:
    """A CPU engine over a TIGER head on ``model`` (plus ``heads``), not
    started."""
    head = TigerGenerativeHead(model, item_sem_ids=catalog, catalog=snapshot, top_k=BEAMS)
    kw.setdefault("handle_signals", False)
    return ServingEngine([head, *heads], device="cpu", ladder=BucketLadder((1, 2), (L_BUCKET,)),
                         max_batch=2, max_wait_ms=1.0, paged_config=PagedConfig(**PAGED), **kw)


def wait_for(pred, what: str, timeout: float = 60.0, poll=None) -> None:
    """Poll ``pred`` until it holds (calling ``poll`` between tries)."""
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        if poll is not None:
            poll()
        time.sleep(0.01)
