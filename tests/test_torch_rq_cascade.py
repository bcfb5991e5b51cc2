"""The residual-quantisation cascade (kernel B7's plain version), port
against the JAX package.

genrec_tpu_torch/kernels/rq_cascade.py pairs with
genrec_tpu/kernels/rq_cascade.py; ``rq_cascade_ref`` is held to
``rq_cascade_pallas`` in interpret mode and to the RQ-VAE model's own
``get_semantic_ids``. Inputs are made from a seed with numpy.

Tolerances: sem-ids exact on every row outside the near ties, qsum within
1e-5 relative to its largest element. Two fp32 implementations that sum
a dot product in different orders can pick either of two codewords whose
distances are within rounding of each other, and every later level
follows that pick; ``near_tie_rows`` marks the rows with a level whose
two smallest distances are within 1e-5 x max |dist| (in float64 along
the reference's cascade). Those rows are counted and the count is
bounded, never silently excused. Duplicated codewords tie exactly, and
there the lower index must win on every row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.kernels.rq_cascade import rq_cascade_pallas
from genrec_tpu.models.rqvae import QuantizeForwardMode, RqVae as JaxRqVae
from genrec_tpu_torch.convert import rqvae_params_from_flax
from genrec_tpu_torch.kernels.rq_cascade import near_tie_rows, rq_cascade, rq_cascade_ref
from genrec_tpu_torch.models.rqvae import RqVae

torch.set_num_threads(1)


def _inputs(seed, B, L, K, D, duplicate=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    cb = (rng.normal(size=(L, K, D)) * 0.7).astype(np.float32)
    if duplicate:
        # Every codeword of the first half repeated in the second half, so
        # each argmin ties exactly between k and k + K/2.
        cb[:, K // 2:] = cb[:, : K - K // 2]
    return x, cb


def _check(x, cb, ids, qsum, want_ids, want_qsum, max_near=0.02):
    """ids equal outside near ties (bounded share), qsum 1e-5 relative on
    the rows whose ids agree."""
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    near = near_tie_rows(torch.as_tensor(x), torch.as_tensor(cb),
                         torch.as_tensor(want_ids)).numpy()
    differ = (ids != want_ids).any(axis=1)
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    assert near.mean() <= max_near, near.mean()
    same = ~differ
    scale = float(np.abs(want_qsum).max())
    np.testing.assert_allclose(np.asarray(qsum)[same], np.asarray(want_qsum)[same],
                               rtol=0, atol=1e-5 * scale)
    return int(near.sum())


@pytest.mark.parametrize("B,L,K,D", [
    (37, 3, 256, 32),   # ragged B (not a multiple of a block), the RQ-VAE's K and D
    (64, 1, 45, 16),    # L = 1, K not a multiple of 32
    (10, 3, 300, 8),    # K above one 256-codeword chunk
    (40, 5, 256, 64),   # LCRec's RQ-VAE (config/lcrec/amazon/rqvae.gin): 5 levels, D 64
])
def test_ref_matches_pallas_interpret(B, L, K, D):
    x, cb = _inputs(B + K, B, L, K, D)
    got_ids, got_q = rq_cascade_ref(torch.as_tensor(x), torch.as_tensor(cb))
    want_ids, want_q = rq_cascade_pallas(jnp.asarray(x), jnp.asarray(cb), blk_b=8,
                                         interpret=True)
    assert got_ids.dtype == torch.int32 and tuple(got_ids.shape) == (B, L)
    _check(x, cb, got_ids.numpy(), got_q.numpy(), np.asarray(want_ids), np.asarray(want_q))
    # CPU tensors route to the plain version.
    routed = rq_cascade(torch.as_tensor(x), torch.as_tensor(cb))
    np.testing.assert_array_equal(routed[0].numpy(), got_ids.numpy())


@pytest.mark.parametrize("L,K", [(1, 32), (3, 64)])
def test_duplicated_codewords_take_the_lower_index(L, K):
    x, cb = _inputs(5, 50, L, K, 8, duplicate=True)
    ids, _ = rq_cascade_ref(torch.as_tensor(x), torch.as_tensor(cb))
    want, _ = rq_cascade_pallas(jnp.asarray(x), jnp.asarray(cb), blk_b=8, interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    assert (ids.numpy() < K - K // 2).all()


def test_ref_matches_the_model_path():
    """Encoder output through rq_cascade_ref against the JAX model's
    get_semantic_ids (dist with the |x|^2 term): equal outside near ties."""
    model = JaxRqVae(input_dim=24, embed_dim=8, hidden_dims=(16,), codebook_size=64,
                     codebook_mode=QuantizeForwardMode.STE,
                     codebook_last_layer_mode=QuantizeForwardMode.SINKHORN,
                     n_layers=3, n_cat_features=0)
    import jax

    x = np.random.default_rng(7).normal(size=(200, 24)).astype(np.float32)
    params = model.init({"params": jax.random.key(0), "gumbel": jax.random.key(1)},
                        jnp.asarray(x[:2]), 0.2)["params"]
    want = model.apply({"params": params}, jnp.asarray(x), 0.001,
                       method=JaxRqVae.get_semantic_ids)
    port = RqVae(input_dim=24, embed_dim=8, hidden_dims=(16,), codebook_size=64,
                 n_layers=3, n_cat_features=0, device="cpu")
    port.load_state_dict(rqvae_params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                port))
    with torch.no_grad():
        enc = port.encode(torch.as_tensor(x))
        ids, qsum = rq_cascade_ref(enc, port.codebooks())
    _check(enc.numpy(), port.codebooks().detach().numpy(), ids.numpy(), qsum.numpy(),
           np.asarray(want.sem_ids), np.asarray(want.embeddings).sum(axis=0))


def test_near_tie_rows_marks_exact_ties():
    x, cb = _inputs(3, 20, 2, 16, 4)
    cb[0, 5] = cb[0, 9]  # codewords 5 and 9 of level 0 tie exactly
    res = torch.as_tensor(x)
    ids, _ = rq_cascade_ref(res, torch.as_tensor(cb))
    near = near_tie_rows(res, torch.as_tensor(cb), ids)
    picked_tied = ids[:, 0] == 5
    assert picked_tied.any() and near[picked_tied].all()
