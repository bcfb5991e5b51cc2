"""SASRec training, port against the JAX package.

Pairs: genrec_tpu_torch/data/batching.py ``right_align`` with its JAX twin
(the same arrays), five steps of ``core/harness.make_train_step`` with the
JAX SASRec trainer's step (its loss function, Adam b2 0.98, no clipping)
at the widths of config/sasrec/synthetic.gin on the same packed batches
from one init at dropout 0, trainers/sasrec_trainer.py ``evaluate`` with
the JAX ``evaluate`` on the same weights (right-aligned rows read at the
last valid slot, and left-padded rows read at slot -1), and ``train()``
end to end on that config on the CPU.

Tolerance: per-step losses and gradient norms 1e-5 relative; parameters
after the steps 1e-5 relative plus 1e-2 x the learning rate absolute
(fp32 on both sides; the summation order differs, and Adam's update
m / sqrt(v) turns a ~1e-7 difference of a gradient near zero into a
difference of a fraction of the learning rate; the config's 1e-2 is ten
times the HSTU test's, whose 1e-5 this scales). Left out of that check
are the parameters whose JAX gradient stays within 1e-6 of the largest at
every step, and the test asserts that these are exactly the key
projections' biases: softmax is invariant to them, so their gradient is
zero up to rounding and Adam's step on it is noise of the size of the
learning rate in either package. right_align and recall
exact; NDCG 1e-6 relative (fp32 sums of
1/log2(rank + 2) in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genrec_tpu.core.harness import make_train_step as jax_make_train_step
from genrec_tpu.core.state import TrainState as JaxTrainState
from genrec_tpu.data import batching as jb
from genrec_tpu.data.synthetic import SyntheticSeqDataset as JaxSynthetic
from genrec_tpu.models.sasrec import SASRec as JaxSASRec
from genrec_tpu.parallel import get_mesh
from genrec_tpu.trainers import sasrec_trainer as jtrainer
from genrec_tpu_torch import configlib
from genrec_tpu_torch.convert import sasrec_params_from_flax
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data import batching as tb
from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset
from genrec_tpu_torch.kernels import fused_ce, hstu_attention
from genrec_tpu_torch.models.sasrec import SASRec
from genrec_tpu_torch.trainers import sasrec_trainer

torch.set_num_threads(1)

GIN = "config/sasrec/synthetic.gin"


def _gin():
    """The train bindings of config/sasrec/synthetic.gin, read by the
    port's configlib."""
    configlib.clear_bindings()
    configlib.clear_macros()
    try:
        configlib.parse_file(GIN)
        return configlib.get_bindings("genrec_tpu_torch.trainers.sasrec_trainer.train")
    finally:
        configlib.clear_bindings()
        configlib.clear_macros()


def _cfg(g):
    return dict(max_seq_len=g["max_seq_len"], embed_dim=g["embed_dim"],
                num_heads=g["num_heads"], num_blocks=g["num_blocks"], ffn_dim=g["ffn_dim"],
                dropout=0.0)


def test_right_align_matches_jax():
    arrays = SyntheticSeqDataset(max_seq_len=16, seed=0).eval_arrays("valid")
    arrays["other"] = np.arange(len(arrays["targets"]))  # passes through
    arrays["input_ids"][3] = 0  # an empty row stays empty
    got, want = tb.right_align(arrays), jb.right_align(arrays)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    only = tb.right_align(arrays, keys=["input_ids"])
    np.testing.assert_array_equal(only["targets"], arrays["targets"])


def _batches(g, n):
    ds = SyntheticSeqDataset(max_seq_len=g["max_seq_len"], seed=0)
    arrays, _ = tb.pack_examples(ds.train_examples(), row_len=g["max_seq_len"], seed=(0, 0))
    arrays.pop("segment_valid")
    out = []
    for batch, _ in tb.batch_iterator(arrays, g["batch_size"], shuffle=True, seed=0,
                                      drop_last=True):
        out.append(batch)
        if len(out) == n:
            return out
    raise AssertionError("not enough batches")


@pytest.mark.parametrize("fused", [False, True], ids=["plain_ce", "fused_ce"])
def test_five_train_steps_match_jax(fused):
    g = _gin()
    n_items = SyntheticSeqDataset(max_seq_len=g["max_seq_len"], seed=0).num_items
    jm = JaxSASRec(num_items=n_items, **_cfg(g))
    params = jm.init(jax.random.key(0), jnp.zeros((1, g["max_seq_len"]), jnp.int32))["params"]
    opt = optax.adam(g["learning_rate"], b2=0.98)

    def loss_fn(p, batch, rng):  # the JAX trainer's
        _, loss = jm.apply({"params": p}, batch["input_ids"], batch["targets"],
                           deterministic=False, segment_ids=batch.get("segment_ids"),
                           positions=batch.get("positions"), rngs={"dropout": rng})
        return loss, {"real_tokens": jnp.sum(batch["segment_ids"] != 0).astype(jnp.float32)}

    jstep = jax.jit(jax_make_train_step(loss_fn, opt, clip_norm=None))
    jstate = JaxTrainState.create(params, opt, jax.random.key(1))

    model = SASRec(num_items=n_items, **_cfg(g), fused_ce=fused, device="cpu")
    model.load_state_dict(sasrec_params_from_flax(jax.device_get(params), model))
    optimizer = Adam(g["learning_rate"], b2=0.98)
    step = make_train_step(sasrec_trainer.make_loss_fn(), optimizer, clip_norm=None)
    state = TrainState.create(model, optimizer, seed=1)
    jgrad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b, jax.random.key(2))[0]))
    grad_max = {}  # largest |JAX gradient| of each parameter over the steps
    for i, b in enumerate(_batches(g, 5)):
        jb_ = {k: jnp.asarray(v) for k, v in b.items()}
        for name, gr in sasrec_params_from_flax(jax.device_get(jgrad(jstate.params, jb_))).items():
            grad_max[name] = max(grad_max.get(name, 0.0), float(gr.abs().max()))
        jstate, jm_ = jstep(jstate, jb_)
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        for key in ("loss", "grad_norm", "real_tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm_[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    assert int(state.step) == int(jstate.step) == 5
    want = sasrec_params_from_flax(jax.device_get(jstate.params))
    # Left out: the parameters whose JAX gradient stayed rounding noise
    # (<= 1e-6 x the largest gradient) at every step, which Adam scales to
    # ~lr. They must be exactly the key projections' biases.
    noise = {n for n, m in grad_max.items() if m <= 1e-6 * max(grad_max.values())}
    assert noise == {n for n, _ in model.named_parameters() if n.endswith("k_proj.bias")}, noise
    for name, p in model.named_parameters():
        if name not in noise:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=1e-2 * g["learning_rate"], rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("last_from_length", [False, True], ids=["slot_-1", "last_valid"])
def test_evaluate_matches_jax(last_from_length):
    """Recall/NDCG@{1,5,10} of one set of weights on the valid split, the
    JAX evaluate (8-device CPU mesh) against the port's on the CPU."""
    cfg = dict(num_items=60, max_seq_len=16, embed_dim=32, num_heads=2, num_blocks=1,
               ffn_dim=64, dropout=0.0)
    jm = JaxSASRec(**cfg)
    params = jm.init(jax.random.key(2), jnp.zeros((1, 16), jnp.int32))["params"]
    arrays = SyntheticSeqDataset(num_items=60, num_users=120, max_seq_len=16,
                                 seed=0).eval_arrays("valid")
    if last_from_length:
        arrays = tb.right_align(arrays)
    want = jtrainer.evaluate(jtrainer.make_eval_step(jm, last_from_length), params, arrays,
                             32, get_mesh())
    tm = SASRec(**cfg, device="cpu")
    tm.load_state_dict(sasrec_params_from_flax(jax.device_get(params), tm))
    got = sasrec_trainer.evaluate(sasrec_trainer.make_eval_step(tm, last_from_length),
                                  arrays, 32, "cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0 if "Recall" in k else 1e-6,
                                   err_msg=k)


def test_synthetic_data_matches_jax():
    for split in ("valid", "test"):
        g = SyntheticSeqDataset(max_seq_len=16, seed=0).eval_arrays(split)
        w = JaxSynthetic(max_seq_len=16, seed=0).eval_arrays(split)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{split}/{k}")


def test_train_runs_end_to_end_on_the_cpu(tmp_path):
    """config/sasrec/synthetic.gin through the port's trainer with
    device="cpu": finite metrics, the run's files, and no kernel launched
    (CPU tensors take the plain versions)."""
    configlib.clear_bindings()
    configlib.clear_macros()
    try:
        configlib.parse_file(GIN)
        configlib.parse_binding(f'train.save_dir_root = "{tmp_path}"')
        configlib.parse_binding('train.device = "cpu"')
        configlib.parse_binding("train.epochs = 2")
        counters = (hstu_attention.hstu_attention_fwd_cuda, hstu_attention.hstu_attention_bwd_cuda,
                    fused_ce.fused_linear_ce_fwd_cuda, fused_ce.fused_linear_ce_dx_cuda,
                    fused_ce.fused_linear_ce_dw_cuda)
        before = [f.launches for f in counters]
        valid, test = sasrec_trainer.train()
    finally:
        configlib.clear_bindings()
        configlib.clear_macros()
    assert set(valid) == set(test) == {f"{m}@{k}" for m in ("Recall", "NDCG") for k in (1, 5, 10)}
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in (*valid.values(), *test.values()))
    assert valid["Recall@10"] > 0
    assert [f.launches for f in counters] == before
    for name in ("train.log", "metrics.jsonl", "best_model"):
        assert (tmp_path / name).exists(), name
    assert "valid Recall@1=" in (tmp_path / "train.log").read_text()


def test_unported_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A18"):
        sasrec_trainer.train(dataset="amazon", device="cpu", save_dir_root=str(tmp_path))
    # Resume is ported (A12): the Amazon refusal comes first.
    with pytest.raises(NotImplementedError, match="ROADMAP A18"):
        sasrec_trainer.train(dataset="amazon", resume_from_checkpoint=True, device="cpu",
                             save_dir_root="")


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sasrec_trainer.train(epochs=0, save_dir_root="")
