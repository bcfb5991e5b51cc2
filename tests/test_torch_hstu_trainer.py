"""HSTU training, port against the JAX package.

Pairs: genrec_tpu_torch/data/{synthetic,batching}.py with their JAX
twins (the same arrays), core/harness.py ``make_train_step`` with the JAX
harness (per-step losses from one init on the same batches, dropout 0,
fp32), its non-finite guard with the JAX guard, trainers/hstu_trainer.py
``evaluate`` with the JAX ``evaluate`` on the same weights, and
``train()`` end to end on config/hstu/synthetic.gin on the CPU.

Tolerance: per-step losses and gradient norms 1e-5 relative, parameters
after the steps 1e-5 absolute plus 1e-5 relative (fp32 on both sides;
summation order differs, and Adam carries each step's ~1e-7 gradient
differences into the next step's weights); packing, batching and recall
exact; NDCG 1e-6 relative (fp32 sums of 1/log2(rank + 2), summed over
8 devices on the JAX side).
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
from genrec_tpu.models.hstu import HSTU as JaxHSTU
from genrec_tpu.parallel import get_mesh
from genrec_tpu.trainers import hstu_trainer as jtrainer
from genrec_tpu_torch import configlib
from genrec_tpu_torch.convert import hstu_params_from_flax
from genrec_tpu_torch.core.checkpoint import load_params
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data import batching as tb
from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset
from genrec_tpu_torch.kernels import fused_ce, hstu_attention
from genrec_tpu_torch.models.hstu import HSTU
from genrec_tpu_torch.trainers import hstu_trainer
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop
from tests._torch_amazon import tiny_amazon

torch.set_num_threads(1)

CFG = dict(num_items=60, max_seq_len=16, embed_dim=32, num_heads=2, num_blocks=2,
           dropout=0.0)
DATA = dict(num_items=60, num_users=120, max_seq_len=16, seed=0)
ROWS = 8


def _examples():
    return SyntheticSeqDataset(**DATA).train_examples(with_time=True)


@pytest.mark.parametrize("seed", [None, (0, 1)], ids=["input_order", "seeded"])
def test_packing_matches_jax(seed):
    jex = JaxSynthetic(**DATA).train_examples(with_time=True)
    tex = _examples()
    got, got_rep = tb.pack_examples(tex, row_len=16, seed=seed)
    want, want_rep = jb.pack_examples(jex, row_len=16, seed=seed)
    assert got_rep == tb.PackingReport(**vars(want_rep))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    capped = tb.pack_examples(tex, row_len=16, max_segments=2, seed=seed)[0]
    for k, v in jb.pack_examples(jex, row_len=16, max_segments=2, seed=seed)[0].items():
        np.testing.assert_array_equal(capped[k], v, err_msg=k)


def test_batches_and_eval_arrays_match_jax():
    arrays, _ = tb.pack_examples(_examples(), row_len=16, seed=(0, 0))
    got = list(tb.batch_iterator(arrays, ROWS, shuffle=True, seed=3, epoch=2,
                                 drop_last=True, start_batch=1))
    want = list(jb.batch_iterator(arrays, ROWS, shuffle=True, seed=3, epoch=2,
                                  drop_last=True, start_batch=1))
    assert len(got) == len(want) > 0
    for (gb, gv), (wb, wv) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
    ds, jds = SyntheticSeqDataset(**DATA), JaxSynthetic(**DATA)
    for split in ("valid", "test"):
        g, w = ds.eval_arrays_with_time(split), jds.eval_arrays_with_time(split)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{split}/{k}")
    last = list(tb.fold_valid(tb.batch_iterator(g, 32)))[-1][0]
    assert last["valid"].dtype == np.int32 and last["valid"].sum() == len(g["targets"]) % 32


def _batches(n):
    arrays, _ = tb.pack_examples(_examples(), row_len=16, seed=(0, 0))
    arrays.pop("positions")
    arrays.pop("segment_valid")
    out = []
    for batch, _ in tb.batch_iterator(arrays, ROWS, shuffle=True, seed=0, drop_last=True):
        out.append(batch)
        if len(out) == n:
            return out
    raise AssertionError("not enough batches")


def _jax_setup(wd, clip, accum, scale_key=False):
    model = JaxHSTU(**CFG)
    params = model.init(jax.random.key(0), jnp.zeros((1, 16), jnp.int32),
                        jnp.zeros((1, 16), jnp.int32))["params"]
    opt = (optax.adamw(1e-3, b2=0.98, weight_decay=wd) if wd
           else optax.adam(1e-3, b2=0.98))

    def loss_fn(p, batch, rng):
        _, loss = model.apply({"params": p}, batch["input_ids"], batch["timestamps"],
                              batch["targets"], deterministic=False,
                              segment_ids=batch["segment_ids"], rngs={"dropout": rng})
        if scale_key:
            loss = loss * batch["scale"][0]
        return loss, {"real_tokens": jnp.sum(batch["segment_ids"] != 0).astype(jnp.float32)}

    step = jax.jit(jax_make_train_step(loss_fn, opt, accum_steps=accum, clip_norm=clip))
    return params, step, JaxTrainState.create(params, opt, jax.random.key(1))


def _port_setup(params, flags, wd, clip, accum, scale_key=False):
    model = HSTU(**CFG, use_pallas=flags, fused_ce=flags, device="cpu")
    model.load_state_dict(hstu_params_from_flax(jax.device_get(params), model))
    opt = Adam(1e-3, b2=0.98, weight_decay=wd)
    loss_fn = hstu_trainer.make_loss_fn()
    if scale_key:
        def loss_fn(model, batch, gen, _inner=loss_fn):
            loss, aux = _inner(model, batch, gen)
            return loss * batch["scale"][0], aux
    step = make_train_step(loss_fn, opt, accum_steps=accum, clip_norm=clip)
    return model, step, TrainState.create(model, opt, seed=1)


# (port flags, AdamW weight decay, clip norm, accumulation steps)
STEP_CASES = {
    "plain": (False, 0.0, None, 1),
    "kernels": (True, 0.0, None, 1),
    "clip_accum_adamw": (True, 0.01, 0.5, 2),
}


@pytest.mark.parametrize("case", STEP_CASES)
def test_five_train_steps_match_jax(case):
    flags, wd, clip, accum = STEP_CASES[case]
    params, jstep, jstate = _jax_setup(wd, clip, accum)
    model, step, state = _port_setup(params, flags, wd, clip, accum)
    for i, b in enumerate(_batches(5)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        for key in ("loss", "grad_norm", "real_tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    assert int(state.step) == int(jstate.step) == 5
    assert int(state.opt_state["count"]) == 5
    want = hstu_params_from_flax(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_nonfinite_guard_skips_poisoned_batches_and_counts_the_streak():
    """Batches 1 and 2 are poisoned (loss times NaN): both packages keep
    parameters, optimizer state and step, and count the streak 1, 2; the
    next finite step resets it to 0. The port's state is unchanged bit for
    bit across a skipped step."""
    params, jstep, jstate = _jax_setup(0.0, None, 1, scale_key=True)
    model, step, state = _port_setup(params, False, 0.0, None, 1, scale_key=True)
    scales = [1.0, np.nan, np.nan, 1.0]
    flags, counts = [], []
    for b, scale in zip(_batches(4), scales):
        b = {**b, "scale": np.full(ROWS, scale, np.float32)}
        before = [p.detach().clone() for p in model.parameters()]
        mu = [t.clone() for t in state.opt_state["mu"]]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        skipped = bool(m["nonfinite"])
        flags.append(skipped)
        counts.append(int(state.nonfinite_count))
        assert skipped == bool(jm["nonfinite"])
        assert int(state.nonfinite_count) == int(jstate.nonfinite_count)
        assert int(state.step) == int(jstate.step)
        if skipped:
            assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
            assert all(torch.equal(a, t) for a, t in zip(mu, state.opt_state["mu"]))
    assert flags == [False, True, True, False]
    assert counts == [0, 1, 2, 0]
    assert int(state.step) == 2 and int(state.opt_state["count"]) == 2


def test_evaluate_matches_jax():
    """Recall/NDCG@{1,5,10} of one set of weights on the valid split, the
    JAX evaluate (8-device CPU mesh) against the port's on the CPU."""
    model = JaxHSTU(**CFG)
    params = model.init(jax.random.key(2), jnp.zeros((1, 16), jnp.int32),
                        jnp.zeros((1, 16), jnp.int32))["params"]
    arrays = SyntheticSeqDataset(**DATA).eval_arrays_with_time("valid")
    want = jtrainer.evaluate(jtrainer.make_eval_step(model), params, arrays, 32, get_mesh())
    tm = HSTU(**CFG, device="cpu")
    tm.load_state_dict(hstu_params_from_flax(jax.device_get(params), tm))
    got = hstu_trainer.evaluate(hstu_trainer.make_eval_step(tm), arrays, 32, "cpu")
    assert set(got) == set(want)
    for k in want:  # hit counts exactly; DCG sums are fp32, summed in other orders
        np.testing.assert_allclose(got[k], want[k], rtol=0 if "Recall" in k else 1e-6,
                                   err_msg=k)


class _FixedLogits(torch.nn.Module):
    def __init__(self, logits):
        super().__init__()
        self.logits = logits

    def forward(self, input_ids, timestamps=None):
        return self.logits, None


def test_eval_top_k_order_matches_lax_top_k_on_ties():
    """Tied scores rank the lower item id first, as lax.top_k does, and
    item 0 (the pad) never ranks."""
    rng = np.random.default_rng(5)
    last = rng.integers(0, 4, size=(6, 40)).astype(np.float32)  # many ties
    last[:, 0] = 99.0
    targets = rng.integers(1, 40, size=(6, 1)).astype(np.int32)
    logits = torch.zeros((6, 3, 40))
    logits[:, -1] = torch.as_tensor(last)
    step = hstu_trainer.make_eval_step(_FixedLogits(logits))
    got = step({"input_ids": torch.zeros((6, 3), dtype=torch.int32),
                "targets": torch.as_tensor(targets)}, torch.ones(6))
    masked = jnp.asarray(last).at[:, 0].set(-jnp.inf)
    _, top = jax.lax.top_k(masked, 10)
    ranks = np.asarray(jtrainer.first_match_ranks(jnp.asarray(targets), top[..., None]))
    for k in (1, 5, 10):
        assert float(got[f"recall_sum@{k}"]) == float((ranks < k).sum())


def test_train_runs_end_to_end_on_the_cpu(tmp_path):
    """config/hstu/synthetic.gin through the port's trainer with
    device="cpu": finite metrics, the run's files, and no kernel launched
    (CPU tensors take the plain versions)."""
    configlib.clear_bindings()
    configlib.clear_macros()
    try:
        configlib.parse_file("config/hstu/synthetic.gin")
        configlib.parse_binding(f'train.save_dir_root = "{tmp_path}"')
        configlib.parse_binding('train.device = "cpu"')
        configlib.parse_binding("train.epochs = 2")
        counters = (hstu_attention.hstu_attention_fwd_cuda, hstu_attention.hstu_attention_bwd_cuda,
                    fused_ce.fused_linear_ce_fwd_cuda, fused_ce.fused_linear_ce_dx_cuda,
                    fused_ce.fused_linear_ce_dw_cuda)
        before = [f.launches for f in counters]
        valid, test = hstu_trainer.train()
    finally:
        configlib.clear_bindings()
        configlib.clear_macros()
    assert set(valid) == set(test) == {f"{m}@{k}" for m in ("Recall", "NDCG") for k in (1, 5, 10)}
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in (*valid.values(), *test.values()))
    assert [f.launches for f in counters] == before
    for name in ("train.log", "metrics.jsonl", "best_model"):
        assert (tmp_path / name).exists(), name
    assert "valid Recall@1=" in (tmp_path / "train.log").read_text()


def test_packed_loop_max_steps_and_unported_options(tmp_path):
    arrays, rep = tb.pack_examples(_examples(), row_len=16)
    model = HSTU(**CFG, device="cpu")
    opt = Adam(1e-3, b2=0.98)
    state = TrainState.create(model, opt, seed=0)
    seen = []
    loop = PackedTrainLoop(
        logger=hstu_trainer.setup_logger(None), tracker=hstu_trainer.Tracker(),
        device="cpu", rows_per_step=ROWS, row_len=16, seed=0, pack_sequences=True,
        repack=lambda epoch: ({k: v for k, v in arrays.items()
                               if k not in ("positions", "segment_valid")}, rep),
        step_hook=lambda s, m, g, *_: seen.append(g))
    step = make_train_step(hstu_trainer.make_loss_fn(), opt, clip_norm=None)
    res = loop.run_epoch(state, step, 0, 0, max_steps=3)
    assert (res.global_step, res.n_batches, seen) == (3, 3, [1, 2, 3])
    res = loop.run_epoch(state, step, 0, 3, start_batch=3)
    assert res.global_step == rep.n_rows // ROWS and int(state.step) == res.global_step
    assert loop.examples_per_step == ROWS * rep.n_examples / rep.n_rows
    # Without a checkpoint manager a save writes nothing and a resume is a
    # fresh start (resume points are ported, A12).
    loop.save(state, epoch=1, next_batch=0, global_step=3)
    assert loop.resume(state) == (state, 0, 0, 0)
    # The amazon branch (A18): AmazonSASRecData with timestamps over a dump,
    # its item count taken from the dump (the num_items argument ignored).
    dump = tiny_amazon(tmp_path)
    valid, test = hstu_trainer.train(
        dataset="amazon", dataset_folder=dump["root"], num_items=999, epochs=1, batch_size=4,
        max_seq_len=16, embed_dim=16, num_heads=2, num_blocks=1, device="cpu",
        save_dir_root=str(tmp_path / "amazon_run"))
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in (*valid.values(), *test.values()))
    best = load_params(str(tmp_path / "amazon_run" / "best_model"))
    assert best["item_embedding"].shape == (dump["items"] + 1, 16)


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hstu_trainer.train(epochs=0, save_dir_root="")
