"""Exact resume through the port's six trainers on the CPU.

Each case runs a trainer uninterrupted, then again under a
``chaos.ChaosPlan`` that delivers SIGTERM at a step (or after an epoch),
then resumes it with ``resume_from_checkpoint=True``, at the tiny configs
of the JAX package's tests/test_fault_tolerance.py. Held exactly (the
same device, the same operations): the logged step set (no step logged
twice, none missing), the per-step losses bit for bit, and the whole
final resume point (parameters, Adam moments, step counters and the
generator's state) bit for bit. Cases: SASRec mid-epoch and between
epochs, HSTU across a repack, TIGER, RQ-VAE, COBRA and LCRec killed in
their final epoch, LCRec at tensor_parallel=2 with only rank 1 signalled
(both ranks save at the same step through the OR of their guards), the
ladder through a trainer (a garbled newest resume point), LCRec
``eval_only``; and for SASRec, the checkpoint steps and the logged step
set of a killed and resumed run equal the JAX trainer's.
"""

import json
import os

import numpy as np
import pytest
import torch

from genrec_tpu.core import chaos as jchaos
from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core.checkpoint import read_record
from genrec_tpu_torch.parallel.mesh import spawn
from genrec_tpu_torch.trainers import (
    cobra_trainer,
    hstu_trainer,
    lcrec_trainer,
    rqvae_trainer,
    sasrec_trainer,
    tiger_trainer,
)

SASREC = dict(epochs=2, batch_size=32, max_seq_len=32, embed_dim=16, num_heads=2,
              num_blocks=1, ffn_dim=32, dropout=0.1, dataset="synthetic", do_eval=False,
              save_every_epoch=1, wandb_log_interval=1, amp=False, use_fused_ce=False,
              pack_sequences=True, seed=0, device="cpu")
HSTU = dict(epochs=2, batch_size=32, max_seq_len=32, embed_dim=16, num_heads=2, num_blocks=1,
            dropout=0.1, dataset="synthetic", do_eval=False, save_every_epoch=1,
            wandb_log_interval=1, amp=False, use_pallas=False, use_fused_ce=False,
            pack_sequences=True, seed=0, device="cpu")
TIGER = dict(epochs=2, batch_size=16, learning_rate=1e-3, num_warmup_steps=5, embedding_dim=16,
             attn_dim=32, num_heads=4, n_layers=2, sem_id_dim=2, codebook_size=16, max_items=4,
             num_users=40, num_user_embeddings=64, dataset="synthetic", do_eval=False,
             save_every_epoch=1, wandb_log_interval=1, amp=False, pack_sequences=True, seed=0,
             device="cpu")
RQVAE = dict(epochs=3, batch_size=64, learning_rate=1e-3, vae_input_dim=16,
             vae_hidden_dims=(16,), vae_embed_dim=4, vae_codebook_size=8, vae_n_layers=2,
             kmeans_warmup_rows=64, dataset="synthetic", do_eval=False, eval_every=100,
             wandb_log_interval=1, seed=0, device="cpu")
LCREC = dict(epochs=2, batch_size=16, eval_every_epoch=10, do_eval=False, eval_batch_size=16,
             hidden_size=32, intermediate_size=64, n_layers=1, num_heads=2, num_kv_heads=2,
             max_text_len=64, eval_item_tasks=False, save_every_epoch=1, wandb_log_interval=1,
             seed=0, amp=False, device="cpu")
LCREC_TP2 = dict(LCREC, max_train_samples=96, max_eval_samples=16)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: several CPU threads split some reductions of
    the HSTU and LCRec steps differently from run to run (two uninterrupted
    HSTU runs differ in the last bit at 1 step of 14 with 8 threads, never
    with 1), which would hide a resume fault behind noise or fake one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cobra_cfg():
    from genrec_tpu_torch.data.cobra_seq import CobraSeqData
    from genrec_tpu_torch.data.sem_ids import random_unique_sem_ids

    rng = np.random.default_rng(0)
    n_items, C, K = 24, 3, 8
    sem_ids = random_unique_sem_ids(n_items, K, C, rng)
    texts = np.zeros((n_items, 6), np.int32)
    texts[:, :4] = rng.integers(2, 64, (n_items, 4))
    seqs = [np.asarray(rng.integers(1, n_items + 1, rng.integers(5, 9)), np.int64)
            for _ in range(48)]
    return dict(
        dataset=lambda: CobraSeqData(seqs, sem_ids, texts, id_vocab_size=K, max_items=6),
        epochs=1, batch_size=8, learning_rate=1e-3, num_warmup_steps=2, encoder_n_layers=1,
        encoder_hidden_dim=16, encoder_num_heads=2, encoder_vocab_size=64, d_model=16,
        decoder_n_layers=1, decoder_num_heads=2, max_items=6, n_beam=4, do_eval=False,
        save_every_epoch=50, test_on_best=False, wandb_log_interval=1, seed=0, amp=False,
        device="cpu")


def _losses_by_step(save_dir, key="train/loss"):
    """The per-step losses of metrics.jsonl by global step (a resumed run
    appends to the same file; a step may appear at most once)."""
    out = {}
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec and "global_step" in rec:
                step = int(rec["global_step"])
                assert step not in out, f"step {step} logged twice (replayed batch)"
                out[step] = rec[key]
    return out


def _ckpt_dir(save_dir, rank=None):
    root = os.path.join(save_dir, "checkpoints")
    return root if rank is None else os.path.join(root, f"p{rank}")


def _steps(save_dir, rank=None):
    return sorted(int(s) for s in os.listdir(_ckpt_dir(save_dir, rank)) if s.isdigit())


def _final_point(save_dir, rank=None):
    step = _steps(save_dir, rank)[-1]
    flat = read_record(os.path.join(_ckpt_dir(save_dir, rank), str(step)))
    return step, {k: v for k, v in flat.items() if k.startswith("state/")}


def _assert_final_points_equal(dir_a, dir_b, rank=None):
    step_a, fin_a = _final_point(dir_a, rank)
    step_b, fin_b = _final_point(dir_b, rank)
    assert step_a == step_b
    assert fin_a.keys() == fin_b.keys() and "state/generator" in fin_a
    for k in fin_a:
        assert torch.equal(fin_a[k], fin_b[k]), k


def _assert_parity(dir_a, dir_b, key="train/loss", ranks=(None,)):
    """The same steps logged once each, the same losses and the same final
    resume point (each rank's), bit for bit."""
    la, lb = _losses_by_step(dir_a, key), _losses_by_step(dir_b, key)
    assert sorted(la) == sorted(lb) and la, "replayed or skipped batches"
    assert la == lb
    for rank in ranks:
        _assert_final_points_equal(dir_a, dir_b, rank)


def _run_interrupted_and_resume(train, cfg, tmp_path, plan, preempt_rv=({}, {})):
    dir_a = str(tmp_path / "uninterrupted")
    train(**cfg, save_dir_root=dir_a)
    dir_b = str(tmp_path / "interrupted")
    with chaos.inject(plan):
        out = train(**cfg, save_dir_root=dir_b)
    if preempt_rv is not None:
        assert out == preempt_rv  # the preempted exit
    if plan.kill_at_step is not None:  # the mid-epoch resume point sits at the kill
        assert plan.kill_at_step in _steps(dir_b)
    train(**cfg, save_dir_root=dir_b, resume_from_checkpoint=True)
    return dir_a, dir_b


def test_sasrec_exact_resume_after_midepoch_sigterm(tmp_path):
    # 7 steps an epoch at this size: step 3 is mid-epoch 0.
    dir_a, dir_b = _run_interrupted_and_resume(sasrec_trainer.train, SASREC, tmp_path,
                                               chaos.ChaosPlan(kill_at_step=3))
    _assert_parity(dir_a, dir_b)


def test_sasrec_between_epoch_sigterm_resumes_exactly(tmp_path):
    """kill_at_epoch fires in the window after an epoch: the next run_epoch
    call writes a (next epoch, batch 0) resume point without a step."""
    dir_a, dir_b = _run_interrupted_and_resume(sasrec_trainer.train, SASREC, tmp_path,
                                               chaos.ChaosPlan(kill_at_epoch=0))
    assert _steps(dir_b) == [7, 14]  # the epoch-0 save, then the final one
    _assert_parity(dir_a, dir_b)


def test_sasrec_checkpoints_and_logged_steps_match_jax(tmp_path):
    """The JAX trainer killed at the same step and resumed writes the same
    checkpoint steps and logs the same step set."""
    from genrec_tpu.trainers.sasrec_trainer import train as jax_train

    jcfg = {k: v for k, v in SASREC.items() if k != "device"}
    dir_j = str(tmp_path / "jax")
    with jchaos.inject(jchaos.ChaosPlan(kill_at_step=3)):
        assert jax_train(**jcfg, save_dir_root=dir_j) == ({}, {})
    jax_train(**jcfg, save_dir_root=dir_j, resume_from_checkpoint=True)
    dir_p = str(tmp_path / "port")
    with chaos.inject(chaos.ChaosPlan(kill_at_step=3)):
        assert sasrec_trainer.train(**SASREC, save_dir_root=dir_p) == ({}, {})
    sasrec_trainer.train(**SASREC, save_dir_root=dir_p, resume_from_checkpoint=True)
    assert _steps(dir_p) == _steps(dir_j) == [3, 7, 14]
    assert sorted(_losses_by_step(dir_p)) == sorted(_losses_by_step(dir_j)) == list(range(1, 15))


def test_hstu_exact_resume_across_a_repack(tmp_path):
    # Killed inside epoch 1, so the resume also crosses a repack.
    dir_a, dir_b = _run_interrupted_and_resume(hstu_trainer.train, HSTU, tmp_path,
                                               chaos.ChaosPlan(kill_at_step=9))
    _assert_parity(dir_a, dir_b)


def test_tiger_exact_resume_after_midepoch_sigterm(tmp_path):
    dir_a, dir_b = _run_interrupted_and_resume(tiger_trainer.train, TIGER, tmp_path,
                                               chaos.ChaosPlan(kill_at_step=4))
    _assert_parity(dir_a, dir_b)


def test_rqvae_exact_resume_after_midepoch_sigterm(tmp_path):
    # ~28 steps an epoch: step 40 is mid-epoch 1. A preempted run returns
    # (model, None): no sem-ids are exported.
    dir_a, dir_b = _run_interrupted_and_resume(rqvae_trainer.train, RQVAE, tmp_path,
                                               chaos.ChaosPlan(kill_at_step=40),
                                               preempt_rv=None)
    _assert_parity(dir_a, dir_b)


def test_rqvae_iteration_mode_saves_on_its_gate_and_resumes_exactly(tmp_path):
    """Iteration mode: the step hook writes a resume point every
    ``save_model_every`` iterations (mid-epoch cursors), the last epoch
    one more, and a kill between them resumes exactly."""
    cfg = {k: v for k, v in RQVAE.items() if k != "epochs"}
    cfg.update(iterations=50, save_model_every=20)
    dir_a, dir_b = _run_interrupted_and_resume(rqvae_trainer.train, cfg, tmp_path,
                                               chaos.ChaosPlan(kill_at_step=30),
                                               preempt_rv=None)
    assert _steps(dir_a) == [20, 40, 50] and _steps(dir_b) == [30, 40, 50]
    _assert_parity(dir_a, dir_b)


def test_cobra_final_epoch_sigterm_resumes_exactly(tmp_path):
    """epochs=1: every step is inside the final epoch, and save_every_epoch
    never fires; the kill still leaves a resume point, and the finished
    run its unconditional final one."""
    dir_a, dir_b = _run_interrupted_and_resume(cobra_trainer.train, _cobra_cfg(), tmp_path,
                                               chaos.ChaosPlan(kill_at_step=3))
    _assert_parity(dir_a, dir_b)


def test_lcrec_final_epoch_sigterm_resumes_exactly(tmp_path):
    dir_a = str(tmp_path / "uninterrupted")
    valid, _ = lcrec_trainer.train(**LCREC, save_dir_root=dir_a)
    n = max(_losses_by_step(dir_a))
    kill = n // 2 + max(1, n // 4)  # inside the final epoch
    dir_b = str(tmp_path / "interrupted")
    with chaos.inject(chaos.ChaosPlan(kill_at_step=kill)):
        assert lcrec_trainer.train(**LCREC, save_dir_root=dir_b) == ({}, {})
    assert kill in _steps(dir_b)
    lcrec_trainer.train(**LCREC, save_dir_root=dir_b, resume_from_checkpoint=True)
    _assert_parity(dir_a, dir_b)

    # eval_only evaluates the newest resume point: the finished run's final
    # parameters, which its own final valid metrics were taken on.
    m, m2 = lcrec_trainer.train(**LCREC, save_dir_root=dir_a, eval_only=True)
    assert m == m2 == valid


def _lcrec_tp2_rank(group, root, cfg):
    """Rank side of the tensor_parallel=2 case: uninterrupted, killed (SIGTERM
    to rank 1 only), resumed; returns what the parent checks."""
    torch.set_num_threads(1)
    cfg = dict(cfg, tensor_parallel=2)
    dir_a, dir_b = os.path.join(root, "uninterrupted"), os.path.join(root, "interrupted")
    lcrec_trainer.train(**cfg, save_dir_root=dir_a)
    n = _steps(dir_a, group.rank)[-1]
    kill = n // 2 + 1  # inside the final epoch; the ranks poll their OR every 8 steps
    with chaos.inject(chaos.ChaosPlan(kill_at_step=kill, only_process=1)):
        out = lcrec_trainer.train(**cfg, save_dir_root=dir_b)
    killed_steps = _steps(dir_b, group.rank)
    lcrec_trainer.train(**cfg, save_dir_root=dir_b, resume_from_checkpoint=True)
    _assert_final_points_equal(dir_a, dir_b, group.rank)
    return dict(n=n, kill=kill, out=out, killed_steps=killed_steps)


def test_lcrec_tp2_kill_on_one_rank_resumes_exactly(tmp_path):
    root = str(tmp_path / "tp2")
    r0, r1 = spawn(_lcrec_tp2_rank, 2, (root, LCREC_TP2), device="cpu", threads=1,
                   timeout_s=240, store_dir=str(tmp_path))
    assert r0["out"] == r1["out"] == ({}, {})
    poll = -(-r0["kill"] // 8) * 8  # the first poll of the OR at or after the kill
    assert poll <= r0["n"]
    # Both ranks wrote their resume point at the same global step.
    assert poll in r0["killed_steps"] and r0["killed_steps"] == r1["killed_steps"]
    _assert_parity(os.path.join(root, "uninterrupted"), os.path.join(root, "interrupted"),
                   ranks=(0, 1))


def test_sasrec_resume_survives_corrupt_latest(tmp_path):
    """The ladder through a trainer: garble the newest resume point; the
    resume quarantines it, falls back to the previous retained step, and
    the losses from there on equal the uninterrupted run's."""
    dir_a = str(tmp_path / "uninterrupted")
    sasrec_trainer.train(**SASREC, save_dir_root=dir_a)
    d = str(tmp_path / "run")
    with chaos.inject(chaos.ChaosPlan(kill_at_step=10)):
        sasrec_trainer.train(**SASREC, save_dir_root=d)
    assert _steps(d) == [7, 10]  # the epoch-0 save + the preemption save
    chaos.garble_checkpoint(_ckpt_dir(d), 10)
    sasrec_trainer.train(**SASREC, save_dir_root=d, resume_from_checkpoint=True)
    assert 10 not in _steps(d)
    assert os.path.isdir(os.path.join(_ckpt_dir(d), "quarantine", "p0", "10"))
    by_step: dict = {}
    with open(os.path.join(d, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "train/loss" in rec and "global_step" in rec:
                by_step[int(rec["global_step"])] = rec["train/loss"]  # the last run wins
    assert by_step == _losses_by_step(dir_a)
    _assert_final_points_equal(dir_a, d)
