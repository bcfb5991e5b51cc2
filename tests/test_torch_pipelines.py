"""The two-stage pipeline runner and the trainers' Amazon branches, port
against the JAX package on the CPU, at tiny widths.

- ``pipelines.run_two_stage`` for TIGER through config/tiger/amazon/{rqvae,
  tiger}.gin on a dump this test writes (chip_smoke.write_amazon_dump),
  ``device="cpu"``: the port's sem-id artifact loads in JAX's
  ``load_sem_ids`` with the RQ-VAE's shape and codebook size, and stage 2's
  metrics are finite. ``pipelines.main`` runs the COBRA (the fixture
  tokenizer standing in for sentence-T5's) and LCRec pipelines the same way.
- The LCRec trainer over a full local HF checkpoint (a tiny
  ``Qwen2ForCausalLM`` built from a config and saved with the fixture
  tokenizer): the port's backbone, built as the trainer builds it, gives
  HF's logits on one prompt at 1e-5 (fp32) before the first step, over the
  tokenizer's vocabulary; the trainer then trains on it. A tokenizer-only
  directory sizes the random backbone's vocabulary to the tokenizer.
"""

import functools
import json
import math
import os

import numpy as np
import pytest
import torch
from transformers import AutoTokenizer, Qwen2Config, Qwen2ForCausalLM

import chip_smoke
from genrec_tpu.data.sem_ids import load_sem_ids as jax_load_sem_ids
from genrec_tpu_torch import pipelines
from genrec_tpu_torch.data.amazon import load_sequences
from genrec_tpu_torch.data.lcrec_tasks import HFTokenizerAdapter
from genrec_tpu_torch.models.backbones.qwen import QwenLM
from genrec_tpu_torch.models.lcrec import extend_vocab
from genrec_tpu_torch.parallel.shardings import shard_qwen_params
from genrec_tpu_torch.trainers import cobra_trainer, lcrec_trainer

torch.set_num_threads(1)

TOK_DIR = os.path.join(os.path.dirname(__file__), "data", "tiny_hf_tokenizer")
DUMP = dict(users=60, items=40, reviews=400, seed=0, emb_dim=24)
# Stage 1 at fixture scale (the shipped files keep their levels and modes).
RQVAE = ["train.epochs=3", "train.warmup_epochs=0", "train.batch_size=16",
         "train.vae_input_dim=24", "train.vae_hidden_dims=[32]", "train.vae_embed_dim=8",
         "train.vae_codebook_size=8", "train.kmeans_warmup_rows=200", "train.do_eval=False"]


@pytest.fixture(scope="module")
def amazon_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("amazon")
    chip_smoke.write_amazon_dump(root, **DUMP)
    load_sequences(str(root), "beauty", download=False)
    return str(root)


def _finite(*metrics):
    return all(np.isfinite(v) for m in metrics for v in m.values())


def test_tiger_two_stage_artifact_loads_in_jax(amazon_root, tmp_path):
    valid, test = pipelines.run_two_stage(
        "tiger_trainer", "config/tiger/amazon/rqvae.gin", "config/tiger/amazon/tiger.gin",
        "beauty", [f"train.dataset_folder='{amazon_root}'", "train.wandb_logging=False"],
        [*RQVAE, f"train.save_dir_root='{tmp_path}/rq'"],
        ["train.epochs=1", "train.batch_size=32", "train.num_warmup_steps=5",
         "train.embedding_dim=16", "train.attn_dim=32", "train.num_heads=4",
         "train.n_layers=2", "train.max_items=6", "train.num_user_embeddings=64",
         "train.eval_batch_size=32", f"train.save_dir_root='{tmp_path}/tiger'"],
        workdir=str(tmp_path / "wd"), device="cpu")
    sem_ids, K = jax_load_sem_ids(str(tmp_path / "wd" / "beauty" / "sem_ids.npz"))
    assert sem_ids.shape == (DUMP["items"], 3) and K == 8
    assert set(valid) == set(test) and _finite(valid, test)
    assert (tmp_path / "tiger" / "best_model").exists()


@pytest.mark.parametrize("pipeline", ["cobra", "lcrec"])
def test_pipeline_cli_runs_cobra_and_lcrec(amazon_root, tmp_path, monkeypatch, pipeline):
    if pipeline == "cobra":
        # The fixture tokenizer stands in for sentence-T5's (not in the repo).
        monkeypatch.setattr(cobra_trainer, "amazon_cobra_data", functools.partial(
            cobra_trainer.amazon_cobra_data, tokenizer_name=TOK_DIR, max_text_len=8))
        model = ["config/cobra/amazon.gin",
                 "train.epochs=1", "train.batch_size=16", "train.num_warmup_steps=2",
                 "train.encoder_hidden_dim=32", "train.encoder_num_heads=2",
                 "train.encoder_vocab_size=640", "train.d_model=32", "train.max_len=64",
                 "train.decoder_n_layers=1", "train.decoder_num_heads=2", "train.max_items=6",
                 "train.n_beam=4", "train.eval_batch_size=32"]
        rq_config, levels = "config/tiger/amazon/rqvae.gin", 3
    else:
        model = ["config/lcrec/amazon/lcrec_debug.gin",
                 "train.pretrained_path=None", "train.epochs=1", "train.batch_size=8",
                 "train.max_text_len=96", "train.num_warmup_steps=2", "train.hidden_size=32",
                 "train.intermediate_size=64", "train.n_layers=2", "train.num_heads=4",
                 "train.num_kv_heads=2", "train.beam_width=4", "train.max_train_samples=32",
                 "train.max_eval_samples=8", "train.eval_batch_size=8"]
        rq_config, levels = "config/lcrec/amazon/rqvae.gin", 5
    argv = [pipeline, "--rqvae-config", rq_config, "--model-config", model[0],
            "--split", "beauty", "--workdir", str(tmp_path / "wd"), "--device", "cpu",
            "--gin", f"train.dataset_folder='{amazon_root}'", "--gin", "train.wandb_logging=False"]
    for b in [*RQVAE, f"train.save_dir_root='{tmp_path}/rq'"]:
        argv += ["--rqvae-gin", b]
    for b in [*model[1:], f"train.save_dir_root='{tmp_path}/model'"]:
        argv += ["--model-gin", b]
    valid, test = pipelines.main(argv)
    sem_ids, K = jax_load_sem_ids(str(tmp_path / "wd" / "beauty" / "sem_ids.npz"))
    assert sem_ids.shape == (DUMP["items"], levels) and K == 8
    assert "Recall@10" in test and _finite(valid, test)
    logged = (tmp_path / "model" / "metrics.jsonl").read_text()
    assert '"train/loss"' in logged


def _checkpoint(path, tie):
    """A tiny Qwen2ForCausalLM with the fixture tokenizer, saved as HF does."""
    tok = AutoTokenizer.from_pretrained(TOK_DIR)
    torch.manual_seed(0)
    cfg = Qwen2Config(vocab_size=640, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-6,
                      tie_word_embeddings=tie, attn_implementation="eager")
    model = Qwen2ForCausalLM(cfg).eval()
    model.save_pretrained(path)
    tok.save_pretrained(path)
    return model


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_lcrec_hf_checkpoint_logits_match_hf(amazon_root, tmp_path, tie):
    path = str(tmp_path / "ckpt")
    hf = _checkpoint(path, tie)
    tok = HFTokenizerAdapter(AutoTokenizer.from_pretrained(path), 5, 8)
    widths = dict(hidden_size=8, intermediate_size=16, num_hidden_layers=1,
                  num_attention_heads=2, num_key_value_heads=1)  # ignored: the file's win
    cfg, full = lcrec_trainer.backbone_params(tok, path, widths, 0, "cpu", max_pos=128)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers) == (640, 32, 2)
    assert cfg.tie_word_embeddings == tie
    # As the trainer: the codebook rows appended at the tokenizer's base.
    cfg, full, base = extend_vocab(cfg, full, 5, 8, torch.Generator().manual_seed(1),
                                   base=tok.base_vocab, pad_to=math.lcm(8, 1))
    assert base == tok.base_vocab == 619
    model = QwenLM(cfg, device="cpu").eval()
    model.load_state_dict(shard_qwen_params(full, 0, 1))
    ids = torch.as_tensor([tok.encode("index tokens of the item")], dtype=torch.int64)
    mask = torch.ones_like(ids)
    with torch.no_grad():
        got = model(ids, attention_mask=mask)[..., :base]
        want = hf(input_ids=ids, attention_mask=mask).logits[..., :base]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # The trainer takes it end to end.
    sem = str(tmp_path / "sem_ids.npz")
    from genrec_tpu_torch.data.sem_ids import random_unique_sem_ids, save_sem_ids

    save_sem_ids(sem, random_unique_sem_ids(DUMP["items"], 8, 5, np.random.default_rng(1)), 8)
    valid, test = lcrec_trainer.train(
        epochs=1, batch_size=8, eval_every_epoch=1, eval_batch_size=8, dataset="amazon",
        dataset_folder=amazon_root, sem_ids_path=sem, pretrained_path=path, max_text_len=96,
        eval_items_limit=8, index2item_max_new=6, max_train_samples=16, max_eval_samples=8,
        amp=False, device="cpu", save_dir_root=str(tmp_path / "lcrec"))
    assert "item2index_exact" in test and _finite(valid, test)
    log = (tmp_path / "lcrec" / "train.log").read_text()
    assert f"loaded HF backbone from {path}" in log


def test_lcrec_tokenizer_only_dir_sizes_the_random_backbone(amazon_root, tmp_path):
    tok = HFTokenizerAdapter(AutoTokenizer.from_pretrained(TOK_DIR), 3, 8)
    widths = dict(hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                  num_attention_heads=2, num_key_value_heads=1)
    cfg, full = lcrec_trainer.backbone_params(tok, TOK_DIR, widths, 0, "cpu", max_pos=40)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.max_position_embeddings) == (619, 16, 40)
    assert not cfg.tie_word_embeddings and full["lm_head"].shape == (619, 16)
    sem = str(tmp_path / "sem_ids.npz")
    from genrec_tpu_torch.data.sem_ids import random_unique_sem_ids, save_sem_ids

    save_sem_ids(sem, random_unique_sem_ids(DUMP["items"], 8, 3, np.random.default_rng(1)), 8)
    valid, test = lcrec_trainer.train(
        epochs=1, batch_size=8, eval_every_epoch=1, eval_batch_size=8, dataset="amazon",
        dataset_folder=amazon_root, sem_ids_path=sem, pretrained_path=TOK_DIR,
        max_text_len=96, hidden_size=32, intermediate_size=64, n_layers=2, num_heads=2,
        num_kv_heads=2, eval_items_limit=8, index2item_max_new=6, max_train_samples=16,
        max_eval_samples=8, device="cpu", save_dir_root=str(tmp_path / "lcrec"))
    assert {"item2index_exact", "index2item_match", "codebook_acc_0"} <= set(test)
    assert _finite(valid, test)
    log = (tmp_path / "lcrec" / "train.log").read_text()
    assert "vocab 619 + 24 codebook tokens" in log
    records = [json.loads(line) for line in open(tmp_path / "lcrec" / "metrics.jsonl")]
    assert any("train/loss" in r for r in records)
