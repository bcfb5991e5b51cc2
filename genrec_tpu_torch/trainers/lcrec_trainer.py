"""LCRec trainer (port of genrec_tpu/trainers/lcrec_trainer.py).

    python -m genrec_tpu_torch.trainers.lcrec_trainer config/lcrec/synthetic.gin \
        [--gin 'train.device="cpu"']
    torchrun --standalone --nproc_per_node=2 -m genrec_tpu_torch.trainers.lcrec_trainer \
        config/lcrec/synthetic.gin --gin 'train.tensor_parallel=2'

The same config files drive both packages. Epoch loop, AdamW with a
cosine schedule after a linear warm-up, global-norm clip 1.0, SFT with
prompt-masked labels, and the constrained beam search eval (per-codebook
accuracy, Recall/NDCG@{1,5,10}), plus the item2index and index2item
evals. ``use_fused_ce`` keeps its JAX name; ``"auto"`` means True: the
CUDA kernels on the card, their plain versions on the CPU.

``tensor_parallel`` is 1 or the number of processes: one process per
rank, launched by torchrun (or ``parallel.mesh.spawn``), each holding its
shard of the backbone; the head's cross-entropy is then the vocab-sharded
fused CE (B8). Every rank starts from the same full parameters, made
from ``seed`` and sliced. Runs on ``device="cuda"`` by default (it raises
without a card unless given ``device="cpu"``); the ranks share ``cuda:0``
when the host has fewer cards than ranks.

Fault tolerance as the JAX trainer's: resume points every
``save_every_epoch`` epochs, on SIGTERM/SIGINT (the run then returns
``({}, {})``) and, unconditionally, after the last epoch; exact resume
with ``resume_from_checkpoint=True``; ``eval_only`` evaluates the newest
valid checkpoint (`core.fault_tolerance.restore_for_eval`);
``profile_steps`` steps under torch.profiler in ``<save_dir_root>/profile``.
Each rank keeps its own shard: its records under
``<save_dir_root>/checkpoints/p<rank>`` (the ranks agree on the step they
restore and, through the OR of their guards, on the step they save at
when one is signalled), ``best_model.rank<r>`` and ``final_model.rank<r>``
(``best_model`` and ``final_model`` at tensor_parallel=1).

``dataset="amazon"`` reads the review and meta dumps under
``<dataset_folder>/raw/<split>/`` and the RQ-VAE's sem-id artifact
(``sem_ids_path``, whose shape sets the codebooks) through
`data.lcrec_tasks.amazon_lcrec_data`. Its ``pretrained_path`` is None (the
dump's words make a `WordTokenizer`; the backbone is random at the
configured widths), a tokenizer-only HF directory (the backbone as for
None, its vocabulary sized to the tokenizer) or a local HF Qwen2
checkpoint (``config.json`` + weights, read with
``AutoModelForCausalLM.from_pretrained`` into
`models.backbones.qwen.params_from_hf_state_dict`); ``transformers`` is
imported only when a ``pretrained_path`` is given.

``use_lora`` trains rank-``lora_rank`` adapters on ``lora_targets``
(`core.lora`) at tensor_parallel=1: the base stays frozen and is never
written (the step runs the loss under merged weights through
``torch.func.functional_call``), the optimizer, the resume points and
``best_model`` hold the adapters, ``final_model`` the merged parameters;
the frozen head's fused CE launches no dW kernel. LoRA with
``tensor_parallel`` or ``expert_parallel`` > 1 raises ValueError, as in
JAX.

Not ported yet, each raising with its ROADMAP item:
``num_experts``/``expert_parallel`` (A14), ``sequence_parallel`` (A15),
``pipeline_parallel`` (A16), data parallelism beside tensor parallelism
(A17). wandb forwarding logs a warning.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from genrec_tpu_torch import configlib
from genrec_tpu_torch.core.checkpoint import BestTracker, CheckpointManager, save_params
from genrec_tpu_torch.core.fault_tolerance import restore_for_eval
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.lora import (
    LoraAdapters,
    call_merged,
    lora_init,
    lora_merge,
    lora_param_count,
)
from genrec_tpu_torch.core.logging import Tracker, setup_logger
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.preemption import PreemptionGuard
from genrec_tpu_torch.core.profiling import ProfileWindow
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data.batching import batch_iterator
from genrec_tpu_torch.data.lcrec_tasks import amazon_lcrec_data, synthetic_lcrec_data
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.backbones.qwen import (
    QwenConfig,
    QwenLM,
    params_from_hf_state_dict,
    qwen_init_params,
)
from genrec_tpu_torch.models.lcrec import (
    extend_vocab,
    generate_greedy,
    generate_topk_constrained,
    make_tp_sharded_fused_sft_loss,
    sft_loss,
)
from genrec_tpu_torch.ops.metrics import TopKAccumulator
from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
from genrec_tpu_torch.parallel.mesh import distributed_init
from genrec_tpu_torch.parallel.shardings import shard_qwen_params
from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop

TORCHRUN = ("torchrun --standalone --nproc_per_node=2 -m genrec_tpu_torch.trainers."
            "lcrec_trainer <config.gin> --gin 'train.tensor_parallel=2'")


def _on(batch: dict, device, keys=("input_ids", "attention_mask")) -> dict:
    return {k: torch.as_tensor(batch[k], device=device) for k in keys}


def make_generate_fn(model, base_vocab, num_codebooks, codebook_size, beam_width, max_cache):
    """``gen(batch) -> sem_ids (B, W, C)``: the constrained beam search."""

    def gen(batch):
        return generate_topk_constrained(
            model, batch["input_ids"], batch["attention_mask"], base_vocab, num_codebooks,
            codebook_size, beam_width=beam_width, max_cache=max_cache).sem_ids

    return gen


def evaluate_item2index(gen_fn, arrays, batch_size, device, num_codebooks):
    """Greedy constrained item -> index over the item set: exact-match and
    per-codebook accuracy. Every tensor-parallel rank sees every batch, so
    nothing is summed over ranks (JAX sums over data-parallel hosts)."""
    correct = np.zeros(num_codebooks)
    exact = total = 0
    for host, valid in batch_iterator(arrays, batch_size):
        top = gen_fn(_on(host, device)).cpu().numpy()
        n = int(valid.sum())
        pred, target = top[:n, 0, :], host["target_ids"][:n]
        correct += (pred == target).sum(axis=0)
        exact += int((pred == target).all(axis=1).sum())
        total += n
    out = {"item2index_exact": exact / max(total, 1)}
    out.update({f"item2index_c{c}": correct[c] / max(total, 1) for c in range(num_codebooks)})
    return out


def evaluate_index2item(free_fn, arrays, target_texts, batch_size, device, tok):
    """Unconstrained index -> item: the generated text must contain the
    target title."""
    match = total = offset = 0
    for host, valid in batch_iterator(arrays, batch_size):
        toks = free_fn(_on(host, device)).cpu().numpy()
        n = int(valid.sum())
        for i in range(n):
            tgt = target_texts[offset + i].strip().lower()
            gen = tok.decode(toks[i]).strip().lower()
            if tgt and gen and tgt in gen:
                match += 1
        total += n
        offset += n
    return {"index2item_match": match / max(total, 1)}


def evaluate(gen_fn, arrays, batch_size, device, num_codebooks):
    """Recall/NDCG@{1,5,10} of the beams and per-codebook accuracy of the
    top beam."""
    acc = TopKAccumulator(ks=(1, 5, 10))
    cb_correct = np.zeros(num_codebooks)
    cb_total = 0
    for host, valid in batch_iterator(arrays, batch_size):
        top = gen_fn(_on(host, device)).cpu()
        n = int(valid.sum())
        target = torch.as_tensor(host["target_ids"][:n])
        acc.accumulate(target, top[:n])
        cb_correct += (top[:n, 0, :] == target).sum(dim=0).numpy()
        cb_total += n
    m = acc.reduce()
    m.update({f"codebook_acc_{c}": cb_correct[c] / max(cb_total, 1)
              for c in range(num_codebooks)})
    return m


def backbone_params(tok, pretrained_path, widths: dict, seed: int, device, max_pos: int,
                    logger=None):
    """(QwenConfig, full state dict on ``device``) of the amazon branch's
    backbone before the codebook tokens: a local HF Qwen2 checkpoint's
    weights when ``pretrained_path`` holds a ``config.json``, else a random
    init from ``seed`` at ``widths`` with the vocabulary sized to ``tok``."""
    hf_config = os.path.join(pretrained_path or "", "config.json")
    if not (pretrained_path and os.path.exists(hf_config)):
        cfg = QwenConfig(vocab_size=tok.base_vocab, **widths, max_position_embeddings=max_pos,
                         rope_theta=10000.0, tie_word_embeddings=False)
        return cfg, qwen_init_params(cfg, seed, device)
    import json

    from transformers import AutoModelForCausalLM

    with open(hf_config) as f:
        hc = json.load(f)
    cfg = QwenConfig(
        vocab_size=hc["vocab_size"], hidden_size=hc["hidden_size"],
        intermediate_size=hc["intermediate_size"],
        num_hidden_layers=hc["num_hidden_layers"],
        num_attention_heads=hc["num_attention_heads"],
        num_key_value_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
        max_position_embeddings=max(max_pos, hc.get("max_position_embeddings", max_pos)),
        rope_theta=hc.get("rope_theta", 1e6), rms_norm_eps=hc.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=hc.get("tie_word_embeddings", True),
    )
    hf_model = AutoModelForCausalLM.from_pretrained(pretrained_path, torch_dtype=torch.float32)
    full = params_from_hf_state_dict(hf_model.state_dict(), cfg)
    del hf_model
    if logger is not None:
        logger.info(f"loaded HF backbone from {pretrained_path}")
    return cfg, {k: v.to(device) for k, v in full.items()}


def lora_loss_fn(model, base_loss, alpha: float, rank: int):
    """``loss_fn(adapters, batch, generator)`` of the LoRA step:
    ``base_loss(model, batch)`` under W + (alpha / rank) A B at the adapted
    weights (``adapters``: a `LoraAdapters`); the frozen base is read,
    never written."""
    base = dict(model.named_parameters())

    def loss_fn(adapters, batch, generator):
        merged = lora_merge(base, adapters.tree(), alpha, rank)
        return call_merged(model, merged, base_loss, batch), {}

    return loss_fn


def _refuse(tensor_parallel, world, *, use_lora, num_experts, expert_parallel,
            sequence_parallel, pipeline_parallel):
    """Raise on what the port does not run yet, naming the ROADMAP item,
    and on LoRA beside model parallelism, as the JAX trainer does."""
    if expert_parallel > 1 and use_lora:
        # The trainable tree is the adapters: an expert axis would shard
        # nothing of it.
        raise ValueError("expert_parallel with use_lora is not wired; run LoRA "
                         "data-parallel")
    if tensor_parallel > 1 and use_lora:
        # The step merges from the whole base on every rank, so tensor
        # parallelism would shard nothing.
        raise ValueError("tensor_parallel with use_lora is not wired; run LoRA "
                         "data-parallel (it is already memory-light)")
    if tensor_parallel > 1 and world == 1:
        raise RuntimeError(f"tensor_parallel={tensor_parallel} runs one process per rank: "
                           f"{TORCHRUN}")
    if world > 1 and tensor_parallel != world:
        raise NotImplementedError(
            f"{world} processes with tensor_parallel={tensor_parallel}: data parallelism "
            "beside tensor parallelism is not ported; ROADMAP A17")
    refused = [
        (num_experts > 0 or expert_parallel > 1, "num_experts / expert_parallel (MoE)",
         "A14"),
        (sequence_parallel > 1, "sequence_parallel (ring attention)", "A15"),
        (pipeline_parallel > 1, "pipeline_parallel", "A16"),
    ]
    for bad, what, item in refused:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet; ROADMAP {item}")


@configlib.configurable
def train(
    epochs=4,
    batch_size=8,
    learning_rate=3e-4,
    num_warmup_steps=20,
    weight_decay=0.01,
    num_codebooks=3,
    codebook_size=8,
    beam_width=10,
    max_text_len=96,
    use_lora=False,
    gradient_checkpointing=False,
    use_fused_ce="auto",
    sequence_parallel=1,
    pipeline_parallel=1,
    pp_microbatches=None,
    tensor_parallel=1,
    lora_rank=8,
    lora_alpha=16.0,
    lora_targets=("q_proj", "v_proj"),
    num_experts=0,
    num_experts_per_tok=2,
    expert_parallel=1,
    pretrained_path=None,
    hidden_size=64,
    intermediate_size=128,
    n_layers=2,
    num_heads=4,
    num_kv_heads=2,
    dataset="synthetic",
    dataset_folder="dataset/amazon",
    split="beauty",
    sem_ids_path=None,
    max_history=20,
    samples_per_user=2,
    task_weights=None,
    eval_item_tasks=True,
    eval_items_limit=256,
    index2item_max_new=16,
    do_eval=True,
    eval_only=False,
    max_train_samples=0,
    max_eval_samples=0,
    resume_from_checkpoint=False,
    test_on_best=True,
    eval_every_epoch=2,
    eval_batch_size=16,
    save_dir_root="out/lcrec",
    save_every_epoch=10,
    wandb_logging=False,
    wandb_project="lcrec_training",
    wandb_log_interval=50,
    amp=True,
    mixed_precision_type="bf16",
    profile_steps=0,
    seed=0,
    device="cuda",
):
    """Train LCRec; returns (valid metrics, test metrics) of the best
    parameters by valid Recall@10 (``test_on_best``) or the last ones."""
    group = distributed_init(device)
    world = 1 if group is None else group.size
    _refuse(tensor_parallel, world, use_lora=use_lora, num_experts=num_experts,
            expert_parallel=expert_parallel, sequence_parallel=sequence_parallel,
            pipeline_parallel=pipeline_parallel)
    rank = 0 if group is None else group.rank
    tp_group = group if tensor_parallel > 1 else None
    dev = group.device if group is not None else resolve_device(device)
    # Rank 0 writes the run's files; every rank logs to its own stdout.
    logger = setup_logger(save_dir_root if rank == 0 else None)
    tracker = Tracker(wandb_logging and rank == 0, wandb_project,
                      save_dir=save_dir_root if rank == 0 else None, logger=logger)
    compute_dtype = (torch.bfloat16 if (amp and mixed_precision_type == "bf16")
                     else torch.float32)

    tw_extra = {} if task_weights is None else {"task_weights": tuple(task_weights)}
    widths = dict(hidden_size=hidden_size, intermediate_size=intermediate_size,
                  num_hidden_layers=n_layers, num_attention_heads=num_heads,
                  num_key_value_heads=num_kv_heads)
    if dataset == "synthetic":
        data, tok = synthetic_lcrec_data(codebook_size=codebook_size,
                                         num_codebooks=num_codebooks, seed=seed, **tw_extra)
        data.max_len = max_text_len
        # The backbone's vocab covers the words; extend_vocab appends the
        # codebook tokens, as the HF resize path does.
        cfg = QwenConfig(vocab_size=tok.base_vocab, **widths,
                         max_position_embeddings=max_text_len + num_codebooks + 1,
                         rope_theta=10000.0, tie_word_embeddings=False)
        full = qwen_init_params(cfg, seed, dev)
    else:
        # Real-data path (reference amazon_lcrec.py:164-676).
        if sem_ids_path is None:
            raise ValueError("amazon LCRec needs sem_ids_path (RQ-VAE artifact)")
        hf_tok = None
        if pretrained_path:
            from transformers import AutoTokenizer

            hf_tok = AutoTokenizer.from_pretrained(pretrained_path)
        data, tok = amazon_lcrec_data(dataset_folder, split, sem_ids_path, tokenizer=hf_tok,
                                      max_len=max_text_len, max_history=max_history, seed=seed,
                                      **tw_extra)
        num_codebooks = int(data.sem_ids.shape[1])
        codebook_size = int(tok.codebook_size)
        cfg, full = backbone_params(
            tok, pretrained_path, widths, seed, dev,
            max_pos=max_text_len + max(num_codebooks, index2item_max_new) + 1, logger=logger)
    cfg, full, base_vocab = extend_vocab(
        cfg, full, num_codebooks, codebook_size,
        torch.Generator(device=dev).manual_seed(seed + 1), base=tok.base_vocab,
        pad_to=math.lcm(8, tensor_parallel))
    model = QwenLM(cfg, dtype=compute_dtype, group=tp_group, device=dev,
                   remat=gradient_checkpointing)
    model.load_state_dict(shard_qwen_params(full, rank, tensor_parallel))
    del full
    live_vocab = base_vocab + num_codebooks * codebook_size
    logger.info(f"vocab {base_vocab} + {num_codebooks * codebook_size} codebook tokens"
                + (f" (+{cfg.vocab_size - live_vocab} pad)" if cfg.vocab_size > live_vocab
                   else "")
                + (f"; tensor_parallel={tensor_parallel} over {group.backend}"
                   if tp_group is not None else ""))

    train_arrays = data.train_arrays(samples_per_user=samples_per_user)
    valid_arrays = data.eval_arrays("valid")
    test_arrays = data.eval_arrays("test")
    if max_train_samples > 0:
        train_arrays = {k: v[:max_train_samples] for k, v in train_arrays.items()}
    if max_eval_samples > 0:
        valid_arrays = {k: v[:max_eval_samples] for k, v in valid_arrays.items()}
        test_arrays = {k: v[:max_eval_samples] for k, v in test_arrays.items()}

    steps_per_epoch = max(1, len(train_arrays["input_ids"]) // batch_size)
    schedule = cosine_schedule_with_warmup(learning_rate, num_warmup_steps,
                                           epochs * steps_per_epoch)
    optimizer = Adam(schedule, weight_decay=weight_decay)
    fused = use_fused_ce == "auto" or bool(use_fused_ce)
    if tp_group is not None and fused:
        tp_loss = make_tp_sharded_fused_sft_loss(model, valid_vocab=live_vocab)

        def base_loss(m, batch):
            return tp_loss(batch)
    else:
        def base_loss(m, batch):
            return sft_loss(m, batch["input_ids"], batch["attention_mask"],
                            batch["labels"], valid_vocab=live_vocab, use_fused_ce=fused)

    if use_lora:
        for p in model.parameters():
            p.requires_grad_(False)
        trainable = LoraAdapters(lora_init(
            dict(model.named_parameters()), torch.Generator(device=dev).manual_seed(seed + 7),
            lora_rank, tuple(lora_targets)))
        logger.info(f"LoRA: {lora_param_count(trainable.tree())} trainable params")
        loss_fn = lora_loss_fn(model, base_loss, lora_alpha, lora_rank)

        def params_of():
            """The merged parameters (state dict names) of the adapters now."""
            with torch.no_grad():
                return lora_merge(dict(model.named_parameters()), trainable.tree(),
                                  lora_alpha, lora_rank)
    else:
        trainable = model

        def loss_fn(model, batch, generator):
            return base_loss(model, batch), {}

    def _merged(fn):
        """``fn(batch)`` of the model, under the merged weights under LoRA."""
        if not use_lora:
            return fn
        return lambda batch: call_merged(model, params_of(), lambda _m: fn(batch))

    step_fn = make_train_step(loss_fn, optimizer, clip_norm=1.0, group=tp_group)
    state = TrainState.create(trainable, optimizer, seed)
    gen_fn = _merged(make_generate_fn(model, base_vocab, num_codebooks, codebook_size,
                                      beam_width, max_cache=max_text_len + num_codebooks + 1))
    # Each rank keeps (and writes) its own shard.
    ckpt = (CheckpointManager(os.path.join(save_dir_root, "checkpoints"), per_host=True)
            if save_dir_root else None)
    prof = ProfileWindow(os.path.join(save_dir_root, "profile") if save_dir_root else "",
                         profile_steps)
    loop = PackedTrainLoop(
        logger=logger, tracker=tracker, device=dev, prof=prof, guard=PreemptionGuard(logger),
        ckpt=ckpt, rows_per_step=batch_size, row_len=max_text_len, seed=seed,
        pack_sequences=False, train_arrays=train_arrays,
        wandb_log_interval=wandb_log_interval, save_dir_root=save_dir_root,
    )
    suffix = "" if tp_group is None else f".rank{rank}"

    # eval_only restores the newest checkpoint WITHOUT the exact-resume
    # preconditions: a pure evaluation consumes no training data, so another
    # data seed or a bare state record must not refuse it.
    start_epoch, start_batch, global_step = 0, 0, 0
    if eval_only:
        state, ckpt_step = restore_for_eval(ckpt, state, logger=logger)
        if ckpt_step is None:
            logger.warning("eval_only without a checkpoint: evaluating the INITIAL model")
        m = evaluate(gen_fn, valid_arrays, eval_batch_size, dev, num_codebooks)
        logger.info("eval_only " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
        loop.shutdown()
        return m, m
    if resume_from_checkpoint:
        state, start_epoch, start_batch, global_step = loop.resume(state)

    best = BestTracker(save_dir_root, name=f"best_model{suffix}")
    for epoch in range(start_epoch, epochs):
        res = loop.run_epoch(state, step_fn, epoch, global_step,
                             start_batch=start_batch if epoch == start_epoch else 0)
        state, global_step = res.state, res.global_step
        if res.preempted:
            # The loop wrote a durable resume point (mid-final-epoch too):
            # exit cleanly so that the scheduler restarts the run with
            # resume_from_checkpoint.
            loop.shutdown(preempted_epoch=epoch)
            return {}, {}
        if ckpt is not None and (epoch + 1) % save_every_epoch == 0:
            # Epoch-boundary resume point: cursor = (next epoch, batch 0).
            loop.save(state, epoch=epoch + 1, next_batch=0, global_step=global_step)
        if do_eval and (epoch + 1) % eval_every_epoch == 0:
            m = evaluate(gen_fn, valid_arrays, eval_batch_size, dev, num_codebooks)
            logger.info(f"epoch {epoch} valid "
                        + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
            tracker.log({"epoch": epoch, **{f"eval/{k}": v for k, v in m.items()}})
            best.update(m["Recall@10"], trainable.state_dict())

    # Unconditional final resume point: a save_every_epoch cadence that
    # never fires must not leave a finished run with nothing to resume from.
    loop.save(state, epoch=epochs, next_batch=0, global_step=global_step)
    best_params = best.best_params(like=trainable.state_dict()) if test_on_best else None
    if best_params is not None:
        trainable.load_state_dict(best_params)
    valid_metrics = evaluate(gen_fn, valid_arrays, eval_batch_size, dev, num_codebooks)
    test_metrics = evaluate(gen_fn, test_arrays, eval_batch_size, dev, num_codebooks)
    if eval_item_tasks:
        greedy_fn = _merged(make_generate_fn(model, base_vocab, num_codebooks, codebook_size,
                                             1, max_cache=max_text_len + num_codebooks + 1))
        i2i_arrays = data.item2index_eval_arrays(eval_items_limit)
        test_metrics.update(evaluate_item2index(greedy_fn, i2i_arrays, eval_batch_size, dev,
                                                num_codebooks))
        idx2i_arrays, idx2i_texts = data.index2item_eval_arrays(eval_items_limit)

        @_merged
        def free_fn(batch):
            # Argmax stays off vocab rows the tokenizer cannot decode.
            return generate_greedy(model, batch["input_ids"], batch["attention_mask"],
                                   index2item_max_new, tok.eos_id,
                                   max_cache=max_text_len + index2item_max_new,
                                   valid_vocab=tok.vocab_size)

        test_metrics.update(evaluate_index2item(free_fn, idx2i_arrays, idx2i_texts,
                                                eval_batch_size, dev, tok))
    logger.info("test " + ", ".join(f"{k}={v:.4f}" for k, v in test_metrics.items()))
    tracker.log({f"test/{k}": v for k, v in test_metrics.items()})
    if save_dir_root:
        # Under LoRA, the merged parameters (best_model holds the adapters).
        final = {**model.state_dict(), **params_of()} if use_lora else model.state_dict()
        save_params(os.path.join(save_dir_root, f"final_model{suffix}"), final)
    loop.shutdown()
    return valid_metrics, test_metrics


if __name__ == "__main__":
    configlib.parse_config()
    train()
