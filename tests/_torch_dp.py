"""The rank side of tests/test_torch_dp*.py: the port's steps and trainer
runs over a data group (``parallel.mesh.spawn`` ranks import this module,
which imports no JAX), and the same functions on one rank (group None)
for the references."""

import os

import numpy as np
import torch

from genrec_tpu_torch.convert import (
    hstu_params_from_flax,
    rqvae_params_from_flax,
    sasrec_params_from_flax,
)
from genrec_tpu_torch.core import chaos
from genrec_tpu_torch.core.checkpoint import read_record
from genrec_tpu_torch.core.harness import make_train_step
from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.data import batching as tb
from genrec_tpu_torch.data.items import SyntheticItemEmbeddings
from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset
from genrec_tpu_torch.models import rqvae as trq
from genrec_tpu_torch.models.hstu import HSTU
from genrec_tpu_torch.models.sasrec import SASRec
from genrec_tpu_torch.ops import schedules as tsched
from genrec_tpu_torch.parallel import mesh as pm
from genrec_tpu_torch.trainers import hstu_trainer, rqvae_trainer, sasrec_trainer

WORLD = 2
STEPS = 3
HSTU_CFG = dict(num_items=60, max_seq_len=16, embed_dim=32, num_heads=2, num_blocks=2)
SAS_CFG = dict(num_items=60, max_seq_len=16, embed_dim=32, num_heads=2, num_blocks=1,
               ffn_dim=64)
LR = 1e-3
RQ = dict(input_dim=24, embed_dim=8, hidden_dims=(16, 12), codebook_size=32, n_layers=3,
          commitment_weight=0.25, n_cat_features=0)
RQ_SCHED = (1e-2, 2, 5)
TRAIN = dict(epochs=2, batch_size=16, max_seq_len=12, embed_dim=16, num_heads=2,
             num_blocks=1, dropout=0.1, num_position_buckets=8, num_time_buckets=8,
             max_position_distance=16, eval_batch_size=32, save_every_epoch=1,
             wandb_log_interval=1, amp=False, device="cpu", seed=0)


def _seq_batches(rows=8, n=STEPS):
    ds = SyntheticSeqDataset(num_items=60, num_users=120, max_seq_len=16, seed=0)
    arrays, _ = tb.pack_examples(ds.train_examples(with_time=True), row_len=16, seed=(0, 0))
    arrays.pop("segment_valid")
    out = []
    for batch, _ in tb.batch_iterator(arrays, rows, shuffle=True, seed=0, drop_last=True):
        out.append(batch)
        if len(out) == n:
            return out
    raise AssertionError("not enough batches")


def _rq_batches():
    return [{"x": np.random.default_rng(20 + i).normal(size=(64, 24)).astype(np.float32)}
            for i in range(STEPS)]


# -- the port's steps, on one rank (group None) or over a data group --------

def _hstu(params, dropout=0.0):
    model = HSTU(**HSTU_CFG, dropout=dropout, use_pallas=True, fused_ce=True, device="cpu")
    model.load_state_dict(hstu_params_from_flax(params, model))
    batches = [{k: v for k, v in b.items() if k != "positions"} for b in _seq_batches()]
    return model, hstu_trainer.make_loss_fn(), Adam(LR, b2=0.98), None, batches


def _sasrec(params):
    model = SASRec(**SAS_CFG, dropout=0.0, fused_ce=True, device="cpu")
    model.load_state_dict(sasrec_params_from_flax(params, model))
    batches = [{k: v for k, v in b.items() if k != "timestamps"} for b in _seq_batches()]
    return model, sasrec_trainer.make_loss_fn(), Adam(LR, b2=0.98), None, batches


def _rqvae(params, mode="STE"):
    M = trq.QuantizeForwardMode
    model = trq.RqVae(**RQ, codebook_mode=M[mode], codebook_last_layer_mode=M.SINKHORN,
                      device="cpu")
    model.load_state_dict(rqvae_params_from_flax(params, model))
    opt = Adam(tsched.linear_schedule_with_warmup(*RQ_SCHED), weight_decay=1e-4)
    return model, rqvae_trainer.make_loss_fn(0.2), opt, 1.0, _rq_batches()


CASES = {"hstu": (_hstu, {}), "hstu_dropout": (_hstu, {"dropout": 0.2}),
         "sasrec": (_sasrec, {}), "rqvae": (_rqvae, {}),
         "rqvae_gumbel": (_rqvae, {"mode": "GUMBEL_SOFTMAX"})}


def _port_steps(group, case, params):
    build, kw = CASES[case]
    model, loss_fn, opt, clip, batches = build(params[case.split("_")[0]], **kw)
    step = make_train_step(loss_fn, opt, clip_norm=clip, data_group=group)
    state = TrainState.create(model, opt, seed=1)
    losses, metrics = [], []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in pm.shard_batch(b, group).items()})
        losses.append(float(m["loss"]))
        metrics.append({k: float(v) for k, v in m.items()})
    return (losses, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
            metrics)


# -- the rank side of tests/test_torch_dp.py -----------------------------------

def _helpers(group):
    """shard_batch, the step context's counts and draws, and the gathers,
    with the rows split 3 / 5 over the ranks."""
    out = {}
    b = {"a": np.arange(24).reshape(12, 2), "b": np.arange(12)}
    out["shard"] = pm.shard_batch(b, group)["b"].tolist()
    out["shard_accum"] = pm.shard_batch(b, group, accum_steps=2)["b"].tolist()
    try:
        pm.shard_batch({"b": np.arange(7)}, group)
    except ValueError as e:
        out["refused"] = str(e)
    rows = 3 if group.rank == 0 else 5
    x = torch.arange(8.0)[group.rank * 3:group.rank * 3 + rows].clone().requires_grad_()
    with pm.data_parallel(group, rows):
        out["count"] = float(pm.global_count(torch.tensor(float(rows))))
        out["global_rows"], out["offset"] = pm.global_rows(), pm.step_row_offset()
        gen = torch.Generator().manual_seed(5)
        out["draw"] = pm.draw_rows(torch.rand, (2 * rows, 3), generator=gen).tolist()
        gathered = pm.data_gather(x * 1.0, grad=True)
        (gathered * torch.arange(1.0, 9.0)).sum().backward()
        out["gathered"] = gathered.tolist()
        out["mean"] = float(pm.global_mean(x.detach()))
    out["grad"] = x.grad.tolist()
    return out


def _uneven_sinkhorn(group):
    """The Sinkhorn level's ids with its 8 rows split 3 / 5 (one rank:
    all 8), and a count of the distinct ids over the gathered rows."""
    q = trq.Quantize(8, 16, forward_mode=trq.QuantizeForwardMode.SINKHORN, device="cpu")
    with torch.no_grad():
        q.codebook.copy_(torch.randn(16, 8, generator=torch.Generator().manual_seed(1)))
    x = torch.randn(8, 8, generator=torch.Generator().manual_seed(2))
    lo, hi = (0, 8) if group is None else ((0, 3) if group.rank == 0 else (3, 8))
    with pm.data_parallel(group, hi - lo):
        ids = q(x[lo:hi], 0.2, training=True).ids
        distinct = int(trq.count_distinct(pm.data_gather(ids[:, None])))
    return ids.tolist(), distinct


def _steps_on_disk(save_dir):
    root = os.path.join(save_dir, "checkpoints")
    return sorted(int(s) for s in os.listdir(root) if s.isdigit())


def _final_point(save_dir):
    step = _steps_on_disk(save_dir)[-1]
    flat = read_record(os.path.join(save_dir, "checkpoints", str(step)))
    return step, {k: v for k, v in flat.items() if k.startswith("state/")}


def _trainer_runs(group, root):
    """hstu_trainer.train at dp = 2: uninterrupted, killed on rank 1 at
    step 5 (the ranks poll their OR every 8 steps) and resumed."""
    dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
    metrics = hstu_trainer.train(**TRAIN, save_dir_root=dir_a)
    with chaos.inject(chaos.ChaosPlan(kill_at_step=5, only_process=1)):
        killed = hstu_trainer.train(**TRAIN, save_dir_root=dir_b)
    killed_steps = _steps_on_disk(dir_b)
    hstu_trainer.train(**TRAIN, save_dir_root=dir_b, resume_from_checkpoint=True)
    pm.barrier("written", group)
    fa, fb = _final_point(dir_a), _final_point(dir_b)
    equal = fa[0] == fb[0] and fa[1].keys() == fb[1].keys() and all(
        torch.equal(fa[1][k], fb[1][k]) for k in fa[1])
    return dict(metrics=metrics, killed=killed, killed_steps=killed_steps,
                resumed_equal=equal)


def _export(group):
    model = trq.RqVae(**RQ, device="cpu", seed=3)
    x = SyntheticItemEmbeddings(num_items=300, dim=24, n_clusters=8, seed=2).embeddings
    return rqvae_trainer.compute_sem_ids(model, x, batch_size=64, use_pallas=True,
                                         data_group=group)


def _rank(group, params, root):
    torch.set_num_threads(1)
    out = {"helpers": _helpers(group), "sinkhorn": _uneven_sinkhorn(group),
           "export": _export(group)}
    out.update({case: _port_steps(group, case, params) for case in CASES})
    out["trainer"] = _trainer_runs(group, os.path.join(root, "run"))
    return out




# -- the rank side of tests/test_torch_dp_contrastive.py -----------------------

def _cobra_model(cfg, params):
    from genrec_tpu_torch.convert import cobra_params_from_flax
    from genrec_tpu_torch.models.cobra import Cobra

    model = Cobra(**cfg, device="cpu")
    model.load_state_dict(cobra_params_from_flax(params, model))
    for layer in model.encoder.layers:  # the tower's fixed 0.1 off, as JAX's runs
        layer.dropout_rate = layer.self_attn.dropout_rate = 0.0
    return model


def _notellm_model(cfg, params):
    from genrec_tpu_torch.convert import notellm_params_from_flax
    from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM
    from genrec_tpu_torch.models.notellm import NoteLLM

    pcfg = QwenConfig(**cfg)
    model = NoteLLM(QwenLM(pcfg, device="cpu"))
    model.load_state_dict(notellm_params_from_flax(params, pcfg))
    return model


def _contrastive_steps(group, case, p):
    """Three steps of the COBRA or NoteLLM trainer's loss and optimizer."""
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
    from genrec_tpu_torch.trainers import cobra_trainer, notellm_trainer

    if case == "cobra":
        model = _cobra_model(p["cfg"], p["params"])
        opt = Adam(cosine_schedule_with_warmup(*p["sched"]), weight_decay=0.01)
        loss_fn = cobra_trainer.make_loss_fn()
    else:
        model = _notellm_model(p["cfg"], p["params"])
        opt = notellm_trainer.make_optimizer(*p["sched"], 0.01)
        loss_fn = notellm_trainer.notellm_loss
    step = make_train_step(loss_fn, opt, clip_norm=1.0, data_group=group)
    state = TrainState.create(model, opt, seed=1)
    losses, metrics = [], []
    for b in p["batches"]:
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in pm.shard_batch(b, group).items()})
        losses.append(float(m["loss"]))
        metrics.append({k: float(v) for k, v in m.items()})
    return (losses, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
            metrics)


def _split_grads(group, case, p, cut):
    """The loss and every gradient of one batch whose rows split at ``cut``
    (rank 0 the rows before it, rank 1 the rest), summed over the group;
    on one rank, of the whole batch."""
    from genrec_tpu_torch.trainers import cobra_trainer, notellm_trainer

    model = (_cobra_model if case == "cobra" else _notellm_model)(p["cfg"], p["params"])
    loss_fn = cobra_trainer.make_loss_fn() if case == "cobra" else notellm_trainer.notellm_loss
    batch = {k: torch.as_tensor(v) for k, v in p["uneven"].items()}
    if group is not None:
        lo, hi = (0, cut) if group.rank == 0 else (cut, len(batch["input_ids"]))
        batch = {k: v[lo:hi] for k, v in batch.items()}
    names, params = zip(*model.named_parameters())
    with pm.data_parallel(group, len(batch["input_ids"])):
        loss, _ = loss_fn(model, batch, None)
    grads = [torch.zeros_like(q) if g is None else g
             for q, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
    if group is not None:
        loss, *grads = (group.all_reduce(t) for t in (loss.detach(), *grads))
    return float(loss), {n: g.numpy() for n, g in zip(names, grads)}


def _contrastive_trainer(group, case, root):
    """The COBRA or NoteLLM trainer for one epoch, its per-step losses and
    its metrics."""
    import json

    from genrec_tpu_torch.trainers import cobra_trainer, notellm_trainer

    save = os.path.join(root, case)
    if case == "cobra":
        metrics = cobra_trainer.train(**COBRA_TRAIN, save_dir_root=save)
    else:
        metrics = notellm_trainer.train(**NOTELLM_TRAIN, save_dir_root=save)
    if group is not None:
        pm.barrier("logged", group)
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["train/loss"] for r in rows if "train/loss" in r], metrics


COBRA_TRAIN = dict(epochs=1, batch_size=16, encoder_n_layers=1, encoder_hidden_dim=16,
                   encoder_num_heads=2, encoder_vocab_size=50, id_vocab_size=16,
                   n_codebooks=2, d_model=16, decoder_n_layers=1, decoder_num_heads=2,
                   max_items=4, n_beam=4, eval_every_epoch=1, eval_batch_size=64, max_len=64,
                   wandb_log_interval=1, amp=False, device="cpu", seed=0)
NOTELLM_TRAIN = dict(epochs=1, batch_pairs=8, hidden_size=32, intermediate_size=64,
                     n_layers=1, num_heads=2, num_kv_heads=2, eval_batch_pairs=8,
                     eval_every_epoch=1, num_topics=16, eval_topics=4, wandb_log_interval=1,
                     amp=False, device="cpu", seed=0)


def _contrastive_rank(group, payload, root):
    torch.set_num_threads(1)
    out = {}
    for case, p in payload.items():
        out[case] = dict(steps=_contrastive_steps(group, case, p),
                         uneven=_split_grads(group, case, p, p["cut"]),
                         trainer=_contrastive_trainer(group, case, root))
    return out


# -- the rank side of tests/test_torch_dp_2d.py --------------------------------

QWEN_BASE, QWEN_C, QWEN_K = 90, 3, 8
QWEN_LIVE = QWEN_BASE + QWEN_C * QWEN_K
QWEN_CFG = dict(vocab_size=120, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                rope_theta=10000.0, tie_word_embeddings=False)
MOE_CFG = dict(QWEN_CFG, num_key_value_heads=4, num_experts=4, num_experts_per_tok=2,
               moe_capacity_factor=1.0, router_aux_coef=0.1)
LCREC_SCHED = (1e-3, 2, 5)
TIGER_MODEL = dict(embedding_dim=16, attn_dim=32, num_heads=4, n_layers=2,
                   num_item_embeddings=8, num_user_embeddings=16, sem_id_dim=3, max_pos=64,
                   pad_vocab_to=2)
TIGER_SCHED = (1e-3, 2, 5)


def _mesh_layout(group):
    """Coordinates, shard, writer and a sum over every axis's group of each
    layout over the four ranks, and the layouts make_mesh refuses."""
    out = {}
    for name, shape in (("dp_tp", {"data": -1, "model": 2}),
                        ("tp_ep", {"data": -1, "model": 2, "expert": 2}),
                        ("dp_ep", {"data": 2, "model": 1, "expert": 2})):
        mesh = pm.make_mesh(shape, group, device="cpu")
        sums = {}
        for axis in mesh.names:
            g = mesh.group(axis)
            sums[axis] = None if g is None else (
                g.rank, g.size, float(g.all_reduce(torch.tensor(float(group.rank + 1)))))
        out[name] = dict(coords=mesh.coords, shard=mesh.shard, n_shards=mesh.n_shards,
                         writer=mesh.writer, sums=sums)
    out["refused"] = []
    for shape in ({"model": 3}, {"data": -1, "model": -1}):
        try:
            pm.make_mesh(shape, group, device="cpu")
        except ValueError as e:
            out["refused"].append(str(e))
    return out


def _lcrec(layout, params, group=None, moe=False):
    """(model, loss_fn, tp group, data group) of the LCRec SFT step at a
    layout: "one" (one rank, the fused CE), "tp_dp" (tp = 2 x dp = 2, B8
    over the model group), "tp_ep" (tp = 2 x ep = 2) or "dp" (dp = 2)."""
    from genrec_tpu_torch.convert import qwen_params_from_flax
    from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenLM
    from genrec_tpu_torch.models.lcrec import make_tp_sharded_fused_sft_loss, sft_loss
    from genrec_tpu_torch.parallel.shardings import shard_expert_params, shard_qwen_params

    cfg = QwenConfig(**(MOE_CFG if moe else QWEN_CFG))
    shape = {"one": None, "tp_dp": {"data": -1, "model": 2},
             "tp_ep": {"data": -1, "model": 2, "expert": 2},
             "dp": {"data": 2, "model": 2}}[layout]
    mesh = None if shape is None else pm.make_mesh(shape, group, device="cpu")
    tp = None if mesh is None or layout == "dp" else mesh.group("model")
    ep = None if mesh is None else mesh.group("expert")
    full = qwen_params_from_flax(params, cfg)
    model = QwenLM(cfg, group=tp, expert_group=ep, device="cpu")
    model.load_state_dict(shard_expert_params(
        shard_qwen_params(full, 0 if tp is None else tp.rank, 1 if tp is None else tp.size, cfg),
        0 if ep is None else ep.rank, 1 if ep is None else ep.size))
    if tp is not None:
        tp_loss = make_tp_sharded_fused_sft_loss(model, QWEN_LIVE)

        def loss_fn(m, b, g):
            return tp_loss(b), {}
    else:
        def loss_fn(m, b, g):
            return sft_loss(m, b["input_ids"], b["attention_mask"], b["labels"],
                            valid_vocab=QWEN_LIVE, use_fused_ce=True), {}
    return model, loss_fn, tp or ep, None if mesh is None else mesh.data


def _lcrec_steps(group, layout, params, batches, moe=False):
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup

    model, loss_fn, mgroup, dgroup = _lcrec(layout, params, group, moe)
    opt = Adam(cosine_schedule_with_warmup(*LCREC_SCHED), weight_decay=0.01)
    step = make_train_step(loss_fn, opt, clip_norm=1.0, group=mgroup, data_group=dgroup)
    state = TrainState.create(model, opt, 0)
    out = []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in pm.shard_batch(b, dgroup).items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _moe_split(group, weights, x, mask, cut):
    """One QwenMoEMLP over tokens of 4 rows split ``cut`` / rest over the
    data ranks (capacity binding across them): its output rows, router
    loss, dropped share and every gradient summed over the group."""
    from genrec_tpu_torch.models.backbones.qwen import QwenConfig, QwenMoEMLP

    moe = QwenMoEMLP(QwenConfig(**MOE_CFG), torch.float32, None, "cpu")
    moe.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    x, mask = torch.as_tensor(x), torch.as_tensor(mask)
    w = torch.linspace(-1, 1, x.numel()).reshape(x.shape)
    if group is not None:
        lo, hi = (0, cut) if group.rank == 0 else (cut, x.shape[0])
        x, mask, w = x[lo:hi], mask[lo:hi], w[lo:hi]
    with pm.data_parallel(group, x.shape[0]):
        y, aux = moe(x, mask)
        dropped = float(moe.dropped)
    loss = (y * w).sum() + aux
    grads = torch.autograd.grad(loss, list(moe.parameters()))
    if group is not None:
        grads = [group.all_reduce(g) for g in grads]
        aux = group.all_reduce(aux.detach())
    return (y.detach().numpy(), float(aux), dropped,
            {n: g.numpy() for (n, _), g in zip(moe.named_parameters(), grads)})


def _tiger(layout, params, group=None):
    from genrec_tpu_torch.convert import tiger_params_from_flax
    from genrec_tpu_torch.models.tiger import Tiger

    mesh = None if layout == "one" else pm.make_mesh({"data": -1, "model": 2}, group,
                                                      device="cpu")
    tp = None if mesh is None else mesh.group("model")
    model = Tiger(**TIGER_MODEL, dropout=0.0, device="cpu", group=tp)
    model.load_state_dict(tiger_params_from_flax(params, model, 0 if tp is None else tp.rank,
                                                 1 if tp is None else 2))
    return model, tp, None if mesh is None else mesh.data


def _tiger_args(b):
    B, D = b["target_ids"].shape
    t = {k: torch.as_tensor(v).long() for k, v in b.items()}
    return (t["user_ids"], t["item_input_ids"], t["token_type_ids"], t["target_ids"],
            torch.arange(D).expand(B, D), t["seq_mask"])


def _tiger_steps(group, layout, params, batches):
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup

    model, tp, dgroup = _tiger(layout, params, group)
    opt = Adam(cosine_schedule_with_warmup(*TIGER_SCHED), weight_decay=0.035)

    def loss_fn(m, b, g):
        return m(*_tiger_args(b)).loss, {}

    step = make_train_step(loss_fn, opt, clip_norm=1.0, group=tp, data_group=dgroup)
    state = TrainState.create(model, opt, 0)
    out = []
    for b in batches:
        state, m = step(state, pm.shard_batch(b, dgroup))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _refusals(group):
    """The trainers' refusals on four ranks: layouts the world does not
    divide."""
    from genrec_tpu_torch.trainers import lcrec_trainer, tiger_trainer

    out = []
    for call in (lambda: tiger_trainer.train(tensor_parallel=3, device="cpu",
                                             save_dir_root=None),
                 lambda: lcrec_trainer.train(tensor_parallel=3, device="cpu",
                                             save_dir_root=None),
                 lambda: lcrec_trainer.train(tensor_parallel=2, expert_parallel=4,
                                             num_experts=4, device="cpu",
                                             save_dir_root=None)):
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _rank_2d(group, p):
    torch.set_num_threads(1)
    out = {"layout": _mesh_layout(group), "refused": _refusals(group)}
    out["lcrec_tp_dp"] = _lcrec_steps(group, "tp_dp", p["lcrec"], p["lcrec_batches"])
    out["moe_tp_ep"] = _lcrec_steps(group, "tp_ep", p["moe"], p["lcrec_batches"], moe=True)
    out["moe_dp"] = _lcrec_steps(group, "dp", p["moe"], p["lcrec_batches"], moe=True)
    dmesh = pm.make_mesh({"data": 2, "model": 2}, group, device="cpu")
    out["moe_split"] = _moe_split(dmesh.data, *p["moe_split"])
    out["tiger_tp_dp"] = _tiger_steps(group, "tp_dp", p["tiger"], p["tiger_batches"])
    return out
