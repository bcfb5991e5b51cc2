"""The train-step factory (port of genrec_tpu/core/harness.py
``make_train_step``): microbatch gradient accumulation, an optional
global-norm clip, the optimizer update, and the non-finite guard, all
issued without waiting for the device. PyTorch runs eagerly, so there is
no counterpart of ``jit_train_step``; the step updates the state in place
and returns it.

Under tensor parallelism (``group``, a ``parallel.mesh.TPGroup``) each
rank holds its shards: the global norm of the clip sums the squares of
the sharded parameters' gradients (``tp_sharded``) over the group, once
per rank, and those of the replicated ones once, so every rank clips by
the norm of the whole model's gradient and the non-finite guard decides
the same on every rank. A sharded parameter whose rows other ranks hold
too (KV heads that tp does not divide) carries ``tp_row_weight``, 1 /
holders a row: its rows' square sums are weighted so that each counts
once over the group. A parameter sharded over another group than the
step's (the expert stacks of tensor x expert parallelism) names it in
``tp_group``.

Under data parallelism (``data_group``) each rank holds the replicated
state and its rows of the global batch. Every microbatch's forward runs
inside ``parallel.mesh.data_parallel``, so that the losses divide by the
global batch's counts (``parallel.mesh.global_count``) and random draws
cover the global batch: each rank's loss is its share of the global
mean, and each aux metric its share of the metric's global value (a
count over its rows, a ``global_mean``, or ``data_share`` of a value that
every rank computes alike). After accumulation the gradients, the loss
and the metrics are summed over the data group in one flattened
all-reduce per dtype, so that the clip's norm and the non-finite guard
read the same values on every rank, and the step equals the one-rank
step on the global batch up to the sums' order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from genrec_tpu_torch.core.optim import Adam
from genrec_tpu_torch.core.state import TrainState
from genrec_tpu_torch.parallel.mesh import data_parallel

# loss_fn(model, batch, generator) -> (loss, aux_metrics_dict)
LossFn = Callable[[Any, dict, torch.Generator], tuple[torch.Tensor, dict]]


def global_norm(grads: list[torch.Tensor], sharded: list | None = None,
                group=None, row_weights: list | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm).
    With ``group``, the gradients flagged in ``sharded`` are this rank's
    shards: their square sum is summed over the group (one all-reduce);
    a flag may instead be the group that a gradient is sharded over (one
    all-reduce per distinct group). ``row_weights[i]`` (None or a tensor
    over gradient i's rows) weights each row's square sum."""
    norms = torch.stack(torch._foreach_norm(grads))
    owner = [None if f is None or f is False else (group if f is True else f)
             for f in (sharded or [None] * len(grads))]
    if all(o is None for o in owner):
        return torch.linalg.vector_norm(norms)
    sq = norms.square()
    if row_weights is not None and any(w is not None for w in row_weights):
        sq = torch.stack([
            s if w is None else (g.to(torch.float32).reshape(g.shape[0], -1).square().sum(1)
                                 * w).sum()
            for s, g, w in zip(sq, grads, row_weights)])
    whole = torch.where(torch.tensor([o is None for o in owner], device=sq.device),
                        sq, 0.0).sum()
    for g in {id(o): o for o in owner if o is not None}.values():
        mine = torch.tensor([o is g for o in owner], device=sq.device)
        whole = whole + g.all_reduce(torch.where(mine, sq, 0.0).sum())
    return whole.sqrt()


def allreduce_flat(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Sum ``tensors`` over ``group``: one flattened all-reduce per dtype,
    in the order of first appearance."""
    out: list = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = group.all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def make_train_step(
    loss_fn: LossFn,
    optimizer: Adam,
    accum_steps: int = 1,
    clip_norm: float | None = 1.0,
    group=None,
    data_group=None,
):
    """Build ``step(state, batch) -> (state, metrics)``.

    With ``accum_steps > 1`` the batch's leading dim is split into
    ``accum_steps`` microbatches run one after another; the optimizer and
    the clip see the averaged full-batch gradient.

    The non-finite guard (the JAX ``skip_nonfinite`` default, which no
    trainer turns off): when the batch loss or the pre-clip gradient norm
    is NaN/Inf, the update is dropped on the device:
    parameters, optimizer state and ``state.step`` stay unchanged (the
    generator still advances), ``state.nonfinite_count`` counts the
    consecutive-skip streak (reset by any finite step), and the metrics
    gain ``nonfinite`` (0/1) and ``nonfinite_count``. Metric values are
    device tensors; reading one waits for the device.
    """

    def grads_of(model, params, batch, gen):
        with data_parallel(data_group, next(iter(batch.values())).shape[0]):
            loss, aux = loss_fn(model, batch, gen)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        model, params = state.model, state.params
        model.train()
        if accum_steps == 1:
            loss, aux, grads = grads_of(model, params, batch, state.generator)
        else:
            micro = {k: v.chunk(accum_steps, dim=0) for k, v in batch.items()}
            loss, aux, grads = None, {}, None
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in micro.items()}
                l_i, a_i, g_i = grads_of(model, params, mb, state.generator)
                loss = l_i if loss is None else loss + l_i
                grads = g_i if grads is None else torch._foreach_add(grads, g_i)
                for k, v in a_i.items():
                    aux[k] = v if k not in aux else aux[k] + v
            loss = loss / accum_steps
            grads = torch._foreach_div(grads, accum_steps)
            aux = {k: v / accum_steps for k, v in aux.items()}

        if data_group is not None and data_group.size > 1:
            keys = sorted(aux)
            summed = allreduce_flat([*grads, loss.reshape(1).to(torch.float32),
                                     *(aux[k].reshape(1).to(torch.float32) for k in keys)],
                                    data_group)
            grads, loss = summed[:len(grads)], summed[len(grads)][0].to(loss.dtype)
            aux = {k: v[0] for k, v in zip(keys, summed[len(grads) + 1:])}
        gnorm = global_norm(grads, [getattr(p, "tp_group", None) or getattr(p, "tp_sharded", False)
                                    for p in params], group,
                            [getattr(p, "tp_row_weight", None) for p in params])
        if clip_norm is not None:
            scale = torch.clamp(clip_norm / gnorm.clamp_min(1e-6), max=1.0)
            grads = torch._foreach_mul(grads, scale)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        optimizer.update(params, grads, state.opt_state, ok)
        state.step = state.step + ok.to(state.step.dtype)
        state.nonfinite_count = torch.where(
            ok, 0, state.nonfinite_count + 1).to(state.nonfinite_count.dtype)
        metrics = {"loss": loss, "grad_norm": gnorm, **aux,
                   "nonfinite": (~ok).to(torch.float32),
                   "nonfinite_count": state.nonfinite_count.to(torch.float32)}
        return state, metrics

    return step
