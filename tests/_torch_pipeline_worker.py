"""SIGKILL-able subprocess worker for tests/test_torch_pipeline.py (the
port's counterpart of tests/_pipeline_worker.py; it imports no JAX).

The chaos kill points that matter here (`die_in_append_at_record`,
`die_in_save_at_step`, `die_in_publish_at_step`) are real ``SIGKILL``s —
they cannot be exercised in the pytest process. Each mode is a
self-contained stage of the streaming pipeline on the shared toy model (a
``{"w": (4, 2)}`` least-squares fit):

    python tests/_torch_pipeline_worker.py append '<json cfg>'
    python tests/_torch_pipeline_worker.py train  '<json cfg>'

``append`` regenerates the full seeded record sequence and appends from
``records_committed`` onward — exactly what a restarted producer does,
so a kill + rerun must yield zero lost and zero duplicated records.
``train`` drives a `StreamTrainer` over the log. Both print one JSON
summary line prefixed ``WORKER `` on success; a chaos kill leaves rc
-SIGKILL and no summary.
"""

import contextlib
import json
import sys


def cmd_append(cfg):
    import numpy as np

    from genrec_tpu_torch.core import chaos
    from genrec_tpu_torch.data.stream_log import StreamLogWriter

    rng = np.random.default_rng(cfg["seed"])
    rows = rng.standard_normal((cfg["n"], 6)).astype(np.float32)
    plan = (chaos.ChaosPlan(die_in_append_at_record=cfg["die_at"])
            if cfg.get("die_at") is not None else None)
    with StreamLogWriter(cfg["log_dir"]) as w:
        start = w.records_committed
        with chaos.inject(plan) if plan else contextlib.nullcontext():
            for i in range(start, cfg["n"]):
                w.append(rows[i].tobytes())
        committed = w.records_committed
    return {"resumed_from": start, "committed": committed}


def toy_stream_trainer(cfg):
    """The toy StreamTrainer both the worker and the in-process tests
    build — one definition, or cross-process loss parity means nothing."""
    import numpy as np
    import torch
    from torch import nn

    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.trainers.stream_trainer import StreamTrainer

    torch.set_num_threads(1)
    model = nn.Module()
    model.w = nn.Parameter(torch.as_tensor(
        np.random.default_rng(0).standard_normal((4, 2)).astype(np.float32)))

    def loss_fn(m, batch, generator):
        return torch.mean((batch["x"] @ m.w - batch["y"]) ** 2), {}

    opt = Adam(1e-2)
    state = TrainState.create(model, opt, 1)
    step_fn = make_train_step(loss_fn, opt, clip_norm=1.0)

    def make_arrays(payloads, epoch):
        rows = np.stack([np.frombuffer(p, np.float32) for p in payloads])
        return {"x": rows[:, :4].copy(), "y": rows[:, 4:].copy()}

    return StreamTrainer(
        log_dir=cfg["log_dir"], save_dir_root=cfg["save_dir"], state=state,
        step_fn=step_fn, make_arrays=make_arrays,
        chunk_records=cfg.get("chunk_records", 16),
        rows_per_step=cfg.get("rows_per_step", 8), seed=0,
        publish_dir=cfg.get("publish_dir"),
        commit_every_steps=cfg.get("commit_every_steps", 1),
        publish_every_steps=cfg.get("publish_every_steps", 0),
        handle_signals=cfg.get("handle_signals", True),
    )


def cmd_train(cfg):
    from genrec_tpu_torch.core import chaos

    plan = None
    if cfg.get("die_in_save") is not None:
        plan = chaos.ChaosPlan(die_in_save_at_step=cfg["die_in_save"])
    elif cfg.get("die_in_publish") is not None:
        plan = chaos.ChaosPlan(die_in_publish_at_step=cfg["die_in_publish"])
    trainer = toy_stream_trainer(cfg)
    with chaos.inject(plan) if plan else contextlib.nullcontext():
        summary = trainer.run(max_chunks=cfg.get("max_chunks"),
                              idle_timeout_s=cfg.get("idle_timeout_s", 2.0))
    return summary


def main(argv):
    mode, cfg = argv[0], json.loads(argv[1])
    out = {"append": cmd_append, "train": cmd_train}[mode](cfg)
    print("WORKER " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
