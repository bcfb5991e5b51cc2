"""One-command two-stage pipelines (port of genrec_tpu/pipelines.py).

The reference's TIGER/LCRec/COBRA flows sequence an RQ-VAE run and a
generator run whose configs must agree on artifact paths. This runner
executes the stages in order, threading the sem-id artifact:

    python -m genrec_tpu_torch.pipelines tiger \
        --rqvae-config config/tiger/amazon/rqvae.gin \
        --model-config config/tiger/amazon/tiger.gin \
        --split beauty [--gin k=v ...] [--device cpu]

Stage overrides: ``--rqvae-gin`` / ``--model-gin`` apply to one stage;
``--gin`` applies to both. ``--device`` (default ``cuda``) binds
``train.device`` in both stages, after every other binding.
"""

from __future__ import annotations

import argparse
import importlib
import os

from genrec_tpu_torch.configlib import clear_bindings, clear_macros, parse_binding, parse_file


def _bind_stage(config, split, bindings, sem_path, device):
    clear_bindings()
    clear_macros()
    parse_file(config, substitutions={"split": split})
    for b in bindings:
        parse_binding(b)
    parse_binding(f"train.sem_ids_path='{sem_path}'")
    if device is not None:
        parse_binding(f"train.device='{device}'")


def run_two_stage(
    trainer_module: str,
    rqvae_config: str,
    model_config: str,
    split: str,
    gin: list[str],
    rqvae_gin: list[str],
    model_gin: list[str],
    workdir: str = "out/pipeline",
    device: str | None = None,
):
    """Stage 1: ``rqvae_trainer.train`` writes ``<workdir>/<split>/sem_ids.npz``;
    stage 2: ``trainers.<trainer_module>.train`` reads it. ``device`` None
    keeps each config's (the trainers' default: the card). Returns what
    stage 2's ``train`` returns."""
    sem_path = os.path.join(workdir, split, "sem_ids.npz")
    from genrec_tpu_torch.trainers import rqvae_trainer

    _bind_stage(rqvae_config, split, [*gin, *rqvae_gin], sem_path, device)
    try:
        rqvae_trainer.train()
        trainer = importlib.import_module(f"genrec_tpu_torch.trainers.{trainer_module}")
        _bind_stage(model_config, split, [*gin, *model_gin], sem_path, device)
        return trainer.train()
    finally:
        clear_bindings()
        clear_macros()


def main(argv=None):
    ap = argparse.ArgumentParser(description="genrec_tpu_torch multi-stage pipeline")
    ap.add_argument("pipeline", choices=["tiger", "cobra", "lcrec"])
    ap.add_argument("--rqvae-config", required=True)
    ap.add_argument("--model-config", required=True)
    ap.add_argument("--split", default="beauty")
    ap.add_argument("--gin", action="append", default=[], help="both stages")
    ap.add_argument("--rqvae-gin", action="append", default=[])
    ap.add_argument("--model-gin", action="append", default=[])
    ap.add_argument("--workdir", default="out/pipeline")
    ap.add_argument("--device", default="cuda",
                    help="train.device of both stages (cuda, cuda:<i> or cpu)")
    args = ap.parse_args(argv)
    return run_two_stage(
        f"{args.pipeline}_trainer", args.rqvae_config, args.model_config, args.split,
        args.gin, args.rqvae_gin, args.model_gin, args.workdir, device=args.device,
    )


if __name__ == "__main__":
    main()
