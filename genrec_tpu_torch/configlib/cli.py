"""Command-line entry shared by the port's trainers (copy of
genrec_tpu/configlib/cli.py without the JAX ``--platform`` pin: a
trainer's ``device`` binding picks the device).

    python -m genrec_tpu_torch.trainers.<x>_trainer <config.gin> \
        [--split beauty] [--gin "k=v"]...

The ``{split}`` placeholder in the config text is substituted before parsing
and ``--gin`` override bindings are applied after the file, so they win.
"""

from __future__ import annotations

import argparse
from typing import Sequence

from genrec_tpu_torch.configlib import parser as _parser


def parse_config(argv: Sequence[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="genrec_tpu_torch trainer")
    ap.add_argument("config", help="path to a .gin config file")
    ap.add_argument("--split", default="beauty", help="dataset split substituted for {split}")
    ap.add_argument(
        "--gin",
        action="append",
        default=[],
        metavar="BINDING",
        help='override binding, e.g. --gin "train.epochs=1" (repeatable)',
    )
    args = ap.parse_args(argv)
    _parser.parse_file(args.config, substitutions={"split": args.split})
    for binding in args.gin:
        _parser.parse_binding(binding)
    return args
