"""A tiny seeded Amazon dump for the port's trainer tests: chip_smoke's
SNAP-layout writer at a few dozen users, the sequences parsed, and, where
asked, a random unique sem-id artifact and the P5 layout beside it."""

import os

import numpy as np

import chip_smoke
from genrec_tpu_torch.data.amazon import load_sequences
from genrec_tpu_torch.data.sem_ids import random_unique_sem_ids, save_sem_ids

DUMP = dict(users=40, items=30, reviews=260, seed=0, emb_dim=24)


def tiny_amazon(path, *, levels=None, codebook_size=8, p5=False, **sizes) -> dict:
    """{"root", "items", and "sem_ids" (the artifact's path, ``levels``
    codes an item) or "p5" (the P5 layout's root) where asked}; ``sizes``
    replace DUMP's."""
    dump = {**DUMP, **sizes}
    root = os.path.join(str(path), "amazon")
    chip_smoke.write_amazon_dump(root, **dump)
    load_sequences(root, "beauty", download=False)
    out = {"root": root, "items": dump["items"]}
    if levels is not None:
        out["sem_ids"] = os.path.join(str(path), "sem_ids.npz")
        save_sem_ids(out["sem_ids"], random_unique_sem_ids(
            dump["items"], codebook_size, levels, np.random.default_rng(1)), codebook_size)
    if p5:
        out["p5"] = os.path.join(str(path), "p5_amazon")
        chip_smoke.write_p5_copy(root, out["p5"])
    return out
