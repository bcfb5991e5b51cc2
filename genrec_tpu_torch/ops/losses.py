"""Loss primitives (port of genrec_tpu/ops/losses.py, the part the HSTU
slice runs)."""

from __future__ import annotations

import torch


def cross_entropy_with_ignore(
    logits: torch.Tensor,
    targets: torch.Tensor,
    ignore_index: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE with an ignored target id.

    Returns ``(per_token_loss, valid_mask)`` with the loss already zeroed at
    ignored positions, so callers choose the reduction (mean over valid
    tokens for SASRec/HSTU; per-sequence sum then batch mean for TIGER).
    """
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    # Clip target for the gather; masked out below.
    tgt = targets.long().clamp(0, logits.shape[-1] - 1)
    gold = logits.gather(-1, tgt[..., None])[..., 0]
    valid = (targets != ignore_index).to(torch.float32)
    return (logz - gold) * valid, valid
