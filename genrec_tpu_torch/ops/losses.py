"""Loss primitives (port of genrec_tpu/ops/losses.py, the parts the HSTU
and RQ-VAE slices run). JAX's ``stop_gradient`` is ``detach()``."""

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


def reconstruction_loss(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-row squared-error sum over the feature axis -> shape (...,)."""
    return (x_hat - x).square().sum(dim=-1)


def categorical_reconstruction_loss(x_hat: torch.Tensor, x: torch.Tensor,
                                    n_cat_feats: int) -> torch.Tensor:
    """MSE on the dense dims + summed BCE-with-logits on the trailing
    categorical dims."""
    if n_cat_feats <= 0:
        return reconstruction_loss(x_hat, x)
    dense = reconstruction_loss(x_hat[..., :-n_cat_feats], x[..., :-n_cat_feats])
    logits = x_hat[..., -n_cat_feats:]
    labels = x[..., -n_cat_feats:]
    bce = torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return dense + bce.sum(dim=-1)


def quantize_loss(query: torch.Tensor, value: torch.Tensor,
                  commitment_weight: float = 1.0) -> torch.Tensor:
    """VQ loss: the codebook term pulls the codeword toward the (frozen)
    encoder output, the commitment term the encoder toward the (frozen)
    codeword."""
    emb_loss = (query.detach() - value).square().sum(dim=-1)
    commit_loss = (query - value.detach()).square().sum(dim=-1)
    return emb_loss + commitment_weight * commit_loss
