"""RQ-VAE: residual-quantised VAE producing semantic IDs (port of
genrec_tpu/models/rqvae.py).

MLP encoder and decoder, ``n_layers`` stacked quantise levels, each
subtracting its codeword from the residual, four gradient modes
(GUMBEL_SOFTMAX, STE, ROTATION_TRICK, SINKHORN), L2 or cosine distance,
the ``sim_vq`` out-projection and the optional codebook L2-norm. The
k-means codebook init is the explicit ``kmeans_init_params``, as in the
JAX package.

Parameter names are the Flax ones: ``encoder.dense_<i>``,
``decoder.dense_<i>``, ``quantize_<i>.codebook`` and
``quantize_<i>.out_proj`` (``convert.rqvae_params_from_flax``). Random
draws (the Gumbel noise) come from a ``torch.Generator``, or the caller
hands each level its uniforms (``uniforms=``), which is how the tests
give both packages the same noise. Distances are fp32 matrix products;
the caller keeps TF32 off (PyTorch's default for matmul), as the JAX
model computes them at HIGHEST precision.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Sequence

import torch
from torch import nn

from genrec_tpu_torch import configlib
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.layers import MLP, truncated_normal
from genrec_tpu_torch.ops.gumbel import gumbel_softmax_sample
from genrec_tpu_torch.ops.kmeans import kmeans
from genrec_tpu_torch.ops.losses import (
    categorical_reconstruction_loss,
    quantize_loss,
    reconstruction_loss,
)
from genrec_tpu_torch.ops.normalize import l2norm
from genrec_tpu_torch.parallel.mesh import (data_gather, data_share, global_mean,
                                             step_row_offset)


@configlib.register_enum
class QuantizeForwardMode(enum.Enum):
    GUMBEL_SOFTMAX = 1
    STE = 2
    ROTATION_TRICK = 3
    SINKHORN = 4


@configlib.register_enum
class QuantizeDistance(enum.Enum):
    L2 = 1
    COSINE = 2


class QuantizeOutput(NamedTuple):
    embeddings: torch.Tensor
    ids: torch.Tensor
    loss: torch.Tensor


class RqVaeOutput(NamedTuple):
    embeddings: torch.Tensor  # (L, B, D) per-level chosen codewords
    residuals: torch.Tensor  # (L, B, D)
    sem_ids: torch.Tensor  # (B, L)
    quantize_loss: torch.Tensor  # (B,)


class RqVaeComputedLosses(NamedTuple):
    loss: torch.Tensor
    reconstruction_loss: torch.Tensor
    rqvae_loss: torch.Tensor
    embs_norm: torch.Tensor  # (B, L)
    p_unique_ids: torch.Tensor


def rotation_trick_transform(u, q, e):
    """Householder-style rotation (arXiv:2410.06424 section 4.2): the value
    moves to the codeword direction while gradients flow only through
    ``e``."""
    w = l2norm(u + q, eps=1e-6).detach()
    e_row = e[:, None, :]  # (B, 1, D)
    refl = e_row @ w[:, :, None] @ w[:, None, :]
    rot = e_row @ u.detach()[:, :, None] @ q.detach()[:, None, :]
    return (e_row - 2 * refl + 2 * rot)[:, 0, :]


def sinkhorn_knopp(cost: torch.Tensor, eps: float = 0.003, max_iter: int = 100):
    """Balanced-assignment transport plan (arXiv:2311.09049), in the log
    domain and fp32 as the JAX function runs it: ``max_iter`` fixed-point
    iterations of the row and column potentials with logsumexp, uniform
    marginals. cost (B, K) -> plan (B, K)."""
    B, K = cost.shape
    logK = (-cost / eps).to(torch.float32)
    log_row = torch.full((B,), -float(torch.log(torch.tensor(float(B)))),
                         dtype=torch.float32, device=cost.device)
    log_col = torch.full((K,), -float(torch.log(torch.tensor(float(K)))),
                         dtype=torch.float32, device=cost.device)
    f = torch.zeros((B,), dtype=torch.float32, device=cost.device)
    g = torch.zeros((K,), dtype=torch.float32, device=cost.device)
    for _ in range(max_iter):
        f = log_row - torch.logsumexp(logK + g[None, :], dim=1)
        g = log_col - torch.logsumexp(logK + f[:, None], dim=0)
    return torch.exp(f[:, None] + logK + g[None, :])


def count_distinct(sem_ids: torch.Tensor) -> torch.Tensor:
    """Exact number of distinct sem-id tuples (0-d int32 on the device):
    a lexicographic sort (stable sorts from the last column to the first)
    and an adjacent compare."""
    B, L = sem_ids.shape
    if B <= 1:
        return torch.tensor(B, dtype=torch.int32, device=sem_ids.device)
    order = torch.arange(B, device=sem_ids.device)
    for col in range(L - 1, -1, -1):
        order = order[torch.sort(sem_ids[order, col], stable=True).indices]
    s = sem_ids[order]
    return (1 + (s[1:] != s[:-1]).any(dim=-1).sum()).to(torch.int32)


def count_distinct_fraction(sem_ids: torch.Tensor) -> torch.Tensor:
    """Fraction of rows with a distinct sem-id tuple."""
    return count_distinct(sem_ids).to(torch.float32) / sem_ids.shape[0]


class Quantize(nn.Module):
    """One VQ level. The codebook starts uniform in [0, 1), as the JAX
    init; ``kmeans_init_params`` replaces it."""

    def __init__(self, embed_dim: int, n_embed: int, codebook_normalize: bool = False,
                 sim_vq: bool = False, commitment_weight: float = 0.25,
                 forward_mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX,
                 distance_mode: QuantizeDistance = QuantizeDistance.L2, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim, self.n_embed = embed_dim, n_embed
        self.codebook_normalize, self.sim_vq = codebook_normalize, sim_vq
        self.commitment_weight = commitment_weight
        self.forward_mode, self.distance_mode = forward_mode, distance_mode
        self.codebook = nn.Parameter(torch.empty((n_embed, embed_dim), device=device))
        if sim_vq:
            self.out_proj = nn.Linear(embed_dim, embed_dim, bias=False, device=device)

    def effective_codebook(self) -> torch.Tensor:
        emb = self.codebook
        if self.sim_vq:
            emb = self.out_proj(emb)
        if self.codebook_normalize:
            emb = l2norm(emb)
        return emb

    def forward(self, x, temperature: float, training: bool = False,
                generator: torch.Generator | None = None,
                uniform: torch.Tensor | None = None) -> QuantizeOutput:
        codebook = self.effective_codebook()
        if self.distance_mode == QuantizeDistance.L2:
            dist = ((x**2).sum(dim=1, keepdim=True) + (codebook**2).sum(dim=1)[None, :]
                    - 2.0 * (x @ codebook.T))
        else:
            dist = -(l2norm(x) @ l2norm(codebook).T)
        ids = torch.argmin(dist.detach(), dim=1)  # first occurrence

        if not training:
            emb_out = codebook[ids]
            return QuantizeOutput(emb_out, ids, quantize_loss(x, emb_out, self.commitment_weight))

        mode = self.forward_mode
        if mode == QuantizeForwardMode.GUMBEL_SOFTMAX:
            weights = gumbel_softmax_sample(-dist, temperature, generator, uniform)
            emb = weights @ codebook
            emb_out = emb
        elif mode == QuantizeForwardMode.STE:
            emb = codebook[ids]
            emb_out = x + (emb - x).detach()
        elif mode == QuantizeForwardMode.ROTATION_TRICK:
            emb = codebook[ids]
            emb_out = rotation_trick_transform(
                x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8),
                emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8),
                x,
            )
        elif mode == QuantizeForwardMode.SINKHORN:
            # Cost normalised to [-1, 1] by the batch's global max and min.
            # In a data-parallel step the plan balances the global batch:
            # every rank gathers the cost's rows (one all-gather; the plan is
            # stop-gradient), runs the transport on all of them, as one rank
            # does, and keeps its own rows' plan.
            cost = data_gather(dist.detach())
            max_d, min_d = cost.max(), cost.min()
            mid = (max_d + min_d) / 2
            amp = max_d - mid + 1e-5
            first = step_row_offset()
            P = sinkhorn_knopp((cost - mid) / amp)[first:first + dist.shape[0]].detach()
            ids = torch.argmax(P, dim=-1)  # first occurrence, as jnp.argmax
            emb = codebook[ids]
            emb_out = x + (emb - x).detach()
        else:
            raise ValueError(f"unsupported mode {mode}")
        return QuantizeOutput(emb_out, ids, quantize_loss(x, emb, self.commitment_weight))


@configlib.configurable
class RqVae(nn.Module):
    """The RQ-VAE. Weights are drawn from ``seed`` (a CPU generator, so
    every device gets the same weights): Dense kernels lecun-normal,
    codebooks uniform in [0, 1), the JAX initialisers."""

    def __init__(self, input_dim: int, embed_dim: int, hidden_dims: Sequence[int],
                 codebook_size: int, codebook_normalize: bool = False,
                 codebook_sim_vq: bool = False,
                 codebook_mode: QuantizeForwardMode = QuantizeForwardMode.GUMBEL_SOFTMAX,
                 codebook_last_layer_mode: QuantizeForwardMode = (
                     QuantizeForwardMode.GUMBEL_SOFTMAX),
                 n_layers: int = 3, commitment_weight: float = 0.25,
                 n_cat_features: int = 18, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.input_dim, self.embed_dim = input_dim, embed_dim
        self.codebook_size, self.n_layers = codebook_size, n_layers
        self.codebook_normalize, self.codebook_sim_vq = codebook_normalize, codebook_sim_vq
        self.n_cat_features = n_cat_features
        for i in range(n_layers):
            self.add_module(f"quantize_{i}", Quantize(
                embed_dim=embed_dim, n_embed=codebook_size,
                forward_mode=codebook_mode if i < n_layers - 1 else codebook_last_layer_mode,
                codebook_normalize=(i == 0 and codebook_normalize),
                sim_vq=codebook_sim_vq, commitment_weight=commitment_weight,
                distance_mode=QuantizeDistance.L2, device=dev,
            ))
        self.encoder = MLP(input_dim, hidden_dims, embed_dim, normalize=codebook_normalize,
                           device=dev)
        self.decoder = MLP(embed_dim, list(hidden_dims)[::-1], input_dim, normalize=True,
                           device=dev)
        self.reset_parameters(seed)

    @property
    def layers(self) -> list[Quantize]:
        return [getattr(self, f"quantize_{i}") for i in range(self.n_layers)]

    @property
    def device(self) -> torch.device:
        return self.quantize_0.codebook.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(truncated_normal(m.weight.shape, m.in_features**-0.5, gen))
            elif isinstance(m, Quantize):
                m.codebook.copy_(torch.rand(m.codebook.shape, generator=gen))

    def codebooks(self) -> torch.Tensor:
        """The raw codebooks stacked, (L, K, D)."""
        return torch.stack([q.codebook for q in self.layers])

    def encode(self, x):
        return self.encoder(x)

    def decode(self, x):
        return self.decoder(x)

    def get_semantic_ids(self, x, gumbel_t: float = 0.001, training: bool = False,
                         generator: torch.Generator | None = None,
                         uniforms: Sequence[torch.Tensor] | None = None) -> RqVaeOutput:
        res = self.encode(x)
        qloss = 0.0
        embs, residuals, sem_ids = [], [], []
        for i, layer in enumerate(self.layers):
            residuals.append(res)
            q = layer(res, temperature=gumbel_t, training=training, generator=generator,
                      uniform=None if uniforms is None else uniforms[i])
            qloss = qloss + q.loss
            res = res - q.embeddings
            embs.append(q.embeddings)
            sem_ids.append(q.ids)
        return RqVaeOutput(
            embeddings=torch.stack(embs), residuals=torch.stack(residuals),
            sem_ids=torch.stack(sem_ids, dim=1), quantize_loss=qloss,
        )

    def forward(self, x, gumbel_t: float, training: bool = False,
                generator: torch.Generator | None = None,
                uniforms: Sequence[torch.Tensor] | None = None) -> RqVaeComputedLosses:
        quantized = self.get_semantic_ids(x, gumbel_t, training, generator, uniforms)
        x_hat = self.decode(quantized.embeddings.sum(dim=0))
        n_cat = self.n_cat_features
        if n_cat > 0:
            x_hat = torch.cat([l2norm(x_hat[..., :-n_cat]), x_hat[..., -n_cat:]], dim=-1)
            recon = categorical_reconstruction_loss(x_hat, x, n_cat)
        else:
            x_hat = l2norm(x_hat)
            recon = reconstruction_loss(x_hat, x)
        rqvae_l = quantized.quantize_loss
        return RqVaeComputedLosses(
            loss=global_mean(recon + rqvae_l),
            reconstruction_loss=global_mean(recon),
            rqvae_loss=global_mean(rqvae_l),
            embs_norm=torch.linalg.vector_norm(quantized.embeddings, dim=-1).T.detach(),
            p_unique_ids=data_share(count_distinct_fraction(
                data_gather(quantized.sem_ids)).detach()),
        )


@torch.no_grad()
def kmeans_init_params(model: RqVae, x: torch.Tensor, generator: torch.Generator | None = None,
                       init_indices: Sequence[torch.Tensor] | None = None) -> RqVae:
    """Re-initialise every codebook with k-means on ``x``, IN PLACE, level
    by level: fit k-means on the current residual, install the centroids
    as the raw codebook, then run the level's eval forward (through any
    sim_vq projection or normalisation) for the next level's residual.
    ``generator`` draws each level's initial rows unless ``init_indices``
    names them (one index tensor per level). Returns ``model``."""
    res = model.encode(x)
    for i, layer in enumerate(model.layers):
        out = kmeans(res, k=model.codebook_size, generator=generator,
                     init_idx=None if init_indices is None else init_indices[i])
        layer.codebook.copy_(out.centroids)
        q = layer(res, temperature=0.001, training=False)
        res = res - q.embeddings
    return model
