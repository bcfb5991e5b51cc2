"""Semantic-ID and user-ID embeddings (port of
genrec_tpu/models/embeddings.py).

SemIdEmbedding: one table of ``num_embeddings * sem_ids_dim + 1`` rows
(rounded up to ``rows_multiple``), index = token_type * num_embeddings +
id, the last real row reserved for padding and read as zero.
UserIdEmbedding: hash by modulo, then embed. Tables are plain parameters
named ``embedding`` like the Flax params, so the converter maps names 1:1.
"""

from __future__ import annotations

import torch
from torch import nn

from genrec_tpu_torch.device import resolve_device


class SemIdEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, sem_ids_dim: int, embeddings_dim: int,
                 rows_multiple: int = 1, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.sem_ids_dim = sem_ids_dim
        rows = num_embeddings * sem_ids_dim + 1
        m = max(rows_multiple, 1)
        self.embedding = nn.Parameter(
            torch.empty(-(-rows // m) * m, embeddings_dim, device=device)
        )

    @property
    def padding_idx(self) -> int:
        return self.num_embeddings * self.sem_ids_dim

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor) -> torch.Tensor:
        idx = token_type_ids * self.num_embeddings + input_ids
        emb = self.embedding[idx]
        return emb.masked_fill((idx == self.padding_idx)[..., None], 0.0)


class UserIdEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, embeddings_dim: int, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.embedding = nn.Parameter(
            torch.empty(num_embeddings, embeddings_dim, device=device)
        )

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[input_ids % self.num_embeddings]
