"""Semantic-ID and user-ID embeddings (port of
genrec_tpu/models/embeddings.py).

SemIdEmbedding: one table of ``num_embeddings * sem_ids_dim + 1`` rows
(rounded up to ``rows_multiple``), index = token_type * num_embeddings +
id, the last real row reserved for padding and read as zero.
UserIdEmbedding: hash by modulo, then embed. Both cast the rows they read
to ``dtype`` (Flax ``dtype``; the tables stay float32). The lookups are
``F.embedding``, whose backward reduces each row's duplicates in parallel
(autograd's backward of a plain index adds them one after another). Tables are plain parameters
named ``embedding`` like the Flax params, so the converter maps names 1:1.
``quantize_item_table`` builds the retrieval heads' int8 scoring table.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.ops.quant import QuantizedTable


def quantize_item_table(table: torch.Tensor) -> QuantizedTable:
    """int8-quantise an item-embedding table for serving retrieval.

    Per-row symmetric quantisation (``ops.quant.QuantizedTable``): the
    table stays tied fp32 in the model for training and the input
    embedding; serving builds this scoring operand from it once per
    weights version (``RetrievalHead.on_params``), and
    ``parallel.shardings.item_topk`` dequantises at score time with fp32
    accumulation. About a 4x smaller scoring operand."""
    return QuantizedTable.from_array(table)


class SemIdEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, sem_ids_dim: int, embeddings_dim: int,
                 rows_multiple: int = 1, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
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
        emb = F.embedding(idx, self.embedding).to(self.dtype)
        return emb.masked_fill((idx == self.padding_idx)[..., None], 0.0)


class UserIdEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, embeddings_dim: int, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.num_embeddings = num_embeddings
        self.embedding = nn.Parameter(
            torch.empty(num_embeddings, embeddings_dim, device=device)
        )

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(input_ids % self.num_embeddings, self.embedding).to(self.dtype)
