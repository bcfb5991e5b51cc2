"""Engine heads (port of genrec_tpu/serving/heads.py: ``Head`` and
``TigerGenerativeHead`` with the paged decode protocol).

A head owns a model + its item corpus and exposes the hooks the engine's
`_PagedRunner` composes:

- ``make_batch(reqs, B, L)``: pad a list of requests into device tensors
  at the (B, L) bucket (rows past the requests are zero-filled, longer
  histories keep their newest items);
- ``paged_layout() -> (n_layers, n_heads, head_dim, dtype)``: page-pool
  geometry; ``paged_kv_tokens(n_items, L_bucket)``: KV tokens a request
  occupies after prefill;
- ``paged_init_step`` / ``paged_total_steps``: a slot enters decode at
  init_step and finishes when its step counter reaches total_steps;
- ``paged_state_zeros(n_slots)``: the slot-major decode state (device
  tensors);
- ``make_prefill_paged_fn(B, L)``: ``fn(*runtime_operands, *batch,
  block_tables, k_pools, v_pools)`` runs the encoder and WRITES its K/V
  into the pools (in place) through the batch's block tables;
- ``make_decode_paged_fn()``: ``fn(*runtime_operands, state, steps,
  block_tables, seq_lens, k_pools, v_pools) -> state`` advances every
  slot one step, each at its own step;
- ``paged_finalize(rows, req)``: the finished slot's host rows (only
  ``paged_output_keys``) -> response payload.

The JAX heads are pure functions of a params tree; here the weights live
in the head's ``nn.Module``, so the functions take no params argument.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from genrec_tpu_torch.catalog.snapshot import CatalogSnapshot
from genrec_tpu_torch.models.tiger import (
    init_tiger_paged_state,
    tiger_paged_decode_step,
    tiger_prefill_paged,
)


class Head:
    """Interface + shared history validation."""

    name: str
    top_k: int
    supports_paged = False

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def runtime_operands(self) -> tuple:
        """Device-side catalog operands passed to every prefill/decode
        call; catalog heads return ``(trie,)``."""
        return ()

    @property
    def catalog_version(self) -> Optional[str]:
        return None

    def validate(self, req) -> None:
        """Reject malformed requests AT SUBMIT TIME, so the error goes to
        the one bad caller, not to every request co-batched with it."""
        h = np.asarray(req.history, np.int64).reshape(-1)
        if h.size and h.min() < 0:
            raise ValueError(f"negative item ids in request history: {h[h < 0][:5]}")
        hi = self.max_item_id()
        if hi is not None and h.size and h.max() > hi:
            raise ValueError(
                f"request history ids exceed the corpus (max valid id {hi}): "
                f"{h[h > hi][:5]}"
            )

    def max_item_id(self):
        """Largest valid history item id, or None when unknown."""
        return None

    def natural_len(self, req) -> int:
        return len(req.history)


def _clip_history(history, L: int) -> np.ndarray:
    """Newest-L items of a history (the informative tail)."""
    h = np.asarray(history, np.int64).reshape(-1)
    if len(h) and h.min() < 0:
        raise ValueError(f"negative item ids in request history: {h[h < 0][:5]}")
    return h[-L:] if len(h) > L else h


class TigerGenerativeHead(Head):
    """TIGER trie-constrained beam search through the paged decode path.

    The corpus comes either as a prebuilt ``catalog=`` CatalogSnapshot or
    as a raw ``item_sem_ids`` (N, D) table; requests carry item ids
    indexing it. Beam search is deterministic (pure beam, no sampling),
    so identical requests get identical answers. The model's device is
    the head's device; the catalog trie is uploaded there once.
    """

    supports_paged = True
    #: State keys ``paged_finalize`` reads: only these leave the device.
    paged_output_keys = ("beam_seqs", "beam_logps")

    def __init__(self, model, item_sem_ids: Optional[np.ndarray] = None,
                 top_k: int = 10, name: str = "tiger", catalog=None):
        self.model = model
        self.name = name
        self.top_k = top_k
        if catalog is None:
            if item_sem_ids is None:
                raise ValueError("need item_sem_ids or catalog=")
            catalog = CatalogSnapshot.build(
                np.asarray(item_sem_ids, np.int64), model.num_item_embeddings
            )
        if catalog.depth != model.sem_id_dim:
            raise ValueError(
                f"catalog depth {catalog.depth} != model sem_id_dim {model.sem_id_dim}"
            )
        if catalog.codebook_size != model.num_item_embeddings:
            raise ValueError(
                f"catalog codebook {catalog.codebook_size} != model "
                f"num_item_embeddings {model.num_item_embeddings}"
            )
        self.catalog = catalog
        self.item_sem_ids = catalog.item_sem_ids
        self.trie = catalog.device_trie(model.device)
        self._item_index = catalog.item_index()
        self._item_sem_ids_dev = torch.as_tensor(self.item_sem_ids, device=model.device)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def catalog_version(self) -> Optional[str]:
        return self.catalog.version

    def runtime_operands(self) -> tuple:
        return (self.trie,)

    def max_item_id(self):
        return len(self.item_sem_ids) - 1

    def lookup(self, tuples: np.ndarray) -> np.ndarray:
        """sem-id tuples -> corpus item ids (-1 flags a tuple not in the
        corpus, which constrained decoding never emits)."""
        return np.asarray(
            [self._item_index.get(tuple(int(c) for c in t), -1) for t in tuples],
            np.int64,
        )

    def make_batch(self, reqs, B: int, L: int):
        """(user (B,), ids (B, L*D), types (B, L*D), mask (B, L*D)) int64
        tensors on the head's device."""
        D = self.model.sem_id_dim
        hist = np.zeros((B, L), np.int64)
        n = np.zeros(B, np.int64)
        user = np.zeros(B, np.int64)
        for i, r in enumerate(reqs):
            h = _clip_history(r.history, L)
            h = h[h < len(self.item_sem_ids)]
            hist[i, : len(h)] = h
            n[i] = len(h)
            user[i] = int(r.user_id) % self.model.num_user_embeddings
        dev = self.device
        hist_t = torch.as_tensor(hist, device=dev)
        valid = torch.arange(L, device=dev)[None, :] < torch.as_tensor(n, device=dev)[:, None]
        ids = self._item_sem_ids_dev[hist_t]  # (B, L, D)
        ids = ids.masked_fill(~valid[..., None], 0).reshape(B, L * D)
        mask = valid[..., None].expand(B, L, D).reshape(B, L * D).to(torch.int64)
        types = torch.arange(D, device=dev).repeat(B, L)
        return torch.as_tensor(user, device=dev), ids, types, mask

    # ---- paged decode protocol ---------------------------------------------

    @property
    def paged_init_step(self) -> int:
        return 0

    @property
    def paged_total_steps(self) -> int:
        return self.model.sem_id_dim

    def paged_layout(self):
        m = self.model
        return (m.n_layers // 2, m.num_heads, m.attn_dim // m.num_heads,
                m.bos_embedding.dtype)

    def paged_kv_tokens(self, n_items: int, L_bucket: int) -> int:
        # user token + D sem-id tokens per (bucket-clipped) history item
        return 1 + min(int(n_items), L_bucket) * self.model.sem_id_dim

    def paged_state_zeros(self, n_slots: int) -> dict:
        return init_tiger_paged_state(self.model, n_slots, self.top_k)

    def make_prefill_paged_fn(self, B: int, L: int):
        del B, L  # shapes come from make_batch / block_tables

        def fn(trie, user, ids, types, mask, block_tables, k_pools, v_pools):
            del trie  # TIGER's prefill is trie-free
            tiger_prefill_paged(self.model, user, ids, types, mask,
                                block_tables, k_pools, v_pools)

        return fn

    def make_decode_paged_fn(self):
        def fn(trie, state, steps, block_tables, seq_lens, k_pools, v_pools):
            return tiger_paged_decode_step(
                self.model, trie, state, steps, block_tables, seq_lens,
                k_pools, v_pools,
            )

        return fn

    def paged_finalize(self, rows: dict, req) -> dict:
        sem = rows["beam_seqs"]
        return dict(items=self.lookup(sem), scores=rows["beam_logps"], sem_ids=sem)
