"""Engine heads (port of genrec_tpu/serving/heads.py: ``Head``,
``TigerGenerativeHead`` and ``CobraGenerativeHead`` with the paged decode
protocol and the dense micro-batch protocol, and ``RetrievalHead``,
``LCRecGenerativeHead`` and ``NoteLLMRetrievalHead`` with the dense one).

A head owns a model + its item corpus. Every head has

- ``make_batch(reqs, B, L)``: pad a list of requests into device tensors
  at the (B, L) bucket (rows past the requests are zero-filled, longer
  histories keep their newest items);
- ``on_params()``: refresh tables derived from the weights (the retrieval
  heads' int8 table), called by the engine when it starts and after
  every hot params swap (the weights are copied into the model in
  place), never per batch.

Every head has the hooks of the engine's dense micro-batch path (the
only path of the heads with ``supports_paged = False``, and the path of
TIGER's and COBRA's in an engine built with ``paged=False``):

- ``make_fn(B, L)``: ``fn(*runtime_operands, *batch) -> outputs`` for one
  (B, L) bucket (the JAX engine compiles one a bucket; eager PyTorch needs
  none, so a head may return one function for every bucket);
- ``finalize(outputs, reqs)``: the host outputs split into one payload a
  request.

Paged heads add the hooks the engine's `_PagedRunner` composes:

- ``paged_layout() -> (n_layers, n_heads, head_dim, dtype)``: page-pool
  geometry, ``dtype`` the model's compute dtype (the pools' unless they
  are int8); ``paged_kv_tokens(n_items, L_bucket)``: KV tokens a request
  occupies after prefill;
- ``paged_init_step`` / ``paged_total_steps``: a slot enters decode at
  init_step and finishes when its step counter reaches total_steps;
- ``paged_state_zeros(n_slots)``: the slot-major decode state (device
  tensors);
- ``make_prefill_paged_fn(B, L)``: ``fn(*runtime_operands, *batch,
  block_tables, k_pools, v_pools)`` runs the encoder and WRITES its K/V
  into the pools (in place) through the batch's block tables; it returns
  None, or a dict of state rows (B, ...) that the runner writes into the
  admitted slots after zeroing them (COBRA's codebook-0 beam);
- ``make_decode_paged_fn()``: ``fn(*runtime_operands, state, steps,
  block_tables, seq_lens, k_pools, v_pools) -> state`` advances every
  slot one step, each at its own step;
- ``paged_finalize(rows, req)``: the finished slot's host rows (only
  ``paged_output_keys``) -> response payload.

Paged heads with ``supports_spec`` also serve the speculative tree decode
(``spec_depth`` levels past the exact root step):
``enable_spec_drafting()`` runs before the runner builds state and
prefill, so the head may add drafter hints to both (TIGER's step-0 logit
window), and ``make_spec_decode_paged_fn(fanout)`` takes the plain decode
function's arguments and returns (state, accept (S,)). For the prefix
cache, ``prefix_key_tokens(req, max_history)`` is the token key of the
history the prefill encodes (None: the head takes no part), and
``paged_warm_state(init, n_tokens, L_bucket)`` the state rows a warm
admission restores from the donor's post-prefill rows.

Catalog heads (``supports_catalog``: TIGER, COBRA, LCRec and NoteLLM)
serve a swappable `CatalogSnapshot`: ``validate_snapshot(snap)`` raises ValueError for a
snapshot the model cannot decode against, ``prepare_snapshot(snap)``
runs on the staging thread (device trie, item index, COBRA's tower
encode), so that ``set_catalog(snap)``, which the engine's batcher calls
between micro-batches, only swaps pointers; ``snapshot_operands(snap)``
is the operand tuple the snapshot would install, and ``catalog_tensors()``
the device tensors the live catalog holds (the memory ledger's
``catalog_operands``). LCRec decodes densely against the snapshot's trie;
NoteLLM scores against the snapshot's ``item_vecs`` as a bank padded to
a ``capacity_for`` rung.

The JAX heads are pure functions of a params tree; here the weights live
in the head's ``nn.Module``, so the functions take no params argument.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from genrec_tpu_torch.catalog.snapshot import CatalogSnapshot
from genrec_tpu_torch.catalog.tensor_trie import capacity_for
from genrec_tpu_torch.models.cobra import (
    cobra_generate,
    cobra_paged_decode_step,
    cobra_prefill_paged,
    cobra_spec_tree_step,
    init_cobra_paged_state,
)
from genrec_tpu_torch.models.embeddings import quantize_item_table
from genrec_tpu_torch.models.lcrec import generate_topk_constrained
from genrec_tpu_torch.models.notellm import query2embedding_forward
from genrec_tpu_torch.models.tiger import (
    init_tiger_paged_state,
    tiger_generate,
    tiger_paged_decode_step,
    tiger_prefill_paged,
    tiger_spec_tree_step,
)
from genrec_tpu_torch.parallel.shardings import item_topk


class Head:
    """Interface + shared history validation."""

    name: str
    top_k: int
    supports_paged = False
    supports_spec = False
    supports_catalog = False

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def spec_depth(self) -> int:
        return 0

    def enable_spec_drafting(self) -> None:
        return None

    def make_spec_decode_paged_fn(self, fanout):
        raise NotImplementedError(f"head {self.name!r} has no speculative decode")

    def prefix_key_tokens(self, req, max_history: int):
        """Token key of the history this head's prefill encodes (bucket-
        clipped to the newest ``max_history`` items, dead ids dropped as
        ``make_batch`` drops them, plus any per-request conditioning):
        equal keys prefill equal pages, so a full-key prefix-cache hit is
        exact. None: the head takes no part in the prefix cache."""
        del req, max_history
        return None

    def paged_warm_state(self, init, n_tokens: int, L_bucket: int):
        """State rows a warm admission restores in place of the prefill:
        the donor's post-prefill rows ``init`` (None when the prefill
        leaves the state zeroed), patched where they depend on the
        admission's bucket rather than the history."""
        del n_tokens, L_bucket
        return init

    def runtime_operands(self) -> tuple:
        """Device-side operands passed ahead of the batch to every call:
        the generative catalog heads return ``(trie,)``, NoteLLM its bank."""
        return ()

    def on_params(self) -> None:
        """Refresh tables derived from the weights (none by default)."""

    @property
    def catalog_version(self) -> Optional[str]:
        return None

    def catalog_tensors(self) -> tuple:
        """The device tensors the live catalog holds (none by default)."""
        return ()

    def set_catalog(self, snapshot) -> None:
        raise NotImplementedError(f"head {self.name!r} has no swappable catalog")

    def validate_snapshot(self, snapshot) -> None:
        raise NotImplementedError(f"head {self.name!r} has no swappable catalog")

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

    def make_batch(self, reqs, B: int, L: int):
        raise NotImplementedError

    def make_fn(self, B: int, L: int):
        raise NotImplementedError

    def finalize(self, outputs, reqs) -> list[dict]:
        raise NotImplementedError


def _clip_history(history, L: int) -> np.ndarray:
    """Newest-L items of a history (the informative tail)."""
    h = np.asarray(history, np.int64).reshape(-1)
    if len(h) and h.min() < 0:
        raise ValueError(f"negative item ids in request history: {h[h < 0][:5]}")
    return h[-L:] if len(h) > L else h


class _CatalogHead(Head):
    """What the generative heads share: a CatalogSnapshot served from the
    model's device (its trie, the sem-id table, the tuple -> item index)
    and histories laid out left-aligned at the (B, L) bucket (TIGER and
    COBRA, the paged ones; LCRec lays out its own prompts)."""

    supports_catalog = True

    def prepare_snapshot(self, snapshot) -> None:
        """Staging-thread hook (``ServingEngine.stage_catalog``): upload the
        trie and the sem-id table and build the item index, so that
        ``set_catalog`` on the batcher is pointer swaps."""
        snapshot.device_trie(self.device)
        snapshot.device_item_sem_ids(self.device)
        snapshot.item_index()

    def snapshot_operands(self, snapshot) -> tuple:
        return (snapshot.device_trie(self.device),)

    def _serve_catalog(self, catalog) -> None:
        dev = self.device
        self.catalog = catalog
        self.item_sem_ids = catalog.item_sem_ids
        self.trie = catalog.device_trie(dev)
        self._item_index = catalog.item_index()
        self._item_sem_ids_dev = catalog.device_item_sem_ids(dev)

    def catalog_tensors(self) -> tuple:
        return (self.trie, self._item_sem_ids_dev)

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

    def _histories(self, reqs, B: int, L: int):
        """(hist (B, L) item ids, valid (B, L) bool) on the device: each
        request's newest L items that the corpus holds, left-aligned."""
        hist = np.zeros((B, L), np.int64)
        n = np.zeros(B, np.int64)
        for i, r in enumerate(reqs):
            h = _clip_history(r.history, L)
            h = h[h < len(self.item_sem_ids)]
            hist[i, : len(h)] = h
            n[i] = len(h)
        dev = self.device
        valid = torch.arange(L, device=dev)[None, :] < torch.as_tensor(n, device=dev)[:, None]
        return torch.as_tensor(hist, device=dev), valid


class TigerGenerativeHead(_CatalogHead):
    """TIGER trie-constrained beam search through the paged decode path
(or, in an engine built with ``paged=False``, one ``tiger_generate`` call
a micro-batch).

    The corpus comes either as a prebuilt ``catalog=`` CatalogSnapshot or
    as a raw ``item_sem_ids`` (N, D) table; requests carry item ids
    indexing it. Beam search is deterministic (pure beam, no sampling),
    so identical requests get identical answers. The model's device is
    the head's device; the catalog trie is uploaded there once.
    """

    #: State keys ``paged_finalize`` reads: only these leave the device.
    paged_output_keys = ("beam_seqs", "beam_logps")
    supports_paged = True
    supports_spec = True

    def __init__(self, model, item_sem_ids: Optional[np.ndarray] = None,
                 top_k: int = 10, name: str = "tiger", catalog=None):
        self.model = model
        self.name = name
        self.top_k = top_k
        self._spec_draft_hint = False
        if catalog is None:
            if item_sem_ids is None:
                raise ValueError("need item_sem_ids or catalog=")
            catalog = CatalogSnapshot.build(
                np.asarray(item_sem_ids, np.int64), model.num_item_embeddings
            )
        self.set_catalog(catalog)

    def validate_snapshot(self, snapshot) -> None:
        if snapshot.depth != self.model.sem_id_dim:
            raise ValueError(f"catalog depth {snapshot.depth} != model sem_id_dim "
                             f"{self.model.sem_id_dim}")
        if snapshot.codebook_size != self.model.num_item_embeddings:
            raise ValueError(f"catalog codebook {snapshot.codebook_size} != model "
                             f"num_item_embeddings {self.model.num_item_embeddings}")

    def set_catalog(self, snapshot) -> None:
        """Serve ``snapshot``: trie, sem-id table and item index swap
        together (the engine calls this after the paged slots drain)."""
        self.validate_snapshot(snapshot)
        self._serve_catalog(snapshot)

    def make_batch(self, reqs, B: int, L: int):
        """(user (B,), ids (B, L*D), types (B, L*D), mask (B, L*D)) int64
        tensors on the head's device."""
        D = self.model.sem_id_dim
        user = np.zeros(B, np.int64)
        for i, r in enumerate(reqs):
            user[i] = int(r.user_id) % self.model.num_user_embeddings
        dev = self.device
        hist_t, valid = self._histories(reqs, B, L)
        ids = self._item_sem_ids_dev[hist_t]  # (B, L, D)
        ids = ids.masked_fill(~valid[..., None], 0).reshape(B, L * D)
        mask = valid[..., None].expand(B, L, D).reshape(B, L * D).to(torch.int64)
        types = torch.arange(D, device=dev).repeat(B, L)
        return torch.as_tensor(user, device=dev), ids, types, mask

    def make_fn(self, B: int, L: int):
        del B, L  # one function serves every bucket: shapes come from make_batch

        def fn(trie, user, ids, types, mask):
            # Pure beam search (no noise) over the cached decode, the trie a
            # runtime operand, as the paged path decodes.
            out = tiger_generate(self.model, trie, user, ids, types, mask,
                                 n_top_k_candidates=self.top_k, deterministic=True,
                                 use_cache=True)
            return out.sem_ids, out.log_probas

        return fn

    def finalize(self, outputs, reqs) -> list[dict]:
        sem_ids, logp = outputs
        return [dict(items=self.lookup(sem_ids[i]), scores=logp[i], sem_ids=sem_ids[i])
                for i in range(len(reqs))]

    # ---- paged decode protocol ---------------------------------------------

    @property
    def paged_init_step(self) -> int:
        return 0

    @property
    def paged_total_steps(self) -> int:
        return self.model.sem_id_dim

    def paged_layout(self):
        m = self.model
        return m.n_layers // 2, m.num_heads, m.attn_dim // m.num_heads, m.dtype

    def paged_kv_tokens(self, n_items: int, L_bucket: int) -> int:
        # user token + D sem-id tokens per (bucket-clipped) history item
        return 1 + min(int(n_items), L_bucket) * self.model.sem_id_dim

    @property
    def spec_depth(self) -> int:
        # The root level is exact; the rest of the tuple is speculated.
        return self.model.sem_id_dim - 1

    def enable_spec_drafting(self) -> None:
        """Add the step-0 logit window to the prefill and to the slot state:
        the drafter's signal at the root codebook, where trie popularity
        says nothing."""
        self._spec_draft_hint = True

    def paged_state_zeros(self, n_slots: int) -> dict:
        return init_tiger_paged_state(self.model, n_slots, self.top_k,
                                      draft_hint=self._spec_draft_hint)

    def make_prefill_paged_fn(self, B: int, L: int):
        del B, L  # shapes come from make_batch / block_tables

        def fn(trie, user, ids, types, mask, block_tables, k_pools, v_pools):
            # The plain prefill is trie-free; the speculative one masks its
            # step-0 draft window with it.
            return tiger_prefill_paged(self.model, user, ids, types, mask, block_tables,
                                       k_pools, v_pools, trie=trie,
                                       draft_hint=self._spec_draft_hint)[3]

        return fn

    def make_spec_decode_paged_fn(self, fanout):
        def fn(trie, state, steps, block_tables, seq_lens, k_pools, v_pools):
            return tiger_spec_tree_step(
                self.model, trie, state, steps, block_tables, seq_lens, k_pools, v_pools,
                fanout=fanout, depth=self.spec_depth,
            )

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

    def prefix_key_tokens(self, req, max_history: int):
        """The user token is encoder position 0 and the encoder is
        bidirectional, so the key carries the user and only a full-key
        match reuses pages."""
        h = _clip_history(req.history, max_history)
        h = h[h < len(self.item_sem_ids)]  # make_batch's drop rule
        return (int(req.user_id) % self.model.num_user_embeddings, *(int(x) for x in h))


class CobraGenerativeHead(_CatalogHead):
    """COBRA trie-constrained beam search through the paged decode path
(or, in an engine built with ``paged=False``, one ``cobra_generate`` call
a micro-batch).

    The sparse side of each history item comes from the catalog's
    ``item_sem_ids`` (N, C), the dense side from the item tower: the
    snapshot's ``item_vecs`` (N, d), or its ``item_text_tokens`` encoded
    here by the model's encoder once per catalog version (``on_params`` and
    ``set_catalog`` encode only when the version changed;
    ``tower_encodes`` counts the encodes). Codebook 0 resolves at prefill,
    so decode steps cover codebooks 1 .. C - 1. Beam search runs at
    temperature 1 and is deterministic.
    """

    #: State keys ``paged_finalize`` reads: only these leave the device.
    paged_output_keys = ("beam_tokens", "beam_scores")
    supports_paged = True
    supports_spec = True
    #: Rows a tower encode takes at once (bounds its activations).
    tower_chunk = 2048

    def __init__(self, model, item_sem_ids: Optional[np.ndarray] = None,
                 item_vecs: Optional[np.ndarray] = None,
                 item_text_tokens: Optional[np.ndarray] = None,
                 top_k: int = 10, name: str = "cobra", catalog=None):
        self.model = model
        self.name = name
        self.top_k = top_k
        self.tower_encodes = 0
        self.item_vecs = None  # (N, d) device tensor, the dense item tower
        self._vecs_version = None  # catalog version the tower belongs to
        self._prepared_tower = None  # (version, vecs) from prepare_snapshot
        if catalog is None:
            if item_sem_ids is None:
                raise ValueError("need item_sem_ids or catalog=")
            catalog = CatalogSnapshot.build(
                np.asarray(item_sem_ids, np.int64), model.id_vocab_size,
                item_vecs=item_vecs, item_text_tokens=item_text_tokens,
            )
        self.set_catalog(catalog)

    def validate_snapshot(self, snapshot) -> None:
        if snapshot.depth != self.model.n_codebooks:
            raise ValueError(f"catalog depth {snapshot.depth} != model n_codebooks "
                             f"{self.model.n_codebooks}")
        if snapshot.codebook_size != self.model.id_vocab_size:
            raise ValueError(f"catalog codebook {snapshot.codebook_size} != model "
                             f"id_vocab_size {self.model.id_vocab_size}")
        if snapshot.item_vecs is None and snapshot.item_text_tokens is None:
            raise ValueError("COBRA catalog snapshot needs item_vecs or item_text_tokens "
                             "(the dense item tower has to come from somewhere)")
        if snapshot.item_vecs is not None and snapshot.item_vecs.shape[-1] != self.model.d_model:
            raise ValueError(f"snapshot tower dim {snapshot.item_vecs.shape[-1]} != model "
                             f"d_model {self.model.d_model}")

    def prepare_snapshot(self, snapshot) -> None:
        """Staging-thread hook: besides the trie, sem-id table and index,
        the tower of a text-only snapshot is encoded HERE, so that
        ``set_catalog`` on the batcher swaps pointers. The encode runs on
        the device's current stream, which the batcher's calls share, so
        no decode call reads the tower before its kernels finish."""
        super().prepare_snapshot(snapshot)
        if snapshot.item_vecs is None and (self._prepared_tower is None
                                           or self._prepared_tower[0] != snapshot.version):
            self._prepared_tower = (snapshot.version, self._encode_text(snapshot))

    def set_catalog(self, snapshot) -> None:
        """Serve ``snapshot``: its trie on the device, its tower taken from
        ``item_vecs``, from ``prepare_snapshot``, or encoded here from its
        text if this version has none yet."""
        self.validate_snapshot(snapshot)
        self._serve_catalog(snapshot)
        if snapshot.item_vecs is not None:
            self.item_vecs = torch.as_tensor(snapshot.item_vecs, dtype=torch.float32,
                                             device=self.device)
            self._vecs_version = snapshot.version
        elif self._prepared_tower is not None and self._prepared_tower[0] == snapshot.version:
            self.item_vecs = self._prepared_tower[1]
            self._vecs_version = snapshot.version
        else:
            self._encode_tower()
        self._prepared_tower = None

    def catalog_tensors(self) -> tuple:
        return (*super().catalog_tensors(), self.item_vecs)

    def on_params(self) -> None:
        """Encode the tower if the catalog's version has none. The tower is
        a catalog artifact: a params swap alone never re-encodes it (as in
        the JAX head, it is re-encoded with the next catalog version)."""
        self._encode_tower()

    def _encode_tower(self) -> None:
        if self._vecs_version == self.catalog.version:
            return
        self.item_vecs = self._encode_text(self.catalog)
        self._vecs_version = self.catalog.version

    @torch.no_grad()
    def _encode_text(self, snapshot) -> torch.Tensor:
        """One full-corpus tower encode from ``snapshot``'s item text."""
        text = torch.as_tensor(snapshot.item_text_tokens, device=self.device)
        vecs = torch.cat([self.model.encode_items(chunk)
                          for chunk in text.split(self.tower_chunk)])
        self.tower_encodes += 1
        return vecs

    def make_batch(self, reqs, B: int, L: int):
        """(ids (B, L*C) int64 with ``pad_id`` padding, vecs (B, L, d) fp32)
        on the head's device, the newest L items of each history first."""
        C = self.model.n_codebooks
        hist_t, valid = self._histories(reqs, B, L)
        ids = self._item_sem_ids_dev[hist_t].masked_fill(~valid[..., None], self.model.pad_id)
        vecs = self.item_vecs[hist_t].masked_fill(~valid[..., None], 0.0)
        return ids.reshape(B, L * C), vecs

    def make_fn(self, B: int, L: int):
        del B, L  # one function serves every bucket: shapes come from make_batch

        def fn(trie, ids, vecs):
            out = cobra_generate(self.model, ids, None, n_candidates=self.top_k,
                                 temperature=1.0, item_vecs=vecs, use_cache=True, trie=trie)
            return out.sem_ids, out.scores

        return fn

    def finalize(self, outputs, reqs) -> list[dict]:
        sem_ids, scores = outputs
        return [dict(items=self.lookup(sem_ids[i]), scores=scores[i], sem_ids=sem_ids[i])
                for i in range(len(reqs))]

    # ---- paged decode protocol ---------------------------------------------

    @property
    def paged_init_step(self) -> int:
        return 1  # codebook 0 resolves at prefill

    @property
    def paged_total_steps(self) -> int:
        return self.model.n_codebooks

    def paged_layout(self):
        m = self.model
        return m.decoder_n_layers, m.decoder_num_heads, m.head_dim, m.dtype

    def paged_kv_tokens(self, n_items: int, L_bucket: int) -> int:
        # C sparse + 1 dense token per (bucket-clipped) history item
        return min(int(n_items), L_bucket) * (self.model.n_codebooks + 1)

    def paged_state_zeros(self, n_slots: int) -> dict:
        return init_cobra_paged_state(self.model, n_slots, self.top_k)

    def make_prefill_paged_fn(self, B: int, L: int):
        del B, L

        def fn(trie, ids, vecs, block_tables, k_pools, v_pools):
            # Codebook 0 resolves here, so the trie is live at prefill.
            return cobra_prefill_paged(self.model, ids, vecs, block_tables, k_pools,
                                       v_pools, trie, self.top_k, temperature=1.0)[2]

        return fn

    def make_decode_paged_fn(self):
        def fn(trie, state, steps, block_tables, seq_lens, k_pools, v_pools):
            return cobra_paged_decode_step(self.model, trie, state, steps, block_tables,
                                           seq_lens, k_pools, v_pools, temperature=1.0)

        return fn

    @property
    def spec_depth(self) -> int:
        # Codebook 0 resolves at prefill, the first suffix step is the exact
        # root: the other C - 2 codebooks are speculated.
        return max(self.model.n_codebooks - 2, 0)

    def make_spec_decode_paged_fn(self, fanout):
        def fn(trie, state, steps, block_tables, seq_lens, k_pools, v_pools):
            return cobra_spec_tree_step(
                self.model, trie, state, steps, block_tables, seq_lens, k_pools, v_pools,
                fanout=fanout, depth=self.spec_depth, temperature=1.0,
            )

        return fn

    def paged_finalize(self, rows: dict, req) -> dict:
        sem = rows["beam_tokens"]
        return dict(items=self.lookup(sem), scores=rows["beam_scores"], sem_ids=sem)

    def prefix_key_tokens(self, req, max_history: int):
        """The effective item history alone (the decoder input has no user
        token). The prefill also resolves codebook 0 from the history's
        last position, so only a full-key match reuses pages."""
        h = _clip_history(req.history, max_history)
        h = h[h < len(self.item_sem_ids)]  # make_batch's drop rule
        return tuple(int(x) for x in h)

    def paged_warm_state(self, init, n_tokens: int, L_bucket: int):
        """The donor's rows, but ``full`` ("does the history fill its
        prefill bucket") judged at the admission's own bucket, from the
        donor's ``base_pos`` (the prefill's pad-masked valid length, not
        ``n_tokens``, which counts ids ``make_batch`` drops)."""
        del n_tokens
        patched = dict(init)
        patched["full"] = init["base_pos"] == L_bucket * (self.model.n_codebooks + 1)
        return patched


class RetrievalHead(Head):
    """SASRec / HSTU: right-aligned history -> ``last_hidden`` -> top-k over
    the item table (``parallel.shardings.item_topk``).

    Histories are RIGHT-aligned (the newest item in slot L-1, zeros pad
    the front) so that the model's last position is the prediction point.
    ``use_timestamps=True`` (HSTU with its temporal bias) batches each
    request's timestamps alongside. History buckets are clamped to the
    model's ``max_seq_len`` (its position table's size), keeping the
    newest items.

    ``quantized=True`` scores against an int8 per-row copy of the tied
    item table (``ops.quant.QuantizedTable``) built by ``on_params`` once
    per weights version; ``item_topk`` dequantises at score time with fp32 accumulation. The fp32 table stays
    in the model (it is also the input embedding). The mesh placement of
    the JAX head is not ported (ROADMAP A26)."""

    def __init__(self, name: str, model, top_k: int = 10, use_timestamps: bool = False,
                 quantized: bool = False):
        self.name = name
        self.model = model
        self.top_k = top_k
        self.use_timestamps = use_timestamps
        self.quantized = bool(quantized)
        self._qtable = None
        self._max_len = int(getattr(model, "max_seq_len", 0)) or None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def on_params(self) -> None:
        """Build the int8 scoring table from the model's current weights."""
        if self.quantized:
            self._qtable = quantize_item_table(self.model.item_embedding)

    @property
    def table(self):
        """The scoring table: the model's fp32 item table, or the int8
        ``QuantizedTable`` that ``on_params`` built."""
        if not self.quantized:
            return self.model.item_embedding
        if self._qtable is None:
            raise RuntimeError(f"head {self.name!r} is quantized but has no table yet; "
                               "on_params() must run first")
        return self._qtable

    def max_item_id(self):
        return int(self.model.num_items)

    def _clamp(self, L: int) -> int:
        return min(L, self._max_len) if self._max_len else L

    def make_batch(self, reqs, B: int, L: int):
        """(ids,) or (ids, timestamps): (B, min(L, max_seq_len)) int32
        tensors on the head's device, histories right-aligned."""
        L = self._clamp(L)
        ids = np.zeros((B, L), np.int32)
        ts = np.zeros((B, L), np.int32) if self.use_timestamps else None
        for i, r in enumerate(reqs):
            h = _clip_history(r.history, L)
            if len(h):
                ids[i, L - len(h):] = h
                if ts is not None and r.timestamps is not None:
                    t = np.asarray(r.timestamps, np.int64).reshape(-1)[-len(h):]
                    ts[i, L - len(t):] = t
        return tuple(torch.as_tensor(a).to(self.device) for a in (ids, ts) if a is not None)

    def make_fn(self, B: int, L: int):
        del B, L  # one function serves every bucket: shapes come from make_batch
        return self._score

    def _score(self, *batch):
        h = self.model.last_hidden(*batch)
        return item_topk(h.to(torch.float32), self.table, self.top_k)

    def finalize(self, outputs, reqs) -> list[dict]:
        scores, items = outputs
        return [dict(items=items[i], scores=scores[i], sem_ids=None)
                for i in range(len(reqs))]


class LCRecGenerativeHead(_CatalogHead):
    """LCRec's constrained beam search over the extended-vocab LLM, on the
    dense micro-batch path (not paged).

    Requests carry ITEM ids into the catalog; ``make_batch`` maps each
    history item to its C codebook tokens (``base_vocab + c K + code``, the
    ``extend_vocab`` layout) and LEFT-pads the prompt: the KV-cached decode
    reads the last position, so the newest item sits at the right edge.
    Items a smaller swapped-in catalog no longer holds are dropped, as
    TIGER drops them. Decoding runs ``generate_topk_constrained`` with the
    snapshot's trie as a runtime operand and ``top_k`` beams: every tuple
    is a catalog item, mapped back to its id by ``lookup``. History
    buckets are clamped so that a prompt of L C tokens plus C decode steps
    fits the model's position table."""

    def __init__(self, model, base_vocab: int, num_codebooks: int, codebook_size: int,
                 item_sem_ids: Optional[np.ndarray] = None, top_k: int = 10,
                 name: str = "lcrec", catalog=None):
        self.model = model
        self.name = name
        self.top_k = top_k
        self.base_vocab = int(base_vocab)
        self.num_codebooks = int(num_codebooks)
        self.codebook_size = int(codebook_size)
        cfg = model.cfg
        if self.base_vocab + self.num_codebooks * self.codebook_size > cfg.vocab_size:
            raise ValueError(
                f"codebook region [{self.base_vocab}, "
                f"{self.base_vocab + self.num_codebooks * self.codebook_size}) exceeds model "
                f"vocab {cfg.vocab_size}")
        max_pos = int(cfg.max_position_embeddings or 0)
        self._max_len = (max(1, (max_pos - self.num_codebooks) // self.num_codebooks)
                         if max_pos else None)
        if catalog is None:
            if item_sem_ids is None:
                raise ValueError("need item_sem_ids or catalog=")
            catalog = CatalogSnapshot.build(np.asarray(item_sem_ids, np.int64),
                                            self.codebook_size)
        self.validate_snapshot(catalog)
        self.set_catalog(catalog)

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    def validate_snapshot(self, snapshot) -> None:
        if snapshot.depth != self.num_codebooks:
            raise ValueError(f"catalog depth {snapshot.depth} != head num_codebooks "
                             f"{self.num_codebooks}")
        if snapshot.codebook_size != self.codebook_size:
            raise ValueError(f"catalog codebook {snapshot.codebook_size} != head "
                             f"codebook_size {self.codebook_size}")

    def set_catalog(self, snapshot) -> None:
        self._serve_catalog(snapshot)

    def _clamp(self, L: int) -> int:
        return min(L, self._max_len) if self._max_len else L

    def make_batch(self, reqs, B: int, L: int):
        """(ids, mask) (B, L C) int32: each history's newest L catalog items
        as codebook tokens, left-padded; the last position attended in
        every row (an emptied history or a padding row keeps a finite
        softmax)."""
        L = self._clamp(L)
        C = self.num_codebooks
        tok_base = self.base_vocab + np.arange(C, dtype=np.int64) * self.codebook_size
        ids = np.zeros((B, L * C), np.int32)
        mask = np.zeros((B, L * C), np.int32)
        for i, r in enumerate(reqs):
            h = _clip_history(r.history, L)
            h = h[h < len(self.item_sem_ids)]
            if len(h):
                toks = (self.item_sem_ids[h] + tok_base).reshape(-1)
                ids[i, L * C - len(toks):] = toks
                mask[i, L * C - len(toks):] = 1
        mask[:, -1] = 1
        return torch.as_tensor(ids, device=self.device), torch.as_tensor(mask, device=self.device)

    def make_fn(self, B: int, L: int):
        L = self._clamp(L)
        C = self.num_codebooks

        def fn(trie, ids, mask):
            out = generate_topk_constrained(
                self.model, ids, mask, self.base_vocab, C, self.codebook_size,
                beam_width=self.top_k, max_cache=L * C + C, trie=trie)
            return out.sem_ids, out.log_probas

        return fn

    def finalize(self, outputs, reqs) -> list[dict]:
        sem_ids, logp = outputs
        return [dict(items=self.lookup(sem_ids[i]), scores=logp[i], sem_ids=sem_ids[i])
                for i in range(len(reqs))]


class NoteLLMRetrievalHead(Head):
    """NoteLLM Query2Embedding retrieval: the ``[EMB]`` hidden state -> the
    top-k items of a bank, on the dense micro-batch path.

    Requests carry query TOKEN ids (``Request.history``); ``make_batch``
    appends the ``[EMB]`` token after the clipped query, and the call
    scores its L2-normalised hidden state (``query2embedding_forward``)
    against the catalog's item-note embeddings through the unchanged
    ``item_topk``.

    The bank is a CATALOG artifact and a RUNTIME OPERAND: the snapshot's
    ``item_vecs`` (N, d) as an AUGMENTED (cap, d+1) fp32 table padded to a
    ``capacity_for`` rung. Row i+1 holds item i and a bias column of 0;
    row 0 (the pad row ``item_topk`` masks) and the capacity rows hold a
    -1e9 bias, and the query side appends a 1, so no pad row reaches the
    top-k. A returned row r is item r-1. ``prepare_snapshot`` uploads a
    snapshot's bank on the staging thread, so ``set_catalog`` swaps a
    pointer. The JAX head's mesh placement is not ported (ROADMAP A26)."""

    supports_catalog = True

    #: Bias of the pad rows, which no real row's cosine-bounded score earns.
    _PAD_BIAS = -1e9

    def __init__(self, model, emb_token_id: int, item_sem_ids: Optional[np.ndarray] = None,
                 item_vecs: Optional[np.ndarray] = None, codebook_size: Optional[int] = None,
                 top_k: int = 10, name: str = "notellm", catalog=None):
        self.model = model
        self.name = name
        self.top_k = top_k
        self.emb_token_id = int(emb_token_id)
        self._bank = None
        self._bank_cache: dict = {}  # version -> augmented bank (staging)
        max_pos = int(model.cfg.max_position_embeddings or 0)
        self._max_len = max(1, max_pos - 1) if max_pos else None
        if catalog is None:
            if item_sem_ids is None or item_vecs is None:
                raise ValueError("need (item_sem_ids, item_vecs) or catalog=")
            item_sem_ids = np.asarray(item_sem_ids, np.int64)
            if codebook_size is None:
                codebook_size = int(item_sem_ids.max()) + 1
            catalog = CatalogSnapshot.build(item_sem_ids, codebook_size,
                                            item_vecs=np.asarray(item_vecs))
        self.validate_snapshot(catalog)
        self.set_catalog(catalog)

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    def validate_snapshot(self, snapshot) -> None:
        if snapshot.item_vecs is None:
            raise ValueError(
                "NoteLLM catalog snapshot needs item_vecs (the precomputed item-note "
                "embeddings — the retrieval bank has to come from somewhere)")
        d = int(snapshot.item_vecs.shape[-1])
        if d != self.model.cfg.hidden_size:
            raise ValueError(f"snapshot item_vecs dim {d} != model hidden_size "
                             f"{self.model.cfg.hidden_size}")
        cur = getattr(self, "catalog", None)
        if cur is not None and d != int(cur.item_vecs.shape[-1]):
            raise ValueError(f"snapshot item_vecs dim {d} != serving bank dim "
                             f"{int(cur.item_vecs.shape[-1])} — operand avals would drift")

    def _augmented_bank(self, snapshot) -> torch.Tensor:
        """(cap, d+1) fp32 on the head's device: row i+1 = [item_vecs[i], 0],
        row 0 and the capacity rows carry the pad bias."""
        vecs = np.asarray(snapshot.item_vecs, np.float32)
        n, d = vecs.shape
        bank = np.zeros((capacity_for(n + 1), d + 1), np.float32)
        bank[1:n + 1, :d] = vecs
        bank[0, d] = self._PAD_BIAS
        bank[n + 1:, d] = self._PAD_BIAS
        return torch.as_tensor(bank, device=self.device)

    def prepare_snapshot(self, snapshot) -> None:
        """Staging-thread hook: build and upload the bank ahead of the swap
        (the snapshot's trie, which JAX also uploads, serves no NoteLLM
        call and stays on the host)."""
        if snapshot.version not in self._bank_cache:
            self._bank_cache[snapshot.version] = self._augmented_bank(snapshot)

    def snapshot_operands(self, snapshot) -> tuple:
        """The bank this snapshot would install (its rung is its row count)."""
        self.prepare_snapshot(snapshot)
        return (self._bank_cache[snapshot.version],)

    def set_catalog(self, snapshot) -> None:
        self.catalog = snapshot
        bank = self._bank_cache.get(snapshot.version)
        if bank is None:
            bank = self._augmented_bank(snapshot)
        self._bank = bank
        self._bank_cache = {snapshot.version: bank}

    @property
    def catalog_version(self) -> Optional[str]:
        return self.catalog.version

    def catalog_tensors(self) -> tuple:
        return (self._bank,)

    def runtime_operands(self) -> tuple:
        return (self._bank,)

    def max_item_id(self):
        # History ids are query TOKEN ids: anything below [EMB] (appended by
        # make_batch, never by the caller) is legal.
        return self.emb_token_id - 1

    def _clamp(self, L: int) -> int:
        return min(L, self._max_len) if self._max_len else L

    def make_batch(self, reqs, B: int, L: int):
        """(ids, mask) (B, L+1) int32 and emb_idx (B, 1): each query's
        newest L tokens then [EMB]; padding rows hold [EMB] at position 0."""
        L = self._clamp(L)
        ids = np.zeros((B, L + 1), np.int32)
        mask = np.zeros((B, L + 1), np.int32)
        emb_idx = np.zeros((B, 1), np.int32)
        for i, r in enumerate(reqs):
            h = _clip_history(r.history, L)
            ids[i, :len(h)] = h
            ids[i, len(h)] = self.emb_token_id
            mask[i, :len(h) + 1] = 1
            emb_idx[i, 0] = len(h)
        ids[len(reqs):, 0] = self.emb_token_id
        mask[len(reqs):, 0] = 1
        return tuple(torch.as_tensor(a, device=self.device) for a in (ids, mask, emb_idx))

    def make_fn(self, B: int, L: int):
        del B, L  # one function serves every bucket: shapes come from make_batch
        return self._score

    def _score(self, bank, ids, mask, emb_idx):
        emb = query2embedding_forward(self.model, ids, mask, emb_idx,
                                      tau=torch.zeros((), device=ids.device),
                                      return_loss=False).sentence_embedding
        ones = torch.ones((emb.shape[0], 1), dtype=emb.dtype, device=emb.device)
        return item_topk(torch.cat([emb, ones], dim=1), bank, self.top_k)

    def finalize(self, outputs, reqs) -> list[dict]:
        scores, rows = outputs
        # Rows only the pad bias could fill (top_k > items) report item -1.
        return [dict(items=np.where(scores[i] < self._PAD_BIAS / 2, -1, rows[i] - 1),
                     scores=scores[i], sem_ids=None) for i in range(len(reqs))]
