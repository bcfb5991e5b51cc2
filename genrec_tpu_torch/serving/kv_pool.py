"""Paged KV cache for the decode heads (port of
genrec_tpu/serving/kv_pool.py: ``PagedConfig``, ``PageAllocator``,
``KVPagePool``).

The history K/V of every in-flight request lives in ONE pool per decoder
layer, shaped (num_pages, page_size, heads, head_dim), and each decode
slot names its pages through a block-table row. The pool holds every
slot's full page budget, so admission waits only for a free slot;
occupancy tracks the pages the resident tokens actually fill.

- ``PageAllocator``: host-side free list with a liveness bit per page;
  page 0 is the reserved NULL page and is never handed out.
- ``KVPagePool``: the device pools + per-slot block tables + seq_lens.
  ``admit(n_tokens)`` binds a free slot to fresh pages, ``evict(slot)``
  releases them. Block-table rows pad with page 0; prefill's padded-tail
  writes land there and attention never reads it unmasked.
- ``PagedConfig``: the static shapes of the paged decode path and the
  page type, ``kv_dtype`` "float32" or "int8" (``ops.quant.
  QuantizedKVPool``: int8 rows plus one fp32 scale per page row,
  dequantised in the attention kernel).

Block tables and seq_lens are host numpy (the engine copies the rows it
decodes to the device each step); the pools are device tensors. Host
bookkeeping is not thread-safe on its own: the engine's batcher thread
is the only caller.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.ops.quant import KV_DTYPES, QuantizedKVPool


class PoolExhausted(RuntimeError):
    """No free decode slot (or, from ``PageAllocator.alloc``, not enough
    free pages); state is unchanged."""


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Static shape surface of the paged decode path. The pool holds the
    full budget, every slot's ``pages_per_slot`` pages plus the null page,
    so a free slot always has its pages."""

    max_slots: int = 32
    page_size: int = 16
    pages_per_slot: int = 8
    kv_dtype: str = "float32"

    def __post_init__(self):
        if self.max_slots <= 0 or self.page_size <= 0 or self.pages_per_slot <= 0:
            raise ValueError(f"invalid paged config {self}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype {self.kv_dtype!r} not supported; choose one of {KV_DTYPES}"
            )

    @property
    def num_pages(self) -> int:
        """Pages per pool, the reserved null page 0 included."""
        return 1 + self.max_slots * self.pages_per_slot

    @property
    def max_kv_tokens(self) -> int:
        """Largest history (in KV tokens) one slot can hold."""
        return self.pages_per_slot * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        n = -(-int(n_tokens) // self.page_size)
        if n > self.pages_per_slot:
            raise ValueError(
                f"{n_tokens} KV tokens need {n} pages > pages_per_slot "
                f"{self.pages_per_slot}; size the config off the largest "
                "history bucket"
            )
        return max(n, 1)

    def hbm_bytes(self, n_layers: int, n_heads: int, head_dim: int,
                  itemsize: int = 4) -> int:
        """Device footprint of the pools (K + V, all layers). int8 pages
        cost one byte an element plus the fp32 scale of each page row."""
        rows = 2 * n_layers * self.num_pages * self.page_size
        if self.kv_dtype == "int8":
            return rows * (n_heads * head_dim * 1 + 4)
        return rows * n_heads * head_dim * itemsize


class PageAllocator:
    """Free-list page allocator; page 0 is never handed out."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the null page)")
        self.num_pages = int(num_pages)
        # LIFO: recently freed pages are reused first (their stale KV is
        # overwritten by the next prefill before any read).
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._live = np.zeros(self.num_pages, bool)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def alloc(self, n: int) -> list[int]:
        """n fresh pages, all or nothing."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free of "
                f"{self.num_pages - 1} allocatable"
            )
        pages = [self._free.pop() for _ in range(n)]
        self._live[pages] = True
        return pages

    def free(self, pages) -> None:
        """Return pages to the free list. Double frees raise instead of
        corrupting the free list."""
        for p in pages:
            if p <= 0 or p >= self.num_pages:
                raise ValueError(f"free of invalid page id {p}")
            if not self._live[p]:
                raise ValueError(f"double free of page {p}")
            self._live[p] = False
            self._free.append(p)

    def check_invariants(self) -> None:
        """free + live == capacity, no duplicate or live page on the free
        list."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list contains duplicates")
        if 0 in free:
            raise AssertionError("null page on the free list")
        live = set(np.nonzero(self._live)[0].tolist())
        if live & free:
            raise AssertionError("page both live and free")
        if len(live) + len(free) != self.num_pages - 1:
            raise AssertionError("pages leaked")


class KVPagePool:
    """Device page pools + slot bindings for ONE head's decode layers.
    ``dtype`` is the fp32 pools' type; ``cfg.kv_dtype="int8"`` builds
    ``QuantizedKVPool``s instead."""

    def __init__(self, cfg: PagedConfig, n_layers: int, n_heads: int,
                 head_dim: int, dtype=torch.float32, device="cuda"):
        dev = resolve_device(device)
        self.cfg = cfg
        self.n_layers = n_layers
        shape = (cfg.num_pages, cfg.page_size, n_heads, head_dim)
        if cfg.kv_dtype == "int8":
            zeros = lambda: QuantizedKVPool.zeros(shape, device=dev)  # noqa: E731
        else:
            zeros = lambda: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
        self.k_pools = tuple(zeros() for _ in range(n_layers))
        self.v_pools = tuple(zeros() for _ in range(n_layers))
        self.allocator = PageAllocator(cfg.num_pages)
        self.block_tables = np.zeros((cfg.max_slots, cfg.pages_per_slot), np.int32)
        self.seq_lens = np.zeros((cfg.max_slots,), np.int32)
        self._slot_pages: list[list[int] | None] = [None] * cfg.max_slots
        # Min-heap: slots fill LOWEST-INDEX-FIRST, so the decode step can
        # run over the prefix [0, max active slot] of the slot set.
        self._free_slots = list(range(cfg.max_slots))
        heapq.heapify(self._free_slots)

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    @property
    def active_slot_count(self) -> int:
        return self.cfg.max_slots - len(self._free_slots)

    def admit(self, n_tokens: int) -> int:
        """Bind a free slot to fresh pages covering ``n_tokens`` of KV.
        Returns the slot id; raises PoolExhausted (state unchanged) when
        no slot is free."""
        if not self._free_slots:
            raise PoolExhausted("no free decode slots")
        pages = self.allocator.alloc(self.cfg.pages_for(n_tokens))
        slot = heapq.heappop(self._free_slots)
        self._slot_pages[slot] = pages
        self.block_tables[slot] = 0
        self.block_tables[slot, : len(pages)] = pages
        self.seq_lens[slot] = n_tokens
        return slot

    def evict(self, slot: int) -> None:
        """Release the slot's pages and return the slot to the free list."""
        pages = self._slot_pages[slot]
        if pages is None:
            raise ValueError(f"evict of inactive slot {slot}")
        self.allocator.free(pages)
        self._slot_pages[slot] = None
        self.block_tables[slot] = 0
        self.seq_lens[slot] = 0
        heapq.heappush(self._free_slots, slot)

    def check_invariants(self) -> None:
        """Allocator accounting holds, and the live slots bind exactly the
        live pages, none of them twice."""
        self.allocator.check_invariants()
        bound = [p for pages in self._slot_pages for p in pages or ()]
        if len(bound) != len(set(bound)):
            raise AssertionError("a page is bound by two slots")
        if set(bound) != set(np.nonzero(self.allocator._live)[0].tolist()):
            raise AssertionError("bound pages differ from the live pages")

    def stats(self) -> dict:
        """Operator gauges (the engine forwards these to its metrics)."""
        return {
            "pages_in_use": self.allocator.pages_in_use,
            "pages_free": self.allocator.pages_free,
            "slots_active": self.active_slot_count,
            "slots_total": self.cfg.max_slots,
            "kv_tokens_resident": int(self.seq_lens.sum()),
            "kv_dtype": self.cfg.kv_dtype,
        }
