"""Paged KV cache for the decode heads (port of
genrec_tpu/serving/kv_pool.py: ``PagedConfig``, ``PageAllocator``,
``KVPagePool`` and the prefix cache's ``PrefixIndex``).

The history K/V of every in-flight request lives in ONE pool per decoder
layer, shaped (num_pages, page_size, heads, head_dim), and each decode
slot names its pages through a block-table row. The pool is a fixed
budget: occupancy tracks the tokens actually resident, and an admission
that finds no pages is refused (``PoolExhausted``), never over-allocated.

- ``PageAllocator``: host-side free list with per-page REFCOUNTS; page 0
  is the reserved NULL page and is never handed out. ``addref`` lets two
  holders share pages copy-on-write style (a slot and a prefix-cache
  entry, or two slots); a page returns to the free list when its last
  reference is dropped, and freeing an unheld page raises.
- ``KVPagePool``: the device pools + per-slot block tables + seq_lens.
  ``admit(n_tokens)`` binds a free slot to fresh pages, ``admit_shared``
  onto a retained run (the prefix cache's warm admit), ``evict(slot)``
  drops the slot's references. ``reserve_scratch`` pins pages outside
  every slot for the speculative tree decode. Block-table rows pad with
  page 0; prefill's padded-tail writes land there and attention never
  reads it unmasked.
- ``PagedConfig``: the static shapes of the paged decode path, the page
  budget ``num_pages`` (0: every slot's full budget) and the page type,
  ``kv_dtype`` "float32" or "int8" (``ops.quant.QuantizedKVPool``: int8
  rows plus one fp32 scale per page row, dequantised in the attention
  kernel).
- ``PrefixIndex``: the cross-request prefix cache, a token radix trie
  whose entries hold a reference on a finished prefill's page run, so a
  repeated history shares those pages instead of paying prefill again.
  Entries are an LRU pool that the engine reclaims before it defers an
  admission.

Block tables and seq_lens are host numpy (the engine copies the rows it
decodes to the device each step); the pools are device tensors. Host
bookkeeping is not thread-safe on its own: the engine's batcher thread
is the only caller.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq

import numpy as np
import torch

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.ops.quant import KV_DTYPES, QuantizedKVPool


class PoolExhausted(RuntimeError):
    """Not enough free pages (or no free slot) to admit the request; state
    is unchanged and the engine leaves the request queued."""


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Static shape surface of the paged decode path. ``num_pages``
    counts the reserved null page 0; 0 means the full budget, every
    slot's ``pages_per_slot`` pages."""

    max_slots: int = 32
    page_size: int = 16
    pages_per_slot: int = 8
    num_pages: int = 0
    kv_dtype: str = "float32"

    def __post_init__(self):
        if self.max_slots <= 0 or self.page_size <= 0 or self.pages_per_slot <= 0:
            raise ValueError(f"invalid paged config {self}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype {self.kv_dtype!r} not supported; choose one of {KV_DTYPES}"
            )
        if self.num_pages == 0:
            object.__setattr__(self, "num_pages", 1 + self.max_slots * self.pages_per_slot)
        if self.num_pages < 1 + self.pages_per_slot:
            # A pool that cannot hold one max-size slot would defer an
            # admissible max-history request forever.
            raise ValueError(
                f"num_pages {self.num_pages} cannot hold one full slot "
                f"({self.pages_per_slot} pages + the null page); the pool "
                "must fit at least one max-history request"
            )

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
    """Free-list page allocator with refcounts; page 0 is never handed out."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the null page)")
        self.num_pages = int(num_pages)
        # LIFO: recently freed pages are reused first (their stale KV is
        # overwritten by the next prefill before any read).
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._refs = np.zeros(self.num_pages, np.int64)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def alloc(self, n: int) -> list[int]:
        """n fresh pages at refcount 1, all or nothing."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free of "
                f"{self.num_pages - 1} allocatable"
            )
        pages = [self._free.pop() for _ in range(n)]
        self._refs[pages] += 1
        return pages

    def addref(self, pages) -> None:
        """Share live pages (one more reference each). Refusing a dead
        page catches a use after free where it happens."""
        pages = list(pages)
        if not self.is_live(pages):
            raise ValueError("addref on a page that is not live")
        self._refs[pages] += 1

    def is_live(self, pages) -> bool:
        """Whether every page holds at least one reference."""
        return all(self._refs[p] > 0 for p in pages)

    def free(self, pages) -> None:
        """Drop one reference a page; a page returns to the free list at
        zero. Double frees raise instead of corrupting the free list."""
        for p in pages:
            if p <= 0 or p >= self.num_pages:
                raise ValueError(f"free of invalid page id {p}")
            if self._refs[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def check_invariants(self) -> None:
        """free + live == capacity, no negative refcount, no duplicate or
        live page on the free list."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list contains duplicates")
        if 0 in free:
            raise AssertionError("null page on the free list")
        if (self._refs < 0).any():
            raise AssertionError("negative refcount")
        live = set(np.nonzero(self._refs > 0)[0].tolist())
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
        # Pages pinned by reserve_scratch (speculative tree decode): held
        # outside the slots' bookkeeping, never admitted against.
        self._scratch_pages: list[int] = []
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

    def live_slots(self) -> list[int]:
        return [s for s, p in enumerate(self._slot_pages) if p is not None]

    def admit(self, n_tokens: int) -> int:
        """Bind a free slot to fresh pages covering ``n_tokens`` of KV.
        Returns the slot id; raises PoolExhausted (state unchanged) when
        out of slots or pages."""
        if not self._free_slots:
            raise PoolExhausted("no free decode slots")
        pages = self.allocator.alloc(self.cfg.pages_for(n_tokens))
        return self._bind_slot(pages, n_tokens)

    def _bind_slot(self, pages: list[int], n_tokens: int) -> int:
        """Pop a free slot and point it at ``pages``, whose one reference
        each the caller has arranged for the slot to own."""
        slot = heapq.heappop(self._free_slots)
        self._slot_pages[slot] = pages
        self.block_tables[slot] = 0
        self.block_tables[slot, : len(pages)] = pages
        self.seq_lens[slot] = n_tokens
        return slot

    def evict(self, slot: int) -> None:
        """Drop the slot's page references (freeing the pages nobody else
        holds) and return the slot to the free list."""
        pages = self._slot_pages[slot]
        if pages is None:
            raise ValueError(f"evict of inactive slot {slot}")
        self.allocator.free(pages)
        self._slot_pages[slot] = None
        self.block_tables[slot] = 0
        self.seq_lens[slot] = 0
        heapq.heappush(self._free_slots, slot)

    def slot_pages(self, slot: int) -> list[int]:
        """A copy of the page run a live slot is bound to."""
        pages = self._slot_pages[slot]
        if pages is None:
            raise ValueError(f"pages of inactive slot {slot}")
        return list(pages)

    def share_into(self, src_slot: int, dst_slot_tokens: int) -> int:
        """Admit a NEW slot that shares the source slot's pages (one more
        reference, no copy). It sees the first ``dst_slot_tokens`` of the
        shared history and references only the pages that view covers."""
        pages = self._slot_pages[src_slot]
        if pages is None:
            raise ValueError(f"share from inactive slot {src_slot}")
        if dst_slot_tokens > len(pages) * self.cfg.page_size:
            raise ValueError("shared view exceeds the source slot's pages")
        return self._bind_shared(pages, dst_slot_tokens)

    def admit_shared(self, pages, n_tokens: int) -> int:
        """Admit a NEW slot onto a live page run held elsewhere (the prefix
        cache's warm admit: the run is a ``PrefixIndex`` entry), taking a
        reference on the pages the ``n_tokens`` view covers."""
        pages = list(pages)
        if n_tokens > len(pages) * self.cfg.page_size:
            raise ValueError("shared view exceeds the retained page run")
        return self._bind_shared(pages, n_tokens)

    def bind_pages(self, pages, n_tokens: int) -> int:
        """Bind a slot onto pages the caller already owns: their
        references pass to the slot (no addref). State unchanged on
        error."""
        pages = list(pages)
        if n_tokens > len(pages) * self.cfg.page_size:
            raise ValueError("bound view exceeds the page run")
        if not self.allocator.is_live(pages):
            raise ValueError("bind_pages on a page that is not live")
        if not self._free_slots:
            raise PoolExhausted("no free decode slots")
        return self._bind_slot(pages, n_tokens)

    def _bind_shared(self, pages: list[int], n_tokens: int) -> int:
        if not self._free_slots:
            raise PoolExhausted("no free decode slots")
        cover = pages[: self.cfg.pages_for(n_tokens)]
        self.allocator.addref(cover)  # may raise; slot state untouched
        return self._bind_slot(list(cover), n_tokens)

    def reserve_scratch(self, n_pages: int) -> np.ndarray:
        """Pin ``n_pages`` for the speculative tree decode and return them.
        They hold one reference each (counted in ``pages_in_use``) and can
        never be bound to a slot, so a rejected tree's rollback leaves the
        pool as it was: speculation and slot state share no pages. The
        port's tree pass carries the tree's K/V as dense tensors inside
        the call and leaves these pages untouched; the reservation keeps
        the JAX engine's page budget and accounting. ``release_scratch``
        undoes it."""
        if n_pages <= 0:
            return np.zeros((0,), np.int32)
        pages = self.allocator.alloc(int(n_pages))  # may raise: size the config to hold it
        self._scratch_pages.extend(pages)
        return np.asarray(pages, np.int32)

    def release_scratch(self) -> int:
        """Drop every scratch reservation. Returns the pages released."""
        n = len(self._scratch_pages)
        if n:
            self.allocator.free(self._scratch_pages)
            self._scratch_pages = []
        return n

    @property
    def scratch_page_count(self) -> int:
        return len(self._scratch_pages)

    def check_invariants(self) -> None:
        """Allocator accounting holds, and no page is bound by more slots
        than it has references."""
        self.allocator.check_invariants()
        bound: dict[int, int] = {}
        for pages in self._slot_pages:
            for p in pages or ():
                bound[p] = bound.get(p, 0) + 1
        for p, n in bound.items():
            if self.allocator.refcount(p) < n:
                raise AssertionError(
                    f"page {p} bound by {n} slots but holds "
                    f"{self.allocator.refcount(p)} refs (aliasing without a ref)"
                )

    def stats(self) -> dict:
        """Operator gauges (the engine forwards these to its metrics)."""
        return {
            "pages_in_use": self.allocator.pages_in_use,
            "pages_free": self.allocator.pages_free,
            "scratch_pages": len(self._scratch_pages),
            "slots_active": self.active_slot_count,
            "slots_total": self.cfg.max_slots,
            "kv_tokens_resident": int(self.seq_lens.sum()),
            "kv_dtype": self.cfg.kv_dtype,
        }


# ---- the cross-request prefix cache ------------------------------------------


class PrefixEntry:
    """One retained page run: the KV a finished prefill wrote, kept alive
    by a reference so the same history can be admitted again without
    prefill. ``init`` is the donor's post-prefill state rows (host numpy,
    the keys its prefill initialised), None for heads whose prefill leaves
    the state zeroed; ``bucket`` the donor's prefill (B, L)."""

    __slots__ = ("key", "n_tokens", "pages", "init", "bucket", "hits")

    def __init__(self, key, n_tokens, pages, init=None, bucket=None):
        self.key = tuple(key)
        self.n_tokens = int(n_tokens)
        self.pages = list(pages)
        self.init = init
        self.bucket = bucket
        self.hits = 0


class _RadixNode:
    __slots__ = ("children", "entry")

    def __init__(self):
        self.children: dict = {}
        self.entry: PrefixEntry | None = None


class PrefixIndex:
    """Radix (token-trie) index of retained page runs, LRU-ordered.

    Keys are token-aligned history tuples (the head's
    ``prefix_key_tokens``), one token a trie level. ``lookup`` returns the
    entry of a FULL-key match (the only reuse that is exact for both head
    families) and the depth of the longest retained prefix (telemetry).
    The index holds one allocator reference a retained page, taken at
    ``insert`` and dropped at removal, so a run outlives its donor slot.
    ``reclaim`` drops LRU entries until the allocator can meet a demand;
    the engine runs it before it defers any admission."""

    def __init__(self, allocator: PageAllocator, max_entries: int = 4096):
        if max_entries <= 0:
            raise ValueError(f"max_entries {max_entries} must be positive")
        self._alloc = allocator
        self._max_entries = int(max_entries)
        self._root = _RadixNode()
        # key -> entry, oldest first; move_to_end on a hit keeps it LRU.
        self._lru: collections.OrderedDict[tuple, PrefixEntry] = collections.OrderedDict()
        self._retained_pages = 0

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def retained_pages(self) -> int:
        """Page references the index holds (entries never share pages:
        each run came from one donor prefill)."""
        return self._retained_pages

    def lookup(self, key) -> tuple[PrefixEntry | None, int]:
        """(exact entry or None, matched token depth)."""
        key = tuple(key)
        node, path = self._root, [self._root]
        for tok in key:
            node = node.children.get(tok)
            if node is None:
                break
            path.append(node)
        if len(path) - 1 == len(key) and path[-1].entry is not None:
            return path[-1].entry, len(key)
        for depth in range(len(path) - 1, 0, -1):  # deepest retained prefix
            if path[depth].entry is not None:
                return None, depth
        return None, 0

    def touch(self, key) -> None:
        """Refresh an entry's LRU position (every warm hit)."""
        self._lru.move_to_end(tuple(key))

    def insert(self, key, n_tokens: int, pages, *, init=None, bucket=None) -> PrefixEntry:
        """Retain a live page run under ``key`` (one reference a page). An
        entry of the same key is replaced; past ``max_entries`` the LRU
        entry goes first."""
        key = tuple(key)
        if key in self._lru:
            self.remove(key)
        while len(self._lru) >= self._max_entries:
            self.remove(next(iter(self._lru)))
        entry = PrefixEntry(key, n_tokens, pages, init=init, bucket=bucket)
        self._alloc.addref(entry.pages)
        node = self._root
        for tok in key:
            node = node.children.setdefault(tok, _RadixNode())
        node.entry = entry
        self._lru[key] = entry
        self._retained_pages += len(entry.pages)
        return entry

    def remove(self, key) -> PrefixEntry | None:
        """Drop one entry (and its page references); prunes emptied trie
        nodes."""
        key = tuple(key)
        entry = self._lru.pop(key, None)
        if entry is None:
            return None
        self._release(entry)
        path = [self._root]
        for tok in key:
            path.append(path[-1].children[tok])
        path[-1].entry = None
        for i in range(len(key), 0, -1):  # prune the childless, entry-less tail
            node, parent = path[i], path[i - 1]
            if node.children or node.entry is not None:
                break
            del parent.children[key[i - 1]]
        return entry

    def _release(self, entry: PrefixEntry) -> None:
        self._alloc.free(entry.pages)
        self._retained_pages -= len(entry.pages)

    def reclaim(self, pages_needed: int) -> int:
        """Evict entries, LRU first, until the allocator has
        ``pages_needed`` free pages or nothing evictable is left. An entry
        whose pages are all still referenced elsewhere (a live slot) is
        skipped: dropping it would free nothing now. Returns the entries
        evicted."""
        evicted = 0
        while self._alloc.pages_free < pages_needed:
            victim = next((key for key, e in self._lru.items()
                           if any(self._alloc.refcount(p) == 1 for p in e.pages)), None)
            if victim is None:
                break
            self.remove(victim)
            evicted += 1
        return evicted

    def clear(self) -> int:
        """Drop every entry (drain). Returns the entries dropped."""
        n = len(self._lru)
        for entry in self._lru.values():
            self._release(entry)
        self._lru.clear()
        self._root = _RadixNode()
        return n

    def stats(self) -> dict:
        return {"entries": len(self._lru), "retained_pages": self._retained_pages}
