"""Device-memory ledger: account every byte a serving process holds (port
of genrec_tpu/obs/memory.py; ``MemoryLedger`` keeps its API).

`MemoryLedger` models one device's resident set per GROUP (the serving
engine uses one group per head):

- **operands** — runtime state that stays resident between calls:
  params, KV page pools, catalog tensors, paged slot state. Recorded as
  named byte counts (`tree_nbytes` sums tensors, arrays, state dicts and
  nested containers by shape x itemsize, without touching their bytes).
- **executables** — the transient bytes of each call shape, recorded as
  ``{"temp": bytes, "output": bytes, ...}``. The JAX ledger takes these
  from XLA's compile-time memory analysis of every AOT executable; eager
  PyTorch compiles nothing, so the serving engine MEASURES them instead:
  at ``start()`` on the card it runs one call at the largest prefill
  bucket and one at the largest decode slot shape and records the rise
  of ``torch.cuda.max_memory_allocated`` over what was allocated before
  the call (``prefill/B{B}/L{L}``, ``decode/S{S}``; ``dense/B{B}/L{L}``
  for the micro-batch heads). That is a measurement of this run's
  allocator, not an analysis: it moves with the inputs' data where a
  kernel's temporaries do, and on the CPU no transient is recorded.

The budget model per group is

    total = sum(operands) + max over executables(temp + output)

— the resident set plus the worst single call's transient (one call runs
at a time: the batcher is single-threaded). The ENGINE total applies the
same premise across groups: all operands resident together, plus only
the single largest transient.

The ledger is host-side bookkeeping: populate it at start, read
``summary()`` into metrics/Prometheus, and let the owner refuse to start
when the model exceeds a declared budget. `device_memory_stats()` is the
complementary live view: the caching allocator's counters
(``torch.cuda.memory_stats``), empty on the CPU.
"""

from __future__ import annotations

import threading
from typing import Any, Mapping, Optional


def _leaf_nbytes(x) -> Optional[int]:
    """Bytes of one tensor or array leaf, None for anything else."""
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return int(x.nbytes)
    return None


def tree_nbytes(tree: Any) -> int:
    """Total bytes of every tensor / numpy array in ``tree``: dicts (state
    dicts), lists, tuples, ``nn.Module`` (its state dict) and objects
    holding tensors as attributes (a TensorTrie, a quantized pool), nested
    to any depth. Shape x itemsize only — no device-to-host copies. A
    tensor reached twice (tied weights: two names, one storage) counts
    once."""
    import torch

    seen: set = set()

    def walk(x) -> int:
        n = _leaf_nbytes(x)
        if n is not None:
            key = ((x.device, x.data_ptr(), x.numel(), x.dtype)
                   if isinstance(x, torch.Tensor) and n else id(x))
            if key in seen:
                return 0
            seen.add(key)
            return n
        if isinstance(x, torch.nn.Module):
            return walk(x.state_dict(keep_vars=True))
        if isinstance(x, Mapping):
            return sum(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        if isinstance(x, type):
            return 0
        n = sum(walk(v) for v in vars(x).values()) if hasattr(x, "__dict__") else 0
        # Slotted holders (a quantized pool) keep their tensors in slots.
        return n + sum(walk(getattr(x, k)) for k in getattr(type(x), "__slots__", ())
                       if hasattr(x, k))

    return walk(tree)


def device_memory_stats(device=None) -> dict:
    """The caching allocator's counters of one CUDA device as ints
    (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``,
    ``allocated_bytes.all.peak``, ...), or ``{}`` on the CPU or where no
    card is present — never raises."""
    import torch

    try:
        dev = torch.device(device) if device is not None else None
        if (dev is not None and dev.type != "cuda") or not torch.cuda.is_available():
            return {}
        stats = torch.cuda.memory_stats(dev)
    except Exception:  # noqa: BLE001
        return {}
    out = {}
    for k, v in (stats or {}).items():
        try:
            out[str(k)] = int(v)
        except (TypeError, ValueError):
            continue
    return out


class MemoryLedger:
    """Per-group device-memory budget model over operands + call
    transients.

    Thread-safe (the engine populates on start/batcher threads and
    snapshots on caller threads); all methods are lock-then-dict-ops,
    never blocking calls under the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        # group -> {"operands": {name: bytes},
        #           "executables": {name: stats-dict | None}}
        self._groups: dict[str, dict] = {}

    def _group(self, group: str) -> dict:
        return self._groups.setdefault(
            group, {"operands": {}, "executables": {}, "reclaimable": {}}
        )

    def reset_group(self, group: str) -> None:
        """Drop a group's entries (re-ledgering after a catalog swap
        replaced its operands)."""
        with self._lock:
            self._groups.pop(group, None)

    def record_operand(self, group: str, name: str, n_bytes: int) -> None:
        """One resident runtime operand (params, pool, trie, slot state)."""
        with self._lock:
            self._group(group)["operands"][name] = int(n_bytes)

    def record_reclaimable(self, group: str, name: str, n_bytes: int) -> None:
        """Bytes held INSIDE an already-recorded operand that the owner
        can release on demand (the serving prefix cache's retained KV
        pages live inside the fixed page-pool tensor). Tracked as its own
        breakdown component — budget math must see cached bytes as
        reclaimable rather than leaked — but NOT added to the group
        total: the containing operand already counts them."""
        with self._lock:
            self._group(group)["reclaimable"][name] = int(n_bytes)

    def record_executable(self, group: str, name: str, compiled: Any = None,
                          *, stats: Optional[Mapping] = None) -> None:
        """One call shape's transient bytes as ``stats`` ({"temp",
        "output", ...}; the serving engine measures them). ``compiled`` is
        accepted for the JAX ledger's signature and ignored: eager PyTorch
        has no compiled object to analyse. Counted even with no stats."""
        del compiled
        with self._lock:
            self._group(group)["executables"][name] = (
                dict(stats) if stats is not None else None
            )

    # -- reporting -----------------------------------------------------------

    def group_summary(self, group: str) -> dict:
        with self._lock:
            g = self._groups.get(group, {"operands": {}, "executables": {}})
            operands = dict(g["operands"])
            reclaimable = dict(g.get("reclaimable") or {})
            execs = {k: (dict(v) if v else None)
                     for k, v in g["executables"].items()}
        operand_bytes = sum(operands.values())
        peak_name, peak_bytes, code_bytes, analyzed = None, 0, 0, 0
        for name, st in execs.items():
            if st is None:
                continue
            analyzed += 1
            code_bytes += st.get("code", 0)
            transient = st.get("temp", 0) + st.get("output", 0)
            if transient >= peak_bytes:
                peak_name, peak_bytes = name, transient
        return {
            "operands": operands,
            "operand_bytes": operand_bytes,
            "reclaimable": reclaimable,
            "reclaimable_bytes": sum(reclaimable.values()),
            "n_executables": len(execs),
            "n_executables_analyzed": analyzed,
            "transient_peak_bytes": peak_bytes,
            "transient_peak_executable": peak_name,
            "code_bytes": code_bytes,
            "total_bytes": operand_bytes + peak_bytes,
        }

    def executables(self, group: str) -> dict:
        """Per-executable stats (the breakdown view; summary() keeps the
        gauge surface to per-group aggregates)."""
        with self._lock:
            g = self._groups.get(group)
            if g is None:
                return {}
            return {k: (dict(v) if v else None)
                    for k, v in g["executables"].items()}

    def summary(self, budget_bytes: Optional[int] = None) -> dict:
        """The gauge snapshot: per-group aggregates + the budget verdict.
        Nested-numeric, so it flattens straight into Prometheus
        exposition (obs/export.py) and the serve/ tracker namespace.

        The cross-group total is Σ all operands + max single transient —
        one executable runs at a time, so per-group transient peaks
        never coexist; summing them would over-refuse multi-head
        configs."""
        with self._lock:
            names = sorted(self._groups)
        heads = {n: self.group_summary(n) for n in names}
        total = (
            sum(h["operand_bytes"] for h in heads.values())
            + max((h["transient_peak_bytes"] for h in heads.values()),
                  default=0)
        )
        out: dict[str, Any] = {
            "heads": heads,
            "total_bytes": total,
            # Bytes the owners can release on demand (prefix-cache pages):
            # under pressure the EFFECTIVE floor is total - reclaimable.
            "reclaimable_bytes": sum(
                h["reclaimable_bytes"] for h in heads.values()
            ),
        }
        if budget_bytes is not None:
            out["budget_bytes"] = int(budget_bytes)
            out["headroom_pct"] = round(
                100.0 * (1.0 - total / budget_bytes), 2
            ) if budget_bytes > 0 else 0.0
            out["over_budget"] = total > budget_bytes
        return out

    def breakdown_text(self, budget_bytes: Optional[int] = None,
                       top_executables: int = 3) -> str:
        """Actionable per-component breakdown (the refusal message): one
        line per group with its operands, plus the largest executables'
        transient bytes."""
        mb = 1.0 / 2**20
        lines = []
        summ = self.summary(budget_bytes)
        for group, h in summ["heads"].items():
            ops = ", ".join(
                f"{k}={v * mb:.2f}MB"
                for k, v in sorted(h["operands"].items(), key=lambda kv: -kv[1])
            ) or "none"
            lines.append(
                f"  {group}: total {h['total_bytes'] * mb:.2f}MB = "
                f"operands {h['operand_bytes'] * mb:.2f}MB ({ops}) + "
                f"transient peak {h['transient_peak_bytes'] * mb:.2f}MB "
                f"({h['transient_peak_executable'] or 'n/a'}; "
                f"{h['n_executables']} executables)"
            )
            if h.get("reclaimable_bytes"):
                rec = ", ".join(
                    f"{k}={v * mb:.2f}MB"
                    for k, v in sorted(h["reclaimable"].items(),
                                       key=lambda kv: -kv[1])
                )
                lines.append(
                    f"    reclaimable (inside the above, releasable on "
                    f"demand): {h['reclaimable_bytes'] * mb:.2f}MB ({rec})"
                )
            execs = [
                (name, st.get("temp", 0) + st.get("output", 0))
                for name, st in self.executables(group).items() if st
            ]
            for name, b in sorted(execs, key=lambda kv: -kv[1])[:top_executables]:
                lines.append(f"    executable {name}: transient {b * mb:.2f}MB")
        head = f"ledger total {summ['total_bytes'] * mb:.2f}MB"
        if budget_bytes is not None:
            head += (
                f" vs budget {budget_bytes * mb:.2f}MB "
                f"(headroom {summ.get('headroom_pct', 0.0):.1f}%)"
            )
        return "\n".join([head, *lines])
