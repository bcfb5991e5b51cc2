"""Static tree topology + shared primitives for speculative tree decode
(port of genrec_tpu/ops/spec_tree.py).

A speculative step drafts a small tree of candidate sem-id paths a slot
from the trie and its draft weights (``ops.trie.legal_topk_ragged``), runs
ONE decoder pass over every tree node with a fixed ancestor mask (node i
attends its ancestors' K/V computed in the same pass), replays the plain
beam update level by level on the verified logits, and accepts the
longest prefix of levels whose selections were all drafted. Level 0 is
the current step's own forward, so every call commits >= 1 code and a
drafter that disagrees degenerates to plain decode.

``TreeTopology`` is copied from the JAX module (numpy tables); the
per-node virtual suffix cache, the level commit and the drafted-child
match are torch. The per-head verify/accept steps live with their models
(``models.tiger.tiger_spec_tree_step``, ``models.cobra.
cobra_spec_tree_step``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


class TreeTopology:
    """Flat node tables for a (beams K, fanouts, depth d) candidate tree.

    Nodes are laid out level-major: level 0 holds one node per live beam
    (the current step's exact forward), level l holds ``fanouts[l-1]``
    children per level-(l-1) node. ``fanout`` is one int or a per-level
    sequence (a short one is padded with its last level). All tables are
    host numpy; ``on(device)`` gives them as torch tensors on a device,
    built once a device.
    """

    def __init__(self, beams: int, fanout, depth: int):
        fanouts = (
            (int(fanout),) * depth if np.ndim(fanout) == 0
            else tuple(int(f) for f in fanout)
        )
        if len(fanouts) < depth:  # pad a short spec with its last level
            fanouts = fanouts + (fanouts[-1],) * (depth - len(fanouts))
        fanouts = fanouts[:depth]
        if beams <= 0 or depth < 0 or any(f <= 0 for f in fanouts):
            raise ValueError(
                f"invalid tree topology K={beams} F={fanouts} d={depth}"
            )
        self.beams = int(beams)
        self.fanouts = fanouts
        self.depth = int(depth)
        sizes = [beams]
        for f in fanouts:
            sizes.append(sizes[-1] * f)
        self.level_sizes = sizes
        self.level_offsets = np.concatenate(
            [[0], np.cumsum(self.level_sizes)]
        ).astype(np.int32)
        self.n_nodes = int(self.level_offsets[-1])
        level = np.zeros(self.n_nodes, np.int32)
        root = np.zeros(self.n_nodes, np.int32)
        parent = np.arange(self.n_nodes, dtype=np.int32)  # self at level 0
        for l in range(depth + 1):
            o, n = self.level_offsets[l], self.level_sizes[l]
            idx = np.arange(n)
            level[o:o + n] = l
            root[o:o + n] = idx * beams // n
            if l > 0:
                parent[o:o + n] = self.level_offsets[l - 1] + idx // fanouts[l - 1]
        self.level = level
        self.root_beam = root
        self.parent = parent
        # anc[n, j]: flat index of node n's ancestor at level j (self where
        # j >= level[n]: those rows land only on positions the mask drops).
        anc = np.tile(np.arange(self.n_nodes, dtype=np.int32)[:, None],
                      (1, depth + 1))
        for j in range(depth, 0, -1):
            anc[:, j - 1] = np.where(
                level >= j, parent[anc[:, j]], anc[:, j - 1]
            )
        self.anc = anc
        self._on: dict = {}

    def signature(self) -> tuple:
        return (self.beams, self.fanouts, self.depth)

    def on(self, device) -> dict:
        """``level``, ``root_beam`` and ``anc`` as int64 tensors on
        ``device``."""
        key = str(device)
        if key not in self._on:
            self._on[key] = {
                name: torch.as_tensor(getattr(self, name), dtype=torch.int64, device=device)
                for name in ("level", "root_beam", "anc")
            }
        return self._on[key]

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"TreeTopology(K={self.beams}, F={self.fanouts}, "
                f"d={self.depth}, nodes={self.n_nodes})")


def tree_topology(beams: int, fanout, depth: int) -> TreeTopology:
    """The ``TreeTopology`` of (beams, fanout, depth), built once: every
    speculative call at one shape reuses its tables and their device
    copies. ``fanout`` is an int or a per-level sequence."""
    return _topology(int(beams), int(fanout) if np.ndim(fanout) == 0 else tuple(fanout),
                     int(depth))


@functools.lru_cache(maxsize=64)
def _topology(beams: int, fanout, depth: int) -> TreeTopology:
    return TreeTopology(beams, fanout, depth)


def tree_virtual_cache(cache, new_kv, topo: TreeTopology, base_steps):
    """Per-node suffix-cache view for the parallel verify pass.

    cache (B, K, S, H, hd): the COMMITTED per-beam suffix cache. new_kv
    (B, N, H, hd): this layer's K (or V) of every tree node. base_steps
    (B,): the cache slot level-0 nodes write (TIGER: the current step;
    COBRA: step - 1). Returns (B, N, S, H, hd): node n's ancestors' K/V
    over the committed cache of its root beam at slots base .. base +
    level[n] (its own entry last), the cache a sequential plain step
    would have built along that path. Slots past base + level[n] hold
    values the caller's causal mask drops.
    """
    t = topo.on(cache.device)
    S = cache.shape[2]
    vc = cache[:, t["root_beam"]]  # (B, N, S, H, hd)
    pos = torch.arange(S, device=cache.device)
    for j in range(topo.depth + 1):
        hit = pos[None, :] == (base_steps.long()[:, None] + j)  # (B, S)
        anc_kv = new_kv[:, t["anc"][:, j]]  # (B, N, H, hd)
        vc = torch.where(hit[:, None, :, None, None], anc_kv[:, :, None], vc)
    return vc


def _take_rows(x, idx):
    """x (B, M, ...) gathered along axis 1 by idx (B, K) -> (B, K, ...)."""
    B, K = idx.shape
    full = idx.reshape(B, K, *([1] * (x.dim() - 2))).expand(B, K, *x.shape[2:])
    return torch.gather(x, 1, full)


def commit_level_kv(node_kvs, run_ck, run_cv, flat_idx, sel_parent, slot):
    """One accepted level's suffix-cache commit, in the PLAIN step's order:
    write the selected nodes' K/V at this level's cache slot for every
    beam, THEN reorder the beam axis by the surviving parents.

    node_kvs: per-layer (k_new, v_new), each (B, N, H, hd). run_ck /
    run_cv: per-layer committed-so-far caches (B, K, S, H, hd). flat_idx
    (B, K): the flat node id feeding each beam this level. sel_parent
    (B, K): the surviving parents. slot (B,): the cache write slot.
    Returns (new_ck, new_cv) per-layer lists.
    """
    Sc = run_ck[0].shape[2]
    hit = (torch.arange(Sc, device=slot.device)[None, :]
           == slot.long()[:, None])[:, None, :, None, None]
    new_ck, new_cv = [], []
    for (k_nodes, v_nodes), rk, rv in zip(node_kvs, run_ck, run_cv):
        k_sel = _take_rows(k_nodes, flat_idx)  # (B, K, H, hd)
        v_sel = _take_rows(v_nodes, flat_idx)
        new_ck.append(_take_rows(torch.where(hit, k_sel[:, :, None], rk), sel_parent))
        new_cv.append(_take_rows(torch.where(hit, v_sel[:, :, None], rv), sel_parent))
    return new_ck, new_cv


def match_drafted(draft_tok, parent_local, sel_tok):
    """Which beam selections were drafted, and where.

    draft_tok (B, N_l, F): the next level's drafted child codes per
    level-l node. parent_local (B, K): each selection's parent as a
    LEVEL-LOCAL index. sel_tok (B, K): the selected codes. Returns
    (all_matched (B,) bool, child_f (B, K) int64): a level is accepted
    only when EVERY beam's (parent, token) pair is a drafted edge; child_f
    is the fanout slot of each match, the first one (arbitrary where
    unmatched: the caller gates on all_matched).
    """
    per_parent = _take_rows(draft_tok, parent_local)  # (B, K, F)
    eq = per_parent == sel_tok[..., None]
    return eq.any(-1).all(-1), torch.argmax(eq.to(torch.int8), dim=-1)
