"""Qwen2-class decoder-only backbone (port of
genrec_tpu/models/backbones/qwen.py): RMSNorm -> GQA attention with
half-rotation RoPE (q/k/v biased, o bias-free) -> SwiGLU MLP, pre-norm
residuals, an optional tied LM head, and the static KV cache of decode.

Every module takes a tensor-parallel group (``parallel.mesh.TPGroup``) or
None. With a group of tp ranks the Megatron layers of
``parallel/shardings.py`` hold this rank's shard: H / tp query heads in
contiguous blocks and the KV heads they use (``shardings.kv_range``: KV / tp
of them when tp divides KV, else a KV head on every rank whose q heads use
it, its gradient summed over those ranks), FFN / tp hidden units, V / tp
vocab rows; the residual stream and the hidden states stay replicated.

``cfg.num_experts > 0`` replaces the SwiGLU MLP with ``QwenMoEMLP`` (JAX
:175): an fp32 router, top-k experts a token, a slot budget per expert,
and a load-balance loss that each block returns and ``QwenLM`` collects
into the caller's ``moe_aux`` list in layer order (JAX sows it into a
``losses`` collection). An ``expert_group`` (expert parallelism, JAX
``moe_rules``) gives each rank E / ep experts of every stack.

Parameters are fp32 and cast to ``dtype`` at use; norms compute in
fp32. Attention is plain torch, as the JAX package computes it outside
any kernel: fp32 scores, an additive -1e9 bias kept inside the softmax.
The decode cache is written in place at its index (the JAX
``dynamic_update_slice`` returns a new array).

``params_from_hf_state_dict`` maps a Hugging Face Qwen2 state dict onto
the port's parameter names (dense models; as in JAX, Qwen2-MoE keys are
not mapped).

Not ported: ring attention (sequence parallelism; A15) and the pipeline
stage body (A16).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.layers import RMSNorm
from genrec_tpu_torch.parallel.mesh import data_share, data_sum, global_rows, step_data_group
from genrec_tpu_torch.parallel.shardings import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    copy_to_tp,
    gather_from_tp,
    kv_holders,
    kv_range,
    reduce_from_tp,
    shard_count,
    sum_replica_grads,
    tp_rank,
    tp_size,
)


@dataclasses.dataclass(frozen=True)
class QwenConfig:
    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    max_position_embeddings: int = 4096
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 2.0
    router_aux_coef: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def causal_pad_bias(L: int, attention_mask=None, device=None) -> torch.Tensor:
    """Additive attention bias (fp32): -1e9 above the diagonal and at
    padded keys (never -inf: fully masked rows would poison gradients)."""
    dev = device if attention_mask is None else attention_mask.device
    upper = torch.triu(torch.ones((L, L), dtype=torch.bool, device=dev), diagonal=1)
    bias = torch.where(upper, -1e9, 0.0)[None, None]
    if attention_mask is not None:
        bias = bias + torch.where(attention_mask[:, None, None, :] == 0, -1e9, 0.0)
    return bias


def _rope(x, positions, theta: float):
    """NeoX-style half-rotation RoPE. x (B, L, H, hd), positions (B, L);
    the angles in fp32, the result in x's dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class QwenAttention(nn.Module):
    def __init__(self, cfg: QwenConfig, dtype, group, device):
        super().__init__()
        tp, rank = tp_size(group), tp_rank(group)
        H, KV, hd, d = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                        cfg.hidden_size)
        self.heads = shard_count(H, tp, "num_attention_heads")
        kv0, kv1 = kv_range(H, KV, rank, tp)
        self.kv_heads = kv1 - kv0
        self.cfg, self.dtype = cfg, dtype
        self.q_proj = ColumnParallelLinear(d, H * hd, True, group, device)
        kv_rows = self.kv_heads * hd
        self.k_proj = ColumnParallelLinear(d, KV * hd, True, group, device, out_local=kv_rows)
        self.v_proj = ColumnParallelLinear(d, KV * hd, True, group, device, out_local=kv_rows)
        self.o_proj = RowParallelLinear(H * hd, d, group, device)
        # How many local q heads read each local KV head, in order (all
        # H / KV when tp divides KV).
        g, q0 = H // KV, rank * self.heads
        kv_of_q = [(q0 + j) // g - kv0 for j in range(self.heads)]
        self.q_per_kv = [kv_of_q.count(j) for j in range(self.kv_heads)]
        if tp > 1 and KV % tp:
            # Replicated KV rows: gradients summed over their holders, square
            # sums counted once in the clip.
            holders = kv_holders(H, KV, tp)
            w = torch.tensor([1.0 / holders[h] for h in range(kv0, kv1) for _ in range(hd)],
                             device=device)
            for lin in (self.k_proj, self.v_proj):
                for p in (lin.weight, lin.bias):
                    sum_replica_grads(p, group, KV * hd, kv0 * hd, kv1 * hd, w)

    def _expand_kv(self, t):
        """(B, S, kv_heads, hd) -> (B, S, heads, hd): each KV head repeated
        for the local q heads that read it. Copies forward, a sum over the
        copies backward (no scatter: the same bits on every run)."""
        counts = self.q_per_kv
        if len(set(counts)) == 1:
            return torch.repeat_interleave(t, counts[0], dim=2)
        B, S, _, hd = t.shape
        return torch.cat([t[:, :, j:j + 1].expand(B, S, c, hd) for j, c in enumerate(counts)],
                         dim=2)

    def forward(self, x, positions, attn_bias, cache=None):
        """x (B, L, d) in ``dtype`` (already through ``copy_to_tp``). With
        ``cache`` ({"k", "v": (B, S, KV / tp, hd), "idx": int}) this step's
        K/V are written at idx and attention runs over all S slots.
        Returns (out (B, L, d), new cache or None)."""
        B, L, _ = x.shape
        hd = self.cfg.head_dim
        q = _rope(self.q_proj(x).view(B, L, self.heads, hd), positions, self.cfg.rope_theta)
        k = _rope(self.k_proj(x).view(B, L, self.kv_heads, hd), positions, self.cfg.rope_theta)
        v = self.v_proj(x).view(B, L, self.kv_heads, hd)
        new_cache = None
        if cache is not None:
            idx = cache["idx"]
            cache["k"][:, idx:idx + L] = k
            cache["v"][:, idx:idx + L] = v
            k, v = cache["k"], cache["v"]
            new_cache = {"k": k, "v": v, "idx": idx + L}
        k, v = self._expand_kv(k), self._expand_kv(v)
        scores = torch.einsum("blhd,bshd->bhls", q, k).to(torch.float32) * (hd ** -0.5)
        attn = torch.softmax(scores + attn_bias, dim=-1).to(x.dtype)
        out = torch.einsum("bhls,bshd->blhd", attn, v).reshape(B, L, self.heads * hd)
        return self.o_proj(out), new_cache


class QwenMLP(nn.Module):
    def __init__(self, cfg: QwenConfig, group, device):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = ColumnParallelLinear(d, f, False, group, device)
        self.up_proj = ColumnParallelLinear(d, f, False, group, device)
        self.down_proj = RowParallelLinear(f, d, group, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class _Dispatch(torch.autograd.Function):
    """expert_in[j] = x[owner[j] // K] for the (expert, slot) rows j of this
    rank, zeros where no token holds the slot (owner -1). Backward gathers
    too: a token's gradient is the sum, in rank order, of the rows of its
    K slots (``slot_of`` (S, K), -1 where the choice holds no slot here),
    so nothing is scattered and a step's bits repeat."""

    @staticmethod
    def forward(ctx, x, owner, slot_of):
        S, K = slot_of.shape
        ctx.save_for_backward(slot_of)
        xz = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        return xz[torch.where(owner >= 0, owner // K, S)]

    @staticmethod
    def backward(ctx, g):
        (slot_of,) = ctx.saved_tensors
        J = g.shape[0]
        gz = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        idx = torch.where(slot_of >= 0, slot_of, J)
        out = gz[idx[:, 0]]
        for k in range(1, idx.shape[1]):
            out = out + gz[idx[:, k]]
        return out, None, None


class _Combine(torch.autograd.Function):
    """y[s] = sum over k of gates[s, k] * out[slot_of[s, k]] (0 where the
    choice holds no slot here), in float32, rounded once to out's dtype.
    Backward gathers in both directions: out's gradient by the slot's
    owner, the gates' by the token's slots."""

    @staticmethod
    def forward(ctx, out, gates, slot_of, owner):
        ctx.save_for_backward(out, gates, slot_of, owner)
        J = out.shape[0]
        oz = torch.cat([out, out.new_zeros((1, out.shape[1]))]).to(torch.float32)
        idx = torch.where(slot_of >= 0, slot_of, J)
        y = gates[:, 0].to(torch.float32)[:, None] * oz[idx[:, 0]]
        for k in range(1, idx.shape[1]):
            y = y + gates[:, k].to(torch.float32)[:, None] * oz[idx[:, k]]
        return y.to(out.dtype)

    @staticmethod
    def backward(ctx, g):
        out, gates, slot_of, owner = ctx.saved_tensors
        (S, K), J = slot_of.shape, out.shape[0]
        gf = torch.cat([g, g.new_zeros((1, g.shape[1]))]).to(torch.float32)
        gate_flat = torch.cat([gates.reshape(-1), gates.new_zeros(1)]).to(torch.float32)
        here = owner >= 0
        g_out = (gate_flat[torch.where(here, owner, S * K)][:, None]
                 * gf[torch.where(here, owner // K, S)]).to(out.dtype)
        oz = torch.cat([out, out.new_zeros((1, out.shape[1]))]).to(torch.float32)
        idx = torch.where(slot_of >= 0, slot_of, J)
        g_gates = torch.stack([(gf[:S] * oz[idx[:, k]]).sum(-1) for k in range(K)], dim=1)
        return g_out, g_gates.to(gates.dtype), None, None


class QwenMoEMLP(nn.Module):
    """Top-k routed mixture of SwiGLU experts (JAX ``QwenMoEMLP``, :175).

    An fp32 router (bias-free) gives softmax probabilities; each token
    takes its top ``num_experts_per_tok`` experts (ties to the lower expert,
    as ``jax.lax.top_k``: a stable sort) with the gates renormalised. Each
    expert has C = max(1, int(ceil(S / E) * moe_capacity_factor)) slots;
    rank-k choices claim slots only after every rank-(k - 1) choice, in
    token order (JAX's transposed cumsum), padding claims none, and a
    choice past C is dropped (its token's MLP delta from that expert is
    zero). The JAX module writes the routing as dense (S, E, C) one-hot
    einsums; here each slot holds one token, so dispatch and combine are
    gathers by slot (``_Dispatch``, ``_Combine``), exact, and gathers in
    their backward too. The Switch load-balance loss over valid tokens,
    times ``router_aux_coef``, is returned beside the output.

    Under an ``expert_group`` of ep ranks (JAX ``moe_rules``) this rank holds
    experts [rank E / ep, (rank + 1) E / ep) of each stack (``tp_sharded``).
    Tokens are replicated: every rank routes every token with the
    replicated router, dispatches to its own experts only, and the partial
    outputs are summed over the group. The expert input and the gates
    enter the local dispatch and combine through ``copy_to_tp`` (their
    gradients summed over the group); the router's own path and the aux
    loss stay replicated and are not summed, so every gradient equals ep
    = 1's. ``dropped`` holds the last call's share of valid choices that
    found no slot."""

    def __init__(self, cfg: QwenConfig, dtype, expert_group, device):
        super().__init__()
        E, D, F_ = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        ep = tp_size(expert_group)
        self.cfg, self.dtype, self.group = cfg, dtype, expert_group
        self.local = shard_count(E, ep, "num_experts")
        self.router = nn.Linear(D, E, bias=False, device=device)
        self.gate_proj = nn.Parameter(torch.zeros((self.local, D, F_), device=device))
        self.up_proj = nn.Parameter(torch.zeros((self.local, D, F_), device=device))
        self.down_proj = nn.Parameter(torch.zeros((self.local, F_, D), device=device))
        for p in (self.gate_proj, self.up_proj, self.down_proj):
            p.tp_sharded = ep > 1
            if ep > 1:
                p.tp_group = expert_group  # beside a model axis, for the clip's norm
        self.dropped = None

    def forward(self, x, token_mask=None):
        """x (B, L, D) in ``dtype``; token_mask (B, L), 1 = valid. Returns
        (y (B, L, D), router_aux scalar fp32)."""
        cfg = self.cfg
        E, K = cfg.num_experts, cfg.num_experts_per_tok
        B, L, D = x.shape
        S = B * L
        xf = x.reshape(S, D)
        probs = torch.softmax(F.linear(xf.to(torch.float32), self.router.weight), dim=-1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, eidx = order.values[:, :K], order.indices[:, :K]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        valid = (torch.ones(S, dtype=torch.int64, device=x.device) if token_mask is None
                 else token_mask.reshape(S).to(torch.int64))

        dgroup = step_data_group()
        S_all = S if dgroup is None else global_rows() * L
        C = max(1, int(-(-S_all // E) * cfg.moe_capacity_factor))
        onehot = F.one_hot(eidx, E) * valid[:, None, None]  # (S, K, E)
        flat = onehot.transpose(0, 1).reshape(K * S, E)
        pos = (torch.cumsum(flat, dim=0) * flat - 1).reshape(K, S, E).transpose(0, 1)
        # The global batch's slot order: a rank-k choice follows every rank-k'
        # < k choice of all data ranks and the rank-k choices of the data
        # ranks before this one (one all-gather of K x E ints under data
        # parallelism; the shift is 0 on one rank).
        mine_ke = onehot.sum(0)  # (K, E)
        every = (mine_ke[None] if dgroup is None
                 else dgroup.all_gather(mine_ke.reshape(1, K * E), dim=0).reshape(-1, K, E))
        tot = every.sum(0)
        below = torch.cumsum(tot, 0) - tot  # all ranks' lower levels
        rank = 0 if dgroup is None else dgroup.rank
        shift = below + every[:rank].sum(0) - (torch.cumsum(mine_ke, 0) - mine_ke)
        pos = pos + shift[None] * onehot
        slot = (pos * onehot).sum(-1)  # (S, K)
        keep = (slot >= 0) & (slot < C) & (valid[:, None] > 0)
        kept = torch.minimum((C - below).clamp_min(0), tot).sum()
        self.dropped = ((tot.sum() - kept) / tot.sum().clamp_min(1)).detach()

        # This rank's experts: flat local slot ids (e - e0) C + slot, -1 where
        # the choice was dropped or lands on another rank's expert.
        e0 = tp_rank(self.group) * self.local
        mine = keep & (eidx >= e0) & (eidx < e0 + self.local)
        J = self.local * C
        slot_of = torch.where(mine, (eidx - e0) * C + slot, -1)
        owner = torch.full((J + 1,), -1, dtype=torch.int64, device=x.device)
        tok_k = torch.arange(S * K, device=x.device).reshape(S, K)
        owner.scatter_(0, torch.where(mine, slot_of, J).reshape(-1), tok_k.reshape(-1))
        owner = owner[:J]  # index J took every choice not held here

        x_in = copy_to_tp(xf, self.group)
        g_in = copy_to_tp(gates.to(x.dtype), self.group)
        expert_in = _Dispatch.apply(x_in, owner, slot_of).reshape(self.local, C, D)
        h = (F.silu(torch.bmm(expert_in, self.gate_proj.to(x.dtype)))
             * torch.bmm(expert_in, self.up_proj.to(x.dtype)))
        out = torch.bmm(h, self.down_proj.to(x.dtype)).reshape(J, D)
        y = reduce_from_tp(_Combine.apply(out, g_in, slot_of, owner), self.group)

        vf = valid.to(torch.float32)
        top1 = F.one_hot(eidx[:, 0], E).to(torch.float32) * vf[:, None]
        # Both means over the global batch's valid tokens (their sums in one
        # all-reduce under data parallelism).
        sums = data_sum(torch.cat([(probs * vf[:, None]).sum(0), top1.sum(0), vf.sum()[None]]))
        nv = sums[-1].clamp_min(1.0)
        aux = E * torch.sum(sums[:E] / nv * (sums[E:2 * E] / nv))
        return y.reshape(B, L, D), cfg.router_aux_coef * data_share(aux)


def collect_moe_aux(moe_aux: list) -> torch.Tensor | float:
    """The sum of the ``router_aux`` values a forward appended to its
    ``moe_aux`` list, in layer order (JAX ``collect_moe_aux``); 0.0 for a
    dense model."""
    return sum(moe_aux) if moe_aux else 0.0


class QwenBlock(nn.Module):
    def __init__(self, cfg: QwenConfig, dtype, group, device, expert_group=None):
        super().__init__()
        self.dtype, self.group = dtype, group
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device)
        self.self_attn = QwenAttention(cfg, dtype, group, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                device=device)
        if cfg.num_experts > 0:
            self.moe = QwenMoEMLP(cfg, dtype, expert_group, device)
        else:
            self.mlp = QwenMLP(cfg, group, device)

    def forward(self, x, positions, attn_bias, cache=None, token_mask=None):
        """Returns (x, new cache or None, the MoE's router_aux or None)."""
        h = copy_to_tp(self.input_layernorm(x).to(self.dtype), self.group)
        h, new_cache = self.self_attn(h, positions, attn_bias, cache)
        x = x + h
        h = self.post_attention_layernorm(x).to(self.dtype)
        if hasattr(self, "moe"):
            # The MoE is replicated over the model axis (its experts split
            # over the expert axis): its input gradient is not summed there.
            y, aux = self.moe(h, token_mask)
            return x + y, new_cache, aux
        return x + self.mlp(copy_to_tp(h, self.group)), new_cache, None


class QwenLM(nn.Module):
    """The backbone and its LM head. ``group`` None is the whole model on
    one device; a ``TPGroup`` makes this module the rank's shard, and an
    ``expert_group`` shards a MoE model's experts (expert parallelism).
    Parameters start at zero: load a state dict (``qwen_init_params`` +
    ``parallel.shardings.shard_qwen_params`` / ``shard_expert_params``, or
    ``convert.qwen_params_from_flax``). ``remat`` recomputes each block's
    activations in the backward pass (JAX ``nn.remat``; the block's
    collectives are issued again, in the same order on every rank)."""

    def __init__(self, cfg: QwenConfig, dtype=torch.float32, group=None, device="cuda",
                 remat: bool = False, expert_group=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype, self.group, self.remat = cfg, dtype, group, remat
        self.expert_group = expert_group
        self.embed_tokens = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size, group,
                                                   device)
        self.layers = nn.ModuleList(
            QwenBlock(cfg, dtype, group, device, expert_group)
            for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Parameter(torch.zeros(
                (self.embed_tokens.rows, cfg.hidden_size), device=device))
            self.lm_head.tp_sharded = tp_size(group) > 1

    @property
    def head_weight(self) -> torch.Tensor:
        """This rank's rows of the head (the embedding when tied), fp32."""
        return self.embed_tokens.weight if self.cfg.tie_word_embeddings else self.lm_head

    def head(self, h):
        """Logits over the whole (padded) vocabulary: h @ Wᵀ per rank,
        concatenated over the group."""
        w = self.head_weight.to(self.dtype)
        return gather_from_tp(F.linear(copy_to_tp(h, self.group), w), self.group)

    def forward(self, input_ids, attention_mask=None, positions=None,
                return_hidden: bool = False, compute_logits: bool = True,
                moe_aux: list | None = None):
        """Full-sequence forward; attention_mask (B, L), 1 = valid (also the
        MoE's token mask). ``compute_logits=False`` skips the head (logits
        None). A MoE model appends each layer's router_aux to ``moe_aux``."""
        B, L = input_ids.shape
        if positions is None:
            positions = torch.arange(L, device=input_ids.device).expand(B, L)
        bias = causal_pad_bias(L, attention_mask, device=input_ids.device)
        x = self.embed_tokens(input_ids).to(self.dtype)
        for block in self.layers:
            if self.remat and torch.is_grad_enabled():
                x, _, aux = torch.utils.checkpoint.checkpoint(
                    block, x, positions, bias, None, attention_mask, use_reentrant=False)
            else:
                x, _, aux = block(x, positions, bias, token_mask=attention_mask)
            if aux is not None and moe_aux is not None:
                moe_aux.append(aux)
        h = self.norm(x).to(self.dtype)
        logits = self.head(h) if compute_logits else None
        return (logits, h) if return_hidden else logits

    def init_cache(self, batch_size: int, max_len: int) -> list[dict]:
        """Zeroed (B, S, KV / tp, hd) K and V per layer, index 0."""
        kv = self.layers[0].self_attn.kv_heads if self.layers else 0
        dev = self.norm.weight.device
        shape = (batch_size, max_len, kv, self.cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                 "v": torch.zeros(shape, dtype=self.dtype, device=dev), "idx": 0}
                for _ in self.layers]

    def decode_step(self, input_ids, positions, caches, pad_mask):
        """Advance by input_ids.shape[1] tokens against the caches;
        pad_mask (B, S), 1 = a valid slot after this step's write (its
        slots of this step's tokens are the MoE's token mask, so a padded
        prompt's pads claim no expert slot). Returns (logits at the last
        position (B, V), new caches)."""
        L = input_ids.shape[1]
        S = caches[0]["k"].shape[1]
        dev = input_ids.device
        slot = torch.arange(S, device=dev)[None, None, None, :]
        write_pos = caches[0]["idx"] + torch.arange(L, device=dev)
        bias = (torch.where(slot > write_pos[None, None, :, None], -1e9, 0.0)
                + torch.where(pad_mask[:, None, None, :] == 0, -1e9, 0.0))
        x = self.embed_tokens(input_ids).to(self.dtype)
        idx = caches[0]["idx"]
        token_mask = pad_mask[:, idx:idx + L]
        new_caches = []
        for block, cache in zip(self.layers, caches):
            x, nc, _ = block(x, positions, bias, cache, token_mask)
            new_caches.append(nc)
        h = self.norm(x).to(self.dtype)
        return self.head(h[:, -1:, :])[:, 0], new_caches


def qwen_param_specs(cfg: QwenConfig) -> dict:
    """name -> (full shape, initialiser) of every parameter of
    ``QwenLM(cfg)``: "embed" N(0, 0.02), "dense" lecun-normal (a normal
    cut at +-2 std, std fan_in^-1/2, Flax's ``lecun_normal``), "expert"
    the same over an (E, in, out) stack (Flax's fan_in is E * in), "zeros",
    "ones"."""
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
    specs = {"embed_tokens.weight": ((cfg.vocab_size, d), "embed")}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        specs.update({
            p + "input_layernorm.weight": ((d,), "ones"),
            p + "self_attn.q_proj.weight": ((H * hd, d), "dense"),
            p + "self_attn.q_proj.bias": ((H * hd,), "zeros"),
            p + "self_attn.k_proj.weight": ((KV * hd, d), "dense"),
            p + "self_attn.k_proj.bias": ((KV * hd,), "zeros"),
            p + "self_attn.v_proj.weight": ((KV * hd, d), "dense"),
            p + "self_attn.v_proj.bias": ((KV * hd,), "zeros"),
            p + "self_attn.o_proj.weight": ((d, H * hd), "dense"),
            p + "post_attention_layernorm.weight": ((d,), "ones"),
        })
        if cfg.num_experts > 0:
            E = cfg.num_experts
            specs.update({
                p + "moe.router.weight": ((E, d), "dense"),
                p + "moe.gate_proj": ((E, d, f), "expert"),
                p + "moe.up_proj": ((E, d, f), "expert"),
                p + "moe.down_proj": ((E, f, d), "expert"),
            })
        else:
            specs.update({
                p + "mlp.gate_proj.weight": ((f, d), "dense"),
                p + "mlp.up_proj.weight": ((f, d), "dense"),
                p + "mlp.down_proj.weight": ((d, f), "dense"),
            })
    specs["norm.weight"] = ((d,), "ones")
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = ((cfg.vocab_size, d), "embed")
    return specs


def qwen_init_params(cfg: QwenConfig, seed: int = 0, device="cuda") -> dict:
    """A full (unsharded) state dict of ``QwenLM(cfg)`` from ``seed``, drawn
    in ``qwen_param_specs`` order. Every rank that calls it with the same
    seed on the same kind of device gets the same tensors."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    full = {}
    for name, (shape, kind) in qwen_param_specs(cfg).items():
        t = torch.empty(shape, device=dev)
        if kind == "embed":
            t.normal_(0.0, 0.02, generator=gen)
        elif kind in ("dense", "expert"):
            fan_in = shape[1] * (shape[0] if kind == "expert" else 1)
            s = fan_in ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(t, std=s, a=-2 * s, b=2 * s, generator=gen)
        else:
            t.fill_(1.0 if kind == "ones" else 0.0)
        full[name] = t
    return full


def params_from_hf_state_dict(sd: dict, cfg: QwenConfig) -> dict[str, torch.Tensor]:
    """An HF ``Qwen2ForCausalLM`` state dict (numpy arrays or tensors) ->
    the full (unsharded) state dict of ``QwenLM(cfg)``, float32 CPU
    tensors. HF names its parameters as the port does under ``model.``
    (and ``lm_head.weight``), with ``nn.Linear``'s (out, in) layout, so
    the map renames and checks every shape against ``qwen_param_specs``;
    the tied head (``tie_word_embeddings``) takes no ``lm_head``. Dense
    models only: Qwen2-MoE's per-expert keys are not mapped, as in JAX."""
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "params_from_hf_state_dict maps dense Qwen2 checkpoints; the MoE key mapping "
            "(cfg.num_experts > 0) is not implemented, as in the JAX package")
    out = {}
    for name, (shape, _) in qwen_param_specs(cfg).items():
        hf = "lm_head.weight" if name == "lm_head" else f"model.{name}"
        if hf not in sd:
            raise KeyError(f"HF state dict has no {hf!r} (for the port's {name!r})")
        t = torch.as_tensor(sd[hf]).to(torch.float32)
        if tuple(t.shape) != shape:
            raise ValueError(f"{hf}: shape {tuple(t.shape)} != the port's {shape}")
        out[name] = t
    return out
