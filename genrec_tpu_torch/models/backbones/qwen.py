"""Qwen2-class decoder-only backbone (port of
genrec_tpu/models/backbones/qwen.py): RMSNorm -> GQA attention with
half-rotation RoPE (q/k/v biased, o bias-free) -> SwiGLU MLP, pre-norm
residuals, an optional tied LM head, and the static KV cache of decode.

Every module takes a tensor-parallel group (``parallel.mesh.TPGroup``) or
None. With a group of tp ranks the Megatron layers of
``parallel/shardings.py`` hold this rank's shard: H / tp query heads and
KV / tp KV heads in contiguous blocks, FFN / tp hidden units, V / tp
vocab rows; the residual stream and the hidden states stay replicated.

Parameters are fp32 and cast to ``dtype`` at use; norms compute in
fp32. Attention is plain torch, as the JAX package computes it outside
any kernel: fp32 scores, an additive -1e9 bias kept inside the softmax.
The decode cache is written in place at its index (the JAX
``dynamic_update_slice`` returns a new array).

Not ported: the mixture of experts (``QwenMoEMLP``; ROADMAP A14), ring
attention (sequence parallelism; A15), the pipeline stage body (A16) and
``params_from_hf_state_dict`` (A18); ``num_experts > 0`` raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.layers import RMSNorm
from genrec_tpu_torch.parallel.shardings import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    copy_to_tp,
    gather_from_tp,
    shard_count,
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
        tp = tp_size(group)
        H, KV, hd, d = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                        cfg.hidden_size)
        if KV % tp:
            raise NotImplementedError(
                f"tensor_parallel={tp} must divide num_key_value_heads={KV} (each rank holds "
                "whole KV heads); ROADMAP A20 lifts it")
        self.heads = shard_count(H, tp, "num_attention_heads")
        self.kv_heads = KV // tp
        self.cfg, self.dtype = cfg, dtype
        self.q_proj = ColumnParallelLinear(d, H * hd, True, group, device)
        self.k_proj = ColumnParallelLinear(d, KV * hd, True, group, device)
        self.v_proj = ColumnParallelLinear(d, KV * hd, True, group, device)
        self.o_proj = RowParallelLinear(H * hd, d, group, device)

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
        rep = self.heads // self.kv_heads
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
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


class QwenBlock(nn.Module):
    def __init__(self, cfg: QwenConfig, dtype, group, device):
        super().__init__()
        self.dtype, self.group = dtype, group
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device)
        self.self_attn = QwenAttention(cfg, dtype, group, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                device=device)
        self.mlp = QwenMLP(cfg, group, device)

    def forward(self, x, positions, attn_bias, cache=None):
        h = copy_to_tp(self.input_layernorm(x).to(self.dtype), self.group)
        h, new_cache = self.self_attn(h, positions, attn_bias, cache)
        x = x + h
        h = copy_to_tp(self.post_attention_layernorm(x).to(self.dtype), self.group)
        return x + self.mlp(h), new_cache


class QwenLM(nn.Module):
    """The backbone and its LM head. ``group`` None is the whole model on
    one device; a ``TPGroup`` makes this module the rank's shard.
    Parameters start at zero: load a state dict (``qwen_init_params`` +
    ``parallel.shardings.shard_qwen_params``, or ``convert.
    qwen_params_from_flax``). ``remat`` recomputes each block's
    activations in the backward pass (JAX ``nn.remat``; the block's
    collectives are issued again, in the same order on every rank)."""

    def __init__(self, cfg: QwenConfig, dtype=torch.float32, group=None, device="cuda",
                 remat: bool = False):
        super().__init__()
        if cfg.num_experts > 0:
            raise NotImplementedError(
                "num_experts > 0 (QwenMoEMLP, expert parallelism) is not ported; "
                "ROADMAP A14 ports it")
        device = resolve_device(device)
        self.cfg, self.dtype, self.group, self.remat = cfg, dtype, group, remat
        self.embed_tokens = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size, group,
                                                   device)
        self.layers = nn.ModuleList(
            QwenBlock(cfg, dtype, group, device) for _ in range(cfg.num_hidden_layers))
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
                return_hidden: bool = False, compute_logits: bool = True):
        """Full-sequence forward; attention_mask (B, L), 1 = valid.
        ``compute_logits=False`` skips the head (logits None)."""
        B, L = input_ids.shape
        if positions is None:
            positions = torch.arange(L, device=input_ids.device).expand(B, L)
        bias = causal_pad_bias(L, attention_mask, device=input_ids.device)
        x = self.embed_tokens(input_ids).to(self.dtype)
        for block in self.layers:
            if self.remat and torch.is_grad_enabled():
                x, _ = torch.utils.checkpoint.checkpoint(block, x, positions, bias,
                                                         use_reentrant=False)
            else:
                x, _ = block(x, positions, bias)
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
        pad_mask (B, S), 1 = a valid slot after this step's write. Returns
        (logits at the last position (B, V), new caches)."""
        L = input_ids.shape[1]
        S = caches[0]["k"].shape[1]
        dev = input_ids.device
        slot = torch.arange(S, device=dev)[None, None, None, :]
        write_pos = caches[0]["idx"] + torch.arange(L, device=dev)
        bias = (torch.where(slot > write_pos[None, None, :, None], -1e9, 0.0)
                + torch.where(pad_mask[:, None, None, :] == 0, -1e9, 0.0))
        x = self.embed_tokens(input_ids).to(self.dtype)
        new_caches = []
        for block, cache in zip(self.layers, caches):
            x, nc = block(x, positions, bias, cache)
            new_caches.append(nc)
        h = self.norm(x).to(self.dtype)
        return self.head(h[:, -1:, :])[:, 0], new_caches


def qwen_param_specs(cfg: QwenConfig) -> dict:
    """name -> (full shape, initialiser) of every parameter of
    ``QwenLM(cfg)``: "embed" N(0, 0.02), "dense" lecun-normal (a normal
    cut at +-2 std, std fan_in^-1/2, Flax's ``lecun_normal``), "zeros",
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
        elif kind == "dense":
            s = shape[1] ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(t, std=s, a=-2 * s, b=2 * s, generator=gen)
        else:
            t.fill_(1.0 if kind == "ones" else 0.0)
        full[name] = t
    return full
