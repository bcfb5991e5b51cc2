"""Weights carried across from the JAX package.

``tiger_params_from_flax``, ``hstu_params_from_flax``,
``sasrec_params_from_flax``, ``rqvae_params_from_flax``,
``cobra_params_from_flax``, ``qwen_params_from_flax`` and
``notellm_params_from_flax`` map a Flax param tree (nested dicts of numpy
arrays, as ``jax.device_get(params)`` gives it) onto the state dict of the
port's ``Tiger``, ``HSTU``, ``SASRec``, ``RqVae``, ``Cobra``, ``QwenLM`` and
``NoteLLM``, and ``lora_from_flax`` maps JAX LoRA adapters onto the port's
(``core.lora``), so
both packages compute the same function from the same weights. The names
follow the Flax module names one for one, with these rewrites:

- ``layer_<i>`` (Flax list submodules) -> ``layers.<i>`` (``nn.ModuleList``);
  SASRec's ``block_<i>`` -> ``blocks.<i>``;
- ``<dense>/kernel`` (Flax ``nn.Dense``, stored ``(in, out)``) ->
  ``<dense>.weight`` (``nn.Linear``, stored ``(out, in)``), transposed;
- HSTU, SASRec and COBRA: ``<norm>/scale`` (Flax ``nn.LayerNorm``) ->
  ``<norm>.weight``;
- Qwen only: ``embed_tokens`` (a raw Flax param) -> ``embed_tokens.weight``;
- every other leaf keeps its name and storage (TIGER's ``rel_bias`` its
  ``(H * buckets, 1)``, HSTU's bias tables their ``(buckets, H)``).
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = (*prefix, str(key))
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, val


def _torch_name(path: tuple[str, ...], renames: dict[str, str]) -> tuple[str, bool]:
    """(state-dict name, whether the leaf is a transposed Dense kernel)."""
    parts = [re.sub(r"^layer_(\d+)$", r"layers.\1", p) for p in path]
    if parts[-1] == "kernel":
        return ".".join([*parts[:-1], "weight"]), True
    return ".".join([*parts[:-1], renames.get(parts[-1], parts[-1])]), False


def tiger_params_from_flax(params_np, model=None) -> dict[str, torch.Tensor]:
    """Flax TIGER params -> the port's state dict (CPU float tensors).

    Every Flax leaf is consumed exactly once. With ``model`` given, the
    result must also fill every parameter of ``model`` at its shape; both
    are asserted, so a renamed or reshaped parameter fails loudly here
    instead of loading silently wrong."""
    return _params_from_flax(params_np, model, {})


def hstu_params_from_flax(params_np, model=None) -> dict[str, torch.Tensor]:
    """Flax HSTU params (``HSTU.init(...)["params"]``) -> the port's
    ``HSTU`` state dict, with the same two checks as
    ``tiger_params_from_flax``."""
    return _params_from_flax(params_np, model, {"scale": "weight"})


def sasrec_params_from_flax(params_np, model=None) -> dict[str, torch.Tensor]:
    """Flax SASRec params (``SASRec.init(...)["params"]``) -> the port's
    ``SASRec`` state dict, with the same two checks as
    ``tiger_params_from_flax``."""
    tree = {re.sub(r"^block_(\d+)$", r"blocks.\1", str(k)): v for k, v in params_np.items()}
    return _params_from_flax(tree, model, {"scale": "weight"})


def rqvae_params_from_flax(params_np, model=None) -> dict[str, torch.Tensor]:
    """Flax RQ-VAE params (``RqVae.init(...)["params"]``) -> the port's
    ``RqVae`` state dict (``encoder.dense_<i>``, ``decoder.dense_<i>``,
    ``quantize_<i>.codebook`` and ``.out_proj``), with the same two checks
    as ``tiger_params_from_flax``."""
    return _params_from_flax(params_np, model, {})


def cobra_params_from_flax(params_np, model=None) -> dict[str, torch.Tensor]:
    """Flax COBRA params (``Cobra.init(...)["params"]``) -> the port's
    ``Cobra`` state dict (raw tables such as ``encoder.embedding`` and
    ``cobra_emb.id_embed`` keep their names; ``sparse_head_<c>`` stay
    top-level ``nn.Linear``s), with the same two checks as
    ``tiger_params_from_flax``."""
    return _params_from_flax(params_np, model, {"scale": "weight"})


def _params_from_flax(params_np, model, renames) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params_np):
        name, is_kernel = _torch_name(path, renames)
        arr = np.array(leaf)  # a copy: jax buffers are read-only
        if is_kernel:
            arr = arr.T
        if name in out:
            raise AssertionError(f"two Flax leaves map to {name}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    if model is not None:
        want = {n: tuple(p.shape) for n, p in model.state_dict().items()}
        unfilled = sorted(set(want) - set(out))
        unused = sorted(set(out) - set(want))
        assert not unfilled, f"port parameters with no Flax leaf: {unfilled}"
        assert not unused, f"Flax leaves with no port parameter: {unused}"
        bad = {n: (tuple(t.shape), want[n]) for n, t in out.items()
               if tuple(t.shape) != want[n]}
        assert not bad, f"shape mismatches (flax -> port, port): {bad}"
    return out


def qwen_params_from_flax(params_np, cfg, rank: int = 0, tp: int = 1) -> dict[str, torch.Tensor]:
    """Flax ``QwenLM`` params -> rank ``rank``'s shard of the port's
    ``QwenLM`` state dict at tensor_parallel ``tp`` (CPU float tensors).

    Every Flax leaf is consumed exactly once and every parameter of
    ``QwenLM(cfg)`` is filled at its full shape before the shard is cut
    (``parallel.shardings.shard_qwen_params``); both are asserted."""
    from genrec_tpu_torch.models.backbones.qwen import qwen_param_specs
    from genrec_tpu_torch.parallel.shardings import shard_qwen_params

    full = _params_from_flax(params_np, None, {"embed_tokens": "embed_tokens.weight"})
    want = {n: shape for n, (shape, _) in qwen_param_specs(cfg).items()}
    unfilled = sorted(set(want) - set(full))
    unused = sorted(set(full) - set(want))
    assert not unfilled, f"port parameters with no Flax leaf: {unfilled}"
    assert not unused, f"Flax leaves with no port parameter: {unused}"
    bad = {n: (tuple(t.shape), want[n]) for n, t in full.items() if tuple(t.shape) != want[n]}
    assert not bad, f"shape mismatches (flax -> port, port): {bad}"
    return shard_qwen_params(full, rank, tp)


def notellm_params_from_flax(params_np, cfg) -> dict[str, torch.Tensor]:
    """The JAX NoteLLM trainer's params ``{"backbone": Flax QwenLM params,
    "tau": ()}`` -> the port's ``NoteLLM`` state dict: ``backbone.<name>``
    through ``qwen_params_from_flax`` (every leaf consumed, every parameter
    filled, both asserted) and the fp32 scalar ``tau``."""
    extra = sorted(set(params_np) - {"backbone", "tau"})
    assert not extra, f"NoteLLM leaves with no port parameter: {extra}"
    out = {f"backbone.{k}": v for k, v in qwen_params_from_flax(params_np["backbone"], cfg).items()}
    out["tau"] = torch.tensor(np.asarray(params_np["tau"], np.float32))
    assert out["tau"].ndim == 0, f"tau must be a scalar, got shape {tuple(out['tau'].shape)}"
    return out


def lora_from_flax(lora_np, cfg) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``core.lora`` adapters ``{"<flax path>/kernel": {"a": (in, r),
    "b": (r, out)}}`` -> the port's ``{"<name>.weight": {"a", "b"}}`` over
    ``QwenLM(cfg)``'s parameters (A and B keep their layout; the port's
    merge adds (A B)ᵀ to its (out, in) weight). Every adapter and factor is
    consumed once and fits its weight's shape; both are asserted."""
    from genrec_tpu_torch.models.backbones.qwen import qwen_param_specs

    specs = qwen_param_specs(cfg)
    out: dict[str, dict[str, torch.Tensor]] = {}
    for path, factors in lora_np.items():
        name, is_kernel = _torch_name(tuple(str(path).split("/")), {})
        assert is_kernel and name in specs, f"LoRA adapter {path} names no port Dense weight"
        assert name not in out, f"two LoRA adapters map to {name}"
        assert set(factors) == {"a", "b"}, f"{path}: factors {sorted(factors)}, want a and b"
        a, b = (torch.from_numpy(np.array(factors[k])) for k in ("a", "b"))
        d_out, d_in = specs[name][0]
        assert a.shape[0] == d_in and b.shape[1] == d_out and a.shape[1] == b.shape[0], \
            f"{path}: a {tuple(a.shape)}, b {tuple(b.shape)} against weight {(d_out, d_in)}"
        out[name] = {"a": a, "b": b}
    return out
