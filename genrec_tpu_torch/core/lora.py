"""LoRA by parameter surgery (port of genrec_tpu/core/lora.py).

``lora_init`` makes low-rank factors (A, B) for every 2-D weight whose
name holds a target; ``lora_merge`` gives the effective weights
W + (alpha / rank) A B. Training optimises ONLY the adapters: the base
stays frozen, so the optimizer state is tiny.

The JAX adapters are keyed by the Flax path of a Dense kernel, stored
(in, out); here they are keyed by the port's parameter name, whose
``weight`` is stored (out, in): A is (in, r) and B (r, out) as in JAX, and
the merge adds (A B)ᵀ. ``LoraAdapters`` holds them as parameters (what a
``TrainState`` trains and a resume point saves), and ``call_merged`` runs
a function of the model under merged weights through
``torch.func.functional_call``: the model's own tensors are never written,
so the base stays bit-unchanged however long it trains.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn


def lora_init(params: Mapping[str, torch.Tensor], generator: torch.Generator, rank: int = 8,
              targets: Sequence[str] = ("q_proj", "v_proj")) -> dict:
    """{name: {"a": (in, r), "b": (r, out)}} for the 2-D ``*.weight``
    parameters whose name holds a target, in ``params`` order: A ~ N(0, 1)
    / rank drawn from ``generator``, B = 0, so the merged model starts
    exactly at the base."""
    out = {}
    for name, w in params.items():
        if w.ndim == 2 and name.endswith("weight") and any(t in name for t in targets):
            d_out, d_in = w.shape
            a = torch.empty((d_in, rank), dtype=w.dtype, device=w.device)
            a.normal_(0.0, 1.0, generator=generator)
            out[name] = {"a": a / rank,
                         "b": torch.zeros((rank, d_out), dtype=w.dtype, device=w.device)}
    return out


def lora_merge(params: Mapping[str, torch.Tensor], lora: Mapping, alpha: float = 16.0,
               rank: int = 8) -> dict:
    """Effective parameters: W + (alpha / rank) (A B)ᵀ at the adapted
    names, the others as they are (no tensor of ``params`` is written)."""
    scale = alpha / rank
    return {name: (w + scale * (lora[name]["a"] @ lora[name]["b"]).T if name in lora else w)
            for name, w in params.items()}


def lora_param_count(lora: Mapping) -> int:
    return sum(int(v["a"].numel() + v["b"].numel()) for v in lora.values())


def _key(name: str) -> str:
    return name.replace(".", "/")  # a module key holds no "."


class LoraAdapters(nn.Module):
    """The adapters of ``lora_init`` as trainable parameters, ``a/<name>``
    and ``b/<name>`` in the state dict (``name`` with "/" for ".")."""

    def __init__(self, lora: Mapping):
        super().__init__()
        self.names = list(lora)
        self.a = nn.ParameterDict({_key(n): nn.Parameter(lora[n]["a"]) for n in self.names})
        self.b = nn.ParameterDict({_key(n): nn.Parameter(lora[n]["b"]) for n in self.names})

    def tree(self) -> dict:
        """{name: {"a", "b"}}, the live parameters (``lora_merge``'s input)."""
        return {n: {"a": self.a[_key(n)], "b": self.b[_key(n)]} for n in self.names}


class _Call(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args, **kwargs):
        return fn(self.model, *args, **kwargs)


def call_merged(model: nn.Module, params: Mapping[str, torch.Tensor], fn, *args, **kwargs):
    """``fn(model, *args, **kwargs)`` with the model's parameters named in
    ``params`` replaced by those tensors for the call (any method of the
    model sees them), through ``torch.func.functional_call``."""
    return torch.func.functional_call(
        _Call(model), {f"model.{k}": v for k, v in params.items()}, (fn, *args), kwargs)
