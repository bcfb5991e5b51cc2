"""Train state (port of genrec_tpu/core/state.py): the model's
parameters, the optimizer and its state, the step, the non-finite streak
and the generator that draws dropout bits.

``step`` counts applied optimizer updates (the non-finite guard in
``core.harness`` skips the update and the increment on a NaN/Inf batch);
``nonfinite_count`` is the streak of consecutive skipped steps. Both are
0-d int32 tensors on the model's device, so the guard never waits for the
device. The JAX state's per-step key split becomes one
``torch.Generator`` on the device that advances with every draw (the
TPU-only ``fast_step_rng`` has no counterpart). The step function
updates the state in place.

``as_tree`` is the state as a checkpoint sees it: the model's state dict
(buffers included), every optimizer tensor (per-parameter lists keyed by
parameter name), ``step``, ``nonfinite_count`` and the generator's state
bytes (its seed and offset on the card: dropout draws from it, so a
resumed run draws what the uninterrupted one drew). ``load_tree`` copies
such a tree back into the live state, on its devices.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from genrec_tpu_torch.core.optim import Adam


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: dict
    step: torch.Tensor
    nonfinite_count: torch.Tensor
    generator: torch.Generator

    @classmethod
    def create(cls, model: nn.Module, optimizer: Adam, seed: int) -> "TrainState":
        params = list(model.parameters())
        dev = params[0].device
        return cls(
            model=model,
            opt_state=optimizer.init(params),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            nonfinite_count=torch.zeros((), dtype=torch.int32, device=dev),
            generator=torch.Generator(device=dev).manual_seed(seed),
        )

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    def as_tree(self) -> dict:
        """The whole state as a nested mapping of tensors (live tensors,
        not copies; the generator state is a CPU uint8 tensor)."""
        names = [n for n, _ in self.model.named_parameters()]
        opt = {k: (dict(zip(names, v, strict=True)) if isinstance(v, list) else v)
               for k, v in self.opt_state.items()}
        return {"model": self.model.state_dict(), "opt": opt, "step": self.step,
                "nonfinite_count": self.nonfinite_count,
                "generator": self.generator.get_state()}

    @torch.no_grad()
    def load_tree(self, tree: dict) -> "TrainState":
        """Copy ``tree`` (laid out as `as_tree`) into this state in place:
        parameters and moments keep their tensors (the optimizer holds
        them), scalars land on their devices, the generator takes the
        saved state. Returns self."""
        self.model.load_state_dict(tree["model"])
        names = [n for n, _ in self.model.named_parameters()]
        for k, v in self.opt_state.items():
            if isinstance(v, list):
                for t, n in zip(v, names, strict=True):
                    t.copy_(tree["opt"][k][n])
            else:
                self.opt_state[k] = tree["opt"][k].to(v.device)
        self.step = tree["step"].to(self.step.device)
        self.nonfinite_count = tree["nonfinite_count"].to(self.nonfinite_count.device)
        self.generator.set_state(tree["generator"].to("cpu"))
        return self
