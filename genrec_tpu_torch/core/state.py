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
