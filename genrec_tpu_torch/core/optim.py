"""Adam and AdamW as optax computes them, with an update that a device
predicate can cancel.

The JAX trainers use ``optax.adam`` / ``optax.adamw``; the port keeps
their arithmetic in the same order (moments, bias correction with the
incremented count, ``mu_hat / (sqrt(nu_hat) + eps)``, decoupled decay,
times ``-lr``) so a train step matches the JAX step from the same
gradients. ``update`` keeps parameters and moments unchanged and the
count unincremented where ``ok`` (a 0-d bool tensor on the device) is
False, with no host synchronisation: the non-finite step guard of
``core.harness``. Parameters and moments are updated in place.
"""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: list[torch.Tensor]) -> dict:
        dev = params[0].device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params],
        }

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: dict,
               ok: torch.Tensor) -> None:
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                torch._foreach_mul(state["mu"], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                                torch._foreach_mul(state["nu"], b2))
        count = state["count"] + 1
        c = count.to(torch.float32)
        mu_hat = torch._foreach_div(mu, 1 - torch.pow(b1, c))
        nu_hat = torch._foreach_div(nu, 1 - torch.pow(b2, c))
        upd = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat),
                                                            self.eps))
        if self.weight_decay:
            upd = torch._foreach_add(upd, torch._foreach_mul(params, self.weight_decay))
        new = torch._foreach_add(params, torch._foreach_mul(upd, -self.learning_rate))
        for old, fresh in ((params, new), (state["mu"], mu), (state["nu"], nu)):
            for o, f in zip(old, fresh):
                o.copy_(torch.where(ok, f, o))
        state["count"] = torch.where(ok, count, state["count"])
