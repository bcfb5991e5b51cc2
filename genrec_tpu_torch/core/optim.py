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

``learning_rate`` is a number or a schedule (``ops/schedules.py``: count
-> rate), which is evaluated, as optax evaluates it, at the update count
before its increment: the first update runs at ``schedule(0)``.
``decay_mask(param) -> bool`` restricts the decoupled decay to the
parameters it accepts (optax ``adamw(mask=...)``; None decays every one).
"""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, decay_mask=None):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay = weight_decay
        self.decay_mask = decay_mask

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
        # Steps write in place into the buffer of the step before: the same
        # operations in the same order, so the same bits (a product with a
        # number stays out of place: in place its bf16 rounding differs on
        # the CPU). The update then holds at most four lists of the
        # parameters' size besides parameters, moments and gradients, not
        # seven.
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(state["mu"], b1))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(state["nu"], b2))
        count = state["count"] + 1
        c = count.to(torch.float32)
        upd = torch._foreach_div(mu, 1 - torch.pow(b1, c))
        denom = torch._foreach_div(nu, 1 - torch.pow(b2, c))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(upd, denom)
        del denom
        if self.weight_decay:
            decayed = [i for i, p in enumerate(params)
                       if self.decay_mask is None or self.decay_mask(p)]
            if decayed:
                torch._foreach_add_([upd[i] for i in decayed], torch._foreach_mul(
                    [params[i] for i in decayed], self.weight_decay))
        lr = self.learning_rate
        if callable(lr):
            lr = lr(state["count"])
        new = torch._foreach_mul(upd, -lr)
        del upd
        torch._foreach_add_(new, params)  # new + params: the bits of params + new
        for old, fresh in ((params, new), (state["mu"], mu), (state["nu"], nu)):
            for o, f in zip(old, fresh):
                o.copy_(torch.where(ok, f, o))
        state["count"] = torch.where(ok, count, state["count"])
