"""Device resolution for the port's entry points.

Every entry point takes ``device="cuda"`` by default and resolves it here:
a CUDA request without a CUDA device raises instead of moving to the CPU,
so a run that was meant for the card can never quietly measure the host.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent. A bare ``"cuda"`` resolves to the current card's index, so two
    resolutions of the same card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
