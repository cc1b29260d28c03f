"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is no card. Entry points never fall back to the CPU: the caller
    asks for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev
