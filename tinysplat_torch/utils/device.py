"""Device resolution for the port's entry points, the card's name, and
stage timing."""
from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Iterator, Optional

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


def gpu_name_and_limit() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (a card
    set below its maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(timings: Optional[dict], name: str, device) -> Iterator[None]:
    """Add the seconds of the enclosed stage to ``timings[name]``, the
    device synchronized at its end; does nothing when ``timings`` is None."""
    if timings is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    synchronize(device)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """float32 matmuls and cuDNN convolutions without TF32 inside the block
    (the JAX package runs at matmul precision "highest"); the flags found
    are restored on the way out."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
