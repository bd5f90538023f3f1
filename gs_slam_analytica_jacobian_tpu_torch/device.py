"""Device resolution for the port's entry points.

``device=None`` means ``"cuda"``. A CUDA request on a machine without a
GPU raises: nothing falls back to the CPU unless the caller asks for it.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device=%r needs CUDA but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions" % (
                "cuda" if device is None else str(device)))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def require_on(device: torch.device, **tensors) -> None:
    """Raise unless every named tensor lies on ``device``."""
    for name, x in tensors.items():
        if x is not None and x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")


def card_line() -> str:
    """The GPU's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (the first
    GPU's line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]

