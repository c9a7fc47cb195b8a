"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device;
without a GPU the default raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None,
                   cpu_hint: str = 'device="cpu"') -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.

    Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and no GPU is available; the message tells the caller to
    pass ``cpu_hint``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA is not available; pass {cpu_hint} to run the port on "
            f"the CPU")
    return dev


def cli_device(arg: str) -> torch.device:
    """``resolve_device`` for a script's ``--device`` flag: without a
    GPU the default raises a RuntimeError that names the flag."""
    return resolve_device(arg, cpu_hint="--device cpu")


def on_card(device: Optional[torch.device]) -> bool:
    """True for a CUDA device: there every predicate mask the kernels
    can express comes from a kernel, and a kernel failure surfaces."""
    return device is not None and device.type == "cuda"


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
