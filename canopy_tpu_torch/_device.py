"""The analysis device: always named by the caller, never guessed."""

from __future__ import annotations

import torch

from .errors import Error

__all__ = ["DeviceError", "resolve_device"]


class DeviceError(Error):
    """The requested device does not exist on this machine."""


def resolve_device(device: str | torch.device) -> torch.device:
    """``"cpu"``/``"cuda"``/``torch.device`` -> a checked ``torch.device``.

    Asking for CUDA on a machine without a usable card raises; there is
    no silent move to the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError("device 'cuda' requested but torch finds no "
                          "CUDA device (torch.cuda.is_available() is "
                          "False)")
    if device.type not in ("cpu", "cuda"):
        raise DeviceError(f"unsupported device '{device}' (cpu or cuda)")
    return device
