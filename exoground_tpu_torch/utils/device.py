"""Device selection shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent.

    The port's entry points default to the card; nothing falls back to the
    CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A small host array as a tensor on ``device``: on a card through
    pinned memory and a copy that does not wait for the stream (PyTorch's
    pinned-memory cache keeps the buffer until the copy is done); on the
    CPU as it is."""
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
