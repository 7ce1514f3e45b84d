"""Device selection for the port's entry points.

Everything runs on ``cuda`` unless the caller asks for the CPU. Asking for
``cuda`` on a machine without a card raises: nothing continues silently on
the CPU, so a run that reports numbers has run on the device it names."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and
    none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            # name the card, so it compares equal to a tensor's device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
