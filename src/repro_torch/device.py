"""Device resolution: the one place a requested device becomes real.

``"cuda"`` is the default everywhere in the port.  When it is asked for and
PyTorch sees no GPU, resolution raises — there is no silent fallback to the
CPU.  The CPU is used only when the caller passes ``"cpu"`` explicitly.
``"meta"`` (shapes and dtypes, no storage) passes through, for stand-ins
such as ``train/step.py``'s abstract parameters and caches.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["Device", "resolve_device"]

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    absent, or if the device type is not ``cuda``, ``cpu`` or ``meta``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
