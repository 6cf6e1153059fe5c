"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda:0`` by default; ``cpu`` only when the caller asks for it.

    Raises ``RuntimeError`` when CUDA is asked for (or left as the default)
    and no card is present: the port never carries on on the CPU silently.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda:0")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
