"""Where the port's entry points run."""
from __future__ import annotations

import os

import torch


def local_card() -> int:
    """The card of this process: 0, or under an initialized process group
    ``LOCAL_RANK`` (else the rank) modulo the cards present, so on one card
    every rank lands on ``cuda:0`` and on N cards each has its own."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return local % max(1, torch.cuda.device_count())


def resolve_device(device=None) -> torch.device:
    """The card by default (``cuda:0``, or the local rank's card under a
    process group: :func:`local_card`); ``cpu`` only when the caller asks
    for it.

    Raises ``RuntimeError`` when CUDA is asked for (or left as the default)
    and no card is present: the port never carries on on the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", local_card())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
