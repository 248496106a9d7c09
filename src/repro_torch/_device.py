"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device=None`` means ``"cuda"``; with no card present that raises
    instead of running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the card "
                "by default; pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the host")
        return torch.device("cuda")
    return torch.device(device)


def canonical_device(device) -> torch.device:
    """``device`` with its index: ``"cuda"`` is the current card, so that
    two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
