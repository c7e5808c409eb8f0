"""Device selection: entry points run on the card unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device`` for ``device``; asking for CUDA without a card
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
