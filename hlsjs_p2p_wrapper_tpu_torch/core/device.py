"""The port's device policy: entry points run on the card unless the
caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without one, raise and say how to ask
    for the CPU; never fall back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device=\"cpu\" to run the plain PyTorch path on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
