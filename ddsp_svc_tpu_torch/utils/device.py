"""Device resolution: entry points run on the card unless told otherwise."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card. Without a card that raises: the port
    never falls back to the CPU on its own; pass ``device="cpu"`` for that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
