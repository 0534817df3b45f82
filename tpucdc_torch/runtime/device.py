"""Device selection: the card by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a torch.device; raise if it names an absent card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return device
