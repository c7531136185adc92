"""Device selection: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device` as a torch.device (default: CUDA). Raises when CUDA is asked
    for and not available: nothing silently runs on the CPU instead."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def as_image_tensor(img, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous uint8 tensor on `device`."""
    t = torch.as_tensor(img)
    if t.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 image, got {t.dtype}")
    return t.to(device).contiguous()
