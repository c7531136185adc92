"""Device selection: CUDA unless the caller asks for the CPU; and the
per-shape build cache of the built functions."""

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


# shapes a built function keeps its per-shape builds for before it starts over
_PER_SHAPE_LIMIT = 64


def per_shape(build, key=lambda img: img.shape):
    """A function img -> build(img)(img) that calls `build` once per image
    shape (the routing decisions that read the environment, the platform or
    the calibration store) and reuses its result after: one dict lookup a
    call. `key` names the shape (a stack's: its images', not their
    count)."""
    built: dict = {}

    def run(img):
        k = key(img)
        fn = built.get(k)
        if fn is None:
            if len(built) >= _PER_SHAPE_LIMIT:
                built.clear()
            fn = built[k] = build(img)
        return fn(img)

    return run
