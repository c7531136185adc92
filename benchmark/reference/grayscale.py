"""Grayscale of the reference program (kernel.cu:39-42): each weighted
channel is truncated on its own, then the three are summed.

    gray = floor(0.3 R) + floor(0.59 G) + floor(0.11 B)

An (H, W, 3) u8 frame in, an (H, W) u8 plane out. Every step is computed
in `dtype`: float32 is the stated arithmetic, a lower type is the control.
"""

from __future__ import annotations

import torch

WEIGHTS = (0.3, 0.59, 0.11)


def make(arg: str | None, dtype: torch.dtype):
    if arg is not None:
        raise ValueError(f"grayscale takes no argument, got {arg!r}")

    def grayscale(img: torch.Tensor) -> torch.Tensor:
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"grayscale needs an (H, W, 3) frame, got {tuple(img.shape)}")
        f = img.to(dtype)
        acc = None
        for c, w in enumerate(WEIGHTS):
            term = torch.floor(f[..., c] * torch.tensor(w, dtype=dtype, device=img.device))
            acc = term if acc is None else acc + term
        return torch.clamp(acc, 0, 255).to(torch.uint8)

    return grayscale
