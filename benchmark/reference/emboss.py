"""Emboss of the reference program (kernel.cu:66-91), with its guard.

The taps (kernel.cu:71-82; both matrices are symmetric, so the source's
transposed indexing changes nothing):

    3: [[-2, -1, 0], [-1, 1, 1], [0, 1, 2]]
    5: diag(4, 4, 1, -4, -4)

A pixel is filtered only where the guard of kernel.cu:83 holds,
``o < x <= W - 1 - o`` and likewise in y (o the half size); every other
pixel keeps its input. The sum is truncated after a clamp to [0, 255], as
C assigns a clamped float to an unsigned char. The input is read whole
before any pixel is written. A plane is filtered as it is, a colour frame
channel by channel.
"""

from __future__ import annotations

import torch

TAPS = {
    3: ((-2, -1, 0), (-1, 1, 1), (0, 1, 2)),
    5: tuple(tuple(v if i == j else 0 for j in range(5))
             for i, v in enumerate((4, 4, 1, -4, -4))),
}


def make(arg: str | None, dtype: torch.dtype):
    size = int(arg) if arg is not None else 3
    if size not in TAPS:
        raise ValueError(f"emboss size must be 3 or 5, got {size}")
    taps = TAPS[size]
    o = size // 2

    def plane(p: torch.Tensor) -> torch.Tensor:
        h, w = p.shape
        out = p.clone()
        if h <= 2 * o + 1 or w <= 2 * o + 1:
            return out  # the guard leaves no pixel to filter
        f = p.to(dtype)
        acc = None
        for dy in range(size):
            for dx in range(size):
                wt = taps[dy][dx]
                if wt == 0:
                    continue
                win = f[dy : h - 2 * o + dy, dx : w - 2 * o + dx]
                term = win * torch.tensor(float(wt), dtype=dtype, device=p.device)
                acc = term if acc is None else acc + term
        q = torch.floor(torch.clamp(acc, 0, 255)).to(torch.uint8)
        # acc[i, j] is the pixel (o + i, o + j); the guard starts one further in
        out[o + 1 : h - o, o + 1 : w - o] = q[1:, 1:]
        return out

    def emboss(img: torch.Tensor) -> torch.Tensor:
        if img.ndim == 3:
            return torch.stack([plane(img[..., c]) for c in range(img.shape[2])], dim=-1)
        return plane(img)

    return emboss
