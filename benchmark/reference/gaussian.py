"""Gaussian blur of side 3, 5 or 7: the binomial taps (the row of Pascal's
triangle, outer product with itself) over a reflect-101 border (OpenCV's
BORDER_REFLECT_101: the edge pixel is not repeated), the sum times one
over the taps' total (a power of two), rounded half to even, clamped to
[0, 255]. A plane is filtered as it is, a colour frame channel by channel.
"""

from __future__ import annotations

import torch


def binomial(size: int) -> list[int]:
    row = [1]
    for _ in range(size - 1):
        row = [a + b for a, b in zip(row + [0], [0] + row)]
    return row


def reflect101(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of an axis of length `n` padded by `pad` on both
    sides in reflect-101, for pads of any width (period 2 (n - 1))."""
    c = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(c)
    period = 2 * (n - 1)
    c = torch.remainder(c, period)
    return torch.where(c >= n, period - c, c)


def make(arg: str | None, dtype: torch.dtype):
    size = int(arg) if arg is not None else 3
    if size not in (3, 5, 7):
        raise ValueError(f"gaussian size must be 3, 5 or 7, got {size}")
    row = binomial(size)
    total = sum(row) ** 2
    o = size // 2

    def plane(p: torch.Tensor) -> torch.Tensor:
        h, w = p.shape
        f = p.to(dtype)
        f = f[reflect101(h, o, p.device)][:, reflect101(w, o, p.device)]
        acc = None
        for dy in range(size):
            for dx in range(size):
                wt = torch.tensor(float(row[dy] * row[dx]), dtype=dtype, device=p.device)
                term = f[dy : dy + h, dx : dx + w] * wt
                acc = term if acc is None else acc + term
        acc = acc * torch.tensor(1.0 / total, dtype=dtype, device=p.device)
        return torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)

    def gaussian(img: torch.Tensor) -> torch.Tensor:
        if img.ndim == 3:
            return torch.stack([plane(img[..., c]) for c in range(img.shape[2])], dim=-1)
        return plane(img)

    return gaussian
