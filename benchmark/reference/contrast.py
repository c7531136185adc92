"""Contrast of the reference program (kernel.cu:49-58):

    out = trunc(clamp(f * (p - 128) + 128, 0, 255))

each product and sum rounded to `dtype` on its own. Any shape of u8 in,
the same shape out.
"""

from __future__ import annotations

import torch


def make(arg: str | None, dtype: torch.dtype):
    if arg is None:
        raise ValueError("contrast needs a factor, as in contrast:3.5")
    factor = float(arg)

    def contrast(img: torch.Tensor) -> torch.Tensor:
        f = torch.tensor(factor, dtype=dtype, device=img.device)
        mid = torch.tensor(128.0, dtype=dtype, device=img.device)
        v = f * (img.to(dtype) - mid) + mid
        return torch.floor(torch.clamp(v, 0, 255)).to(torch.uint8)

    return contrast
