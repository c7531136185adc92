"""The reference program's store of a gray result as a colour frame
(kernel.cu:210, OpenCV's GRAY2BGR): the plane copied into three channels.
An (H, W) u8 plane in, an (H, W, 3) u8 frame out; no arithmetic."""

from __future__ import annotations

import torch


def make(arg: str | None, dtype: torch.dtype):
    if arg is not None:
        raise ValueError(f"gray2rgb takes no argument, got {arg!r}")

    def gray2rgb(img: torch.Tensor) -> torch.Tensor:
        if img.ndim != 2:
            raise ValueError(f"gray2rgb needs an (H, W) plane, got {tuple(img.shape)}")
        return img[..., None].expand(*img.shape, 3).contiguous()

    return gray2rgb
