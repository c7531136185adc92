"""The least time a frame can take on the card, from the configuration's
shapes alone.

An image pipeline is bound by memory: its arithmetic is a few operations
a byte. The least bytes a frame needs are its u8 input read once and its
u8 output written once, whatever the route does in between (an
intermediate plane, a reread halo row, a second launch) and whichever
kernels implement it. Over the H100 SXM's published HBM3 rate of 3.35
TB/s (NVIDIA's data sheet, at the full 700 W limit) that is the frame's
bound.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3350e9


def least_bytes(config: dict) -> int:
    """u8 input read once plus u8 output written once, for one frame."""
    pixels = config["height"] * config["width"]
    return pixels * (config["channels"] + config["out_channels"])


def least_seconds(config: dict) -> float:
    return least_bytes(config) / PEAK_BYTES_PER_S
