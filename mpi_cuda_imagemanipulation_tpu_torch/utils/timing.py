"""Timing: sample percentiles, and device time by CUDA events.

Device time is never taken with a host clock around an unsynchronised
call: PyTorch returns before the card finishes.
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Iterable, Sequence

import torch


def percentiles(
    samples: Iterable[float], qs: Sequence[float] = (50, 95, 99)
) -> dict[float, float]:
    """Percentiles of `samples` by sorted-rank linear interpolation (numpy's
    default 'linear' method), as a {q: value} dict. Raises on no samples."""
    xs = sorted(samples)
    if not xs:
        raise ValueError("percentiles() needs at least one sample")
    out: dict[float, float] = {}
    for q in qs:
        if not 0 <= q <= 100:
            raise ValueError(f"percentile out of range [0, 100]: {q}")
        rank = (len(xs) - 1) * (q / 100.0)
        lo = math.floor(rank)
        hi = math.ceil(rank)
        out[q] = xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)
    return out


def device_time_ms(
    fn: Callable[[], object], *, warmup: int = 3, reps: int = 10, inner: int = 10
) -> float:
    """Milliseconds of device time per call of `fn`: after `warmup` calls,
    the median over `reps` samples, each a pair of CUDA events around
    `inner` calls enqueued back to back (so that host-side launch work
    overlaps the device's and is not counted as device time)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)
