"""Temporal ops — the first cross-frame operators (stream/ video mode).
A copy of the JAX package's ``ops/temporal.py``: host numpy, so both
packages give the same bytes.

Every op elsewhere in ``ops/`` maps one image to one image; video adds
operators whose output at frame t depends on a bounded window of PAST
frames. They are deliberately host-side numpy over uint8 frames: the
per-frame spatial chain still runs through the compiled tile pipeline,
and the temporal combine is a cheap pointwise pass over the bounded
frame-history ring the stream runner maintains (stream/video.py) — the
ring, not the video, bounds memory, which is what makes hour-long
streams a constant-footprint workload.

Golden semantics (deterministic, integer-exact):

  * ``framediff`` — ``|f_t - f_{t-1}|`` per pixel (u8 absolute
    difference, computed in int16 so 255-0 doesn't wrap). Frame 0 has no
    predecessor and diffs against itself: an all-zeros first frame, the
    standard motion-mask convention.
  * ``tdenoise:K`` — temporal box denoise: round-to-nearest-even mean of
    the last K frames (fewer while the ring is still filling). Integer
    sums are exact in int32; the single divide + rint happens in
    float64 on the host, so the result is identical on every platform.

Temporal ops must lead the chain (``framediff,grayscale,gaussian:5``):
they consume raw frames from the ring, and everything after them is the
ordinary spatial pipeline. ``split_temporal`` enforces that."""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TemporalOp:
    """One cross-frame operator.

    ``window`` is the ring capacity the op needs: how many frames of
    history (INCLUDING the current frame) ``fn`` may read. ``fn``
    receives the ring oldest-to-newest — at stream start it is shorter
    than ``window`` and the op must define its warm-up behaviour (both
    ops here do)."""

    name: str
    window: int
    fn: Callable[[Sequence[np.ndarray]], np.ndarray]

    def __call__(self, history: Sequence[np.ndarray]) -> np.ndarray:
        if not history:
            raise ValueError(f"temporal op {self.name!r}: empty history")
        return self.fn(history)


def _framediff(history: Sequence[np.ndarray]) -> np.ndarray:
    cur = history[-1]
    prev = history[-2] if len(history) > 1 else cur
    d = np.abs(cur.astype(np.int16) - prev.astype(np.int16))
    return d.astype(np.uint8)


def make_framediff() -> TemporalOp:
    return TemporalOp("framediff", window=2, fn=_framediff)


def make_tdenoise(k: int) -> TemporalOp:
    if k < 2:
        raise ValueError(f"tdenoise window must be >= 2, got {k}")

    def tdenoise(history: Sequence[np.ndarray]) -> np.ndarray:
        frames = list(history)[-k:]  # history may be a deque (no slicing)
        acc = np.zeros(frames[0].shape, dtype=np.int32)
        for f in frames:
            acc += f
        # exact integer sum, one host-side float64 divide + rint: the
        # same quantizer discipline as the spatial rint_clip ops
        return np.rint(acc / np.float64(len(frames))).astype(np.uint8)

    return TemporalOp(f"tdenoise{k}", window=k, fn=tdenoise)


# name -> factory(arg_str_or_None) — the video-mode counterpart of
# ops.registry.REGISTRY (kept separate: these are invalid in per-image
# pipelines, and Pipeline.parse must keep rejecting them loudly)
TEMPORAL_REGISTRY: dict[str, Callable[[str | None], TemporalOp]] = {
    "framediff": lambda a: make_framediff(),
    "tdenoise": lambda a: make_tdenoise(int(a) if a else 3),
}


def split_temporal(spec: str) -> tuple[tuple[TemporalOp, ...], str]:
    """Split a stream pipeline spec into its leading temporal ops and the
    trailing spatial spec (handed to ``Pipeline.parse``). Temporal ops
    after a spatial op are rejected: the ring holds raw input frames, so
    a mid-chain temporal op would need a second ring of intermediate
    frames per op — out of scope until a workload needs it."""
    temporal: list[TemporalOp] = []
    rest: list[str] = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, _, arg = tok.partition(":")
        factory = TEMPORAL_REGISTRY.get(name.strip().lower())
        if factory is not None:
            if rest:
                raise ValueError(
                    f"temporal op {tok!r} must precede every spatial op "
                    "(the frame ring holds raw inputs; see ops/temporal.py)"
                )
            temporal.append(factory(arg.strip() or None if arg else None))
        else:
            rest.append(tok)
    return tuple(temporal), ",".join(rest)
