"""Shape buckets + stack padding — shared by the serving scheduler and the
batch CLI.

A jitted executable is keyed on its input shapes, so an online service that
compiled one executable per request shape would trace on every novel image.
Instead requests are padded *up* to a small configured set of (rows, cols)
buckets and the batch dimension is padded up to a small set of batch sizes,
so the whole reachable shape space is a finite grid that `serve/cache.py`
pre-compiles at startup. `serve/padded.py` makes the padding bit-invisible.

The same helpers serve `cli.py:cmd_batch`: a mid-stream partial stack (shape
change flush) pads to the compiled stack size with `pad_stack` so the shape's
executable is reused, while the trailing partial stack ships right-sized
(one extra compile beats discarding the pad's compute at the tail).
"""

from __future__ import annotations

import numpy as np

# Default row/col bucket sizes (each bucket is square unless the spec says
# RxC): covers thumbnails through 4K-ish rows; `serve --buckets` overrides.
DEFAULT_BUCKETS = ((512, 512), (1024, 1024), (2048, 2048), (4096, 4096))


def parse_buckets(spec: str) -> tuple[tuple[int, int], ...]:
    """Parse a CLI bucket spec: 'N' entries are square NxN buckets, 'RxC'
    entries are explicit. '512,1024x2048' -> ((512, 512), (1024, 2048)),
    sorted by area so `pick_bucket` prefers the cheapest fit."""
    out: list[tuple[int, int]] = []
    for tok in spec.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        try:
            if "x" in tok:
                r, _, c = tok.partition("x")
                bh, bw = int(r), int(c)
            else:
                bh = bw = int(tok)
        except ValueError:
            raise ValueError(
                f"invalid bucket {tok!r}: expected N (square) or RxC"
            ) from None
        if bh < 1 or bw < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {tok!r}")
        out.append((bh, bw))
    if not out:
        raise ValueError(f"empty bucket spec {spec!r}")
    return tuple(sorted(set(out), key=lambda b: (b[0] * b[1], b)))


def pick_bucket(
    height: int, width: int, buckets: tuple[tuple[int, int], ...]
) -> tuple[int, int] | None:
    """The smallest-area bucket that fits (height, width), or None when the
    image exceeds every bucket (the caller sheds with a 'too large' status
    instead of compiling an unbounded shape)."""
    for bh, bw in buckets:  # sorted by area in parse_buckets
        if height <= bh and width <= bw:
            return (bh, bw)
    return None


def batch_buckets(max_batch: int, shards: int = 1) -> tuple[int, ...]:
    """The compiled batch sizes: shards * powers of two up to max_batch,
    plus max_batch itself. Every entry is a multiple of `shards` so the
    data-parallel sharding over the mesh's batch axis always divides."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if max_batch % shards:
        raise ValueError(
            f"max_batch ({max_batch}) must be a multiple of shards ({shards})"
        )
    sizes = set()
    n = shards
    while n < max_batch:
        sizes.add(n)
        n *= 2
    sizes.add(max_batch)
    return tuple(sorted(sizes))


def pick_batch_bucket(n: int, buckets: tuple[int, ...]) -> int:
    """The smallest compiled batch size >= n (buckets sorted ascending)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest compiled size {buckets[-1]}")


def pad_to_bucket(img: np.ndarray, bucket_h: int, bucket_w: int) -> np.ndarray:
    """Zero-pad an image at the bottom/right up to the bucket shape. The
    pad content is arbitrary by design: serve/padded.py reconstructs each
    op's true border extension from the true shape, so padded outputs are
    bit-identical to the unpadded run and the pad region is never read."""
    h, w = img.shape[:2]
    if h > bucket_h or w > bucket_w:
        raise ValueError(
            f"image {img.shape} exceeds bucket ({bucket_h}, {bucket_w})"
        )
    if (h, w) == (bucket_h, bucket_w):
        return img
    pad = [(0, bucket_h - h), (0, bucket_w - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad)


def pad_stack(imgs: list[np.ndarray], n_target: int) -> np.ndarray:
    """Stack same-shape images, padding to `n_target` by repeating the last
    image so every dispatch reuses one compiled batch shape (a ragged batch
    would force a recompile — the very overhead stacking amortises). The
    caller drops the padded outputs (it knows its own real count)."""
    if not imgs:
        raise ValueError("pad_stack needs at least one image")
    if len(imgs) > n_target:
        raise ValueError(f"{len(imgs)} images exceed the target stack {n_target}")
    imgs = list(imgs) + [imgs[-1]] * (n_target - len(imgs))
    return np.stack(imgs, axis=0)
