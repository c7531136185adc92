"""The check that decides ``correct``: the sampled outputs of the timed
path against the plain reference (``reference/<op>.py``, found by the op's
name), computed from inputs the check makes again from the seed.

The configuration states float32 arithmetic on u8 frames with every
output byte exact, so the comparison is exact: each number below has the
limit 0.
"""

from __future__ import annotations

import importlib.util
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE_DIR = os.path.join(HERE, "reference")

# what is compared, with its limit (PERF.md, section 2, gives the readings
# it was set from)
LIMITS = {"wrong_bytes": 0}


def parse_spec(spec: str) -> list[tuple[str, str | None]]:
    """'grayscale,contrast:3.5' -> [('grayscale', None), ('contrast', '3.5')]."""
    out = []
    for part in spec.split(","):
        name, _, arg = part.strip().partition(":")
        out.append((name, arg or None))
    return out


def load_op(name: str):
    path = os.path.join(REFERENCE_DIR, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no plain reference for op {name!r} (expected {path})")
    spec = importlib.util.spec_from_file_location(f"bench_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_fn(spec: str, dtype: torch.dtype = torch.float32):
    """The pipeline `spec` as plain ops in `dtype`: one frame in, one out."""
    fns = [load_op(name).make(arg, dtype) for name, arg in parse_spec(spec)]

    def run(img: torch.Tensor) -> torch.Tensor:
        for fn in fns:
            img = fn(img)
        return img

    return run


def reference_entry(spec: str, stack: int, dtype: torch.dtype):
    """The reference put in the program's place: the entry's call form
    (one frame, or a stack of `stack` frames), computed in `dtype`."""
    one = reference_fn(spec, dtype)
    if stack == 1:
        return one
    return lambda st: torch.stack([one(x) for x in st])


def compare(samples, inputs, spec: str, stack: int) -> dict:
    """Compare each sampled output, ``(call, pool index, output)``, with the
    reference over ``inputs[pool index]``, frame by frame. A frame of the
    wrong shape or type, or missing, counts every byte the reference gives
    as wrong, and a frame beyond the stack all of its own. Returns the
    number compared and the outputs that were wrong."""
    ref = reference_fn(spec)
    wrong_bytes = wrong_outputs = 0
    for _call, k, out in samples:
        frames = [inputs[k]] if stack == 1 else list(inputs[k])
        outs = []
        if isinstance(out, torch.Tensor) and out.ndim >= 1:
            outs = [out] if stack == 1 else list(out)
        # frames beyond the stack are wrong whole
        bad = sum(y.numel() for y in outs[len(frames):])
        outs = outs[: len(frames)] + [None] * (len(frames) - len(outs))
        for x, y in zip(frames, outs):
            want = ref(x)
            if y is None or y.shape != want.shape or y.dtype != want.dtype:
                bad += want.numel()
            else:
                bad += int(torch.count_nonzero(y.to(want.device) != want))
        wrong_bytes += bad
        wrong_outputs += int(bad > 0)
    return {"numbers": {"wrong_bytes": wrong_bytes}, "compared": len(samples),
            "wrong_outputs": wrong_outputs}


def verdict(numbers: dict, compared: int) -> bool:
    return compared > 0 and all(numbers[k] <= lim for k, lim in LIMITS.items())
