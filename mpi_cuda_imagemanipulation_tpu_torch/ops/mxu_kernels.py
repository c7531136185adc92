"""The tensor-core route: stencils as banded matrix products. The counterpart
of the JAX package's ``ops/mxu_kernels.py`` (its "MXU" is the TPU's matrix
unit; here it is the H100's tensor cores).

Two parts:

* **The whole-op route** (``backend='mxu'``, `pipeline_mxu`): an eligible
  stencil over a pre-extended tile as blocked banded products, ``out[:,
  B*j + n] = sum_k x[:, B*j + n + k] * t[k]``: with block width B = 128,
  the block ``x[:, B*j : B*j + B + 2h]`` times the banded matrix ``C[n + i,
  n] = t[i]`` of shape (B + 2h, B). The JAX package leaves these products to
  XLA; the port leaves them to ``torch.matmul``. Separable ops take a row
  pass and a column pass; the other correlations contract their kh
  row-shifted views in one product; erode and dilate go through the
  threshold decomposition (below). Every op that is not an eligible
  stencil runs through the K1/K2 group runner (ops/cuda_kernels.py),
  byte-equal to its golden op.
* **The in-stage arm K5** (`stage_arm_for`, `stage_valid_mxu_plain`): the
  same contraction at each stencil's contraction point inside the fused
  stage megakernel K4/K4g, in one of two forms: bf16 operands with float32
  accumulation (arm ``'mxu'``) or ``x - 128`` and the taps as int8 with
  int32 accumulation and ``+128 * sum(w)`` added back in float32 (arm
  ``'mxu-int8'``). On the card it is hand-written ``mma.sync`` code
  (ops/csrc/mma_stage.cuh) inside K4/K4g; `stage_valid_mxu_plain` here is
  its plain version.

**Exactness.** u8 values and every eligible tap are integers that bf16
holds exactly; every product and every partial sum is an integer below
``255 * sum|w| < 2^24`` (`_int_kernels_ok`), so a float32 sum of them is
exact in any order; the int8 form's int32 sums stay below 2^23, and
`mxu_int8_ok` proves its operand bound ``|w| <= 127``. The magnitude
combine and the scale then replay the golden float ops of
``spec.StencilOp.valid`` on the exact sums, and the golden finalize does
the rest, so the bytes are golden by construction. On the card this holds
only if the tensor cores keep 24 bits in their float32 sums; chip_smoke.py
holds K5 against its plain version at the inputs where the sums are
largest.

**Plain versions compute in float32.** ``torch.matmul`` of bf16 operands
returns bf16, which rounds a sum above 256 to 8 significant bits, and TF32
keeps 10: both break exactness. Every product here takes float32 operands
(exact: integers below 2^24) with TF32 off for the call (`_f32_matmuls`).
So the column variants ``'bf16split'`` (the JAX package's 64a+b split,
which exists to keep bf16 operands exact) and ``'f32'`` give the same
integers; both are kept, as plain keyword arguments.

**Morphology** (erode/dilate over a square all-ones window): ``y = sum_t
[window_reduce(x) > t]`` for t in 0..254, with ``[max > t] ==
[windowsum([x > t]) >= 1]`` and ``[min > t] == [windowsum([x > t]) ==
K^2]``. The indicator planes of m thresholds pack base ``M = K^2 + 1``
into one float32 plane (a window holds at most K^2 ones, so digits never
carry), m the largest with ``M^m - 1 < 2^24``; digits come out in int32.

**Weights.** The stencils have no weights but the registry's taps: the
band matrices are built from the same ``StencilOp.kernels`` arrays the JAX
package reads, so ``Pipeline.parse`` of the same spec is all either
package needs.

**Auto routing**, as in the JAX package, and only on a CUDA device
(utils/platform.is_cuda_device): ``backend='auto'`` sends a stencil group
to the whole-op route only behind a ``backend_choice`` record for its
family and width (``autotune --dimension backend``) or the
``MCIM_PREFER_MXU`` switch (`use_mxu_for_stencil`), and ``stage_arm_for``
under the setting ``'auto'`` (``MCIM_MXU_STAGE``, the default) puts a
stencil on K5 only behind a ``stage_arm`` record (utils/calibration.py).
With no record an op keeps the VPU arm, counted as ``'no-calibration'``;
off the card, counted as ``'not-cuda'``. The JAX package's TPU records do
not carry over: records are keyed by device kind.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    F32,
    Op,
    StencilOp,
    _f32,
    corr_valid,
    exact_f32,
    pad2d,
    per_image,
    takes_stack,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics
from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration, platform
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry

B = 128  # block width of the banded products
_SPLIT = 64.0  # the 64a+b column-split radix
_F32_EXACT = 1 << 24  # integers below this are exact in float32

MXU_MODES = ("banded", "hybrid")
MXU_COL_VARIANTS = ("bf16split", "f32")


def mxu_mode() -> str:
    """The banded-product mode: MCIM_MXU_MODE, default 'banded'."""
    m = env_registry.get("MCIM_MXU_MODE") or "banded"
    if m not in MXU_MODES:
        raise ValueError(f"MCIM_MXU_MODE={m!r}; known: {MXU_MODES}")
    return m


def mxu_col_variant() -> str:
    """The column-pass variant: MCIM_MXU_COL, default 'bf16split'."""
    v = env_registry.get("MCIM_MXU_COL") or "bf16split"
    if v not in MXU_COL_VARIANTS:
        raise ValueError(f"MCIM_MXU_COL={v!r}; known: {MXU_COL_VARIANTS}")
    return v


def prefer_mxu() -> bool:
    """The A/B switch MCIM_PREFER_MXU=1: eligible stencil families take the
    banded products on auto paths with no record (CUDA devices only)."""
    return env_registry.get_bool("MCIM_PREFER_MXU")


@contextlib.contextmanager
def _f32_matmuls():
    """Float32 products in full float32 for the duration: TF32 off, the
    previous setting restored after."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


# --------------------------------------------------------------------------
# Eligibility
# --------------------------------------------------------------------------


def _bf16_exact(a) -> bool:
    """Whether every value round-trips through bfloat16 exactly."""
    t = torch.as_tensor(np.asarray(a, np.float64))
    return bool(torch.equal(t.to(torch.bfloat16).to(torch.float64), t))


def _int_kernels_ok(op: StencilOp) -> bool:
    for k in op.kernels:
        ka = np.asarray(k, np.float64)
        if not np.array_equal(ka, np.round(ka)):
            return False
        if not _bf16_exact(ka):
            return False
        if 255.0 * float(np.abs(ka).sum()) >= _F32_EXACT:
            return False
    return True


def _sep_taps(op: StencilOp) -> tuple[float, ...] | None:
    """The op's separable taps when the banded row and column passes apply:
    integer, non-negative, bf16-exact, length 2 * halo + 1, sum in [1, 64].
    Every registry separable qualifies; anything else takes the one-product
    2-D path."""
    t = op.separable
    if t is None:
        return None
    ta = np.asarray(t, np.float64).reshape(-1)
    if not np.array_equal(ta, np.round(ta)) or np.any(ta < 0):
        return None
    if len(ta) - 1 != 2 * op.halo:
        return None
    s = float(ta.sum())
    if s < 1 or s > _SPLIT:
        return None
    if not _bf16_exact(ta):
        return None
    return tuple(float(v) for v in ta)


def _morph_ok(op: StencilOp) -> bool:
    """Whether the threshold decomposition applies: a min/max reduce over a
    square all-ones window."""
    if op.reduce not in ("min", "max"):
        return False
    if op.combine != "single":
        return False
    if 2 * op.halo >= B:
        return False
    k = 2 * op.halo + 1
    return all(
        tuple(kk.shape) == (k, k) and np.array_equal(np.asarray(kk), np.ones((k, k)))
        for kk in op.kernels
    )


def mxu_eligible(op: Op) -> bool:
    """True iff `op` has an exact banded-product formulation (module
    docstring): integer-tap correlations with square (2h + 1)-kernels and
    erode/dilate. Median has none."""
    if not isinstance(op, StencilOp):
        return False
    if op.reduce in ("min", "max"):
        return _morph_ok(op)
    if op.reduce != "corr":
        return False
    if op.combine not in ("single", "magnitude"):
        return False
    if 2 * op.halo >= B:
        return False
    k = 2 * op.halo + 1
    if any(tuple(kk.shape) != (k, k) for kk in op.kernels):
        return False
    return _int_kernels_ok(op)


def mxu_family(op: Op) -> str | None:
    """The op's formulation class: 'sepK' (banded separable, K taps),
    'gradKxK' (magnitude combine), 'corrKxK' (one 2-D product), 'morphKxK'
    (threshold decomposition). None for ineligible ops."""
    if not mxu_eligible(op):
        return None
    k = int(op.kernels[0].shape[0])
    if op.reduce in ("min", "max"):
        return f"morph{k}x{k}"
    if op.combine == "magnitude":
        return f"grad{k}x{k}"
    if _sep_taps(op) is not None:
        return f"sep{k}"
    return f"corr{k}x{k}"


def mxu_int8_ok(op: Op) -> bool:
    """Whether the int8 form is proven exact for `op`: an eligible
    correlation whose every weight is an integer in [-127, 127]. The sum
    bound already follows from eligibility."""
    if not isinstance(op, StencilOp) or op.reduce != "corr":
        return False
    if not mxu_eligible(op):
        return False
    for k in op.kernels:
        if float(np.abs(np.asarray(k, np.float64)).max()) > 127:
            return False
    return True


# --------------------------------------------------------------------------
# Banded tap matrices (host-built, cached per weights)
# --------------------------------------------------------------------------

_band_cache: dict = {}


def _band_np(taps: tuple, h: int) -> np.ndarray:
    """(B + 2h, B) banded matrix with C[n + i, n] = taps[i]."""
    key = ("1d", taps, h)
    got = _band_cache.get(key)
    if got is None:
        C = np.zeros((B + 2 * h, B), np.float32)
        for n in range(B):
            for i, t in enumerate(taps):
                C[n + i, n] = t
        got = _band_cache[key] = C
    return got


def _band2_np(w2d: np.ndarray, h: int) -> np.ndarray:
    """(kh, B + 2h, B) per-row-offset banded matrices of the 2-D path:
    C2[d, n + i, n] = w2d[d, i]."""
    wa = np.asarray(w2d, np.float32)
    key = ("2d", wa.tobytes(), wa.shape, h)
    got = _band_cache.get(key)
    if got is None:
        kh, kw = wa.shape
        C2 = np.zeros((kh, B + 2 * h, B), np.float32)
        for d in range(kh):
            for n in range(B):
                for i in range(kw):
                    C2[d, n + i, n] = wa[d, i]
        got = _band_cache[key] = C2
    return got


def _band_blocks(xp: torch.Tensor, axis: int, h: int) -> torch.Tensor:
    """Sliding blocks of width B + 2h along `axis` (-2 rows, -1 columns; any
    leading axes are a stack's) with stride B, as a view with a new block
    axis in place of `axis` and the block width last; `xp` carries the 2h
    halo along `axis` and a block-multiple core."""
    return xp.unfold(axis, B + 2 * h, B)


def _band(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=F32, device=like.device)


# --------------------------------------------------------------------------
# Exact banded passes (float32 operands: see the module docstring)
# --------------------------------------------------------------------------


def _row_pass_banded(rows: torch.Tensor, taps: tuple, h: int) -> torch.Tensor:
    """(..., R, Wc + 2h) exact-integer float32 -> (..., R, Wc) row sums, Wc
    a block multiple (the leading axes a stack's: one batched product)."""
    ext = _band_blocks(rows, -1, h)  # (..., R, nb, B + 2h)
    out = torch.matmul(ext, _band(_band_np(taps, h), rows))  # (..., R, nb, B)
    return out.reshape(out.shape[:-2] + (-1,))


def _col_pass_banded(tmp: torch.Tensor, taps: tuple, h: int, variant: str) -> torch.Tensor:
    """(..., Rc + 2h, W) exact-integer row sums -> (..., Rc, W) column
    sums, Rc a block multiple. 'bf16split' contracts tmp = 64a + b as its
    two halves and recombines them, 'f32' contracts tmp itself: the same
    integers."""
    if variant not in MXU_COL_VARIANTS:
        raise ValueError(f"unknown column variant {variant!r}; known: {MXU_COL_VARIANTS}")
    C = _band(_band_np(taps, h), tmp)

    def colsum(x: torch.Tensor) -> torch.Tensor:
        ext = _band_blocks(x, -2, h)  # (..., nb, W, B + 2h)
        out = torch.matmul(ext, C)  # (..., nb, W, B)
        return out.transpose(-1, -2).reshape(x.shape[:-2] + (-1, x.shape[-1]))

    if variant == "f32":
        return colsum(tmp)
    a = torch.floor(tmp * _f32(1.0 / _SPLIT))
    b = tmp - a * _SPLIT
    return colsum(a) * _SPLIT + colsum(b)


def _sep_valid_mxu(
    xpad: torch.Tensor, taps: tuple, h: int, *, mode: str, col_variant: str
) -> torch.Tensor:
    """Separable valid-mode correlation as banded products; the same
    integers as spec.separable_valid."""
    hh = xpad.shape[-2] - 2 * h
    ww = xpad.shape[-1] - 2 * h
    xf = exact_f32(xpad)
    if mode == "hybrid":
        # the row pass as the golden shifts, the column pass as products
        tmp = corr_valid(xf, np.asarray(taps, np.float32).reshape(1, -1))
    else:
        wpad = (-ww) % B
        core = xf if wpad == 0 else torch.nn.functional.pad(xf, (0, wpad))
        tmp = _row_pass_banded(core, taps, h)  # (hh + 2h, ww + wpad)
    hpad = (-hh) % B
    if hpad:
        tmp = torch.nn.functional.pad(tmp, (0, 0, 0, hpad))
    out = _col_pass_banded(tmp, taps, h, col_variant)
    return out[..., :hh, :ww]


def _corr2d_valid_mxu(xpad: torch.Tensor, w2d: np.ndarray, h: int) -> torch.Tensor:
    """Valid 2-D integer correlation as one banded product per block: the
    kh row-shifted views of the width-blocked tile contract together over
    (row offset, band position) against the stacked C2[d]."""
    kh, kw = w2d.shape
    hh = xpad.shape[-2] - (kh - 1)
    ww = xpad.shape[-1] - (kw - 1)
    xf = exact_f32(xpad)
    wpad = (-ww) % B
    if wpad:
        xf = torch.nn.functional.pad(xf, (0, wpad))
    views = torch.cat(
        [_band_blocks(xf[..., d : d + hh, :], -1, h) for d in range(kh)], dim=-1
    )  # (..., hh, nb, kh * (B + 2h))
    C2 = _band(_band2_np(w2d, h).reshape(kh * (B + 2 * h), B), xf)
    out = torch.matmul(views, C2)  # (..., hh, nb, B)
    return out.reshape(out.shape[:-2] + (-1,))[..., :ww]


def _morph_digits(M: int) -> int:
    """Digits per packed plane: the largest m with M^m - 1 < 2^24."""
    m = 1
    while M ** (m + 1) - 1 < _F32_EXACT:
        m += 1
    return m


def _ones_windowsum_f32(xp: torch.Tensor, K: int, h: int) -> torch.Tensor:
    """(..., R + 2h, C + 2h) exact-integer float32 planes -> (..., R, C)
    K x K window sums, by two all-ones banded passes."""
    hh = xp.shape[-2] - 2 * h
    ww = xp.shape[-1] - 2 * h
    taps = (1.0,) * K
    wpad = (-ww) % B
    core = xp if wpad == 0 else torch.nn.functional.pad(xp, (0, wpad))
    tmp = _row_pass_banded(core, taps, h)
    hpad = (-hh) % B
    if hpad:
        tmp = torch.nn.functional.pad(tmp, (0, 0, 0, hpad))
    return _col_pass_banded(tmp, taps, h, "f32")[..., :hh, :ww]


def _morph_valid_mxu(op: StencilOp, xpad: torch.Tensor) -> torch.Tensor:
    """Valid-mode erode/dilate by threshold decomposition (module
    docstring): dilate counts the thresholds with a hit in the window,
    erode those where the whole window hits."""
    K = 2 * op.halo + 1
    h = op.halo
    hh = xpad.shape[-2] - 2 * h
    ww = xpad.shape[-1] - 2 * h
    xf = exact_f32(xpad)
    M = K * K + 1
    m = _morph_digits(M)
    full = K * K
    acc = torch.zeros(xf.shape[:-2] + (hh, ww), dtype=F32, device=xf.device)
    for t0 in range(0, 255, m):
        ts = range(t0, min(t0 + m, 255))
        packed = torch.zeros_like(xf)
        for i, t in enumerate(ts):
            packed = packed + (xf > float(t)).to(F32) * float(M**i)
        si = _ones_windowsum_f32(packed, K, h).to(torch.int32)
        for i, _t in enumerate(ts):
            d = torch.div(si, M**i, rounding_mode="floor") % M
            hit = (d >= 1) if op.reduce == "max" else (d == full)
            acc = acc + hit.to(F32)
    return acc


def _combine_scale(op: StencilOp, accs: list) -> torch.Tensor:
    """The golden combine and scale of spec.StencilOp.valid, replayed on
    the exact sums (the magnitude's root through float64, as there)."""
    if op.combine == "single":
        acc = accs[0]
    elif op.combine == "magnitude":
        sq = accs[0] * accs[0] + accs[1] * accs[1]
        acc = torch.sqrt(sq.to(torch.float64)).to(F32)
    else:  # pragma: no cover - eligibility rejects other combines
        raise ValueError(f"unknown combine {op.combine!r}")
    if op.scale != 1.0:
        acc = acc * _f32(op.scale)
    return acc


def mxu_valid(
    op: StencilOp,
    xpad: torch.Tensor,
    *,
    mode: str = "banded",
    col_variant: str = "bf16split",
) -> torch.Tensor:
    """Drop-in for ``op.valid`` on an eligible op: float32 (H + 2h, W + 2h)
    -> float32 (H, W), byte for byte the golden accumulation; a stack of
    such planes (..., H + 2h, W + 2h) contracts as one batched product per
    pass (the sums are exact integers, so they do not depend on it). `mode`
    'banded' takes both separable passes as products, 'hybrid' the row pass
    as golden shifts. Every tensor-core route calls it on its own
    pre-extended tile."""
    if not mxu_eligible(op):
        raise ValueError(f"op {op.name!r} has no banded-product formulation")
    if mode not in MXU_MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {MXU_MODES}")
    with _f32_matmuls():
        if op.reduce in ("min", "max"):
            return _morph_valid_mxu(op, xpad)
        h = op.halo
        taps = _sep_taps(op)
        if taps is not None and op.combine == "single":
            accs = [_sep_valid_mxu(xpad, taps, h, mode=mode, col_variant=col_variant)]
        else:
            accs = [_corr2d_valid_mxu(xpad, np.asarray(k, np.float32), h) for k in op.kernels]
        return _combine_scale(op, accs)


# --------------------------------------------------------------------------
# Op and pipeline entry points
# --------------------------------------------------------------------------


@takes_stack
def mxu_stencil(
    op: StencilOp,
    stack: torch.Tensor,
    *,
    mode: str = "banded",
    col_variant: str = "bf16split",
) -> torch.Tensor:
    """One eligible stencil over a stack of u8 images, per channel plane,
    byte-equal to ``op`` on each image: golden edge extension, banded
    accumulation, golden finalize. The stack's planes contract together as
    batched ``torch.matmul`` products (TF32 off)."""

    def plane(x: torch.Tensor) -> torch.Tensor:
        hh, ww = x.shape[-2:]
        h = op.halo
        xpad = pad2d(exact_f32(x), op.edge_mode, h, h, h, h)
        acc = mxu_valid(op, xpad, mode=mode, col_variant=col_variant)
        return op.finalize(acc, x, 0, 0, hh, ww)

    if stack.ndim == 4:
        return torch.stack([plane(stack[..., c]) for c in range(stack.shape[-1])], dim=-1)
    # the banded products can leave a plane column-major, and the K1/K2
    # launch that pipeline_mxu may run next refuses it ("the kernels take
    # contiguous images")
    return plane(stack).contiguous()


def _within_halo(op: StencilOp, shape: tuple[int, ...]) -> bool:
    """Whether the K1/K2 group runner refuses `op` on an image of `shape`
    from its shape alone: a reflect101 stencil on an image no taller or
    wider than its halo (cuda_kernels.run_group)."""
    height, width = shape[:2]
    return op.edge_mode == "reflect101" and (height <= op.halo or width <= op.halo)


@takes_stack
def pipeline_mxu(
    ops,
    stack: torch.Tensor,
    *,
    mode: str = "banded",
    col_variant: str = "bf16split",
    block_h: int | None = None,
) -> torch.Tensor:
    """A pipeline with every eligible stencil on the banded products and
    every other op, in runs between them, through the K1/K2 group runner
    (`pipeline_cuda`: its kernels on a CUDA tensor, their plain versions on
    a CPU one), byte-equal to the golden ops. A stencil with no banded form
    on an image the group runner refuses (`_within_halo`) runs its golden
    op instead, as the JAX package's pipeline_mxu runs every such op,
    counted in ``plan_metrics.mxu_golden_ops``. `block_h` sets K2's tile
    height. The banded products contract the stack as batched products,
    each K1/K2 group is one launch over it, and a golden op runs per
    image."""
    from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import pipeline_cuda

    run: list = []
    for op in ops:
        eligible = isinstance(op, StencilOp) and mxu_eligible(op)
        if eligible or (isinstance(op, StencilOp)
                        and _within_halo(op, tuple(stack.shape[1:]))):
            if run:
                stack = pipeline_cuda(run, stack, block_h=block_h, batched=True)
                run = []
            if eligible:
                stack = mxu_stencil(op, stack, mode=mode, col_variant=col_variant, batched=True)
            else:
                stack = per_image(op, stack)
                plan_metrics.mxu_golden_ops[op.name] += 1
        else:
            run.append(op)
    if run:
        stack = pipeline_cuda(run, stack, block_h=block_h, batched=True)
    return stack


# --------------------------------------------------------------------------
# Auto routing
# --------------------------------------------------------------------------


def use_mxu_for_stencil(op: Op, width: int | None = None, device=None) -> str | None:
    """The auto route of one stencil group on an image `width` columns
    wide on `device` (None: the current CUDA device): the banded-product
    mode ('banded' or 'hybrid') to run it in, or None to keep K1/K2. Routes
    only when the op has a banded formulation, `device` is a CUDA device,
    and either MCIM_PREFER_MXU=1 (then in `mxu_mode`) or the store records
    'mxu' (banded) or 'hybrid' for its family, device kind and width. The
    JAX package's ``use_mxu_for_stencil``; the unsharded and sharded auto
    paths both ask it. Reads the environment and the store: resolve once
    per built function and image shape."""
    if not isinstance(op, StencilOp) or not mxu_eligible(op):
        return None
    if not platform.is_cuda_device(device):
        return None
    if prefer_mxu():
        return mxu_mode()
    choice = calibration.lookup_backend_choice(
        mxu_family(op), device_kind=platform.device_kind(device), width=width
    )
    return {"mxu": "banded", "hybrid": "hybrid"}.get(choice)


# --------------------------------------------------------------------------
# In-stage arm resolution (inside the fused stage megakernel)
# --------------------------------------------------------------------------

STAGE_ARMS = ("vpu", "mxu", "mxu-int8")
# The JAX package's settings less its 'int8', which forces what 'on' does
# (MCIM_MXU_STAGE=int8 reads as 'on')
MXU_STAGE_SETTINGS = ("auto", "off", "on", "f32")

# Closed vocabulary of why an op with a banded formulation (mxu_family is
# not None) stays on the VPU arm inside a fused stage (the JAX package's,
# with 'not-cuda' for its 'not-tpu'):
#
#   off            the setting 'off': the caller disabled the arm
#   family         the formulation is whole-op only (morphology: threshold
#                  decomposition needs its own pass structure)
#   not-cuda       the setting 'auto' off a CUDA device: no K5 to win there
#   no-calibration the setting 'auto': no stage_arm record for (family,
#                  device kind, width)
STAGE_FALLBACK_REASONS = ("off", "family", "not-cuda", "no-calibration")


def count_stage_fallback(counter, reason: str) -> None:
    """The one place an op's VPU landing is counted, so the reason
    vocabulary above is enforced."""
    if reason not in STAGE_FALLBACK_REASONS:
        raise ValueError(
            f"unknown mxu-in-stage fallback reason {reason!r}; "
            f"known: {STAGE_FALLBACK_REASONS}"
        )
    counter[reason] += 1


def mxu_stage_setting() -> str:
    """The MCIM_MXU_STAGE knob (MXU_STAGE_SETTINGS; 'int8' reads as 'on'),
    default 'auto'."""
    v = env_registry.get("MCIM_MXU_STAGE") or "auto"
    v = "on" if v == "int8" else v
    if v not in MXU_STAGE_SETTINGS:
        raise ValueError(f"MCIM_MXU_STAGE={v!r}; known: {MXU_STAGE_SETTINGS + ('int8',)}")
    return v


def stage_arm_for(op: Op, width: int | None = None, setting: str | None = None, *,
                  device=None) -> str:
    """The in-stage arm of one op of a fused stage on an image `width`
    columns wide on `device`: 'vpu', 'mxu' (bf16 operands) or 'mxu-int8'
    (STAGE_ARMS), resolved on the host before the launch. `setting`
    (MXU_STAGE_SETTINGS; None = MCIM_MXU_STAGE, default 'auto'): 'on'
    forces the tensor-core arm on every eligible correlation, int8 where
    `mxu_int8_ok` proves it and bf16 otherwise; 'f32' forces bf16; 'off'
    keeps the VPU arm; 'auto' follows the store's stage_arm record for the
    op's family, device kind and width on a CUDA device (None: the current
    one), int8 only where proven, and keeps the VPU arm otherwise.

    Counts into ``plan_metrics``: the op's arm in ``mxu_stage_ops`` when it
    is a tensor-core arm, its reason in ``mxu_stage_fallbacks`` when an op
    with a banded formulation stays on the VPU arm by default. Ops with
    none (pointwise, median, fractional taps) are not counted, nor a
    recorded 'vpu', which is a measured choice."""
    setting = setting or mxu_stage_setting()
    if setting not in MXU_STAGE_SETTINGS:
        raise ValueError(f"unknown mxu_stage setting {setting!r}; known: {MXU_STAGE_SETTINGS}")
    fam = mxu_family(op) if isinstance(op, StencilOp) else None
    if fam is None:
        return "vpu"
    if setting == "off":
        count_stage_fallback(plan_metrics.mxu_stage_fallbacks, "off")
        return "vpu"
    if op.reduce != "corr":
        count_stage_fallback(plan_metrics.mxu_stage_fallbacks, "family")
        return "vpu"
    if setting == "f32":
        arm = "mxu"
    elif setting == "on":
        arm = "mxu-int8" if mxu_int8_ok(op) else "mxu"
    else:  # auto
        if not platform.is_cuda_device(device):
            count_stage_fallback(plan_metrics.mxu_stage_fallbacks, "not-cuda")
            return "vpu"
        choice = calibration.lookup_stage_arm(
            fam, device_kind=platform.device_kind(device), width=width
        )
        if choice is None:
            count_stage_fallback(plan_metrics.mxu_stage_fallbacks, "no-calibration")
            return "vpu"
        if choice == "vpu":
            return "vpu"
        arm = choice if choice != "mxu-int8" or mxu_int8_ok(op) else "mxu"
    plan_metrics.mxu_stage_ops[arm] += 1
    return arm


def stage_arms(ops, setting: str | None = None, width: int | None = None, *,
               device=None) -> tuple[str, ...]:
    """`stage_arm_for` of every op of a stage, in order (counted once
    each)."""
    return tuple(stage_arm_for(op, width, setting, device=device) for op in ops)


def check_stage_arm(op: Op, arm: str) -> None:
    """Raise unless `arm` is proven exact for `op`: the bf16 form needs an
    eligible correlation, the int8 form `mxu_int8_ok`."""
    if arm not in STAGE_ARMS:
        raise ValueError(f"unknown stage arm {arm!r}; known: {STAGE_ARMS}")
    if arm == "vpu":
        return
    if not isinstance(op, StencilOp) or op.reduce != "corr" or not mxu_eligible(op):
        raise ValueError(f"op {getattr(op, 'name', op)!r} has no in-stage {arm!r} form")
    if arm == "mxu-int8" and not mxu_int8_ok(op):
        raise ValueError(f"op {op.name!r}: the int8 form needs integer taps in [-127, 127]")


# --------------------------------------------------------------------------
# K5's plain version
# --------------------------------------------------------------------------


def _stage_corr2d_plain(xe: torch.Tensor, w2d: np.ndarray, h: int, int8: bool) -> torch.Tensor:
    """One kernel's in-stage contraction: (rows, W + 2h) exact u8-integer
    float32 carry -> (rows - 2h, W) float32 sums, one product per 128-column
    block with the kh row-shifted views on the contracting axis (K = kh *
    (B + 2h)). With `int8`, the operands are x - 128 and `+128 * sum(w)` is
    added after, as the int8 form does it."""
    kh = w2d.shape[0]
    rows, we = xe.shape
    W, out_rows = we - 2 * h, rows - 2 * h
    need = -(-W // B) * B + 2 * h
    xf = exact_f32(xe)
    if need > we:
        xf = torch.nn.functional.pad(xf, (0, need - we))
    if int8:
        xf = xf - 128.0
    blocks = _band_blocks(xf, 1, h)  # (rows, nbw, B + 2h)
    a = torch.cat([blocks[d : d + out_rows] for d in range(kh)], dim=-1)
    C = _band(_band2_np(w2d, h).reshape(kh * (B + 2 * h), B), xf)
    out = torch.matmul(a, C).reshape(out_rows, -1)[:, :W]
    if int8:
        out = out + _f32(128.0 * float(np.asarray(w2d, np.float64).sum()))
    return out


def stage_sums_mxu_plain(
    op: StencilOp, xe: torch.Tensor, *, arm: str, kernel: int = 0
) -> torch.Tensor:
    """The sums of `op`'s kernel number `kernel` as K5's plain version forms
    them before the combine and scale: (rows, W + 2h) -> (rows - 2h, W)
    float32. The plain version of K5's exactness probe
    (ops/cuda_kernels.k5_sums)."""
    check_stage_arm(op, arm)
    with _f32_matmuls():
        return _stage_corr2d_plain(
            xe, np.asarray(op.kernels[kernel], np.float32), op.halo, arm == "mxu-int8"
        )


def stage_valid_mxu_plain(op: StencilOp, xe: torch.Tensor, *, arm: str) -> torch.Tensor:
    """Plain PyTorch version of K5, the JAX package's ``stage_valid_mxu``:
    drop-in for ``op.valid`` at the megakernel's contraction point, the
    width-extended carry (rows, W + 2h) -> the (rows - 2h, W) accumulation
    of the arm's form. Separable ops contract their 2-D outer-product
    kernel; the magnitude combine and the scale replay the golden float
    ops."""
    if arm not in ("mxu", "mxu-int8"):
        raise ValueError(f"not a tensor-core stage arm: {arm!r}")
    check_stage_arm(op, arm)
    with _f32_matmuls():
        accs = [
            _stage_corr2d_plain(xe, np.asarray(k, np.float32), op.halo, arm == "mxu-int8")
            for k in op.kernels
        ]
        return _combine_scale(op, accs)
