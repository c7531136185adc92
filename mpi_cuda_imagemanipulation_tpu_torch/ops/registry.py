"""Concrete op definitions and the name -> op factory registry.

An op string is ``name`` or ``name:arg`` (``contrast:3.5``, ``emboss:5``,
``gaussian:7``); a pipeline string is comma-separated op strings. The
reference pipeline (kernel.cu:192-195) is ``grayscale,contrast:3.5,emboss:3``.

This slice holds the pointwise and stencil ops. The geometric and
global-statistics names are registered so that they fail with a clear
message instead of "unknown op".
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops import filters
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    F32,
    PW_BRIGHTNESS,
    PW_CONTRAST,
    PW_GRAY2RGB,
    PW_GRAYSCALE,
    PW_GRAYSCALE601,
    PW_INVERT,
    PW_POSTERIZE,
    PW_SEPIA,
    PW_SOLARIZE,
    PW_THRESHOLD,
    U8,
    Op,
    PointwiseOp,
    StencilOp,
    _f32,
    pointwise_from_core,
    rint_clip_f32,
    trunc_clip_f32,
)

# --------------------------------------------------------------------------
# Pointwise op bodies (f32 in, exact u8 integers out)
# --------------------------------------------------------------------------


def grayscale_core(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reference grayscale (kernel.cu:39-42): each weighted term truncated
    before summing; the three floored terms sum exactly in f32."""
    tr = torch.floor(r * _f32(0.3))
    tg = torch.floor(g * _f32(0.59))
    tb = torch.floor(b * _f32(0.11))
    return tr + tg + tb


def grayscale_u8(img: torch.Tensor) -> torch.Tensor:
    """Golden grayscale on an (H, W, 3) RGB image."""
    f = img.to(F32)
    return grayscale_core(f[..., 0], f[..., 1], f[..., 2]).to(U8)


def grayscale601_core(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """OpenCV-parity Rec.601 grayscale: (R*4899 + G*9617 + B*1868 + 8192)
    >> 14, with every intermediate an exact integer in f32."""
    acc = r * _f32(4899.0) + g * _f32(9617.0) + b * _f32(1868.0) + _f32(8192.0)
    return torch.floor(acc * _f32(1.0 / 16384.0))


def grayscale601_u8(img: torch.Tensor) -> torch.Tensor:
    f = img.to(F32)
    return grayscale601_core(f[..., 0], f[..., 1], f[..., 2]).to(U8)


def make_contrast_core(factor: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """Reference contrast (kernel.cu:49-58): clamp(f*(p-128)+128), truncated."""
    ff = _f32(factor)

    def contrast(x: torch.Tensor) -> torch.Tensor:
        return trunc_clip_f32(ff * (x - _f32(128.0)) + _f32(128.0))

    return contrast


def _contrast_rounding_free(factor: float) -> bool:
    """Whether clamp(f*(p-128)+128) incurs zero f32 rounding for every p in
    0..255; only such factors run in the kernels' f32 core, the others are
    lookup tables."""
    ff = np.float64(np.float32(factor))
    d = np.arange(256, dtype=np.float64) - 128.0
    prod = ff * d
    if not np.array_equal(prod.astype(np.float32).astype(np.float64), prod):
        return False
    s = prod + 128.0
    return bool(np.array_equal(s.astype(np.float32).astype(np.float64), s))


def make_contrast_lut(factor: float) -> np.ndarray:
    """256-entry contrast table with per-op f32 rounding: mul, add, clip, trunc."""
    ff = np.float32(factor)
    d = np.arange(256, dtype=np.float32) - np.float32(128.0)
    v = (ff * d).astype(np.float32) + np.float32(128.0)
    return np.floor(np.clip(v.astype(np.float32), 0.0, 255.0)).astype(np.uint8)


def make_brightness_core(delta: float) -> Callable[[torch.Tensor], torch.Tensor]:
    d = _f32(delta)

    def brightness(x: torch.Tensor) -> torch.Tensor:
        return trunc_clip_f32(x + d)

    return brightness


def invert_core(x: torch.Tensor) -> torch.Tensor:
    return _f32(255.0) - x


def make_threshold_core(t: float) -> Callable[[torch.Tensor], torch.Tensor]:
    if not 0 <= t <= 255:
        raise ValueError(f"threshold must be in [0, 255], got {t}")
    tv = _f32(np.uint8(t))  # match u8 truncation of the threshold arg

    def threshold(x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= tv, 255.0, 0.0).to(F32)

    return threshold


def make_gamma_lut(g: float) -> np.ndarray:
    """256-entry gamma table computed on the host in float64."""
    if g <= 0:
        raise ValueError(f"gamma must be > 0, got {g}")
    v = np.arange(256, dtype=np.float64) / 255.0
    return np.rint(255.0 * np.power(v, g)).astype(np.uint8)


def make_lut_op(
    name: str,
    table: np.ndarray,
    in_channels: int = 0,
    out_channels: int = 0,
) -> PointwiseOp:
    """Pointwise op applying a 256-entry u8 lookup table by gather. It has no
    kernel program: it runs as its own group, a plain gather on the device."""
    table = np.asarray(table, dtype=np.uint8).copy()

    def fn(img: torch.Tensor) -> torch.Tensor:
        lut = torch.from_numpy(table).to(img.device)
        return lut[img.long()]

    return PointwiseOp(name, in_channels, out_channels, fn=fn)


# Sepia tone matrix x1000 as integers: the integer multiply-accumulate is
# exact in f32, and the single 0.001 scale is one correctly rounded op.
SEPIA_MATRIX_X1000 = np.array(
    [
        [393, 769, 189],
        [349, 686, 168],
        [272, 534, 131],
    ],
    dtype=np.float32,
)


def sepia_planes_core(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    m = SEPIA_MATRIX_X1000
    scale = _f32(0.001)
    return [
        rint_clip_f32((r * _f32(m[i, 0]) + g * _f32(m[i, 1]) + b * _f32(m[i, 2])) * scale)
        for i in range(3)
    ]


def sepia_u8(img: torch.Tensor) -> torch.Tensor:
    f = img.to(F32)
    planes = sepia_planes_core(f[..., 0], f[..., 1], f[..., 2])
    return torch.stack([p.to(U8) for p in planes], dim=-1)


def _posterize_step(bits: int) -> float:
    if not 1 <= bits <= 8:
        raise ValueError(f"posterize bits must be in [1, 8], got {bits}")
    return _f32(2 ** (8 - bits))


def make_posterize_core(bits: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """PIL-parity posterize: keep the top `bits` bits, as floor(x/step)*step."""
    step = _posterize_step(bits)

    def posterize(x: torch.Tensor) -> torch.Tensor:
        return torch.floor(x / step) * step

    return posterize


def make_solarize_core(t: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """PIL-parity solarize: invert every pixel >= threshold."""
    if not 0 <= t <= 255:
        raise ValueError(f"solarize threshold must be in [0, 255], got {t}")
    tv = _f32(t)

    def solarize(x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= tv, _f32(255.0) - x, x)

    return solarize


def gray2rgb_u8(img: torch.Tensor) -> torch.Tensor:
    """Channel-replicate, the reference's GRAY2BGR step (kernel.cu:210)."""
    return img[..., None].expand(*img.shape, 3).contiguous()


# --------------------------------------------------------------------------
# Stencil op instances
# --------------------------------------------------------------------------


def make_emboss(size: int) -> StencilOp:
    if size not in (3, 5):
        raise ValueError(f"emboss size must be 3 or 5 (kernel.cu:66), got {size}")
    k = filters.EMBOSS3 if size == 3 else filters.EMBOSS5
    return StencilOp(
        name=f"emboss{size}",
        halo=(size - 1) // 2,
        kernels=(k,),
        edge_mode="interior",
        quantize="trunc_clip",
    )


def make_emboss101(size: int) -> StencilOp:
    """The kern.cpp emboss variant: reflect-101 borders, round to even."""
    if size not in (3, 5):
        raise ValueError(f"emboss101 size must be 3 or 5, got {size}")
    k = filters.EMBOSS3 if size == 3 else filters.EMBOSS5
    return StencilOp(
        name=f"emboss101_{size}",
        halo=(size - 1) // 2,
        kernels=(k,),
        edge_mode="reflect101",
        quantize="rint_clip",
    )


def make_gaussian(size: int) -> StencilOp:
    if size not in (3, 5, 7):
        raise ValueError(f"gaussian size must be 3, 5 or 7, got {size}")
    k2, scale = filters.gaussian_2d(size)
    return StencilOp(
        name=f"gaussian{size}",
        halo=(size - 1) // 2,
        kernels=(k2,),
        scale=scale,  # power of two: exact
        separable=filters.binomial_1d(size),
        edge_mode="reflect101",
        quantize="rint_clip",
    )


def make_box(size: int) -> StencilOp:
    # even sizes are ill-defined under a symmetric halo; size 1 is the
    # halo-0 identity
    if size < 1 or size % 2 == 0:
        raise ValueError(f"box size must be odd and >= 1, got {size}")
    k2, scale = filters.box_2d(size)
    return StencilOp(
        name=f"box{size}",
        halo=(size - 1) // 2,
        kernels=(k2,),
        scale=scale,
        separable=np.ones((size,), np.float32),
        edge_mode="reflect101",
        quantize="rint_clip",
    )


def make_morph(kind: str, size: int) -> StencilOp:
    """Grayscale erode (window min) / dilate (window max), square window."""
    if size < 3 or size % 2 == 0:
        raise ValueError(f"{kind} size must be odd and >= 3, got {size}")
    return StencilOp(
        name=f"{kind}{size}",
        halo=(size - 1) // 2,
        kernels=(np.ones((size, size), np.float32),),
        reduce="min" if kind == "erode" else "max",
        edge_mode="edge",
        quantize="rint_clip",
    )


def make_median(size: int) -> StencilOp:
    """Rank filter by min/max selection network (spec.MEDIAN_NETWORKS)."""
    if size not in (3, 5):
        raise ValueError(
            f"median supports sizes 3 and 5 (selection networks), got {size}"
        )
    return StencilOp(
        name=f"median{size}",
        halo=(size - 1) // 2,
        kernels=(np.ones((size, size), np.float32),),
        reduce="median",
        edge_mode="reflect101",
        quantize="rint_clip",
    )


SOBEL = StencilOp(
    name="sobel",
    halo=1,
    kernels=(filters.SOBEL_GX, filters.SOBEL_GY),
    combine="magnitude",
    edge_mode="reflect101",
    quantize="rint_clip",
)

PREWITT = StencilOp(
    name="prewitt",
    halo=1,
    kernels=(filters.PREWITT_GX, filters.PREWITT_GY),
    combine="magnitude",
    edge_mode="reflect101",
    quantize="rint_clip",
)

SCHARR = StencilOp(
    name="scharr",
    halo=1,
    kernels=(filters.SCHARR_GX, filters.SCHARR_GY),
    combine="magnitude",
    edge_mode="reflect101",
    quantize="rint_clip",
)

SHARPEN = StencilOp(
    name="sharpen",
    halo=1,
    kernels=(filters.SHARPEN3,),
    edge_mode="reflect101",
    quantize="rint_clip",
)

UNSHARP = StencilOp(
    name="unsharp",
    halo=2,
    kernels=(filters.UNSHARP5,),
    scale=filters.UNSHARP5_SCALE,  # power of two: exact
    edge_mode="reflect101",
    quantize="rint_clip",
)


def make_laplacian(neighbours: int) -> StencilOp:
    if neighbours not in (4, 8):
        raise ValueError(f"laplacian connectivity must be 4 or 8, got {neighbours}")
    k = filters.LAPLACIAN4 if neighbours == 4 else filters.LAPLACIAN8
    return StencilOp(
        name=f"laplacian{neighbours}",
        halo=1,
        kernels=(k,),
        edge_mode="reflect101",
        quantize="rint_clip",
    )


def make_filter(arg: str | None) -> StencilOp:
    """Arbitrary odd-square correlation kernel (cv::filter2D, kern.cpp:62-75).

    Spec: ``filter:v1/v2/.../vK*K[:scale]`` with K in {3, 5, 7} inferred from
    the value count; weights ``w[dy, dx]`` row-major. Integer weights keep
    bit-exactness across devices; non-integer weights are deterministic per
    device but may differ from another implementation in the last ulp
    before quantization."""
    if not arg:
        raise ValueError("filter needs filter:v1/v2/...[:scale]")
    parts = arg.split(":")
    sep = "/" if "/" in parts[0] else ","
    vals = [float(v) for v in parts[0].split(sep) if v.strip()]
    size = int(round(len(vals) ** 0.5))
    if size * size != len(vals) or size not in (3, 5, 7):
        raise ValueError(
            f"filter needs 9, 25 or 49 comma-separated values "
            f"(3x3/5x5/7x7 row-major), got {len(vals)}"
        )
    scale = float(parts[1]) if len(parts) > 1 else 1.0
    k = np.asarray(vals, dtype=np.float32).reshape(size, size)
    return StencilOp(
        name=f"filter{size}x{size}",
        halo=(size - 1) // 2,
        kernels=(k,),
        scale=scale,
        edge_mode="reflect101",
        quantize="rint_clip",
    )


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_GRAYSCALE = PointwiseOp(
    "grayscale", 3, 1, fn=grayscale_u8, planes_core=grayscale_core,
    program=(PW_GRAYSCALE, 0.0, 0.0),
)
_GRAYSCALE601 = PointwiseOp(
    "grayscale601", 3, 1, fn=grayscale601_u8, planes_core=grayscale601_core,
    program=(PW_GRAYSCALE601, 0.0, 0.0),
)
_INVERT = pointwise_from_core("invert", 0, 0, invert_core, (PW_INVERT, 0.0, 0.0))
_GRAY2RGB = PointwiseOp(
    "gray2rgb", 1, 3, fn=gray2rgb_u8, program=(PW_GRAY2RGB, 0.0, 0.0)
)
_SEPIA = PointwiseOp(
    "sepia", 3, 3, fn=sepia_u8, planes_core=sepia_planes_core,
    program=(PW_SEPIA, 0.0, 0.0),
)


def _float_arg(arg: str | None, default: float) -> float:
    return default if arg is None else float(arg)


def _int_arg(arg: str | None, default: int) -> int:
    return default if arg is None else int(arg)


def _make_contrast(f: float) -> PointwiseOp:
    """Rounding-free factors (3.5, 3, any short binary fraction) use the f32
    core the kernels interpret; other factors use a host-built table."""
    name = f"contrast{f:g}"
    if _contrast_rounding_free(f):
        return pointwise_from_core(
            name, 1, 1, make_contrast_core(f), (PW_CONTRAST, _f32(f), 0.0)
        )
    return make_lut_op(name, make_contrast_lut(f), in_channels=1, out_channels=1)


def _brightness(a: str | None) -> PointwiseOp:
    d = _float_arg(a, 0)
    return pointwise_from_core(
        f"brightness{d:g}", 0, 0, make_brightness_core(d), (PW_BRIGHTNESS, _f32(d), 0.0)
    )


def _threshold(a: str | None) -> PointwiseOp:
    t = _float_arg(a, 128)
    core = make_threshold_core(t)
    return pointwise_from_core(
        f"threshold{t:g}", 1, 1, core, (PW_THRESHOLD, _f32(np.uint8(t)), 0.0)
    )


def _posterize(prefix: str, bits: int) -> PointwiseOp:
    return pointwise_from_core(
        f"{prefix}{bits}", 0, 0, make_posterize_core(bits),
        (PW_POSTERIZE, _posterize_step(bits), 0.0),
    )


def _solarize(a: str | None) -> PointwiseOp:
    t = _float_arg(a, 128)
    return pointwise_from_core(
        f"solarize{t:g}", 0, 0, make_solarize_core(t), (PW_SOLARIZE, _f32(t), 0.0)
    )


def _not_ported(name: str) -> Callable[[str | None], Op]:
    def factory(arg: str | None) -> Op:
        raise NotImplementedError(
            f"op {name!r} is not yet ported to the PyTorch package"
        )

    return factory


REGISTRY: dict[str, Callable[[str | None], Op]] = {
    "grayscale": lambda a: _GRAYSCALE,
    "gray": lambda a: _GRAYSCALE,
    "grayscale601": lambda a: _GRAYSCALE601,
    "gray601": lambda a: _GRAYSCALE601,
    "contrast": lambda a: _make_contrast(_float_arg(a, 3.5)),  # 3.5: kernel.cu:50
    "brightness": _brightness,
    "invert": lambda a: _INVERT,
    "threshold": _threshold,
    "gray2rgb": lambda a: _GRAY2RGB,
    "emboss": lambda a: make_emboss(_int_arg(a, 3)),  # smallEmboss=true: kernel.cu:195
    "emboss101": lambda a: make_emboss101(_int_arg(a, 3)),
    "gaussian": lambda a: make_gaussian(_int_arg(a, 5)),
    "box": lambda a: make_box(_int_arg(a, 3)),
    "sobel": lambda a: SOBEL,
    "prewitt": lambda a: PREWITT,
    "scharr": lambda a: SCHARR,
    "sharpen": lambda a: SHARPEN,
    "unsharp": lambda a: UNSHARP,
    "laplacian": lambda a: make_laplacian(_int_arg(a, 4)),
    "filter": make_filter,
    "gamma": lambda a: make_lut_op(
        f"gamma{_float_arg(a, 1.0):g}", make_gamma_lut(_float_arg(a, 1.0))
    ),
    "sepia": lambda a: _SEPIA,
    "posterize": lambda a: _posterize("posterize", _int_arg(a, 4)),
    # bit-depth quantization: posterize's core under another name
    "quantize": lambda a: _posterize("quantize", _int_arg(a, 6)),
    "solarize": _solarize,
    "erode": lambda a: make_morph("erode", _int_arg(a, 3)),
    "dilate": lambda a: make_morph("dilate", _int_arg(a, 3)),
    "median": lambda a: make_median(_int_arg(a, 3)),
}
# geometric and global-statistics ops: a later slice of the port
for _name in (
    "fliph", "mirror", "flipv", "flip", "transpose", "rot", "rot90", "rot180",
    "rot270", "crop", "pad", "resize", "scale", "rotate",
    "equalize", "autocontrast", "otsu",
):
    REGISTRY[_name] = _not_ported(_name)
del _name


def make_op(spec: str) -> Op:
    """Parse ``name`` or ``name:arg`` into an op instance."""
    name, _, arg = spec.strip().partition(":")
    name = name.strip().lower()
    if name not in REGISTRY:
        raise ValueError(f"unknown op {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name](arg.strip() or None if arg else None)


def make_pipeline_ops(spec: str) -> tuple[Op, ...]:
    """Parse a comma-separated pipeline string into op instances, checking
    that channel counts chain."""
    ops = tuple(make_op(s) for s in spec.split(",") if s.strip())
    chan = None
    for op in ops:
        if op.in_channels and chan and op.in_channels != chan:
            raise ValueError(
                f"op {op.name!r} expects {op.in_channels} channels but the "
                f"previous op produces {chan}"
            )
        if op.out_channels:
            chan = op.out_channels
        elif op.in_channels:
            chan = op.in_channels
    return ops


def op_from_arrays(desc: dict) -> Op:
    """Build an op from its parameters as plain numpy arrays and scalars.

    This system has no trained weights: the integer filter banks and the
    lookup tables are its parameters. A stencil ``desc`` holds ``name``,
    ``halo``, ``kernels`` (a sequence of 2-D arrays), ``separable`` (1-D
    array or None), ``scale``, ``combine``, ``reduce``, ``edge_mode`` and
    ``quantize``; a lookup-table ``desc`` holds ``name`` and ``table`` (256
    u8 entries), plus optional ``in_channels``/``out_channels``."""
    if "table" in desc:
        table = np.asarray(desc["table"])
        if table.shape != (256,):
            raise ValueError(f"lookup table must have 256 entries, got {table.shape}")
        return make_lut_op(
            desc["name"], table.astype(np.uint8),
            desc.get("in_channels", 0), desc.get("out_channels", 0),
        )
    sep = desc.get("separable")
    return StencilOp(
        name=desc["name"],
        halo=int(desc["halo"]),
        kernels=tuple(np.asarray(k, dtype=np.float32) for k in desc["kernels"]),
        scale=float(desc.get("scale", 1.0)),
        separable=None if sep is None else np.asarray(sep, dtype=np.float32),
        combine=desc.get("combine", "single"),
        reduce=desc.get("reduce", "corr"),
        edge_mode=desc.get("edge_mode", "interior"),
        quantize=desc.get("quantize", "trunc_clip"),
    )


REFERENCE_PIPELINE_SPEC = "grayscale,contrast:3.5,emboss:3"

# The other reference program (kern.cpp:73-75, the CPU/OpenCV variant):
# Rec.601 rounded grayscale, contrast 3, reflect-101 emboss.
REFERENCE_CPU_PIPELINE_SPEC = "grayscale601,contrast:3,emboss101:3"
