"""Plan execution in PyTorch ops: the stage walker. The counterpart of the
JAX package's ``plan/exec.py``.

A fused stage runs over an *extended region*: a buffer that covers its
output rows plus up to `Stage.halo` rows of real context on each interior
side. The walker applies the stage's ops in order on a float32 carry
holding exact u8 integer values (every core maps exact integers to exact
integers, so one u8 materialisation per stage gives the bytes of one per
op):

  * pointwise ops run their `core`/`planes_core` on the carry (fn-only
    ops, the lookup tables and gray2rgb, round-trip through u8, which is
    exact);
  * each stencil consumes `op.halo` context rows per side while real
    context remains and pads (`pad2d`, the op's own edge mode) where the
    side is the true image edge, then finalizes at global row offsets so
    'interior' masks see image coordinates.

Two context conventions, one walker:

  * full image (`run_stage_full`, lead = tail = 0): every stencil pads both
    sides per its mode. This is the golden per-op computation, staged, and
    the plain version of the megakernel K4
    (``ops/cuda_kernels.fused_stage_plain``).
  * sharded tiles (parallel/api.py): context rows are always present (the
    stage's one ghost exchange), and an `edge_fix` callback rewrites the
    out-of-image rows per op before that op reads them
    (`parallel.api._fix_edge_axis`), so no assumption is made that an op's
    output commutes with the next op's border extension. This is the plain
    version of K4's ghost mode (``ops/cuda_kernels.fused_stage_ext_plain``).

Each stencil's accumulator is chosen per op (`stencil_acc_fn`): the golden
``op.valid`` under impl ``'torch'``; under impl ``'mxu'`` the whole-op
banded products (``ops/mxu_kernels.mxu_valid``) for eligible ops; and, for
an op given a tensor-core in-stage arm (``plan='fused-pallas-mxu'``), K5's
plain version ``stage_valid_mxu_plain``, which is how the walker is the
plain version of K4 with the K5 arm.
"""

from __future__ import annotations

from functools import partial

import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import (
    mxu_eligible,
    mxu_valid,
    stage_arms,
    stage_valid_mxu_plain,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import op_family
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    U8,
    StencilOp,
    _check_channels,
    exact_f32,
    pad2d,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import Plan

# the walker's accumulator routing: the JAX package's 'xla' is the port's
# 'torch'. Its 'auto' (the banded products behind a record) has no
# counterpart: the port's 'auto' backend never walks (plan/planner.py
# refuses the walker modes there, and a recorded one is ignored)
PLAN_IMPLS = ("torch", "mxu")


def stencil_acc_fn(op: StencilOp, impl: str, arm: str = "vpu"):
    """The valid-region accumulator of one stencil: K5's plain version when
    the op has a tensor-core in-stage `arm`, else the whole-op banded
    products under impl 'mxu' for an eligible op, else the golden
    ``op.valid``. (A stage the megakernel rejects does not come here on the
    card: plan/cuda_exec.py sends it through ``pipeline_mxu`` under 'mxu',
    which keeps the whole-op route.)"""
    if impl not in PLAN_IMPLS:
        raise ValueError(f"unknown plan impl {impl!r}; known: {PLAN_IMPLS}")
    if arm != "vpu":
        return partial(stage_valid_mxu_plain, op, arm=arm)
    if impl == "mxu" and mxu_eligible(op):
        return partial(mxu_valid, op)
    return op.valid


def acc_fns_for(ops, impl: str = "torch", arms=None) -> tuple:
    """The accumulator of each op of a stage, in order (None for pointwise
    ops); `arms` are the ops' in-stage arms (default all 'vpu')."""
    arms = arms or ("vpu",) * len(ops)
    return tuple(
        stencil_acc_fn(op, impl, arm) if isinstance(op, StencilOp) else None
        for op, arm in zip(ops, arms)
    )


def apply_pointwise_f32(op, cur: torch.Tensor) -> torch.Tensor:
    """One pointwise op on the f32 exact-integer carry."""
    _check_channels(op.name, op.in_channels, cur)
    if op.planes_core is not None and cur.ndim == 3:
        planes = op.planes_core(cur[..., 0], cur[..., 1], cur[..., 2])
        if isinstance(planes, (list, tuple)):
            return torch.stack(list(planes), dim=-1)
        return planes
    if op.core is not None:
        return op.core(cur)
    # fn-only op (lookup table, gray2rgb): the u8 round trip is exact on
    # integer-valued f32
    return exact_f32(op.fn(cur.to(U8)))


def _stencil_region(
    op: StencilOp,
    buf: torch.Tensor,
    acc_fn,
    take_top: int,
    take_bot: int,
    y0: int,
    global_h: int,
    global_w: int,
) -> torch.Tensor:
    """One stencil over an extended f32 region: consume `take_*` real
    context rows, pad the rest per the op's edge mode, finalize at global
    coordinates."""
    h = op.halo
    pad_top, pad_bot = h - take_top, h - take_bot

    def plane(x: torch.Tensor) -> torch.Tensor:
        xpad = pad2d(x, op.edge_mode, pad_top, pad_bot, h, h)
        orig = x[take_top : x.shape[0] - take_bot]
        return op.finalize_f32(acc_fn(xpad), orig, y0, 0, global_h, global_w)

    if buf.ndim == 3:
        return torch.stack([plane(buf[..., c]) for c in range(buf.shape[2])], dim=-1)
    return plane(buf)


def walk_stage(
    ops,
    cur: torch.Tensor,
    *,
    y_lo: int,
    lead_rem: int,
    tail_rem: int,
    global_h: int,
    global_w: int,
    acc_fns=None,
    edge_fix=None,
):
    """Apply one fused stage's ops over the f32 region `cur`, whose first
    row sits at global row `y_lo` with `lead_rem`/`tail_rem` real context
    rows still unconsumed at each end. `acc_fns` (`acc_fns_for`) gives each
    stencil's accumulator; default the golden ``op.valid``.

    With `edge_fix(cur, op, y_lo)`, the sharded convention, context is
    always present: every stencil consumes its full halo, and the callback
    first rewrites the out-of-image rows per that op's edge mode. Without
    it, a stencil consumes context only while `*_rem > 0` and pads
    otherwise.

    Returns ``(cur, y_lo, lead_rem, tail_rem)`` so a tiled caller can
    thread the context budget across consecutive stages."""
    acc_fns = acc_fns or acc_fns_for(ops)
    for op, acc_fn in zip(ops, acc_fns):
        fam = op_family(op)
        if fam == "pointwise":
            cur = apply_pointwise_f32(op, cur)
            continue
        if fam != "stencil":
            raise ValueError(f"op {op.name!r} ({fam}) cannot appear inside a fused stage")
        _check_channels(op.name, op.in_channels, cur)
        h = op.halo
        if h == 0:  # degenerate stencil (box:1): keeps the shape, no context
            cur = _stencil_region(op, cur, acc_fn, 0, 0, y_lo, global_h, global_w)
            continue
        if edge_fix is not None:
            cur = edge_fix(cur, op, y_lo)
            take_top = take_bot = h
        else:
            take_top = h if lead_rem > 0 else 0
            take_bot = h if tail_rem > 0 else 0
        y0 = y_lo + take_top
        cur = _stencil_region(op, cur, acc_fn, take_top, take_bot, y0, global_h, global_w)
        lead_rem -= take_top
        tail_rem -= take_bot
        y_lo = y0
    return cur, y_lo, lead_rem, tail_rem


def run_stage_full(stage, img: torch.Tensor, acc_fns=None) -> torch.Tensor:
    """One fused stage over a whole u8 image (lead = tail = 0)."""
    cur, _, _, _ = walk_stage(
        stage.ops, exact_f32(img), y_lo=0, lead_rem=0, tail_rem=0,
        global_h=img.shape[0], global_w=img.shape[1], acc_fns=acc_fns,
    )
    return cur.to(U8)


def plan_callable(plan: Plan, *, impl: str = "torch", mxu_stage: str | None = None):
    """The full-image executor for a plan: an image -> image function.
    Barrier stages run their golden op; fused stages run as one walk each,
    each stencil's accumulator routed by `impl` (PLAN_IMPLS). With
    `mxu_stage` (ops/mxu_kernels.MXU_STAGE_SETTINGS; 'on' under
    ``plan='fused-pallas-mxu'``), every stage's in-stage arms are resolved
    here, once per stage, and stencils on a tensor-core arm run K5's plain
    version."""
    acc = [
        acc_fns_for(
            stage.ops, impl,
            stage_arms(stage.ops, mxu_stage) if mxu_stage is not None else None,
        )
        if stage.kind == "fused" else None
        for stage in plan.stages
    ]

    def run(img: torch.Tensor) -> torch.Tensor:
        for stage, acc_fns in zip(plan.stages, acc):
            if stage.kind in ("geometric", "global"):
                img = stage.ops[0](img)
            else:
                img = run_stage_full(stage, img, acc_fns)
        return img

    return run


def unfused_callables(ops) -> list:
    """One callable per op, the op-at-a-time execution model (each op a
    whole-image pass of its golden version, like the reference's sequential
    kernel launches): the per-op lane of the bench suite's plan_ab. The
    counterpart of the JAX package's ``unfused_callables``."""
    return [lambda x, o=op: o(x) for op in ops]


def run_unfused(fns, img):
    for f in fns:
        img = f(img)
    return img
