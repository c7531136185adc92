"""Tile geometry and the per-tile op chain. The counterpart of the JAX
package's ``stream/tiles.py``: the geometry (`validate_stream_ops`,
`out_channels`, `TileSpec`, `plan_tiles`) is a copy; the tile function is a
plain closure over the port's stage walker.

The streaming engine decomposes an (H, W[, C]) image into fixed-height
row bands and runs the same op chain every other route runs, on a band
extended with `chain_halo` real neighbour rows per interior seam, so the
band's output is byte-identical to the corresponding rows of the
whole-image golden result:

  * each stencil op consumes `op.halo` rows of context from every
    interior side of the band and pads (pad2d, the op's own edge mode) at
    sides that are the true image boundary: a chain of ops walks the
    extension down exactly as `ops.spec.chain_halo` sizes it
    (``plan/exec.walk_stage`` without ``edge_fix``);
  * finalize runs at global row offsets (the band's first row ``y0`` is
    a Python int), so ``edge_mode='interior'`` masks (the reference
    emboss guard) see image coordinates, not band coordinates;
  * only shape-preserving ops stream: pointwise and stencil families.
    Geometric ops re-index globally and global-statistics ops need a
    full-image pass; both are rejected (`StreamabilityError`).

Every middle band shares one (lead, tail) context signature, so an image of
any height needs at most four tile functions (first / middle / last /
single band) per chain.

The stream computes with the walker only (impl ``torch``: the golden
accumulators; ``mxu``: the whole-op banded products for eligible
stencils), as the JAX stream computes with XLA only: a resolved
``fused-pallas[-mxu]`` plan keeps its stage partition and walks it, since
the megakernel does not model a band's (lead, tail) context budget. The
port has no banded-product record for the walker, so ``auto`` runs what
``torch`` runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    U8,
    GeometricOp,
    GlobalOp,
    Op,
    PointwiseOp,
    StencilOp,
    chain_halo,
    exact_f32,
)
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

STREAM_IMPLS = ("auto", "torch", "mxu")


class StreamabilityError(ValueError):
    """The op chain cannot run as a row stream."""


def validate_stream_ops(ops: tuple[Op, ...]) -> int:
    """Reject non-streamable ops; return the chain halo (seam size)."""
    for op in ops:
        if isinstance(op, GeometricOp):
            raise StreamabilityError(
                f"op {op.name!r} re-indexes the image globally and cannot "
                "run as a row stream (geometric ops need the whole frame)"
            )
        if isinstance(op, GlobalOp):
            raise StreamabilityError(
                f"op {op.name!r} depends on a full-image statistic and "
                "cannot run as a single-pass row stream"
            )
        if not isinstance(op, (PointwiseOp, StencilOp)):
            raise StreamabilityError(f"op {op.name!r} is not streamable")
    return chain_halo(ops)


def out_channels(ops: tuple[Op, ...], in_channels: int) -> int:
    """Channel count after the chain (grayscale 3->1, gray2rgb 1->3)."""
    chan = in_channels
    for op in ops:
        if op.in_channels and chan != op.in_channels:
            raise ValueError(
                f"op {op.name!r} expects {op.in_channels} channels, "
                f"stream carries {chan}"
            )
        if op.out_channels:
            chan = op.out_channels
    return chan


@dataclass(frozen=True)
class TileSpec:
    """One band of the decomposition, in global row coordinates."""

    index: int
    out_lo: int  # first output row this tile produces
    out_hi: int  # one past the last
    lead: int  # context rows included above out_lo (0 at the image top)
    tail: int  # context rows included below out_hi (0 at the bottom)

    @property
    def ext_lo(self) -> int:
        return self.out_lo - self.lead

    @property
    def ext_hi(self) -> int:
        return self.out_hi + self.tail

    @property
    def out_rows(self) -> int:
        return self.out_hi - self.out_lo


def plan_tiles(height: int, tile_rows: int, halo: int) -> list[TileSpec]:
    """Decompose `height` rows into bands of `tile_rows`, each extended
    by `halo` rows of real context at interior seams. `tile_rows` must
    cover the chain halo: a seam strip comes from exactly one neighbour
    band (the Casper single-strip reuse), so halo > tile_rows would need
    multi-band carries — raise and let the caller pick a bigger tile."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    if height < 1:
        raise ValueError(f"height must be >= 1, got {height}")
    if halo > tile_rows:
        raise StreamabilityError(
            f"tile_rows={tile_rows} is smaller than the chain halo "
            f"{halo}; a seam would span multiple bands — raise "
            f"--tile-rows to at least {halo}"
        )
    n = math.ceil(height / tile_rows)
    bounds = [
        (k * tile_rows, min(height, (k + 1) * tile_rows)) for k in range(n)
    ]
    # a short last band (< halo rows) would hand its predecessor a
    # partial seam strip; merge it into the predecessor instead — the
    # merged band is at most tile_rows + halo <= 2*tile_rows tall, so
    # the memory bound only gains a constant
    if len(bounds) > 1 and bounds[-1][1] - bounds[-1][0] < halo:
        lo, _ = bounds[-2]
        bounds[-2] = (lo, height)
        bounds.pop()
    tiles = []
    for k, (lo, hi) in enumerate(bounds):
        tiles.append(
            TileSpec(
                index=k,
                out_lo=lo,
                out_hi=hi,
                lead=min(halo, lo),
                tail=min(halo, height - hi),
            )
        )
    return tiles


# --------------------------------------------------------------------------
# The per-tile chain
# --------------------------------------------------------------------------


def _walk_impl(impl: str) -> str:
    """The walker's accumulator routing for a stream impl (module
    docstring: 'auto' is 'torch')."""
    if impl not in STREAM_IMPLS:
        raise ValueError(f"unknown stream impl {impl!r}; known: {STREAM_IMPLS}")
    return "mxu" if impl == "mxu" else "torch"


def make_tile_fn(
    ops: tuple[Op, ...],
    *,
    lead: int,
    tail: int,
    global_h: int,
    global_w: int,
    impl: str = "torch",
    plan=None,
):
    """``f(ext_u8, y_ext0) -> out_u8`` for tiles with this (lead, tail)
    context signature. ``ext`` (a u8 tensor) covers global rows
    [y_ext0, y_ext0 + ext.rows); the result covers
    [y_ext0 + lead, y_ext0 + ext.rows - tail). One closure serves every
    band with the same signature.

    `plan` (a built plan.ir.Plan, default per-op) stages the walk: each
    fused stage runs as one walk (``plan/exec.walk_stage``), with the
    context budget threaded across stages so that seam consumption is
    identical to the per-op walk."""
    walk_impl = _walk_impl(impl)
    from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan
    from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import acc_fns_for, walk_stage

    if plan is None:
        plan = build_plan(ops, "off")
    # validate_stream_ops rejected geometric/global ops up front, so every
    # stage is a fused pointwise/stencil run
    accs = [acc_fns_for(stage.ops, walk_impl) for stage in plan.stages]

    def run(ext: torch.Tensor, y_ext0: int) -> torch.Tensor:
        cur = ext
        lead_rem, tail_rem = lead, tail
        y_lo = int(y_ext0)
        for stage, acc_fns in zip(plan.stages, accs):
            f, y_lo, lead_rem, tail_rem = walk_stage(
                stage.ops, exact_f32(cur), y_lo=y_lo, lead_rem=lead_rem, tail_rem=tail_rem,
                global_h=global_h, global_w=global_w, acc_fns=acc_fns,
            )
            cur = f.to(U8)
        return cur

    return run


class TileFnCache:
    """The per-run tile-function cache: one closure per (lead, tail)
    signature, at most four for any image height, each wrapped by the cost
    ledger (``obs/cost.wrap_cache_fn("stream", ...)``), which attributes its
    first call. `plan` (a PLAN_MODES string) is resolved once here, as for
    the walker's backend (``torch``, or ``mxu`` under impl ``mxu``) on
    `device`, so every band variant shares one stage structure."""

    def __init__(self, ops, *, global_h, global_w, impl, plan="auto", device=None):
        from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan, resolve_plan_mode

        walk_impl = _walk_impl(impl)
        if impl == "auto":
            get_logger().info(
                "stream impl 'auto' runs what 'torch' runs: the port keeps no banded-product "
                "record for the stage walker"
            )
        self.ops = tuple(ops)
        self.global_h = global_h
        self.global_w = global_w
        self.impl = impl
        self.plan_mode = resolve_plan_mode(self.ops, plan, backend=walk_impl, width=global_w,
                                           device=device)
        self.plan = build_plan(self.ops, self.plan_mode)
        self._fns: dict[tuple[int, int], object] = {}

    @property
    def variants(self) -> int:
        """Tile functions built so far (at most four)."""
        return len(self._fns)

    def _modeled_bytes(self, lead: int, tail: int, args) -> float:
        """Boundary model of one tile call: the u8 extended band in, the u8
        output band out (seam context rides the input read; nothing else
        crosses, however the plan staged the walk)."""
        ext = args[0]
        ch_in = ext.shape[2] if ext.ndim == 3 else 1
        out_rows = ext.shape[0] - lead - tail
        return float(ext.numel() + out_rows * ext.shape[1] * out_channels(self.ops, ch_in))

    def fn(self, spec: TileSpec):
        key = (spec.lead, spec.tail)
        f = self._fns.get(key)
        if f is None:
            from mpi_cuda_imagemanipulation_tpu_torch.obs import cost as obs_cost

            tile_fn = make_tile_fn(
                self.ops, lead=spec.lead, tail=spec.tail, global_h=self.global_h,
                global_w=self.global_w, impl=self.impl, plan=self.plan,
            )
            f = self._fns[key] = obs_cost.wrap_cache_fn(
                "stream", f"{self.plan.fingerprint}:l{spec.lead}t{spec.tail}", tile_fn,
                modeled_fn=lambda args, lt=key: self._modeled_bytes(lt[0], lt[1], args),
            )
        return f
