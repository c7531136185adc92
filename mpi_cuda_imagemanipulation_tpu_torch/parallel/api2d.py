"""2-D tile-sharded pipeline execution over a ('rows', 'cols') mesh. The
counterpart of the JAX package's ``parallel/api2d.py``.

Extends the 1-D row decomposition (parallel/api.py, the reference's
MPI_Scatter row blocks) to a 2-D tile decomposition: the image is split
over both mesh axes, every stencil tile is extended with ghost zones on all
four sides, and corners arrive without any diagonal copy through the
two-phase exchange: the row-axis exchange runs first, then the column-axis
exchange carries the *row-extended* edge strips, so each tile's corner
ghosts are its diagonal neighbour's data relayed through the shared row or
column neighbour (parallel/halo.exchange_halo along axis 0, then axis 1).

Where the JAX package traces one tile function that every device runs
(``shard_map``), the port walks the ops once and applies each step to
every tile this process holds, in slot order, as the 1-D runner does:
`tiles` is a list with one tensor per local slot, and a tile's global
offsets (y0, x0) are plain ints. Exchanges happen between the steps.

The compute per tile is the ops' own golden tile functions (ops/spec.py
``valid`` / ``finalize`` take global (y0, x0) offsets), so 2-D sharded
output is byte-identical to the unsharded golden path. Global-statistics
ops sum each tile's histogram over its valid pixels (rows and columns
inside the image) over this process's slots and, under a process group,
across ranks with ``all_reduce``: the counterpart of ``lax.psum`` over
both axes. Geometric ops run on the whole image between sharded segments
(parallel/api._split_segments, _run_whole), as in the 1-D runner.

Scope, as in the JAX package (its ``api2d.py`` scope note): the tile
compute is the golden PyTorch ops, never a hand kernel. The row-shard
kernels (K2g, K3, K4g) assume full-width rows; a width-split tile would
need ghost columns inside their row loads, which buys nothing at these
tile sizes, so ``Pipeline.sharded`` takes only 'torch' and 'auto' on a
2-D mesh.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    F32,
    U8,
    GlobalOp,
    PointwiseOp,
    StencilOp,
    exact_f32,
)
from mpi_cuda_imagemanipulation_tpu_torch.parallel.api import (
    HALO_MODES,
    _exchange_async,
    _fix_edge_axis,
    _join_exchange,
    _run_whole,
    _split_segments,
    gather_slots,
)
from mpi_cuda_imagemanipulation_tpu_torch.parallel.halo import exchange_halo
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import Mesh2D
from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan, resolve_plan_mode
from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import apply_pointwise_f32
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import check_plan
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import per_shape


def _per_channel(fn, ext: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """`fn(ext plane, tile plane)` on each channel plane, stacked."""
    if tile.ndim == 3:
        return torch.stack([fn(ext[..., c], tile[..., c]) for c in range(tile.shape[2])], dim=-1)
    return fn(ext, tile)


def _extend_2d(op: StencilOp, tiles, offsets, global_h: int, global_w: int, mesh: Mesh2D):
    """Every tile extended by `op.halo` on all four sides: the row-axis
    exchange and the row edge fix on the raw tile, then the column-axis
    exchange carrying the row-extended strips (corners through the shared
    neighbour) and the column edge fix."""
    h = op.halo
    vexts = exchange_halo(tiles, h, mesh, axis=0)
    vexts = [_fix_edge_axis(e, op, y0, global_h, 0) for e, (y0, _) in zip(vexts, offsets)]
    exts = exchange_halo(vexts, h, mesh, axis=1)
    return [_fix_edge_axis(e, op, x0, global_w, 1) for e, (_, x0) in zip(exts, offsets)]


def _apply_stencil_2d(op: StencilOp, tile: torch.Tensor, ext: torch.Tensor, y0: int, x0: int,
                      global_h: int, global_w: int) -> torch.Tensor:
    """The op's golden valid/finalize over one tile's four-sided extension
    (`_extend_2d`)."""
    return _per_channel(
        lambda e, t: op.finalize(op.valid(e.to(F32)), t, y0, x0, global_h, global_w), ext, tile
    )


def _overlap_ok_2d(op, pad_h: int, pad_w: int, local_h: int, local_w: int) -> bool:
    """2-D interior-first gate: a real halo, no pad rows/cols inside the
    tile, and a non-empty interior along both axes (the 1-D _overlap_ok,
    applied per axis)."""
    return (
        isinstance(op, StencilOp)
        and op.halo >= 1
        and pad_h == 0
        and pad_w == 0
        and local_h > 2 * op.halo
        and local_w > 2 * op.halo
    )


def _apply_stencil_2d_overlap(op: StencilOp, tile: torch.Tensor, ext: torch.Tensor,
                              interior: torch.Tensor, y0: int, x0: int, global_h: int,
                              global_w: int) -> torch.Tensor:
    """The h-thick frame of one interior-first stencil tile, stitched around
    its `interior` (`_interior_2d`, computed while the ghosts were in
    flight): full-width top and bottom bands, whose corners use the
    two-phase corner-carrying ghosts, and the left and right middle bands,
    each from the extended tile. Every band's valid windows slice the same
    values the serial path's whole-tile valid sees, so the stitched output
    is byte-identical."""
    h = op.halo
    local_h, local_w = tile.shape[0], tile.shape[1]

    def plane(extp, tilep, interior_p):
        def band(rows, cols, orig, yb, xb):
            acc = op.valid(extp[rows, cols].to(F32))
            return op.finalize(acc, orig, yb, xb, global_h, global_w)

        # ext row r holds input row r - h (likewise columns)
        top = band(slice(0, 3 * h), slice(None), tilep[:h], y0, x0)
        bottom = band(slice(local_h - h, local_h + 2 * h), slice(None),
                      tilep[local_h - h :], y0 + local_h - h, x0)
        left = band(slice(h, local_h + h), slice(0, 3 * h), tilep[h:-h, :h], y0 + h, x0)
        right = band(slice(h, local_h + h), slice(local_w - h, local_w + 2 * h),
                     tilep[h:-h, local_w - h :], y0 + h, x0 + local_w - h)
        mid = torch.cat([left, interior_p, right], dim=1)
        return torch.cat([top, mid, bottom], dim=0)

    if tile.ndim == 3:
        return torch.stack(
            [plane(ext[..., c], tile[..., c], interior[..., c]) for c in range(tile.shape[2])],
            dim=-1,
        )
    return plane(ext, tile, interior)


def _interior_2d(op: StencilOp, tile: torch.Tensor, y0: int, x0: int, global_h: int,
                 global_w: int) -> torch.Tensor:
    """The (local_h - 2h) x (local_w - 2h) interior of one stencil tile,
    from the raw tile alone: no dependence on either exchange phase."""
    h = op.halo
    return _per_channel(
        lambda t, _: op.finalize(op.valid(t.to(F32)), t[h:-h, h:-h], y0 + h, x0 + h,
                                 global_h, global_w),
        tile, tile,
    )


def _min_local(pad: int, halo: int) -> int:
    """Feasibility of local edge fixups, per axis (the 1-D runner's
    reasoning): every reflect/pad source index must live on the tile."""
    return max(2 * pad + 1, pad + halo, halo, 1)


# --------------------------------------------------------------------------
# Plan-fused stage forms (plan/): temporal blocking over both mesh axes
# --------------------------------------------------------------------------


def _plan_stage_fused_ok_2d(stage, pad_h: int, pad_w: int, local_h: int, local_w: int) -> bool:
    """Whether one fused stage can run temporally blocked on this 2-D
    decomposition: no pad rows/cols inside the tile (the per-op edge fix
    gathers only from real data) and enough local extent on both axes to
    source the stage-halo strips: the 1-D serial gate applied per axis.
    Static, so every tile decides alike."""
    H = stage.halo
    if H < 1:
        return True  # halo-0 stages fuse with no exchange at all
    return pad_h == 0 and pad_w == 0 and local_h > H and local_w > H


def _plan_walk_2d(stage, ext: torch.Tensor, y0: int, x0: int, global_h: int,
                  global_w: int) -> torch.Tensor:
    """One fused stage over a (local_h + 2H, local_w + 2H[, C]) tile whose
    four-sided context the stage's one two-phase exchange materialised. Each
    stencil rewrites the out-of-image rows, then columns, of the carry per
    its own edge mode (`_fix_edge_axis`; rows before columns, so the column
    fix reads row-fixed values and global corners resolve to the separable
    reflect-of-reflect the golden pad2d gives), runs its golden `valid` over
    the doubly extended carry, and finalizes at global (y, x) offsets. The
    carry stays float32 exact-integer between member ops; u8 once at the
    stage's end."""
    H = stage.halo
    cur = exact_f32(ext)
    off = 0
    for op in stage.ops:
        if not isinstance(op, StencilOp):
            cur = apply_pointwise_f32(op, cur)
            continue
        h = op.halo
        row0 = y0 - (H - off)  # global coordinates of the carry's first row / column
        col0 = x0 - (H - off)
        if h:
            cur = _fix_edge_axis(cur, op, row0 + h, global_h, 0)
            cur = _fix_edge_axis(cur, op, col0 + h, global_w, 1)
        rows, cols = cur.shape[0], cur.shape[1]

        def plane(p, _, op=op, h=h, rows=rows, cols=cols, row0=row0, col0=col0):
            acc = op.valid(p)
            orig = p[h : rows - h, h : cols - h]
            return op.finalize_f32(acc, orig, row0 + h, col0 + h, global_h, global_w)

        cur = _per_channel(plane, cur, cur)
        off += h
    return cur.to(U8)


def _apply_stage_serial_2d(stage, tiles, offsets, global_h: int, global_w: int, mesh: Mesh2D):
    """Temporally blocked execution of one fused stage on every tile: one
    two-phase corner-carrying exchange sized to the stage's grown halo (the
    row-axis strips first, then the column-axis strips carrying the
    row-extended ones), then the whole stage walks each extended tile.
    Where the per-op path pays one round per stencil on each axis, a fused
    stage pays one in all."""
    H = stage.halo
    if H:
        tiles = exchange_halo(exchange_halo(tiles, H, mesh, axis=0), H, mesh, axis=1)
    return [_plan_walk_2d(stage, t, y0, x0, global_h, global_w)
            for t, (y0, x0) in zip(tiles, offsets)]


@dataclasses.dataclass
class _Region2D:
    """What the steps of one 2-D sharded region share: the mesh, the
    decomposition, and each local tile's global (row, column) offset."""

    mesh: Mesh2D
    global_h: int
    global_w: int
    local_h: int
    local_w: int
    pad_h: int
    pad_w: int
    offsets: tuple[tuple[int, int], ...]


def _open_region_2d(ops, mesh: Mesh2D, img: torch.Tensor):
    """Pad-to-multiple on both axes and scatter: returns the region and the
    local tiles. A decomposition whose tiles cannot source their edge fixes
    raises, with the JAX package's wording."""
    n_r, n_c = mesh.n_rows, mesh.n_cols
    max_halo = max((op.halo for op in ops), default=0)
    global_h, global_w = img.shape[0], img.shape[1]
    padded_h = -(-global_h // n_r) * n_r
    padded_w = -(-global_w // n_c) * n_c
    pad_h, pad_w = padded_h - global_h, padded_w - global_w
    local_h, local_w = padded_h // n_r, padded_w // n_c
    for size, pad, name in ((local_h, pad_h, "rows"), (local_w, pad_w, "cols")):
        if size < _min_local(pad, max_halo):
            raise ValueError(
                f"image {global_h}x{global_w} over a {n_r}x{n_c} mesh gives "
                f"{size} {name}/shard, below the minimum "
                f"{_min_local(pad, max_halo)} for halo {max_halo} and "
                f"padding {pad}; use a smaller mesh"
            )
    tiles, offsets = [], []
    for slot in mesh.local_slots:
        r, c = mesh.coords(slot)
        y0, x0 = r * local_h, c * local_w
        dev = mesh.devices[slot]
        part = img[y0 : min(y0 + local_h, global_h), x0 : min(x0 + local_w, global_w)]
        tile = torch.zeros((local_h, local_w) + tuple(img.shape[2:]), dtype=U8, device=dev)
        tile[: part.shape[0], : part.shape[1]] = part.to(dev, non_blocking=True)
        tiles.append(tile)
        offsets.append((y0, x0))
    region = _Region2D(mesh, global_h, global_w, local_h, local_w, pad_h, pad_w, tuple(offsets))
    return region, tiles


def _close_region_2d(region: _Region2D, tiles) -> torch.Tensor:
    """Gather and crop: the whole image on the first slot's device. Under a
    process group the rank that holds slot 0 receives every other rank's
    tiles and returns the whole image; the others return their own tiles,
    stacked in slot order."""
    mesh = region.mesh
    dev = mesh.devices[mesh.local_slots[0]]
    every = gather_slots(mesh, torch.stack([t.to(dev, non_blocking=True) for t in tiles]))
    if mesh.distributed and mesh.rank != mesh.ranks[0]:
        return every  # this rank's own tiles
    rows = [torch.cat(list(every[r * mesh.n_cols : (r + 1) * mesh.n_cols]), dim=1)
            for r in range(mesh.n_rows)]
    return torch.cat(rows, dim=0)[: region.global_h, : region.global_w]


def _apply_global_2d(region: _Region2D, op: GlobalOp, tiles):
    """One global-statistics op on every tile: each tile's histogram over
    its valid pixels (inside the image on both axes), summed over the local
    slots and, under a process group, across ranks, then applied to each
    tile."""
    mesh = region.mesh
    dev = mesh.devices[mesh.local_slots[0]]
    total = None
    for tile, (y0, x0) in zip(tiles, region.offsets):
        valid = None
        if y0 + tile.shape[0] > region.global_h or x0 + tile.shape[1] > region.global_w:
            rows = y0 + torch.arange(tile.shape[0], device=tile.device)
            cols = x0 + torch.arange(tile.shape[1], device=tile.device)
            valid = (rows < region.global_h)[:, None] & (cols < region.global_w)[None, :]
            valid = valid.view(valid.shape + (1,) * (tile.ndim - 2))
        counts = op.stats(tile, valid).to(dev)
        total = counts if total is None else total + counts
    if mesh.distributed:
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return [op.apply(t, total.to(t.device)) for t in tiles]


def _stencil_step(region: _Region2D, op: StencilOp, tiles, overlap: bool):
    """One stencil on every tile: the two-phase exchange, then the golden
    tile function; interior-first under `overlap` where `_overlap_ok_2d`
    admits it (the interiors run while both exchange phases are in flight,
    on a side stream of each card)."""
    gh, gw = region.global_h, region.global_w
    if not (overlap and _overlap_ok_2d(op, region.pad_h, region.pad_w, region.local_h,
                                       region.local_w)):
        exts = _extend_2d(op, tiles, region.offsets, gh, gw, region.mesh)
        return [_apply_stencil_2d(op, t, e, y0, x0, gh, gw)
                for t, e, (y0, x0) in zip(tiles, exts, region.offsets)]
    exts = _exchange_async(
        region, lambda: [_extend_2d(op, tiles, region.offsets, gh, gw, region.mesh)], tiles
    )
    interiors = [_interior_2d(op, t, y0, x0, gh, gw) for t, (y0, x0) in zip(tiles, region.offsets)]
    _join_exchange(region, exts)
    return [
        _apply_stencil_2d_overlap(op, t, e, i, y0, x0, gh, gw)
        for t, e, i, (y0, x0) in zip(tiles, exts[0], interiors, region.offsets)
    ]


def _run_segment_2d(ops, mesh: Mesh2D, img: torch.Tensor, halo_mode: str = "serial",
                    plan=None) -> torch.Tensor:
    """One 2-D sharded region: pad-to-multiple on both axes, scatter, the
    ops step by step on every local tile (per op, or per stage of `plan`),
    gather and crop."""
    region, tiles = _open_region_2d(ops, mesh, img)
    gh, gw = region.global_h, region.global_w
    overlap = halo_mode == "overlap"
    if plan is not None:
        for stage in plan.stages:
            if stage.kind == "global":
                tiles = _apply_global_2d(region, stage.ops[0], tiles)
            elif _plan_stage_fused_ok_2d(stage, region.pad_h, region.pad_w, region.local_h,
                                         region.local_w):
                tiles = _apply_stage_serial_2d(stage, tiles, region.offsets, gh, gw, mesh)
            else:
                # per-op fallback for this stage only (pad rows/cols, sub-halo
                # tiles): the golden contract the fused path is gated against
                for op in stage.ops:
                    if isinstance(op, PointwiseOp):
                        tiles = [op.fn(t) for t in tiles]
                    else:
                        tiles = _stencil_step(region, op, tiles, overlap=False)
        return _close_region_2d(region, tiles)
    for op in ops:
        if isinstance(op, PointwiseOp):
            tiles = [op.fn(t) for t in tiles]
        elif isinstance(op, GlobalOp):
            tiles = _apply_global_2d(region, op, tiles)
        else:
            tiles = _stencil_step(region, op, tiles, overlap)
    return _close_region_2d(region, tiles)


def sharded_pipeline_2d(pipe, mesh: Mesh2D, halo_mode: str = "serial", plan: str = "auto"):
    """`pipe` as a function that runs tile-sharded over a ('rows', 'cols')
    mesh (parallel/mesh.make_mesh_2d): a whole (H, W[, 3]) uint8 image
    (numpy array or tensor) in, the whole image out as a tensor on the
    first slot's device, byte-identical to the unsharded golden path. Under
    a process group the other ranks return their own tiles of the last
    region, stacked, or the whole image when the pipeline ends in a
    geometric op.

    Geometric (shape-changing) ops run on the whole image between sharded
    segments, as in the 1-D runner. `halo_mode='overlap'` computes each
    eligible stencil's interior while both exchange phases are in flight
    (`_stencil_step`); ineligible stencils (pad rows/cols, halo 0, tiny
    tiles) stay serial, output unchanged.

    `plan` engages the fusion planner's stage forms: a fused stage pays one
    two-phase corner-carrying exchange round (its grown halo, both axes)
    instead of one round per stencil op. The tile compute is the golden
    ops, so 'fused-pallas[-mxu]' run their (identical) stage partition
    through the same walker: the megakernel is the 1-D runner's. 'auto'
    resolves as under backend 'torch' and stays 'off' under
    halo_mode='overlap', whose per-op interior-first structure only an
    explicit plan request replaces (the stage forms then run serial). The
    plan is resolved once per image shape."""
    if halo_mode not in HALO_MODES:
        raise ValueError(f"unknown halo_mode {halo_mode!r}; known: {HALO_MODES}")
    if len(mesh.axis_names) != 2:
        raise ValueError(
            f"sharded_pipeline_2d needs a ('rows', 'cols') mesh, got {mesh.axis_names}"
        )
    check_plan(plan, "torch")
    device = mesh.devices[mesh.local_slots[0]]
    segments = _split_segments(pipe.ops)

    def build(img):
        plan_mode = resolve_plan_mode(pipe.ops, plan, backend="torch", width=img.shape[1],
                                      device=device)
        if plan_mode != "off" and halo_mode == "overlap" and plan in ("auto", None, ""):
            plan_mode = "off"  # the 1-D runner's rule
        seg_plans = [
            build_plan(ops, plan_mode) if plan_mode != "off" and kind == "sharded" else None
            for kind, ops in segments
        ]

        def run(img):
            everywhere = True  # every rank holds the whole image
            for (kind, ops), seg_plan in zip(segments, seg_plans):
                if kind == "whole":
                    img = _run_whole(ops[0], mesh, img, everywhere)
                    everywhere = True
                    continue
                everywhere = not mesh.distributed
                img = _run_segment_2d(ops, mesh, img, halo_mode, seg_plan)
            return img

        return run

    built = per_shape(build)

    def run(img) -> torch.Tensor:
        img = torch.as_tensor(img)
        if img.dtype != U8:
            raise TypeError(f"expected a uint8 image, got {img.dtype}")
        return built(img)

    return run

