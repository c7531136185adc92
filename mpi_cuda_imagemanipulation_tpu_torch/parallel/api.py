"""Sharded pipeline execution over a ('rows',) mesh. The counterpart of the
JAX package's ``parallel/api.py``.

Replaces the reference's entire distribution layer:

  MPI_Scatter row blocks (kern.cpp:55)   -> row blocks copied to the mesh's devices
  (missing) ghost-row exchange           -> ghost strips between neighbours (halo.py)
  MPI_Gather (kern.cpp:81-83)            -> blocks concatenated on the first device
  rows % size silently dropped (ku:117)  -> pad-to-multiple + crop (exact)
  per-slice seams (kernel.cu:83)         -> global-coordinate interior masks

Every op runs on its local tile with the op's own tile functions
(ops/spec.py) or the kernel that reproduces them, so sharded output is
byte-identical to the unsharded golden path.

Where the JAX package traces one tile function that every device runs
(``shard_map``), the port walks the ops once and applies each step to
every shard this process holds, in slot order: `tiles` is a list with one
tensor per local slot, each on its slot's device, and a shard's global row
offset `y0` is a plain int. Exchanges happen between the steps.

Backends: ``torch`` runs the golden ops per tile (the JAX package's
``xla``). ``cuda`` runs the hand-written kernels, where the JAX package's ``pallas`` runs Pallas
kernels: a ``[pointwise*, stencil]`` group is one K2g launch per shard, a
group on tiles with pad rows (or a halo-0 stencil) one K3 launch over the
materialised extended tile, a flushed pointwise run one K1 launch, and
under ``plan='fused-pallas'`` a fused stage one K4g launch
(``'fused-pallas-mxu'``: with every eligible stencil on K5, its
tensor-core arm). ``mxu`` runs every eligible stencil as the whole-op
banded products (``ops/mxu_kernels.mxu_valid``) on the materialised
extended tile, and every other op as ``cuda`` does; under plan 'pointwise'
or 'fused' its stages walk with those products, and under
'fused-pallas[-mxu]' a stage that takes no K4g launch runs as under plan
'off'. ``swar`` (every plan resolves to 'off') runs each
``[pre*, stencil, post*]`` group that ``_swar_group_ok`` admits on a gray
tile as one K6g, K7g or K8g launch per shard (ops/swar_kernels.py ghost
mode), and every other group as ``cuda`` does. ``auto`` is the JAX
package's measured choice (its ``parallel/api.py`` ``_resolve_backend``):
per stencil the banded products on the extended tile where
ops/mxu_kernels.use_mxu_for_stencil says so (a calibration record or
``MCIM_PREFER_MXU``, on a card), else the ``swar`` ghost path under
``MCIM_PREFER_SWAR`` (read once per built function), else the ``cuda``
paths; ``plan='auto'`` follows a plan record, so K4g runs behind a
recorded ``fused-pallas`` win. With no record and no switch ``auto`` runs
what ``cuda`` runs. The records are read once per image shape. On a CPU
tile each kernel wrapper takes its plain version.

Global-statistics ops (equalize, autocontrast, otsu) flush the pending
pointwise run, then each tile counts its histogram over its valid rows (a
row is valid when ``y0 + r < global_h``, so the pad rows of the last shard
never count). The counts are summed over this process's slots on the first
slot's device, then with ``torch.distributed.all_reduce(SUM)`` across ranks
under a process group: the counterpart of the JAX package's ``lax.psum``.
Integer counts, so the sum is exact, and every tile applies the same table.

Geometric ops cut the pipeline into segments (`_split_segments`). Each one
runs on the whole image on the first slot's device between two sharded
regions, and the next region is opened on the new shape (its own
``global_h``, ``local_h`` and pad rows). Under a process group the rank that
holds slot 0 applies it to the gathered image and broadcasts the shape, then
the bytes, so that every rank opens the next region from the same image.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.distributed as dist

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import (
    mxu_eligible,
    mxu_mode,
    mxu_valid,
    stage_arms,
    use_mxu_for_stencil,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import op_family
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    F32,
    U8,
    PointwiseOp,
    StencilOp,
    exact_f32,
    pad2d,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.swar_kernels import (
    _chain_fixes_zero,
    post_chain_end,
    prefer_swar,
    swar_any_eligible,
    swar_fusable,
    swar_stencil,
)
from mpi_cuda_imagemanipulation_tpu_torch.parallel.halo import (
    exchange_edge_strips,
    exchange_halo,
    exchange_halo_strips,
)
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import ROWS, Mesh
from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan, resolve_plan_mode
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import check_plan
from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import (
    run_stage_cuda_ext,
    stage_kernel_reject,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import acc_fns_for, walk_stage
from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import per_shape

# Halo execution modes for the sharded stencil runners. 'serial' exchanges
# ghost strips and only then runs each stencil group; 'overlap' computes the
# interior rows, which need no ghost data, while the strips are in flight (on
# a side CUDA stream), and starts the next group's exchange from the previous
# group's boundary outputs (cross-group prefetch). Output is byte-identical
# either way.
HALO_MODES = ("serial", "overlap")
BACKENDS = ("torch", "cuda", "mxu", "swar", "auto")


# --------------------------------------------------------------------------
# Global-edge fixups: index work on the device
# --------------------------------------------------------------------------


def _reflect101_index(g: torch.Tensor, size: int) -> torch.Tensor:
    """Map any (possibly out-of-range) global row index to its reflect-101
    source inside [0, size): ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ..."""
    a = g.abs()
    return (size - 1) - ((size - 1) - a).abs()


def _fix_edge_axis(
    ext: torch.Tensor, op: StencilOp, off: int, global_size: int, axis: int
) -> torch.Tensor:
    """Overwrite ghost/padding slices along `axis` whose global index falls
    outside the real image with the op's edge extension.

    Slices needing fixes are (a) the unsent halos on the first/last shard
    and (b) the pad-to-multiple slices at the global end. Sources are
    gathered from within this shard's extended tile; feasibility is checked
    by the segment runners. `off` is the global index of the tile's first
    slice, `op.halo` slices into `ext`."""
    ext_sz = ext.shape[axis]
    h = op.halo
    lo = off - h
    if lo >= 0 and lo + ext_sz <= global_size:
        return ext  # every slice lies inside the image
    g = lo + torch.arange(ext_sz, device=ext.device)
    outside = (g < 0) | (g >= global_size)
    bshape = [1] * ext.ndim
    bshape[axis] = ext_sz
    outside_b = outside.view(bshape)
    if op.edge_mode in ("interior", "zero"):
        # zero out-of-image slices; 'interior' never reads them (masked),
        # but zeroing keeps tile values identical to the golden zero-padded
        # path.
        return torch.where(outside_b, torch.zeros_like(ext), ext)
    if op.edge_mode == "reflect101":
        src_g = _reflect101_index(g, global_size)
    elif op.edge_mode == "edge":
        src_g = g.clamp(0, global_size - 1)
    else:  # pragma: no cover
        raise ValueError(f"unknown edge mode {op.edge_mode!r}")
    src_local = (src_g - lo).clamp(0, ext_sz - 1)
    gathered = ext.index_select(axis, src_local)
    return torch.where(outside_b, gathered, ext)


def _fix_edge_rows(ext: torch.Tensor, op: StencilOp, y0: int, global_h: int) -> torch.Tensor:
    """Row-axis form of _fix_edge_axis (the 1-D runner's call shape)."""
    return _fix_edge_axis(ext, op, y0, global_h, 0)


def _fix_edge_strips(
    top: torch.Tensor,
    bottom: torch.Tensor,
    tile: torch.Tensor,
    op: StencilOp,
    y0: int,
    global_h: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Strip-level global-edge fixup for the fused-ghost path.

    With no pad rows inside the tile (caller-gated) and local_h > halo, a
    strip is either fully inside the image (middle shards: the exchanged
    rows are already correct) or fully outside (first shard's top / last
    shard's bottom), so the fix replaces a whole strip by the op's edge
    extension synthesised from the tile's own rows."""
    h = op.halo
    local_h = tile.shape[0]
    mode = op.edge_mode

    def synth(at_top: bool) -> torch.Tensor:
        if mode in ("interior", "zero"):
            return torch.zeros_like(top)
        if mode == "reflect101":
            # global row -k reflects to row k; row H-1+k reflects to H-1-k
            rows = tile[1 : h + 1] if at_top else tile[local_h - 1 - h : local_h - 1]
            return rows.flip(0)
        if mode == "edge":
            row = tile[:1] if at_top else tile[local_h - 1 :]
            return row.expand(top.shape).contiguous()
        raise ValueError(f"unknown edge mode {mode!r}")  # pragma: no cover

    if y0 == 0:
        top = synth(True)
    if y0 + local_h == global_h:
        bottom = synth(False)
    return top, bottom


# --------------------------------------------------------------------------
# One sharded region: scatter, the shards' state, gather
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Region:
    """What the steps of one sharded region share: the mesh and backend,
    the decomposition, and each local shard's global row offset."""

    mesh: Mesh
    backend: str  # 'torch' | 'cuda' | 'mxu' | 'swar'
    halo_mode: str
    n: int
    local_h: int
    global_h: int
    global_w: int
    y0s: tuple[int, ...]
    # id(op) -> banded-product mode of each stencil on the whole-op route
    mxu_modes: dict = dataclasses.field(default_factory=dict)

    @property
    def padded(self) -> bool:
        return self.n * self.local_h != self.global_h


def _open_region(ops, mesh: Mesh, backend: str, halo_mode: str, img: torch.Tensor,
                 mxu_modes: dict | None = None):
    """Pad-to-multiple and scatter: returns the region and the local tiles.
    Fixes the reference's silent `rows / size` truncation (kernel.cu:117) by
    padding and cropping instead of dropping rows."""
    n = mesh.shape[ROWS]
    max_halo = max((op.halo for op in ops), default=0)
    global_h, global_w = img.shape[0], img.shape[1]
    padded_h = -(-global_h // n) * n
    pad = padded_h - global_h
    local_h = padded_h // n
    # Static feasibility of local edge fixups: every reflect/pad source row
    # must live on-shard.
    min_local = max(2 * pad + 1, pad + max_halo, max_halo)
    if local_h < min_local:
        raise ValueError(
            f"image height {global_h} over {n} shards gives {local_h} "
            f"rows/shard, below the minimum {min_local} for halo "
            f"{max_halo} and padding {pad}; use fewer shards"
        )
    tiles = []
    for slot in mesh.local_slots:
        dev = mesh.devices[slot]
        rows = img[slot * local_h : min((slot + 1) * local_h, global_h)]
        tile = rows.to(dev, non_blocking=True)
        if tile.shape[0] < local_h:  # the pad rows, zeros, in the last shard
            fill = torch.zeros(
                (local_h - tile.shape[0],) + tuple(tile.shape[1:]), dtype=U8, device=dev
            )
            tile = torch.cat([tile, fill], dim=0)
        tiles.append(tile.contiguous())
    region = _Region(
        mesh=mesh, backend=backend, halo_mode=halo_mode, n=n, local_h=local_h,
        global_h=global_h, global_w=global_w,
        y0s=tuple(slot * local_h for slot in mesh.local_slots), mxu_modes=mxu_modes or {},
    )
    return region, tiles


def gather_slots(mesh, local: torch.Tensor) -> torch.Tensor:
    """Under a process group, the blocks of every rank's slots on the rank
    that holds slot 0: `local` is this rank's slots' blocks, equal-sized,
    concatenated along axis 0 in slot order. The root receives the other
    ranks' blocks in slot order and returns them all concatenated; every
    other rank sends its own and returns them. Without a process group,
    `local` itself."""
    root = mesh.ranks[0]
    if not mesh.distributed:
        return local
    if mesh.rank != root:
        dist.send(local.contiguous(), dst=root)
        return local
    per_slot = local.shape[0] // len(mesh.local_slots)
    blocks = []
    for rank in dict.fromkeys(mesh.ranks):  # ranks in slot order
        if rank == root:
            blocks.append(local)
            continue
        buf = local.new_empty((mesh.ranks.count(rank) * per_slot,) + tuple(local.shape[1:]))
        dist.recv(buf, src=rank)
        blocks.append(buf)
    return torch.cat(blocks, dim=0)


def _close_region(region: _Region, tiles: list[torch.Tensor]) -> torch.Tensor:
    """Gather and crop: the whole image on the first slot's device. Under a
    process group the rank that holds slot 0 receives every other rank's
    block and returns the whole image; the other ranks return their own
    rows."""
    mesh = region.mesh
    dev = mesh.devices[mesh.local_slots[0]]
    rows = gather_slots(mesh, torch.cat([t.to(dev, non_blocking=True) for t in tiles], dim=0))
    if mesh.distributed and mesh.rank != mesh.ranks[0]:
        return rows  # this rank's own
    return rows[: region.global_h]


# --------------------------------------------------------------------------
# Exchanges off the compute stream (halo_mode='overlap')
# --------------------------------------------------------------------------


@functools.cache
def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The one side stream of a card, made once for the process: the
    caching allocator keeps a pool of blocks per stream, so a new stream per
    call would allocate its strips with cudaMalloc every time."""
    return torch.cuda.Stream(dev)


def _cuda_devices(region: _Region) -> list[torch.device]:
    mesh = region.mesh
    return list(dict.fromkeys(
        mesh.devices[s] for s in mesh.local_slots if mesh.devices[s].type == "cuda"
    ))


def _exchange_async(region: _Region, exchange, sources):
    """Run `exchange()` with a side stream current on every local CUDA
    device, after what the compute streams have enqueued so far: the strip
    copies then run beside the interior launches that follow on the compute
    streams. `_join_exchange` orders the compute streams after them.
    `sources` are the tensors the exchange reads; the allocator is told
    that the side streams use them. On the CPU the exchange simply runs
    now."""
    with contextlib.ExitStack() as stack:
        for dev in _cuda_devices(region):
            side = _side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            stack.enter_context(torch.cuda.stream(side))
        for t in sources:
            if t.device.type == "cuda":
                t.record_stream(_side_stream(t.device))
        return exchange()


def _join_exchange(region: _Region, strips) -> None:
    """Order every local compute stream after its side stream, and tell the
    allocator that the compute stream now uses the strips the side stream
    made."""
    for dev in _cuda_devices(region):
        torch.cuda.current_stream(dev).wait_stream(_side_stream(dev))
    for group in strips:
        for t in group:
            if t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(t.device))


# --------------------------------------------------------------------------
# Per-group execution
# --------------------------------------------------------------------------


def _apply_pointwise(region: _Region, chain, tile: torch.Tensor) -> torch.Tensor:
    """A pointwise chain on one tile: the golden ops under 'torch'; under
    'cuda', 'mxu' and 'swar' one K1 launch per kernel-safe run (lookup
    tables as gathers)."""
    if not chain:
        return tile
    if region.backend in ("cuda", "mxu", "swar"):
        return ck.pipeline_cuda(chain, tile)
    for p in chain:
        tile = p.fn(tile)
    return tile


def _apply_global(region: _Region, op, tiles):
    """One global-statistics op on every tile: each tile's histogram over
    its valid rows, summed over the local slots and, under a process group,
    across ranks, then applied to each tile. A tile with no pad rows counts
    unmasked (the same counts, without the mask's pass)."""
    mesh = region.mesh
    dev = mesh.devices[mesh.local_slots[0]]
    total = None
    for tile, y0 in zip(tiles, region.y0s):
        valid = None
        if y0 + tile.shape[0] > region.global_h:  # the last shard's pad rows
            rows = y0 + torch.arange(tile.shape[0], device=tile.device)
            valid = (rows < region.global_h).view((-1,) + (1,) * (tile.ndim - 1))
        counts = op.stats(tile, valid).to(dev)
        total = counts if total is None else total + counts
    if mesh.distributed:
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return [op.apply(t, total.to(t.device)) for t in tiles]


def _interior_box(op: StencilOp, rows: int, y0: int, global_h: int, global_w: int):
    """`op.interior_mask` over a `rows`-row, full-width tile at global row
    `y0`, as the box it is: the rows [r0, r1) and columns [c0, c1) the
    reference guard (kernel.cu:83) lets the stencil write."""
    o = op.halo
    r0 = min(max(o + 1 - y0, 0), rows)
    r1 = max(min(global_h - o - y0, rows), r0)
    c0 = min(o + 1, global_w)
    c1 = max(global_w - o, c0)
    return r0, r1, c0, c1


def _stencil_on_ext(
    op: StencilOp,
    ext: torch.Tensor,
    tile: torch.Tensor,
    y0: int,
    global_h: int,
    global_w: int,
    backend: str,
    mxu_mode: str | None = None,
) -> torch.Tensor:
    """Run one stencil over a (rows + 2h, W[, C]) pre-exchanged tile; `tile`
    holds the rows the output replaces and `y0` their global offset. With
    an `mxu_mode` (the region's route for the op) it takes the banded
    products in that mode; otherwise under every backend but 'torch' K3
    (under 'swar' too: the materialised tiles of pad rows and of the overlap
    structure have no SWAR form, as in the JAX package)."""
    h = op.halo
    if mxu_mode is None and backend != "torch":
        q = ck.stencil_tile(op, ext.contiguous())  # K3, every channel at once
        if op.edge_mode != "interior":
            return q
        # the interior mask, applied as copies of the (at most four) border
        # bands it passes through: a few launches, where building the mask
        # costs a dozen
        rows, width = q.shape[:2]
        r0, r1, c0, c1 = _interior_box(op, rows, y0, global_h, global_w)
        if r0 > 0:
            q[:r0] = tile[:r0]
        if r1 < rows:
            q[r1:] = tile[r1:]
        if c0 > 0:
            q[r0:r1, :c0] = tile[r0:r1, :c0]
        if c1 < width:
            q[r0:r1, c1:] = tile[r0:r1, c1:]
        return q

    acc_fn = functools.partial(mxu_valid, op, mode=mxu_mode) if mxu_mode else op.valid

    def plane(e: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        xpad = pad2d(e.to(F32), op.edge_mode, 0, 0, h, h)  # width halo is local
        return op.finalize(acc_fn(xpad), t, y0, 0, global_h, global_w)

    if ext.ndim == 3:  # colour: filter each channel plane independently
        return torch.stack(
            [plane(ext[..., c], tile[..., c]) for c in range(ext.shape[2])], dim=-1
        )
    # the banded products can leave a plane column-major, which the K1
    # launch of the next pointwise run refuses
    return plane(ext, tile).contiguous()


def _apply_stencil(region: _Region, op: StencilOp, tiles):
    """Materialised-ext stencil path (pad-to-multiple tiles, halo-0 ops and
    the 'torch' backend). The fast path under 'cuda' is the fused-ghost
    group in _apply_group_fused, selected by the group walker."""
    exts = exchange_halo(tiles, op.halo, region.mesh)
    return [
        _stencil_on_ext(
            op, _fix_edge_rows(ext, op, y0, region.global_h), tile, y0,
            region.global_h, region.global_w, region.backend, region.mxu_modes.get(id(op)),
        )
        for ext, tile, y0 in zip(exts, tiles, region.y0s)
    ]


def _apply_group_fused(region: _Region, pointwise, stencil: StencilOp, tiles):
    """Run one [pointwise*, stencil] group as a single K2g launch per shard:
    the raw pre-pointwise tile streams through the kernel once, the (halo,
    W) ghost strips ride along raw (pointwise ops are per-pixel, so they
    commute with strip selection and are applied to the strips inside the
    kernel), and no intermediate pointwise output reaches device memory.

    Edge synthesis on the raw tile is exact for reflect101/edge (row
    selections commute with per-pixel ops). For interior mode the strip
    values on the first/last shard never reach an unmasked output, so the
    raw zeros are fine (the mask passes those outputs through)."""
    tops, bottoms = exchange_halo_strips(tiles, stencil.halo, region.mesh)
    out = []
    for tile, top, bottom, y0 in zip(tiles, tops, bottoms, region.y0s):
        top, bottom = _fix_edge_strips(top, bottom, tile, stencil, y0, region.global_h)
        out.append(ck.stream_stencil_ghost(
            list(pointwise), stencil, tile, top.contiguous(), bottom.contiguous(),
            y0=y0, image_h=region.global_h, image_w=region.global_w,
        ))
    return out


def _swar_group_ok(region: _Region, pointwise, op: StencilOp, tiles) -> bool:
    """Whether one [pointwise*, stencil] group can take the SWAR ghost path
    on these tiles: a single u8 plane the op is shape-eligible on, no pad
    rows inside the tile (strip edge synthesis is whole-strip), every
    buffered pointwise op fits an exact affine chain, and (zero mode only)
    the composed chain fixes 0, so that chain and padding commute."""
    return (
        tiles[0].ndim == 2
        and not region.padded
        and region.local_h > op.halo
        and swar_any_eligible(op, (region.local_h, tiles[0].shape[1]))
        and all(swar_fusable(p) is not None for p in pointwise)
        and (op.edge_mode != "zero" or _chain_fixes_zero(pointwise))
    )


def _apply_group_swar(region: _Region, pointwise, stencil: StencilOp, tiles, post=()):
    """Run one [pointwise*, stencil, pointwise*] group as a single SWAR
    ghost-mode launch per shard (K6g, K7g or K8g): the ghost strips are
    exchanged raw (per-pixel chains commute with strip selection), and the
    fitted chains run inside the kernel, on the strips too, so the shard's
    tile streams exactly as the unsharded SWAR path does, post-chain
    included. The caller gates with _swar_group_ok."""
    tops, bottoms = exchange_halo_strips(tiles, stencil.halo, region.mesh)
    out = []
    for tile, top, bottom, y0 in zip(tiles, tops, bottoms, region.y0s):
        top, bottom = _fix_edge_strips(top, bottom, tile, stencil, y0, region.global_h)
        out.append(swar_stencil(
            stencil, tile, pre_ops=tuple(pointwise), post_ops=tuple(post),
            ghosts=(top.contiguous(), bottom.contiguous()), y0=y0,
            global_h=region.global_h,
        ))
    return out


def _overlap_ok(op, n: int, local_h: int, global_h: int) -> bool:
    """Whether one stencil group can take the interior-first overlap path:
    a real halo (halo-0 groups have no exchange to hide), no pad rows
    inside the tile (strip-level edge synthesis is whole-strip, the same
    gate as the fused-ghost path), and a non-empty interior. Static, so
    the walker and the cross-group prefetch lookahead always agree."""
    return (
        isinstance(op, StencilOp)
        and op.halo >= 1
        and n * local_h == global_h
        and local_h > 2 * op.halo
    )


def _piece_edge_rows(pieces, k: int):
    """First/last `k` rows of a stitched (top, interior, bottom) piece list
    without concatenating the tile first: slices are taken from the
    individual pieces, so the next group's exchange payload depends only on
    the pieces that hold edge rows (for k <= halo just the boundary
    strips), never on the whole interior computation."""
    first, need = [], k
    for p in pieces:
        take = min(need, p.shape[0])
        if take:
            first.append(p[:take])
            need -= take
        if not need:
            break
    last, need = [], k
    for p in reversed(pieces):
        take = min(need, p.shape[0])
        if take:
            last.insert(0, p[p.shape[0] - take :])
            need -= take
        if not need:
            break

    def cat(xs):
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=0)

    return cat(first), cat(last)


def _next_stencil_group(ops, i: int):
    """(next stencil op, intervening pointwise chain) looking forward from
    ops[i], or (None, []) when anything but a PointwiseOp intervenes."""
    chain: list = []
    for op in ops[i:]:
        if isinstance(op, PointwiseOp):
            chain.append(op)
        elif isinstance(op, StencilOp):
            return op, chain
        else:
            return None, []
    return None, []


def _apply_stencil_overlap(region: _Region, op: StencilOp, tiles, strips):
    """Interior-first execution of one stencil group.

    The interior rows, everything a halo-h stencil can produce from the
    local tile alone, are computed with no dependence on the ghost strips,
    which are still in flight on the side streams; only the two h-row
    boundary bands wait for them. Stitching top/interior/bottom with
    per-slice global row offsets reproduces the serial path's windows
    exactly, so output stays byte-identical. Under 'cuda' the interior and
    the (3h, W) bands each run K3.

    Returns, per shard, the (top, interior, bottom) pieces unconcatenated so
    the caller can slice the next group's prefetch payload from the
    boundary pieces alone (_piece_edge_rows)."""
    h = op.halo
    gh, gw, be = region.global_h, region.global_w, region.backend
    mode = region.mxu_modes.get(id(op))
    interiors = [
        _stencil_on_ext(op, tile, tile[h : tile.shape[0] - h], y0 + h, gh, gw, be, mode)
        for tile, y0 in zip(tiles, region.y0s)
    ]
    _join_exchange(region, strips)
    pieces = []
    for tile, top, bottom, y0, interior in zip(tiles, *strips, region.y0s, interiors):
        local_h = tile.shape[0]
        top, bottom = _fix_edge_strips(top, bottom, tile, op, y0, gh)
        top_out = _stencil_on_ext(
            op, torch.cat([top, tile[: 2 * h]], dim=0), tile[:h], y0, gh, gw, be, mode
        )
        bottom_out = _stencil_on_ext(
            op, torch.cat([tile[local_h - 2 * h :], bottom], dim=0),
            tile[local_h - h :], y0 + local_h - h, gh, gw, be, mode,
        )
        pieces.append((top_out, interior, bottom_out))
    return pieces


def _walk_groups(region: _Region, ops, tiles):
    """The per-group walk over one region's ops: kernel-safe pointwise ops
    buffer until the next op decides their fate, fused into a ghost-mode
    stencil group (one pass over device memory for the whole [pointwise*,
    stencil] chain) or flushed as one pointwise pass."""
    n, local_h, global_h = region.n, region.local_h, region.global_h
    pending: list[PointwiseOp] = []

    def flush(ts):
        chain = list(pending)
        pending.clear()
        return [_apply_pointwise(region, chain, t) for t in ts]

    i = 0
    # ghost strips already in flight for the next overlap group: (tops,
    # bottoms, halo) started from the previous group's boundary outputs
    prefetch = None
    while i < len(ops):
        op = ops[i]
        i += 1
        fam = op_family(op)
        if fam == "pointwise":
            if op.kernel_safe:
                pending.append(op)
            else:
                tiles = [op.fn(t) for t in flush(tiles)]
            continue
        if fam == "global-stat":
            tiles = _apply_global(region, op, flush(tiles))
            continue
        # Interior-first overlapped halo path: eligible stencil groups
        # compute their interior while the ghost strips are in flight;
        # boundary strips stitch once they land. Takes priority over the
        # fused serial path: the knob is an explicit request for this
        # execution structure.
        if region.halo_mode == "overlap" and _overlap_ok(op, n, local_h, global_h):
            tiles = flush(tiles)
            if prefetch is not None and prefetch[2] == op.halo:
                strips = (prefetch[0], prefetch[1])
            else:
                strips = _exchange_async(
                    region, lambda: exchange_halo_strips(tiles, op.halo, region.mesh), tiles
                )
            prefetch = None
            pieces = _apply_stencil_overlap(region, op, tiles, strips)
            nxt, chain = _next_stencil_group(ops, i)
            if nxt is not None and _overlap_ok(nxt, n, local_h, global_h):
                # start the next group's exchange now, from this group's
                # boundary pieces (pointwise chains commute with row
                # slicing, so applying them to the edge rows alone matches
                # slicing the post-chain tile)
                edges = [_piece_edge_rows(p, nxt.halo) for p in pieces]
                firsts = [_apply_pointwise(region, chain, f) for f, _ in edges]
                lasts = [_apply_pointwise(region, chain, l) for _, l in edges]
                pre = _exchange_async(
                    region, lambda: exchange_edge_strips(firsts, lasts, region.mesh),
                    firsts + lasts,
                )
                prefetch = (pre[0], pre[1], nxt.halo)
            tiles = [torch.cat(p, dim=0) for p in pieces]
            continue
        # SWAR ghost path: an eligible group runs as one K6g/K7g/K8g launch
        # per shard, with its post-chain as pipeline_swar takes it, unless
        # the op's route is the banded products (auto checks those first).
        # Other groups fall through to the 'cuda' paths below.
        banded = id(op) in region.mxu_modes
        if (region.backend == "swar" and not banded
                and _swar_group_ok(region, pending, op, tiles)):
            group = list(pending)
            pending.clear()
            end = post_chain_end(ops, i)
            tiles = _apply_group_swar(region, group, op, tiles, ops[i:end])
            i = end
            continue
        # Fused-ghost fast path: no pad rows inside the tile
        # (pad-to-multiple needs position-dependent edge fixes), halo >= 1,
        # a mode the streaming kernel supports, and enough local rows for
        # strip synthesis. Not for an op on the banded products.
        kernel_group = region.backend != "torch" and not banded
        fusible = (
            kernel_group
            and op.halo >= 1
            and op.edge_mode != "zero"  # K2g rejects zero mode
            and not region.padded
            and local_h > op.halo
        )
        if fusible:
            group = list(pending)
            pending.clear()
            tiles = _apply_group_fused(region, group, op, tiles)
        else:
            tiles = _apply_stencil(region, op, flush(tiles))
    return flush(tiles)


# --------------------------------------------------------------------------
# Plan-fused segment execution (plan/): temporally blocked stages
# --------------------------------------------------------------------------


def _plan_stage_fused_ok(stage, n: int, local_h: int, global_h: int, overlap: bool) -> bool:
    """Whether one fused stage can run temporally blocked on this
    decomposition: a real stage halo, no pad-to-multiple rows inside the
    tile (the per-op edge fix gathers only from real rows, the same gate as
    the fused-ghost and overlap paths), and enough local rows to slice the
    stage-halo strips (overlap additionally needs a non-empty interior
    after consuming 2H context rows). Static, so the fallback decision is
    identical on every shard."""
    H = stage.halo
    if H < 1 or n * local_h != global_h:
        return H == 0  # halo-0 stages always "fuse" (no exchange at all)
    if overlap:
        return local_h > 2 * H
    return local_h > H


def _plan_walk(stage, ext: torch.Tensor, y_lo: int, global_h: int, global_w: int,
               acc_fns=None):
    """One fused stage over a materialised extended tile: the shared stage
    walker (plan/exec.walk_stage) with the sharded edge convention. Context
    rows are always present (the stage's single exchange), and out-of-image
    rows are rewritten per op by _fix_edge_axis before that op reads them,
    so unsent strips and global-edge extension resolve exactly as the
    per-op serial path's fixups do, one op at a time. `acc_fns`
    (plan/exec.acc_fns_for) routes each stencil's accumulator."""

    def fix(cur, op, row_lo):
        return _fix_edge_axis(cur, op, row_lo + op.halo, global_h, 0)

    cur, _, _, _ = walk_stage(
        stage.ops, exact_f32(ext), y_lo=y_lo, lead_rem=stage.halo,
        tail_rem=stage.halo, global_h=global_h, global_w=global_w, acc_fns=acc_fns,
        edge_fix=fix,
    )
    return cur.to(U8)


def _apply_stage_serial(region: _Region, stage, tiles, acc_fns=None):
    """Temporally blocked serial execution of one fused stage: one ghost
    strip pair sized to the stage's grown halo (`Stage.halo`, the
    chain_halo of the member stencils), then the whole stage walks the
    extended tile. Where the per-op serial path pays one exchange per
    stencil, a fused stage pays one in all."""
    H = stage.halo
    gh, gw = region.global_h, region.global_w
    if H == 0:
        return [_plan_walk(stage, t, y0, gh, gw, acc_fns) for t, y0 in zip(tiles, region.y0s)]
    exts = exchange_halo(tiles, H, region.mesh)
    return [_plan_walk(stage, e, y0 - H, gh, gw, acc_fns) for e, y0 in zip(exts, region.y0s)]


def _apply_stage_overlap(region: _Region, stage, tiles, acc_fns=None):
    """Stage-granular interior-first execution: the stage's single exchange
    is started first, the interior (every output row the local tile can
    produce alone, all but H per side) walks the stage with no dependence
    on the strips, and two 3H-row boundary bands stitch once they land.
    Output is byte-identical to the serial stage (the walker is the same;
    only the region decomposition differs)."""
    H = stage.halo
    gh, gw = region.global_h, region.global_w
    strips = _exchange_async(
        region, lambda: exchange_halo_strips(tiles, H, region.mesh), tiles
    )
    interiors = [
        _plan_walk(stage, t, y0, gh, gw, acc_fns) for t, y0 in zip(tiles, region.y0s)
    ]
    _join_exchange(region, strips)
    out = []
    for tile, top, bottom, y0, interior in zip(tiles, *strips, region.y0s, interiors):
        local_h = tile.shape[0]
        top_out = _plan_walk(
            stage, torch.cat([top, tile[: 2 * H]], dim=0), y0 - H, gh, gw, acc_fns
        )
        bottom_out = _plan_walk(
            stage, torch.cat([tile[local_h - 2 * H :], bottom], dim=0),
            y0 + local_h - 2 * H, gh, gw, acc_fns,
        )
        out.append(torch.cat([top_out, interior, bottom_out], dim=0))
    return out


def _apply_stage_megakernel(region: _Region, stage, tiles, arms):
    """Fused-pallas execution of one stage on every shard: the stage's one
    ghost strip pair (the same wire structure as _apply_stage_serial), then
    one K4g launch per shard over the pre-exchanged tile, with every
    member-op intermediate in shared memory and each stencil on its
    in-stage arm. Strips ride raw: the unsent rows on the edge shards are
    rewritten per op inside the kernel, keyed on the shard's `y0`."""
    exts = exchange_halo(tiles, stage.halo, region.mesh)
    return [
        run_stage_cuda_ext(
            stage, ext, y0=y0, image_h=region.global_h, image_w=region.global_w, arms=arms
        )
        for ext, y0 in zip(exts, region.y0s)
    ]


def _run_segment_planned(
    plan, mesh: Mesh, backend: str, img, halo_mode: str, mega: bool,
    mxu_stage: str | None = None, arms: dict | None = None, mxu_modes: dict | None = None,
):
    """One sharded region executed stage by stage from a fused plan.

    Under 'torch', stages the decomposition gate rejects (pad rows in the
    tile, sub-halo tiles) fall back to per-op execution inside the same
    region, so the output contract is unchanged. `mega` (plan mode
    'fused-pallas[-mxu]' under 'cuda' and 'mxu') routes eligible fused
    stages through K4g, one launch consuming the stage's single
    pre-exchanged halo, each stencil on the in-stage arm `mxu_stage` sets;
    `arms` caches each stage's arms, resolved at its first K4g launch. A
    stage K4g rejects, or that fails the decomposition gate, is counted by
    reason and runs through the per-group walk, and so do halo-0 stages,
    uncounted, and every stage under halo_mode='overlap': K2g (or K3 on pad
    tiles and in the overlap structure), K1 for pointwise runs, and under
    'mxu' the banded products for each eligible stencil. No stage of a
    `mega` run walks in plain ops on the card.

    K4g's eligibility is asked with the channels each stage reads, which
    after a `grayscale` in an earlier stage is 1. The JAX runner asks with
    the image's channels for every stage; that deviation is deliberate (the
    shared-memory budget depends on the stage's real input), and it can
    change only the `plan_metrics` counts of a later stage, never a byte."""
    # feasibility bounds come from the per-op fallback: a stage whose grown
    # halo outsizes the tile falls back to per-op execution instead of
    # failing the build
    region, tiles = _open_region(plan.ops, mesh, backend, halo_mode, img, mxu_modes)
    n, local_h, global_h = region.n, region.local_h, region.global_h
    overlap = halo_mode == "overlap"
    # static per-stage K4g eligibility (identical on every shard): the
    # decomposition gate at overlap strength (local_h > 2H, the in-kernel
    # edge synthesis bound) plus the kernel's own eligibility
    mega_stages: set[int] = set()
    if mega and not overlap:
        ch = img.shape[2] if img.ndim == 3 else 1  # channels the stage reads
        for si, stage in enumerate(plan.stages):
            ch_in = ch
            for op in stage.ops:
                ch = op.out_channels or ch
            if stage.kind != "fused" or stage.halo < 1:
                continue
            if not _plan_stage_fused_ok(stage, n, local_h, global_h, overlap=True):
                plan_metrics.pallas_fallbacks["image-too-small"] += 1
                continue
            reason = stage_kernel_reject(stage, local_h, region.global_w, ch_in)
            if reason is None:
                plan_metrics.pallas_stages += 1
                mega_stages.add(si)
            else:
                plan_metrics.pallas_fallbacks[reason] += 1

    impl = "mxu" if backend == "mxu" else "torch"
    arms = {} if arms is None else arms
    for si, stage in enumerate(plan.stages):
        if stage.kind == "global":
            tiles = _apply_global(region, stage.ops[0], tiles)
        elif si in mega_stages:
            if si not in arms:
                arms[si] = stage_arms(stage.ops, mxu_stage, region.global_w,
                                      device=tiles[0].device)
            tiles = _apply_stage_megakernel(region, stage, tiles, arms[si])
        elif mega:
            tiles = _walk_groups(region, stage.ops, tiles)
        elif _plan_stage_fused_ok(stage, n, local_h, global_h, overlap):
            walk_arms = None
            if backend == "torch" and mxu_stage is not None:  # K5's plain version
                if si not in arms:
                    arms[si] = stage_arms(stage.ops, mxu_stage, region.global_w,
                                          device=tiles[0].device)
                walk_arms = arms[si]
            acc_fns = acc_fns_for(stage.ops, impl, walk_arms)
            if overlap and stage.halo >= 1:
                tiles = _apply_stage_overlap(region, stage, tiles, acc_fns)
            else:
                tiles = _apply_stage_serial(region, stage, tiles, acc_fns)
        else:
            # fallback: per-op execution for this stage only (the golden
            # contract the fused path is gated against)
            for op in stage.ops:
                if isinstance(op, PointwiseOp):
                    tiles = [op.fn(t) for t in tiles]
                else:
                    tiles = _apply_stencil(region, op, tiles)
    return _close_region(region, tiles)


def _split_segments(ops):
    """Partition an op sequence into sharded segments separated by
    geometric (shape-changing) steps.

    Pointwise, stencil and global ops run on local tiles (stencils with
    ghost exchanges, global ops with an all-reduce of their masked
    statistics). Geometric ops are pure data movement with data-dependent
    output shapes; they run between segments on the whole image."""
    segments: list[tuple[str, tuple]] = []
    cur: list = []
    for op in ops:
        if op_family(op) == "geometric":
            if cur:
                segments.append(("sharded", tuple(cur)))
                cur = []
            segments.append(("whole", (op,)))
        else:
            cur.append(op)
    if cur:
        segments.append(("sharded", tuple(cur)))
    return segments


def _run_whole(op, mesh: Mesh, img: torch.Tensor, everywhere: bool) -> torch.Tensor:
    """One geometric op on the whole image, on the first slot's device (a
    numpy input lands there first: no CPU detour beside a card).
    `everywhere` says that every rank holds the whole image (the pipeline's
    input, or an earlier whole segment's result); otherwise, under a process
    group, only the rank that holds slot 0 does (`_close_region`), and it
    applies the op and broadcasts the result's shape, then its bytes."""
    dev = mesh.devices[mesh.local_slots[0]]
    img = img.to(dev)
    if not mesh.distributed or everywhere:
        return op(img)
    root = mesh.ranks[0]
    shape = torch.zeros(4, dtype=torch.int64, device=dev)  # (ndim, H, W, C)
    if mesh.rank == root:
        out = op(img)
        shape[: out.ndim + 1] = torch.tensor((out.ndim,) + tuple(out.shape))
    dist.broadcast(shape, src=root)
    if mesh.rank != root:
        ndim, *dims = shape.tolist()
        out = torch.empty(dims[:ndim], dtype=U8, device=dev)
    dist.broadcast(out, src=root)
    return out


def _run_segment(ops, mesh: Mesh, backend: str, img, halo_mode: str = "serial",
                 mxu_modes: dict | None = None):
    """One sharded region: pad-to-multiple, halo-exchanged local compute,
    crop."""
    region, tiles = _open_region(ops, mesh, backend, halo_mode, img, mxu_modes)
    return _close_region(region, _walk_groups(region, ops, tiles))


def sharded_pipeline(
    pipe, mesh: Mesh, backend: str = "cuda", halo_mode: str = "serial", plan: str = "auto"
):
    """`pipe` as a function that runs row-sharded over `mesh` with halo
    exchange: a whole (H, W[, 3]) uint8 image (numpy array or tensor) in,
    the whole image out as a tensor on the first slot's device,
    byte-identical to the unsharded golden path. Under a process group the
    other ranks return their own rows of the last region, or the whole
    image when the pipeline ends in a geometric op.

    `halo_mode='overlap'` restructures each eligible stencil group so the
    interior rows compute while the ghost strips are in flight (see
    HALO_MODES); groups the overlap gate rejects (halo 0, pad rows,
    sub-2*halo tiles) take the serial paths, so the output contract is
    unchanged.

    `plan` engages the fusion planner (plan/): a fused plan exchanges one
    stage-halo ghost-strip pair per fused stage, temporal blocking over the
    wire, instead of one per stencil op. 'auto' resolves as
    plan/planner.resolve_plan_mode says (MCIM_PLAN, a plan record, then
    'fused' under 'torch' and 'mxu', 'off' under 'cuda' and 'auto'; every
    plan is 'off' under 'swar') and stays 'off' under
    halo_mode='overlap', whose per-group prefetch structure only an
    explicit plan request restructures. Under 'fused-pallas-mxu' each
    stencil's in-stage arm is forced on (K5 under 'cuda' and 'mxu', its
    plain version in the walker under 'torch'), under 'fused-pallas' it
    follows MCIM_MXU_STAGE (by default a stage_arm record on a card); a
    stage's arms are resolved, and counted in `plan_metrics`, once per
    built function and image shape, at the stage's first launch."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if halo_mode not in HALO_MODES:
        raise ValueError(f"unknown halo_mode {halo_mode!r}; known: {HALO_MODES}")
    check_plan(plan, backend)  # a refused plan raises here
    region_backend = backend
    if backend == "auto":  # MCIM_PREFER_SWAR, read once per built function
        region_backend = "swar" if prefer_swar() else "cuda"
    device = mesh.devices[mesh.local_slots[0]]
    segments = _split_segments(pipe.ops)

    def build(img):
        """Everything that reads the environment or the store, for images
        of this shape: the plan mode, the segments' plans, each stencil's
        banded-product route."""
        width = img.shape[1]
        plan_mode = resolve_plan_mode(pipe.ops, plan, backend=backend, width=width,
                                      device=device)
        if plan_mode != "off" and halo_mode == "overlap" and plan in ("auto", None, ""):
            plan_mode = "off"
        seg_plans = [
            build_plan(ops, plan_mode) if plan_mode != "off" and kind == "sharded" else None
            for kind, ops in segments
        ]
        mega = plan_mode in ("fused-pallas", "fused-pallas-mxu") and backend != "torch"
        mxu_stage = "on" if plan_mode == "fused-pallas-mxu" else None
        seg_arms = [{} for _ in segments]  # per segment: stage index -> arms
        if backend == "mxu":
            mode = mxu_mode()
            mxu_modes = {id(op): mode for op in pipe.ops if mxu_eligible(op)}
        elif backend == "auto":
            mxu_modes = {id(op): m for op in pipe.ops
                         if (m := use_mxu_for_stencil(op, width, device)) is not None}
        else:
            mxu_modes = {}

        def run(img) -> torch.Tensor:
            everywhere = True  # every rank holds the whole image
            for (kind, ops), seg_plan, arms in zip(segments, seg_plans, seg_arms):
                if kind == "whole":
                    img = _run_whole(ops[0], mesh, img, everywhere)
                    everywhere = True
                    continue
                everywhere = not mesh.distributed
                if seg_plan is None:
                    img = _run_segment(ops, mesh, region_backend, img, halo_mode, mxu_modes)
                else:
                    img = _run_segment_planned(
                        seg_plan, mesh, region_backend, img, halo_mode, mega, mxu_stage, arms,
                        mxu_modes,
                    )
            return img

        return run

    built = per_shape(build)

    def run(img) -> torch.Tensor:
        img = torch.as_tensor(img)
        if img.dtype != U8:
            raise TypeError(f"expected a uint8 image, got {img.dtype}")
        return built(img)

    return run
