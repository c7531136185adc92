"""Ghost-strip halo exchange over the ('rows',) mesh, and along both axes
of a ('rows', 'cols') mesh. The counterpart of the JAX package's
``parallel/halo.py``.

This is the component the reference lacks: its MPI row-scatter runs
stencils on each slice independently, producing visible seams every H/N
rows (kernel.cu:83 guard skips slice-edge rows). Here every stencil tile
is extended with real neighbour rows before the stencil runs, so the
sharded result equals the unsharded result byte for byte.

Every function takes the shards this process holds as a list of tiles,
one per local slot of the mesh in slot order, and returns lists of the
same length. A neighbour slot in the same process is a device-to-device
copy on the current streams; a neighbour on another rank is a
``torch.distributed`` point-to-point transfer. The JAX ring wraps around
(XLA needs a bijection) and its callers overwrite the wrapped strips; the
port sends nothing there: the leading strip of a shard with no
predecessor along the axis, and the trailing strip of one with no
successor, are zeros, which the callers overwrite the same way
(``parallel.api._fix_edge_strips`` / ``_fix_edge_axis``).

`host_edge_strips` and `stitch_tile` are the same strip logic on host
numpy arrays, across the row bands of the streaming tile engine (stream/)
instead of across shards.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import COLS, ROWS, Mesh, Mesh2D


class ExchangeCounts:
    """How often strips crossed shard boundaries: `rounds` counts the calls
    that exchanged (one pair of strips over every boundary of one mesh
    axis, the counterpart of one ppermute pair in the JAX program), and
    `axis_rounds` the same per axis: a 2-D stencil's two-phase exchange is
    one round on 'rows' and one on 'cols'. Calls along an axis of one slot
    exchange nothing and count nothing."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.rounds = 0
        self.axis_rounds = {ROWS: 0, COLS: 0}


exchanges = ExchangeCounts()


def _copy_to(strip: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of `strip` on `device`, enqueued on the current streams of
    both devices (PyTorch orders a cross-device copy after the producer on
    the source's stream and before later work on the target's)."""
    return strip.to(device, non_blocking=True, copy=True)


def _boundaries(mesh: Mesh | Mesh2D, axis_name: str) -> list[tuple[int, int]]:
    """The (before, after) slot pairs that share a boundary along
    `axis_name`, in one order every rank enumerates alike: the 1-D mesh's
    consecutive slots; on a 2-D mesh, (r, c) above (r + 1, c) along 'rows'
    and (r, c) left of (r, c + 1) along 'cols'."""
    if isinstance(mesh, Mesh):
        if axis_name != ROWS:
            raise ValueError(f"a 1-D mesh has no {axis_name!r} axis")
        return [(k, k + 1) for k in range(mesh.shape[ROWS] - 1)]
    nr, nc = mesh.n_rows, mesh.n_cols
    if axis_name == ROWS:
        return [(r * nc + c, (r + 1) * nc + c) for r in range(nr - 1) for c in range(nc)]
    if axis_name == COLS:
        return [(r * nc + c, r * nc + c + 1) for r in range(nr) for c in range(nc - 1)]
    raise ValueError(f"unknown mesh axis {axis_name!r}")


def exchange_edge_strips(
    firsts: list[torch.Tensor], lasts: list[torch.Tensor], mesh: Mesh | Mesh2D,
    axis_name: str = ROWS,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Exchange pre-sliced edge strips along `axis_name`: `firsts[i]` /
    `lasts[i]` are the leading / trailing `halo` rows (or columns, along
    'cols') of local shard i, already cut out by the caller. Returns
    (befores, afters): for each local shard, its predecessor's trailing
    strip and its successor's leading strip along the axis; a shard with no
    predecessor (successor) gets zeros there.

    This is the primitive under exchange_halo_strips, exposed so the
    overlapped-halo runner can exchange a derived strip (the next stencil
    group's edge rows assembled from the previous group's boundary
    outputs) without waiting for a whole tile.

    Transfers between ranks are posted boundary by boundary in the order
    of `_boundaries`, on each boundary the forward strip before the
    backward one, so every rank posts its sends and receives in the same
    order."""
    slots = mesh.local_slots
    pos = {s: i for i, s in enumerate(slots)}
    befores: list = [None] * len(slots)
    afters: list = [None] * len(slots)
    p2p = []
    pairs = _boundaries(mesh, axis_name)
    for upper, lower in pairs:
        if upper in pos and lower in pos:
            befores[pos[lower]] = _copy_to(lasts[pos[upper]], mesh.devices[lower])
            afters[pos[upper]] = _copy_to(firsts[pos[lower]], mesh.devices[upper])
        elif upper in pos:
            i, peer = pos[upper], mesh.ranks[lower]
            afters[i] = torch.empty_like(firsts[i], memory_format=torch.contiguous_format)
            p2p.append(dist.P2POp(dist.isend, lasts[i].contiguous(), peer))
            p2p.append(dist.P2POp(dist.irecv, afters[i], peer))
        elif lower in pos:
            i, peer = pos[lower], mesh.ranks[upper]
            befores[i] = torch.empty_like(lasts[i], memory_format=torch.contiguous_format)
            p2p.append(dist.P2POp(dist.irecv, befores[i], peer))
            p2p.append(dist.P2POp(dist.isend, firsts[i].contiguous(), peer))
    if p2p:
        for work in dist.batch_isend_irecv(p2p):
            work.wait()
    for i in range(len(slots)):  # the mesh's edges along the axis
        if befores[i] is None:
            befores[i] = torch.zeros_like(lasts[i])
        if afters[i] is None:
            afters[i] = torch.zeros_like(firsts[i])
    if pairs:
        exchanges.rounds += 1
        exchanges.axis_rounds[axis_name] += 1
    return befores, afters


def exchange_halo_strips(
    tiles: list[torch.Tensor], halo: int, mesh: Mesh | Mesh2D, axis: int = 0
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The (before, after) ghost strips of every local tile, each `halo`
    rows (axis 0, over the 'rows' ring) or columns (axis 1, over the 'cols'
    ring of a 2-D mesh) thick: each shard's last rows go to its successor
    (becoming that neighbour's leading halo) and its first rows to its
    predecessor. The mesh's first leading and last trailing strips are
    zeros; callers overwrite them with the op's edge extension."""
    firsts = [t.narrow(axis, 0, halo) for t in tiles]
    lasts = [t.narrow(axis, t.shape[axis] - halo, halo) for t in tiles]
    return exchange_edge_strips(firsts, lasts, mesh, (ROWS, COLS)[axis])


def exchange_halo(tiles: list[torch.Tensor], halo: int, mesh: Mesh | Mesh2D,
                  axis: int = 0) -> list[torch.Tensor]:
    """Every local tile extended with `halo` ghost rows (axis 0) or
    columns (axis 1) on both sides (see exchange_halo_strips; this
    materialises the concatenated tile for the paths that run over an
    extended tile). The 2-D runner's two-phase, corner-carrying order is
    axis 0 first, then axis 1 over the row-extended tiles, so corner ghosts
    arrive through the shared neighbour with no diagonal copy."""
    if halo == 0:
        return list(tiles)
    befores, afters = exchange_halo_strips(tiles, halo, mesh, axis)
    return [torch.cat([b, t, a], dim=axis) for b, t, a in zip(befores, tiles, afters)]


def host_edge_strips(tile: np.ndarray, halo: int, *, axis: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(leading, trailing) `halo`-thick strips of a host tile along `axis`.
    The streaming tile engine keeps band k's trailing strip to extend band
    k + 1 instead of reading those rows again. The strips are copies, not
    views, so that the band they came from can be released while a strip
    is still held."""
    n = tile.shape[axis]
    lead = np.take(tile, range(halo), axis=axis)
    tail = np.take(tile, range(n - halo, n), axis=axis)
    return np.ascontiguousarray(lead), np.ascontiguousarray(tail)


def stitch_tile(
    before: np.ndarray | None, tile: np.ndarray, after: np.ndarray | None, *, axis: int = 0
) -> np.ndarray:
    """A host tile with its neighbours' seam strips on either side along
    `axis` (the host counterpart of `exchange_halo`'s extended tile). A
    strip that is None is the image's edge: nothing is stitched there, and
    each op pads there by its own edge mode. With no strip, `tile` itself
    is returned."""
    parts = [p for p in (before, tile, after) if p is not None]
    if len(parts) == 1:
        return tile
    return np.concatenate(parts, axis=axis)
