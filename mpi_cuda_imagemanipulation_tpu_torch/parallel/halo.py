"""Ghost-row halo exchange over the ('rows',) mesh. The counterpart of the
JAX package's ``parallel/halo.py``.

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
port sends nothing there: slot 0's leading strip and the last slot's
trailing strip are zeros, which the callers overwrite the same way
(``parallel.api._fix_edge_strips`` / ``_fix_edge_axis``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import ROWS, Mesh


class ExchangeCounts:
    """How often strips crossed shard boundaries: `rounds` counts the calls
    that exchanged (one pair of strips over each of the mesh's n - 1
    boundaries, the counterpart of one ppermute pair in the JAX program).
    Calls on a one-slot mesh exchange nothing and count nothing."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.rounds = 0


exchanges = ExchangeCounts()


def _copy_to(strip: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of `strip` on `device`, enqueued on the current streams of
    both devices (PyTorch orders a cross-device copy after the producer on
    the source's stream and before later work on the target's)."""
    return strip.to(device, non_blocking=True, copy=True)


def exchange_edge_strips(
    firsts: list[torch.Tensor], lasts: list[torch.Tensor], mesh: Mesh
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Exchange pre-sliced edge strips: `firsts[i]`/`lasts[i]` are the
    leading/trailing `halo` rows of local shard i, already cut out by the
    caller. Returns (befores, afters): for each local shard, its upper
    neighbour's trailing rows and its lower neighbour's leading rows.

    This is the primitive under exchange_halo_strips, exposed so the
    overlapped-halo runner can exchange a derived strip (the next stencil
    group's edge rows assembled from the previous group's boundary
    outputs) without waiting for a whole tile.

    Transfers between ranks are posted boundary by boundary in mesh order,
    on each boundary the downward strip before the upward one, so every
    rank posts its sends and receives in the same order."""
    slots = mesh.local_slots
    n = mesh.shape[ROWS]
    pos = {s: i for i, s in enumerate(slots)}
    befores: list = [None] * len(slots)
    afters: list = [None] * len(slots)
    p2p = []
    for upper in range(n - 1):
        lower = upper + 1
        if upper in pos and lower in pos:
            befores[pos[lower]] = _copy_to(lasts[pos[upper]], mesh.devices[lower])
            afters[pos[upper]] = _copy_to(firsts[pos[lower]], mesh.devices[upper])
        elif upper in pos:
            i, peer = pos[upper], mesh.ranks[lower]
            afters[i] = torch.empty_like(firsts[i])
            p2p.append(dist.P2POp(dist.isend, lasts[i].contiguous(), peer))
            p2p.append(dist.P2POp(dist.irecv, afters[i], peer))
        elif lower in pos:
            i, peer = pos[lower], mesh.ranks[upper]
            befores[i] = torch.empty_like(lasts[i])
            p2p.append(dist.P2POp(dist.irecv, befores[i], peer))
            p2p.append(dist.P2POp(dist.isend, firsts[i].contiguous(), peer))
    if p2p:
        for work in dist.batch_isend_irecv(p2p):
            work.wait()
    if 0 in pos:
        befores[pos[0]] = torch.zeros_like(lasts[pos[0]])
    if n - 1 in pos:
        afters[pos[n - 1]] = torch.zeros_like(firsts[pos[n - 1]])
    if n > 1:
        exchanges.rounds += 1
    return befores, afters


def exchange_halo_strips(
    tiles: list[torch.Tensor], halo: int, mesh: Mesh
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The (before, after) ghost strips of every local tile, each `halo`
    rows thick: each shard's last rows go to its successor (becoming that
    neighbour's leading halo) and its first rows to its predecessor. Slot
    0's leading and the last slot's trailing strip are zeros; callers
    overwrite them with the op's edge extension."""
    firsts = [t[:halo] for t in tiles]
    lasts = [t[t.shape[0] - halo :] for t in tiles]
    return exchange_edge_strips(firsts, lasts, mesh)


def exchange_halo(tiles: list[torch.Tensor], halo: int, mesh: Mesh) -> list[torch.Tensor]:
    """Every local tile extended with `halo` ghost rows on both sides (see
    exchange_halo_strips; this materialises the concatenated tile for the
    paths that run over an extended tile)."""
    if halo == 0:
        return list(tiles)
    befores, afters = exchange_halo_strips(tiles, halo, mesh)
    return [torch.cat([b, t, a], dim=0) for b, t, a in zip(befores, tiles, afters)]
