"""Systolic streaming: plan stages spread over the slots of a 'stage' mesh,
row-band tiles passed slot to slot. The counterpart of the JAX package's
``parallel/systolic.py``.

A fused-stage pipeline is cut into contiguous stage groups, each group
owned by one slot of a 1-D ``'stage'`` mesh, and the image streams
through as fixed-height row bands: slot g runs its stages on band k while
slot g-1 runs its stages on band k+1, the classic systolic wavefront.
Between steps every in-flight band moves to its successor stage owner
(the JAX package's one ``lax.ppermute`` a step): a copy to the next slot's
device, or ``torch.distributed`` point-to-point between ranks, as in
parallel/halo.py. A band crosses each stage boundary exactly once.

The mesh is a list of slots as the port's row mesh is
(parallel/mesh.py): each slot names its device, several slots may name
one device (so one card, or the CPU, runs the whole wavefront), and that
is always an explicit `devices` argument, never something the code falls
into when it finds too few cards.

Byte-exactness is inherited, not re-proven: inside a group the walk is
`plan/exec.walk_stage` under the sharded edge convention (context always
materialised, out-of-image rows rewritten per op by
``parallel.api._fix_edge_axis`` before each stencil reads them, the
`parallel/api._plan_walk` fixture), every stage materialises u8 between
stages as `run_stage_full` does, and the carry is the f32 exact-integer
contract from `ops.spec`, so the slot-boundary handoff moves u8 values
equal to the pinned path's stage intermediates.

Geometry (the JAX package's): every band rides in a fixed (E, W[, C]) u8
buffer with ``E = tile_rows + 2 * total_halo``; group g's live region sits
at the static offset ``off_g`` (the halo consumed by all earlier groups).
The schedule runs ``n_tiles + n_groups - 1`` steps. The build's structural
counters are the formula's; `SystolicBuild.last` holds the copies that
actually ran in the last call (bands forwarded, their bytes, the exchange
rounds), the evidence for "one exchange per stage boundary".
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import U8, Op, exact_f32
from mpi_cuda_imagemanipulation_tpu_torch.parallel.api import _fix_edge_axis
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import _slots, _Slots
from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import (
    StreamabilityError,
    out_channels,
    validate_stream_ops,
)

STAGE = "stage"

# closed vocabulary of sharded-eligibility refusals
ELIGIBILITY_REASONS = (
    "not-streamable",  # geometric/global op in the chain
    "channel-changing",  # stage in/out channel counts differ (every slot
    #                      holds one buffer shape)
    "halo-exceeds-tile",  # chain halo > tile_rows (seam spans bands)
    "too-few-stages",  # fewer plan stages than 2 (nothing to spread)
)


def systolic_eligible(ops: tuple[Op, ...], *, channels: int = 3, tile_rows: int) -> str | None:
    """``None`` when the chain can run stage-sharded, else the refusal
    reason (one of ELIGIBILITY_REASONS)."""
    try:
        halo = validate_stream_ops(ops)
    except StreamabilityError:
        return "not-streamable"
    try:
        if out_channels(ops, channels) != channels:
            return "channel-changing"
    except ValueError:
        return "channel-changing"
    for op in ops:
        if op.out_channels and op.out_channels != channels:
            return "channel-changing"
    if halo > tile_rows:
        return "halo-exceeds-tile"
    if len(ops) < 2:
        return "too-few-stages"
    return None


@dataclasses.dataclass(frozen=True)
class StageMesh(_Slots):
    """A 1-D ('stage',) mesh: slot g owns stage group g on `devices[g]`,
    held by rank `ranks[g]`. Its own axis (not the 'rows' data axis),
    because the decomposition is by pipeline DEPTH."""

    devices: tuple[torch.device, ...]
    ranks: tuple[int, ...]
    rank: int = 0  # this process

    axis_names = (STAGE,)

    @property
    def shape(self) -> dict[str, int]:
        return {STAGE: len(self.devices)}


def make_stage_mesh(n: int, *, devices=None) -> StageMesh:
    """A stage mesh of `n` slots, the devices given as `make_mesh` takes
    them (default: every visible CUDA device, one slot each, raising with
    fewer than `n`; explicit devices may repeat; under a process group,
    this rank's slots)."""
    if n < 2:
        raise ValueError(f"systolic mesh needs >= 2 slots, got {n}")
    devices, ranks, rank = _slots(n, devices, "stage slots")
    return StageMesh(devices, ranks, rank)


def stage_weights(plan, *, channels: int = 3, ledger=None) -> list[float]:
    """Per-stage balancer weight in bytes/pixel: the one-u8-read +
    one-u8-write guess, scaled by the cost ledger's measured drift ratio
    when a record with this plan fingerprint + stage label exists."""
    if ledger is None:
        from mpi_cuda_imagemanipulation_tpu_torch.obs.cost import cost_ledger

        ledger = cost_ledger
    weights = []
    for i, stage in enumerate(plan.stages):
        w = float(2 * channels)
        drift = ledger.drift("plan", plan.fingerprint, f"s{i}/{stage.kind}")
        if drift is not None and drift > 0:
            w *= float(drift)
        weights.append(w)
    return weights


@dataclasses.dataclass
class SystolicCounts:
    """The copies one call ran on this rank: bands forwarded to the next
    slot (a local copy or a send), their u8 bytes, and the exchange rounds
    (wavefront steps in which this rank moved or received a band)."""

    tiles_forwarded: int = 0
    exchange_bytes: int = 0
    n_exchanges: int = 0


@dataclasses.dataclass(frozen=True)
class SystolicBuild:
    """A built stage-sharded executor plus its static structure (fixed by
    geometry and grouping at build time) and `last`, the copies the last
    call actually ran."""

    fn: object  # (H, W[, C]) u8 -> (H, W[, C]) u8 on slot 0's device
    ranges: tuple[tuple[int, int], ...]  # stage index ranges per slot
    n_tiles: int
    tile_rows: int
    buf_rows: int  # E = tile_rows + 2 * total_halo
    n_steps: int  # wavefront length: n_tiles + n_groups - 1
    tiles_forwarded: int  # n_tiles * (n_groups - 1): boundary crossings
    exchange_bytes: int  # u8 payload bytes crossing stage boundaries
    last: SystolicCounts = dataclasses.field(default_factory=SystolicCounts)

    @property
    def n_groups(self) -> int:
        return len(self.ranges)

    @property
    def n_exchanges(self) -> int:
        """Exchange rounds: one per wavefront step except the last. With
        n_tiles == 1 this equals n_groups - 1, exactly one exchange per
        stage boundary."""
        return self.n_steps - 1


def systolic_callable(
    plan,
    *,
    height: int,
    width: int,
    channels: int = 3,
    tile_rows: int,
    n_devices: int | None = None,
    mesh: StageMesh | None = None,
    impl: str = "torch",
    ledger=None,
) -> SystolicBuild:
    """Build the stage-sharded streaming executor for one image shape.

    Stages are grouped contiguously over the mesh's slots by the
    linear-partition balancer the replica placement pass uses
    (`graph.compile.partition_weights` over modelled-or-measured
    bytes/pixel); then the wavefront runs ``n_tiles + n_groups - 1``
    steps: slot 0 injects band t, every slot runs its group on the band it
    holds, every band moves one slot down, the last slot collects finished
    rows. `mesh` defaults to `make_stage_mesh(n_devices or 2)`; `impl`
    routes each stencil's accumulation (graph/compile.GRAPH_IMPLS).

    The returned `fn` takes the image (a tensor or host array; only the
    rank that holds slot 0 reads it) and returns the result on slot 0's
    device; under a process group the other ranks return None."""
    from mpi_cuda_imagemanipulation_tpu_torch.graph.compile import (
        partition_weights,
        stage_accs,
    )
    from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import walk_stage

    reason = systolic_eligible(plan.ops, channels=channels, tile_rows=tile_rows)
    if reason is not None:
        raise StreamabilityError(f"chain not systolic-eligible: {reason}")
    if mesh is None:
        mesh = make_stage_mesh(n_devices or 2)
    n = mesh.shape[STAGE]
    stages = plan.stages
    if len(stages) < 2:
        raise StreamabilityError(f"plan has {len(stages)} stage(s); systolic needs >= 2")
    if len(stages) < n:
        raise ValueError(
            f"mesh has {n} slots but the plan only has {len(stages)} stages: "
            "build the mesh with n <= n_stages"
        )
    ranges = partition_weights(stage_weights(plan, channels=channels, ledger=ledger), n)
    group_halos = [sum(stages[i].halo for i in range(lo, hi)) for lo, hi in ranges]
    h_total = sum(group_halos)
    assert h_total == plan.total_halo
    # static offset of group g's live region inside the E-row buffer: the
    # context consumed by every earlier group
    offs = [0]
    for gh in group_halos:
        offs.append(offs[-1] + gh)
    e_rows = tile_rows + 2 * h_total
    n_tiles = math.ceil(height / tile_rows)
    n_steps = n_tiles + n - 1
    buf_shape = (e_rows, width, channels) if channels > 1 else (e_rows, width)
    band_bytes = math.prod(buf_shape)
    local = set(mesh.local_slots)
    last_slot = n - 1
    root = mesh.ranks[0]
    # each stage's accumulators, resolved on the device of the slot whose
    # group holds it
    owner = {si: g for g, (lo, hi) in enumerate(ranges) for si in range(lo, hi)}
    accs = [stage_accs(stages[si], impl, width, mesh.devices[owner[si]])
            if owner[si] in local else None for si in range(len(stages))]
    counts = SystolicCounts()

    def fix(cur, op, row_lo):
        return _fix_edge_axis(cur, op, row_lo + op.halo, height, 0)

    def run_group(g: int, buf: torch.Tensor, y0: int) -> torch.Tensor:
        """Group g's stages over its live region; the result re-embedded
        at the next group's static offset of a fresh (E, W[, C]) buffer."""
        lo, hi = ranges[g]
        off = offs[g]
        cur = buf[off: e_rows - off] if off else buf
        y_lo = y0 + off
        for si in range(lo, hi):
            stage = stages[si]
            f, y_lo, _, _ = walk_stage(
                stage.ops, exact_f32(cur), y_lo=y_lo, lead_rem=stage.halo,
                tail_rem=stage.halo, global_h=height, global_w=width, acc_fns=accs[si],
                edge_fix=fix,
            )
            # per-stage u8 materialisation: the pinned path's stage
            # boundary contract, so the handoff is byte-exact
            cur = f.to(U8)
        off_next = offs[g + 1]
        out = torch.zeros(buf_shape, dtype=U8, device=buf.device)
        out[off_next: e_rows - off_next] = cur
        return out

    def band(img: torch.Tensor, k: int) -> torch.Tensor:
        """Band k's extended rows, clipped to the image (out-of-image rows
        carry clipped copies; the per-op edge fix rewrites them before any
        stencil reads them)."""
        rows = torch.arange(e_rows, device=img.device) + (k * tile_rows - h_total)
        return img.index_select(0, rows.clamp(0, height - 1))

    def run(img):
        counts.tiles_forwarded = counts.exchange_bytes = counts.n_exchanges = 0
        if 0 in local:
            img = torch.as_tensor(img).to(mesh.devices[0])
        hold: dict[int, torch.Tensor] = {}  # slot -> the band it holds now
        outs: list = [None] * n_tiles
        for t in range(n_steps):
            if t < n_tiles and 0 in local:
                hold[0] = band(img, t)
            for g in sorted(hold):
                hold[g] = run_group(g, hold[g], (t - g) * tile_rows - h_total)
            if last_slot in hold:
                # the last slot holds band t - (n - 1) finished
                outs[t - last_slot] = hold.pop(last_slot)[h_total: e_rows - h_total]
            if t == n_steps - 1:
                break
            moved, p2p, recvd = False, [], {}
            for g in range(n - 1):
                if not 0 <= t - g < n_tiles:
                    continue  # no band at slot g this step
                if g in local and g + 1 in local:
                    recvd[g + 1] = hold.pop(g).to(mesh.devices[g + 1], copy=True)
                elif g in local:
                    p2p.append(dist.P2POp(dist.isend, hold.pop(g).contiguous(),
                                          mesh.ranks[g + 1]))
                elif g + 1 in local:
                    recvd[g + 1] = torch.empty(buf_shape, dtype=U8, device=mesh.devices[g + 1])
                    p2p.append(dist.P2POp(dist.irecv, recvd[g + 1], mesh.ranks[g]))
                    moved = True
                    continue
                else:
                    continue
                moved = True
                counts.tiles_forwarded += 1
                counts.exchange_bytes += band_bytes
            if p2p:
                for work in dist.batch_isend_irecv(p2p):
                    work.wait()
            counts.n_exchanges += int(moved)
            hold = recvd
        result = None
        if last_slot in local:
            result = torch.cat(outs, dim=0)[:height]
        if mesh.distributed and mesh.ranks[last_slot] != root:
            if mesh.rank == mesh.ranks[last_slot]:
                dist.send(result.contiguous(), dst=root)
                return None
            if mesh.rank == root:
                result = torch.empty((height,) + buf_shape[1:], dtype=U8,
                                     device=mesh.devices[0])
                dist.recv(result, src=mesh.ranks[last_slot])
        if mesh.distributed and mesh.rank != root:
            return None
        return result.to(mesh.devices[0])

    tiles_forwarded = n_tiles * (n - 1)
    return SystolicBuild(
        fn=run,
        ranges=ranges,
        n_tiles=n_tiles,
        tile_rows=tile_rows,
        buf_rows=e_rows,
        n_steps=n_steps,
        tiles_forwarded=tiles_forwarded,
        exchange_bytes=tiles_forwarded * band_bytes,
        last=counts,
    )
