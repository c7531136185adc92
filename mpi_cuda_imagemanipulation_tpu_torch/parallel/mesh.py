"""Device mesh construction and multi-process group set-up. The
counterpart of the JAX package's ``parallel/mesh.py``.

Replaces the reference's MPI world management (MPI_Init/rank/size,
kern.cpp:25-28; kernel.cu:104-107): the communicator becomes a 1-D mesh
over the 'rows' axis, the image-height domain decomposition the reference
implements with MPI_Scatter row blocks, or a 2-D ('rows', 'cols') mesh
for the tile decomposition (parallel/api2d.py).

A mesh is an ordered list of *slots*. Each slot is one row-shard of the
image; it names the ``torch.device`` that holds the shard and the
``torch.distributed`` rank that owns that device (0 without a process
group). A caller may name the same device for several slots: the shards
then run one after another on that device through the same scatter,
exchange, kernels and gather. That is how the CPU tests run 8 shards, and
how one card shows the whole path. It is always an explicit ``devices``
argument, never something the code falls into when it finds too few
cards.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device

ROWS = "rows"
COLS = "cols"

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class _Slots:
    """What every mesh has: `devices[k]` and `ranks[k]`, slot k's device and
    owner, and `rank`, this process."""

    @property
    def local_slots(self) -> tuple[int, ...]:
        """The slots this process holds, in order."""
        return tuple(k for k, r in enumerate(self.ranks) if r == self.rank)

    @property
    def distributed(self) -> bool:
        return len(set(self.ranks)) > 1


@dataclasses.dataclass(frozen=True)
class Mesh(_Slots):
    """A 1-D ('rows',) mesh: slot k holds row-shard k on `devices[k]`,
    owned by rank `ranks[k]`."""

    devices: tuple[torch.device, ...]
    ranks: tuple[int, ...]
    rank: int = 0  # this process

    axis_names = (ROWS,)

    @property
    def shape(self) -> dict[str, int]:
        return {ROWS: len(self.devices)}


@dataclasses.dataclass(frozen=True)
class Mesh2D(_Slots):
    """A 2-D ('rows', 'cols') mesh of `n_rows` x `n_cols` slots in
    row-major order: slot k = r * n_cols + c holds tile (r, c) on
    `devices[k]`, owned by rank `ranks[k]`. Slots and ranks work as in the
    1-D `Mesh`."""

    devices: tuple[torch.device, ...]
    ranks: tuple[int, ...]
    n_rows: int
    n_cols: int
    rank: int = 0  # this process

    axis_names = (ROWS, COLS)

    @property
    def shape(self) -> dict[str, int]:
        return {ROWS: self.n_rows, COLS: self.n_cols}

    def coords(self, slot: int) -> tuple[int, int]:
        """The (row, column) of `slot`'s tile."""
        return divmod(slot, self.n_cols)


def distributed_init(device: str | torch.device | None = None) -> None:
    """Initialise the process group when launched as one process per rank
    (``torchrun``, the ``mpirun`` analogue). No-op for a single process.

    Reads MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE. The backend is
    ``nccl`` when this rank's `device` (default CUDA) is a CUDA device and
    ``gloo`` when it is the CPU. With only some of the four variables set
    it raises."""
    if dist.is_initialized():
        return
    env = {k: os.environ.get(k) for k in _TORCHRUN_VARS}
    if not any(env.values()):
        return
    missing = [k for k, v in env.items() if not v]
    if missing:
        raise RuntimeError(
            f"set all of {', '.join(_TORCHRUN_VARS)} (as torchrun does) or none "
            f"of them; missing: {', '.join(missing)}"
        )
    world = int(env["WORLD_SIZE"])
    if world == 1:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":  # NCCL binds a rank to its current card
        torch.cuda.set_device(_local_card(int(env["RANK"])) if dev.index is None else dev.index)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=int(env["RANK"]),
        world_size=world,
    )


def _local_card(rank: int) -> int:
    """The card of `rank` on its host: LOCAL_RANK as torchrun sets it, else
    the rank modulo the number of cards."""
    return int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """The device of this rank: `device` itself for the CPU or an indexed
    CUDA device; for plain 'cuda', card LOCAL_RANK (as torchrun sets it),
    else the rank modulo the number of cards."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank, world = _world()
    if world == 1:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", _local_card(rank))


def _indexed(dev: torch.device) -> torch.device:
    """`dev` with its card's index spelled out ('cuda' -> the current card),
    so that a slot's device equals its tensors' `.device`."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_shards: int | None = None, *, devices=None) -> Mesh:
    """A 1-D mesh of `n_shards` slots on the ('rows',) axis.

    `devices=None` means every visible CUDA device (raising without one);
    `n_shards=None` one slot per device, the analogue of ``mpirun -np
    <world>`` with MPI_Comm_size (kernel.cu:107). Asking for more shards
    than devices raises. `devices` may be given explicitly, CPU devices
    included, and may repeat a device.

    Under a ``torch.distributed`` process group, `devices` are this rank's
    slots (default: this rank's one device); every rank passes as many, and
    the mesh is their concatenation in rank order."""
    devices, ranks, rank = _slots(n_shards, devices, "shards")
    return Mesh(devices, ranks, rank)


def make_mesh_2d(n_rows: int, n_cols: int, *, devices=None) -> Mesh2D:
    """A 2-D ('rows', 'cols') mesh of n_rows x n_cols slots: the tile
    decomposition of parallel/api2d.py. `devices` as `make_mesh` takes
    them (default every visible CUDA device; more slots than devices
    raise; explicit devices may repeat), and under a process group each
    rank holds an equal share of the slots in rank order."""
    if n_rows < 1 or n_cols < 1:
        raise ValueError(f"mesh axes must be >= 1, got {n_rows}x{n_cols}")
    devices, ranks, rank = _slots(n_rows * n_cols, devices, f"a {n_rows}x{n_cols} mesh's slots")
    return Mesh2D(devices, ranks, n_rows, n_cols, rank)


def _slots(n_shards: int | None, devices, what: str):
    """(devices, ranks, this rank) of a mesh of `n_shards` slots (None: one
    per device) over `devices` (see make_mesh)."""
    rank, world = _world()
    if devices is None:
        if world > 1:
            devices = [rank_device()]
        else:
            resolve_device("cuda")
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if world > 1:
        total = world * len(devices)
        if n_shards not in (None, total):
            raise ValueError(
                f"requested {n_shards} {what} but {world} ranks hold "
                f"{len(devices)} slot(s) each"
            )
        # a remote slot's device is known only to its owner; the entry
        # keeps the mesh's length and is never used from this rank
        slots = [
            (d if r == rank else torch.device("meta"), r)
            for r in range(world)
            for d in devices
        ]
        return tuple(d for d, _ in slots), tuple(r for _, r in slots), rank
    if n_shards is None:
        n_shards = len(devices)
    if n_shards > len(devices):
        raise ValueError(
            f"requested {n_shards} {what} but only {len(devices)} devices are visible"
        )
    return tuple(devices[:n_shards]), (0,) * n_shards, 0


_SPEC_ERROR = (
    "invalid --shards spec {spec!r}: expected N (1-D row mesh) "
    "or RxC (2-D rows x cols mesh), e.g. '8' or '2x4'"
)


def parse_shards(spec) -> tuple[int, int | None]:
    """Parse a CLI shard spec: '4' -> (4, None) (1-D row mesh), '2x4' ->
    (2, 4) (2-D rows x cols mesh). Ints pass through as 1-D."""
    if isinstance(spec, int):
        return spec, None
    s = str(spec).lower().strip()
    if "x" in s:
        r, _, c = s.partition("x")
        try:
            n_r, n_c = int(r), int(c)
        except ValueError:
            raise ValueError(_SPEC_ERROR.format(spec=spec)) from None
        if n_r < 1 or n_c < 1:
            raise ValueError(f"shard counts must be >= 1, got {spec!r}")
        return n_r, n_c
    try:
        n = int(s)
    except ValueError:
        raise ValueError(_SPEC_ERROR.format(spec=spec)) from None
    if n < 1:
        raise ValueError(f"shard count must be >= 1, got {spec!r}")
    return n, None


def mesh_from_shards(spec, device: str | torch.device | None = None) -> Mesh | Mesh2D | None:
    """Mesh for a CLI shard spec, or None when it means 'unsharded' ('1').
    'RxC' builds the 2-D mesh (make_mesh_2d) even for '1x8' or '8x1' (an
    explicit 2-D request, as in the JAX package); a bare count builds the
    1-D row mesh. On a CUDA `device` (the default) the mesh takes the first
    N (or R * C) cards and raises if there are fewer; on the CPU it makes
    that many CPU slots; under a process group each rank takes an equal
    share of the slots."""
    n_r, n_c = parse_shards(spec)
    n = n_r * (n_c or 1)
    if n_c is None and n_r <= 1:
        return None

    def build(devices=None):
        if n_c is not None:
            return make_mesh_2d(n_r, n_c, devices=devices)
        return make_mesh(n_r, devices=devices)

    rank, world = _world()
    if world > 1:  # every rank holds an equal share of the slots on its device
        if n % world:
            raise ValueError(f"--shards {spec} does not divide over {world} ranks")
        return build([rank_device(device)] * (n // world))
    if resolve_device(device).type == "cpu":
        return build(["cpu"] * n)
    return build()
