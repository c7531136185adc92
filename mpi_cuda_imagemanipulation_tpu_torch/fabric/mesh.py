"""The mesh lane: one LARGE request spans a mesh; small requests ride
data-parallel replicas. The counterpart of the JAX package's
``fabric/mesh.py``.

The replica tier scales throughput: N processes, each serving bucketed
small images. What it cannot do is serve an image bigger than one
replica's largest bucket. This lane is the other axis of the paper's MPI
story: the row-scatter across ranks (kern.cpp:55), run in the router
process as `Pipeline.sharded` over a 1-D ('rows',) mesh from
`parallel.mesh.make_mesh`: pad-to-multiple + crop, ghost-strip exchange,
byte-identical to the golden path.

The mesh's slots are the cards of this process, in turn (slot i on card
i mod count; one card holds every slot), the CPU for the tests
(``device='cpu'``), or, when `parallel.mesh.distributed_init` finds a
``torchrun`` world, one NCCL rank each. `backend` is any backend
`Pipeline.sharded` takes: 'torch' (the golden ops per tile, the JAX
lane's 'xla' default) or 'cuda' (the ghost-mode kernels K2g, K3 and K4g).

The JAX package's ``simulated_hosts_xla_flags`` builds an XLA flag for
spawned CPU processes and has no counterpart: the CPU slots are named
here.

Dispatches build nothing per shape: the lane exists for RARE oversize
requests, so the bucket grid's no-first-call contract stays a replica
property.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import (
    _world,
    distributed_init,
    make_mesh,
    rank_device,
)
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import resolve_device

MESH_BACKENDS = ("torch", "cuda")


def _lane_mesh(n_shards: int, device):
    """A 1-D mesh of `n_shards` slots for `device`: CPU slots, an equal
    share of the slots on this rank's card under a process group, else the
    visible cards in turn (slot i on card i mod count)."""
    dev = resolve_device(device)
    _rank, world = _world()
    if world > 1:
        if n_shards % world:
            raise ValueError(f"{n_shards} mesh shards do not divide over {world} ranks")
        return make_mesh(n_shards, devices=[rank_device(dev)] * (n_shards // world))
    if dev.type == "cpu":
        return make_mesh(n_shards, devices=["cpu"] * n_shards)
    if dev.index is not None:
        return make_mesh(n_shards, devices=[dev] * n_shards)
    cards = torch.cuda.device_count()
    return make_mesh(n_shards, devices=[torch.device("cuda", i % cards) for i in range(n_shards)])


class MeshLane:
    """The router's oversize-request executor: `pipe.sharded` over an
    `n_shards`-slot row mesh on `device` (default CUDA; raises without
    it)."""

    def __init__(
        self,
        ops: str,
        n_shards: int,
        *,
        halo_mode: str = "serial",
        backend: str = "torch",
        device=None,
    ):
        if backend not in MESH_BACKENDS:
            raise ValueError(f"mesh lane backend must be one of {MESH_BACKENDS}, got {backend!r}")
        # a torchrun world first: the process group must exist before the
        # mesh reads its rank (a single process no-ops, parallel/mesh.py)
        distributed_init(device)
        self.pipe = Pipeline.parse(ops)
        self.n_shards = n_shards
        self.backend = backend
        self.mesh = _lane_mesh(n_shards, device)
        self.device = self.mesh.devices[0]
        self._fn = self.pipe.sharded(self.mesh, backend=backend, halo_mode=halo_mode)
        self._lock = threading.Lock()
        self._dispatches = 0
        self._shapes: set[tuple] = set()

    def process(self, img: np.ndarray) -> np.ndarray:
        """Run one image through the sharded pipeline; byte-identical to
        the golden path by the sharded runner's contract (pad-to-multiple
        + crop, parallel/api.py). Waits for the card before it returns."""
        out = self._fn(np.ascontiguousarray(img))
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        out = out.cpu().numpy()
        with self._lock:
            self._dispatches += 1
            self._shapes.add(img.shape)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "shards": self.n_shards,
                "ops": self.pipe.name,
                "backend": self.backend,
                "device": str(self.device),
                "dispatches": self._dispatches,
                "shapes_seen": len(self._shapes),
            }
