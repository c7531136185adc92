"""Worker for tests/test_torch_multiprocess.py: one process of a
``torch.distributed`` group, holding one or more slots of a ('rows',) mesh
on its device: the CPU over ``gloo`` (the default, what the tests run) or
its card over ``nccl``. Every rank runs the sharded pipelines on the same seeded
image; the rank that holds slot 0 compares the gathered result byte for
byte against the local unsharded golden.

This is the ``mpirun -np 2`` analogue of the reference (kern.cpp:25-28,
kernel.cu:104-107): two OS processes, a real rendezvous, strips and the
gather crossing a process boundary. The rendezvous comes from the torchrun
environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE).

    python tests/_torch_mp_worker.py SLOTS_PER_RANK [cpu|cuda] [HEIGHTxWIDTH]

On a host with one card per rank, the NCCL form is

    torchrun --nproc_per_node 4 tests/_torch_mp_worker.py 1 cuda 4320x7680

With a size, rank 0 also prints each lane's time per call: the median of
five host-clock samples, each between a barrier and a device synchronise.
"""

import os
import statistics
import sys
import time

# the checkout next to us always wins over any installed copy
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image  # noqa: E402
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline  # noqa: E402
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import (  # noqa: E402
    REFERENCE_PIPELINE_SPEC,
)
from mpi_cuda_imagemanipulation_tpu_torch.parallel import halo  # noqa: E402
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import (  # noqa: E402
    distributed_init,
    make_mesh,
    rank_device,
)

LANES = [("torch", "off", "serial"), ("torch", "fused", "serial"), ("cuda", "off", "serial"),
         ("cuda", "fused-pallas", "serial"), ("cuda", "off", "overlap"),
         ("torch", "fused", "overlap")]


def main() -> int:
    slots = int(sys.argv[1])
    kind = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    distributed_init(kind)
    assert dist.is_initialized()
    assert dist.get_backend() == ("gloo" if kind == "cpu" else "nccl")
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = rank_device(kind)
    mesh = make_mesh(devices=[dev] * slots)
    assert mesh.shape == {"rows": world * slots} and mesh.distributed
    assert mesh.local_slots == tuple(range(rank * slots, (rank + 1) * slots))
    height, width = (int(v) for v in sys.argv[3].split("x")) if len(sys.argv) > 3 else (128, 96)
    img = synthetic_image(height, width, channels=3, seed=21)
    backend_name = dist.get_backend()
    bad = 0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    # then the histogram's all_reduce across ranks, a geometric op on the
    # input every rank holds, and one after a sharded region (the root
    # applies it and broadcasts the shape and the bytes)
    for spec in (REFERENCE_PIPELINE_SPEC, "gaussian:5", "gaussian:5,emboss:3,gaussian:3",
                 "grayscale,equalize,gaussian:5", "rot:90,gaussian:5",
                 "gaussian:3,rot:90,gaussian:5"):
        pipe = Pipeline.parse(spec)
        golden = pipe(torch.from_numpy(img).to(dev))
        for backend, plan, halo_mode in LANES:
            halo.exchanges.reset()
            fn = pipe.sharded(mesh, backend=backend, plan=plan, halo_mode=halo_mode)
            out = fn(img)
            if len(sys.argv) > 3:
                x = torch.from_numpy(img).to(dev)  # the image already on the rank's device
                samples = []
                for rep in range(7):
                    sync()
                    t0 = time.perf_counter()
                    fn(x)
                    sync()
                    samples.append((time.perf_counter() - t0) * 1e3)
                if rank == 0:
                    print(f"TORCH_MULTIPROC_TIME {spec} {backend}/{plan}/{halo_mode} "
                          f"{height}x{width} over {world * slots} slots on {world} ranks "
                          f"({backend_name}): {statistics.median(samples[2:]):.4f} ms per call "
                          "(host clock, barrier to synchronise)", flush=True)
            if halo.exchanges.rounds < 1:  # every spec here has a stencil group
                bad += 1
            if rank != 0:  # its own rows of the last region (rot:90 turns the height)
                rows = golden.shape[0] // (world * slots)
                local = slice(rank * slots * rows, (rank + 1) * slots * rows)
                if not torch.equal(out, golden[local]):
                    bad += 1
                continue
            if not torch.equal(out, golden):
                diff = (out.int() - golden.int()).abs()
                print(f"TORCH_MULTIPROC_MISMATCH {spec} {backend}/{plan}/{halo_mode} "
                      f"maxdiff={diff.max().item()} ndiff={int((diff > 0).sum())}", flush=True)
                bad += 1
    dist.barrier()
    dist.destroy_process_group()
    if bad:
        print(f"TORCH_MULTIPROC_BAD rank={rank} n={bad}", flush=True)
        return 1
    if rank == 0:
        print(f"TORCH_MULTIPROC_OK slots={world * slots} shape={tuple(golden.shape)} "
              f"backend={backend_name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
