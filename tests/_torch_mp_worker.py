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
    python tests/_torch_mp_worker.py 2d|dp|systolic [cpu|cuda]

The second form holds two slots per rank and runs the 2-D tile-sharded
runner over a 2 x (ranks) mesh (parallel/api2d: both exchange phases, the
histograms' all_reduce and the root's geometric ops crossing ranks), or
``Pipeline.data_parallel`` over a 5-image stack (uneven over the slots;
the gather crossing ranks), or the systolic runner (parallel/systolic.py)
over a stage mesh of one and of two slots per rank (bands sent between
ranks, the result sent to slot 0's rank, which prints its SHA-256 for the
caller to hold against the JAX package's bytes).

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
    make_mesh_2d,
    rank_device,
)

# the systolic form's chain and image (tests/test_torch_systolic.py holds
# the printed SHA-256 against the JAX package's plan_callable bytes)
SYSTOLIC_SPEC = "invert,gaussian:3,sharpen,box:3,quantize:6,median"
SYSTOLIC_SHAPE = (97, 64)

LANES = [("torch", "off", "serial"), ("torch", "fused", "serial"), ("cuda", "off", "serial"),
         ("cuda", "fused-pallas", "serial"), ("cuda", "off", "overlap"),
         ("torch", "fused", "overlap")]


def main_form(form: str) -> int:
    """The 2-D runner ('2d') or the data-parallel stack ('dp') across the
    ranks, two slots each; the rank that holds slot 0 checks the result
    against the golden ops, and data-parallel's other ranks their own
    chunks."""
    kind = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    distributed_init(kind)
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = rank_device(kind)
    bad = 0
    if form == "2d":
        mesh = make_mesh_2d(world, 2, devices=[dev] * 2)
        assert mesh.shape == {"rows": world, "cols": 2} and mesh.distributed
        img = synthetic_image(96, 88, channels=3, seed=23)
        for spec in (REFERENCE_PIPELINE_SPEC, "gaussian:5,gaussian:5",
                     "grayscale,equalize,gaussian:5", "rot:90,gaussian:5",
                     "gaussian:3,rot:90,gaussian:5"):
            pipe = Pipeline.parse(spec)
            golden = pipe(torch.from_numpy(img).to(dev))
            for plan, halo_mode in (("off", "serial"), ("off", "overlap"), ("fused", "serial")):
                halo.exchanges.reset()
                out = pipe.sharded(mesh, backend="torch", plan=plan, halo_mode=halo_mode)(img)
                rounds = halo.exchanges.axis_rounds
                if rounds["rows"] < 1 or rounds["cols"] < 1:
                    bad += 1
                if rank == 0 and not torch.equal(out, golden):
                    print(f"TORCH_MULTIPROC_MISMATCH 2d {spec} {plan}/{halo_mode}", flush=True)
                    bad += 1
    elif form == "systolic":
        import hashlib

        from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_pipeline_ops
        from mpi_cuda_imagemanipulation_tpu_torch.parallel.systolic import (
            make_stage_mesh,
            systolic_callable,
        )
        from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan

        h, w = SYSTOLIC_SHAPE
        img = synthetic_image(h, w, channels=3, seed=13)
        plan = build_plan(make_pipeline_ops(SYSTOLIC_SPEC), "off")
        golden = Pipeline.parse(SYSTOLIC_SPEC)(torch.from_numpy(img).to(dev))
        for per_rank, tile_rows in ((1, 32), (2, 24)):
            mesh = make_stage_mesh(world * per_rank, devices=[dev] * per_rank)
            assert mesh.distributed
            build = systolic_callable(plan, height=h, width=w, tile_rows=tile_rows, mesh=mesh)
            out = build.fn(img)
            # every band crossed every boundary once, whichever rank sent it
            counts = torch.tensor([build.last.tiles_forwarded, build.last.exchange_bytes])
            dist.all_reduce(counts)
            if counts.tolist() != [build.tiles_forwarded, build.exchange_bytes]:
                print(f"TORCH_MULTIPROC_MISMATCH systolic counts {counts.tolist()}", flush=True)
                bad += 1
            if rank != 0:
                bad += out is not None
                continue
            if not torch.equal(out, golden):
                print(f"TORCH_MULTIPROC_MISMATCH systolic {per_rank}/{tile_rows}", flush=True)
                bad += 1
            sha = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
            print(f"TORCH_MULTIPROC_SHA systolic {world * per_rank} {tile_rows} {sha}",
                  flush=True)
    else:
        mesh = make_mesh(devices=[dev] * 2)
        n, per = 5, -(-5 // (2 * world))
        stack = torch.stack([torch.from_numpy(synthetic_image(40, 56, channels=3, seed=30 + t))
                             for t in range(n)])
        padded = torch.cat([stack, stack[-1:].expand((per * 2 * world - n,) + stack.shape[1:])])
        for spec in (REFERENCE_PIPELINE_SPEC, "grayscale,equalize,gaussian:5", "gaussian:5"):
            pipe = Pipeline.parse(spec)
            for backend in ("torch", "cuda"):
                out = pipe.data_parallel(mesh, backend=backend)(stack)
                mine = padded if rank == 0 else padded[rank * 2 * per : (rank + 1) * 2 * per]
                want = [pipe(x.to(dev)) for x in (stack if rank == 0 else mine)]
                if len(out) != len(want) or not all(map(torch.equal, out, want)):
                    print(f"TORCH_MULTIPROC_MISMATCH dp {spec} {backend} rank={rank}", flush=True)
                    bad += 1
    dist.barrier()
    dist.destroy_process_group()
    if bad:
        print(f"TORCH_MULTIPROC_BAD rank={rank} n={bad}", flush=True)
        return 1
    if rank == 0:
        print(f"TORCH_MULTIPROC_OK {form} slots={2 * world}", flush=True)
    return 0


def main() -> int:
    if sys.argv[1] in ("2d", "dp", "systolic"):
        return main_form(sys.argv[1])
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
