"""Pipeline: an op sequence over an image, with three backends.

* ``backend='torch'``: PyTorch ops. ``plan='off'`` runs the golden ops op
  by op (the oracle); the other plans run the stage walker (plan/exec.py),
  under ``'fused-pallas-mxu'`` with K5's plain version for every eligible
  stencil.
* ``backend='cuda'`` : the hand-written kernels. ``plan='off'`` (and
  ``'auto'``) runs one launch per ``[pointwise*, stencil?]`` group (K1,
  K2; ops/cuda_kernels.py); ``plan='fused-pallas'`` runs one launch of K4
  per eligible fused stage (plan/cuda_exec.py), and ``'fused-pallas-mxu'``
  the same with every eligible stencil on K5, K4's tensor-core arm.
  Rejected stages run as K1/K2 groups.
* ``backend='mxu'``  : the tensor-core route (ops/mxu_kernels.py).
  ``plan='off'`` runs `pipeline_mxu`: eligible stencils as banded
  products, every other op through the K1/K2 group runner; ``'pointwise'``,
  ``'fused'`` and ``'auto'`` run the walker with the banded products;
  ``'fused-pallas[-mxu]'`` run K4 stages as under ``cuda``, and a rejected
  stage walks with the banded products.
* ``backend='swar'`` : the SWAR kernels (ops/swar_kernels.py). Every plan
  resolves to ``'off'``: `pipeline_swar` runs each eligible
  ``[pre*, stencil, post*]`` group on a gray plane as one launch of K6, K7
  or K8, and every other op through the K1/K2 group runner.
* ``backend='auto'`` : every eligible group takes its hand kernel, which
  is ``'cuda'`` (the port has no calibration store to route by).

Geometric ops (which may change the shape) and global-statistics ops run
as their own tensor ops between the kernel groups on every backend and
plan: a barrier stage of the plan, a group of their own in the K1/K2,
SWAR and banded routes.

``Pipeline.sharded`` runs the same pipeline row-sharded over a mesh of
devices with ghost-strip exchange (parallel/api.py).

Every combination gives the same u8 bytes.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import (
    REFERENCE_CPU_PIPELINE_SPEC,
    REFERENCE_PIPELINE_SPEC,
    make_pipeline_ops,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import pipeline_cuda
from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import pipeline_mxu
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import Op
from mpi_cuda_imagemanipulation_tpu_torch.ops.swar_kernels import pipeline_swar
from mpi_cuda_imagemanipulation_tpu_torch.parallel.api import sharded_pipeline
from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan, resolve_plan_mode
from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import plan_callable_cuda
from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import plan_callable
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import PLAN_MODES
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import (
    as_image_tensor,
    resolve_device,
)

BACKENDS = ("torch", "cuda", "mxu", "swar", "auto")
__all__ = ["BACKENDS", "PLAN_MODES", "Pipeline", "reference_cpu_pipeline", "reference_pipeline"]


def _resolve_backend(backend: str) -> str:
    """`backend` checked against BACKENDS, with 'auto' resolved to 'cuda'."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    return "cuda" if backend == "auto" else backend


@dataclasses.dataclass(frozen=True)
class Pipeline:
    ops: tuple[Op, ...]

    @classmethod
    def parse(cls, spec: str) -> "Pipeline":
        return cls(ops=make_pipeline_ops(spec))

    @property
    def name(self) -> str:
        return ",".join(op.name for op in self.ops)

    @property
    def max_halo(self) -> int:
        return max((op.halo for op in self.ops), default=0)

    # -- golden path -----------------------------------------------------

    def apply(self, img: torch.Tensor) -> torch.Tensor:
        """The golden ops in sequence, on the tensor's own device."""
        for op in self.ops:
            img = op(img)
        return img

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        return self.apply(img)

    # -- entry point -----------------------------------------------------

    def _planned_callable(self, backend: str, plan: str, block_h: int | None = None):
        """The plan executor for this (backend, plan) pair, or None when the
        plan resolves to per-op execution (plan/planner.resolve_plan_mode)."""
        backend = _resolve_backend(backend)
        mode = resolve_plan_mode(self.ops, plan, backend=backend)
        if mode == "off":
            return None
        built = build_plan(self.ops, mode)
        mxu_stage = "on" if mode == "fused-pallas-mxu" else None
        if mode in ("fused-pallas", "fused-pallas-mxu") and backend != "torch":
            return plan_callable_cuda(built, block_h=block_h, mxu_stage=mxu_stage, impl=backend)
        impl = "mxu" if backend == "mxu" else "torch"
        return plan_callable(built, impl=impl, mxu_stage=mxu_stage)

    def _callable(self, backend: str, block_h: int | None = None, plan: str = "auto"):
        backend = _resolve_backend(backend)
        planned = self._planned_callable(backend, plan, block_h)
        if planned is not None:
            return planned
        if backend == "torch":
            return self.apply
        if backend == "mxu":
            return partial(pipeline_mxu, self.ops, block_h=block_h)
        if backend == "swar":
            return partial(pipeline_swar, self.ops, block_h=block_h)
        return partial(pipeline_cuda, self.ops, block_h=block_h)

    def jit(
        self,
        backend: str = "cuda",
        block_h: int | None = None,
        *,
        device: str | torch.device | None = None,
        plan: str = "auto",
    ):
        """An image -> image function on `device` (default CUDA), the
        counterpart of the JAX package's ``Pipeline.jit``. PyTorch runs
        eagerly: nothing is traced or compiled here; the CUDA kernels are
        built at their first launch.

        The function takes a uint8 numpy array or tensor, moves it to the
        device, and returns a tensor there. `block_h` sets the stencil
        kernels' tile height (K2 and K4; under 'swar' K6-K8 only). `plan` selects the fusion-planner
        execution structure (PLAN_MODES; see the module docstring for what
        each backend runs under each). With no CUDA device, the default
        raises."""
        dev = resolve_device(device)
        fn = self._callable(backend, block_h, plan)

        def run(img) -> torch.Tensor:
            return fn(as_image_tensor(img, dev))

        return run

    def sharded(
        self, mesh, backend: str = "cuda", halo_mode: str = "serial", plan: str = "auto"
    ):
        """A function running this pipeline row-sharded over `mesh`
        (parallel/mesh.make_mesh) with ghost-strip halo exchange, the
        counterpart of the JAX package's ``Pipeline.sharded`` on a 1-D
        ('rows',) mesh.

        The function takes a whole uint8 image (numpy array or tensor),
        scatters row blocks to the mesh's devices, runs every op on the
        local tiles and gathers the result on the first slot's device,
        where it returns a tensor. Under ``torch.distributed`` every rank
        calls it with the same image; the rank that holds slot 0 returns the
        whole image, the others their own rows (the whole image too when
        the pipeline ends in a geometric op). A geometric op runs on the
        whole image between two sharded regions; a global-statistics op
        sums its histogram over every shard's valid rows.

        `backend` is 'cuda' (the hand-written ghost-mode kernels K2g, K3,
        K4g and K1), 'mxu' (the banded products for eligible stencils on
        the extended tile, the 'cuda' kernels otherwise), 'swar' (K6g, K7g
        or K8g for each eligible group on gray tiles without pad rows, the
        'cuda' kernels otherwise), 'torch' (the golden ops per tile) or
        'auto' (every eligible group takes its kernel: 'cuda'). `halo_mode='overlap'`
        computes interior rows while the ghost strips are in flight
        (parallel.api.HALO_MODES). `plan` (PLAN_MODES) engages the fusion
        planner: a fused stage exchanges one `Stage.halo`-row ghost strip
        pair instead of one per stencil op, and under 'cuda'
        `plan='fused-pallas'` runs each eligible stage as one K4g launch per
        shard over that same pre-exchanged halo ('fused-pallas-mxu': with
        every eligible stencil on K5). Byte-identical output in every
        combination."""
        return sharded_pipeline(self, mesh, backend=backend, halo_mode=halo_mode, plan=plan)


def reference_pipeline() -> Pipeline:
    """The reference's exact pipeline: grayscale -> contrast 3.5 -> emboss 3x3
    (kernel.cu:192-195, smallEmboss=true)."""
    return Pipeline.parse(REFERENCE_PIPELINE_SPEC)


def reference_cpu_pipeline() -> Pipeline:
    """The reference's CPU/OpenCV program (kern.cpp:73-75): Rec.601
    grayscale, contrast 3, reflect-101 emboss."""
    return Pipeline.parse(REFERENCE_CPU_PIPELINE_SPEC)
