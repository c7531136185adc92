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
* ``backend='auto'`` : the measured per-group choice of the JAX package's
  ``auto`` (ops/cuda_kernels.auto_runner): a stencil takes the whole-op
  banded products behind a ``backend_choice`` record or
  ``MCIM_PREFER_MXU``, the SWAR kernels under ``MCIM_PREFER_SWAR``, else
  its K1/K2 group, so with no record and no switch it runs what ``'cuda'``
  runs. ``plan='auto'`` follows a ``plan_choice`` record
  (plan/planner.resolve_plan_mode), so ``fused-pallas[-mxu]`` enter only
  behind a measured win. The records are the calibration store's
  (utils/calibration.py), filled by the ``autotune`` command on the card
  and keyed by device kind; on the CPU no record or switch promotes a
  route but a plan choice or block height recorded under ``'cpu'``.

A built function (``jit``, ``sharded``) reads the environment and the
store once per image shape, at its first call for that shape, and never
per call after.

Geometric ops (which may change the shape) and global-statistics ops run
as their own tensor ops between the kernel groups on every backend and
plan: a barrier stage of the plan, a group of their own in the K1/K2,
SWAR and banded routes.

``Pipeline.sharded`` runs the same pipeline row-sharded over a mesh of
devices with ghost-strip exchange (parallel/api.py), or tile-sharded over
a 2-D mesh (parallel/api2d.py). ``Pipeline.batched`` runs it over a stack
of same-shape images, each kernel group one launch for the whole stack,
and ``Pipeline.data_parallel`` splits a stack over a mesh's slots.

Every combination gives the same u8 bytes.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch

from mpi_cuda_imagemanipulation_tpu_torch.obs import cost as obs_cost
from mpi_cuda_imagemanipulation_tpu_torch.obs import trace as obs_trace
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import (
    REFERENCE_CPU_PIPELINE_SPEC,
    REFERENCE_PIPELINE_SPEC,
    make_pipeline_ops,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import (
    auto_runner,
    calibrated_tile,
    pipeline_cuda,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import (
    mxu_col_variant,
    mxu_mode,
    pipeline_mxu,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import Op, one_image, per_image
from mpi_cuda_imagemanipulation_tpu_torch.ops.swar_kernels import pipeline_swar, prefer_swar
from mpi_cuda_imagemanipulation_tpu_torch.parallel.api import gather_slots, sharded_pipeline
from mpi_cuda_imagemanipulation_tpu_torch.parallel.api2d import sharded_pipeline_2d
from mpi_cuda_imagemanipulation_tpu_torch.plan import build_plan, resolve_plan_mode
from mpi_cuda_imagemanipulation_tpu_torch.plan.cuda_exec import plan_callable_cuda
from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import plan_callable
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import PLAN_MODES, check_plan
from mpi_cuda_imagemanipulation_tpu_torch.resilience import failpoints
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import (
    as_image_tensor,
    per_shape,
    resolve_device,
)
from mpi_cuda_imagemanipulation_tpu_torch.utils.log import get_logger

BACKENDS = ("torch", "cuda", "mxu", "swar", "auto")
__all__ = ["BACKENDS", "PLAN_MODES", "Pipeline", "reference_cpu_pipeline", "reference_pipeline"]


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

    def _build(self, backend: str, block_h: int | None, plan: str, width: int, device,
               swar: bool):
        """The (N, H, W[, C]) stack -> stack function of this (backend,
        plan) for images `width` columns wide on `device`, every decision
        that reads the environment or the calibration store made here: each
        kernel group one launch over the stack, the golden ops and the
        walker per image. One image runs as a stack of one (`one_image`).
        Returns ``(function, built plan)``, the plan None where the
        resolution says per-op."""
        mode = resolve_plan_mode(self.ops, plan, backend=backend, width=width, device=device)
        if mode != "off":
            built = build_plan(self.ops, mode)
            mxu_stage = "on" if mode == "fused-pallas-mxu" else None
            if mode in ("fused-pallas", "fused-pallas-mxu") and backend != "torch":
                impl = "mxu" if backend == "mxu" else "cuda"
                return plan_callable_cuda(built, block_h=block_h, mxu_stage=mxu_stage, impl=impl,
                                          batched=True), built
            impl = "mxu" if backend == "mxu" else "torch"
            return partial(per_image, plan_callable(built, impl=impl, mxu_stage=mxu_stage)), built
        return self._build_per_op(backend, block_h, width, device, swar), None

    def _build_per_op(self, backend: str, block_h: int | None, width: int, device, swar: bool):
        """`_build`'s stack function where the plan resolves to per-op."""
        if backend == "torch":
            return partial(per_image, self.apply)
        if backend == "mxu":
            return partial(pipeline_mxu, self.ops, block_h=block_h, mode=mxu_mode(),
                           col_variant=mxu_col_variant(), batched=True)
        if backend == "auto":
            return auto_runner(self.ops, width, device, block_h=block_h, swar=swar)
        impl = "swar" if backend == "swar" else "cuda"
        tile = None if block_h is not None else calibrated_tile(impl, width, device)
        runner = pipeline_swar if backend == "swar" else pipeline_cuda
        return partial(runner, self.ops, block_h=block_h, calibrated=tile, batched=True)

    def jit(
        self,
        backend: str = "cuda",
        block_h: int | None = None,
        *,
        device: str | torch.device | None = None,
        plan: str = "auto",
        donate: bool = False,
    ):
        """An image -> image function on `device` (default CUDA), the
        counterpart of the JAX package's ``Pipeline.jit``. PyTorch runs
        eagerly: nothing is traced or compiled here; the CUDA kernels are
        built at their first launch.

        The function takes a uint8 numpy array or tensor, moves it to the
        device, and returns a tensor there. `block_h` sets the stencil
        kernels' tile height (K2 and K4; under 'swar' K6-K8 only); where it
        is None, a ``block_h`` record of the calibration store sets K2's
        (under 'cuda' and 'auto') or K6-K8's (under 'swar') where it fits.
        `plan` selects the fusion-planner
        execution structure (PLAN_MODES; see the module docstring for what
        each backend runs under each). With no CUDA device, the default
        raises. The function builds its route (`_build`) at its first call
        for each image shape; an explicit plan the backend refuses raises
        here, and MCIM_PREFER_SWAR is read here, once.

        ``donate=True`` (the JAX package's input donation) gives the input
        to the function: once the call has enqueued its work, the function
        drops the input tensor (`_donate`; the wrappers' frames hold it
        until then), so that its memory goes back to the caching allocator,
        which hands it out again only to work ordered after the kernels
        that read it: a stream of dispatches (engine/core.py) recycles each
        staged buffer into the next. The caller must not read the input
        again: a tensor passed in is left empty. The port has no
        input-output aliasing: the output is a new tensor, and no byte
        changes.

        Where the plan resolves to other than 'off', the first call for
        each image shape is attributed by the cost ledger (obs/cost.py,
        site 'plan'; MCIM_COST_ATTRIB=0 turns it off): its boundary bytes
        against one u8 image in and one out, and on a card its temporary
        bytes, at the price of one synchronise."""
        dev = resolve_device(device)
        check_plan(plan, backend)
        swar = backend == "auto" and prefer_swar()

        def build(img):
            stack_fn, built = self._build(backend, block_h, plan, img.shape[1], img.device, swar)
            if built is None:
                return one_image(stack_fn)
            return obs_cost.wrap_cache_fn(
                "plan", built.fingerprint, one_image(stack_fn),
                modeled_fn=lambda args: float(
                    args[0].numel() + math.prod(obs_cost.modeled_shape(self.ops, args[0].shape))),
            )

        fn = per_shape(build)

        def run(img) -> torch.Tensor:
            x = as_image_tensor(img, dev)
            out = fn(x)
            if donate:
                _donate(x)
            return out

        return run

    def batched(
        self,
        backend: str = "cuda",
        *,
        device: str | torch.device | None = None,
        plan: str = "auto",
        donate: bool = False,
    ):
        """An (N, H, W[, C]) -> (N, ...) function over a stack of same-shape
        uint8 images on `device` (default CUDA), the counterpart of the JAX
        package's ``Pipeline.batched`` (``jax.vmap``, under which each
        Pallas kernel takes the batch as an extra grid dimension). Here the
        batch is a dimension written out: each kernel group is one launch
        over the whole stack, counted once (K1 as one flat run of pixels,
        K2, K4/K5 and K6-K8 on their batch axis, grid z), and the banded
        products contract the stack as batched ``torch.matmul`` products.
        Image i of the result equals ``self.jit(backend, plan=plan)(stack[i])``
        byte for byte, on every backend and plan.

        What runs per image: the golden ops (``backend='torch'``), the
        PyTorch stage walker (plans 'pointwise' and 'fused'), and the
        geometric and global-statistics ops between the batched groups (a
        statistic reduces over its own image, as under vmap). The route is
        built once per image shape (H, W, C), whatever the stack's length.
        The stack is made contiguous on `device` first: the kernels take
        each image at a fixed stride from the first. ``donate=True`` gives
        the stack to the function, as in ``jit``: the caller must not read
        it again."""
        dev = resolve_device(device)
        check_plan(plan, backend)
        swar = backend == "auto" and prefer_swar()
        fn = per_shape(
            lambda st: self._build(backend, None, plan, st.shape[2], st.device, swar)[0],
            key=lambda st: st.shape[1:],
        )

        def run(imgs) -> torch.Tensor:
            stack = as_image_tensor(imgs, dev)
            if stack.ndim not in (3, 4) or stack.shape[0] < 1:
                raise ValueError(
                    f"expected a non-empty (N, H, W[, C]) stack, got shape {tuple(stack.shape)}"
                )
            out = fn(stack)
            if donate:
                _donate(stack)
            return out

        return run

    def serving(
        self,
        bucket_h: int,
        bucket_w: int,
        channels: int,
        batch: int,
        *,
        backend: str = "torch",
        mesh=None,
        on_trace=None,
        plan: str = "auto",
        device: str | torch.device | None = None,
    ):
        """The bucket-padded serving function of one (bucket, channels,
        batch) cell on `device` (default CUDA), the counterpart of the JAX
        package's ``Pipeline.serving``:

            fn(imgs_u8[B, Hb, Wb(, C)], true_h[B], true_w[B]) -> out[B, ...]

        Image b cropped to [:true_h[b], :true_w[b]] is byte-equal to this
        pipeline on the unpadded request. `backend` is 'torch', 'mxu' or
        'auto' (the JAX package's 'xla', 'mxu', 'auto'); the hand-written
        kernels extend edges at the bucket border and are refused. See
        serve/padded.make_serving_fn."""
        from mpi_cuda_imagemanipulation_tpu_torch.serve.padded import make_serving_fn

        return make_serving_fn(
            self, bucket_h, bucket_w, channels, batch,
            backend=backend, mesh=mesh, on_trace=on_trace, plan=plan, device=device,
        )

    def data_parallel(self, mesh, backend: str = "cuda", plan: str = "auto"):
        """An (N, H, W[, C]) -> (N, ...) function with the stack split over
        `mesh`'s slots (parallel/mesh.make_mesh or make_mesh_2d, in slot
        order): each slot runs the whole pipeline (`batched`) on its chunk
        of the images on its own device, and the chunks are gathered on the
        first slot's device. The counterpart of the JAX package's
        ``Pipeline.data_parallel``: images are independent, so the only
        communication is the gather; a global-statistics op reduces per
        image. N need not divide the slot count: the stack is padded by
        repeating its last image and the padding is sliced off, as in the
        JAX package, so every chunk has the same length.

        Under ``torch.distributed`` every rank calls it with the same stack
        and computes the chunks of its own slots; as ``Pipeline.sharded``
        does, the rank that holds slot 0 receives the other ranks' chunks
        and returns the whole result, and every other rank returns its own
        chunks (padding included where they hold the last slot)."""
        n_slots = len(mesh.devices)
        slots = mesh.local_slots
        fns = {d: self.batched(backend, device=d, plan=plan)
               for d in dict.fromkeys(mesh.devices[s] for s in slots)}
        root = mesh.devices[slots[0]]

        def run(imgs) -> torch.Tensor:
            stack = torch.as_tensor(imgs)
            if stack.dtype != torch.uint8:
                raise TypeError(f"expected a uint8 stack, got {stack.dtype}")
            if stack.ndim not in (3, 4) or stack.shape[0] < 1:
                raise ValueError(
                    f"expected a non-empty (N, H, W[, C]) stack, got shape {tuple(stack.shape)}"
                )
            n = stack.shape[0]
            pad = -n % n_slots
            if pad:
                stack = torch.cat([stack, stack[-1:].expand((pad,) + tuple(stack.shape[1:]))])
            per = stack.shape[0] // n_slots
            outs = [
                fns[mesh.devices[s]](stack[s * per : (s + 1) * per]).to(root, non_blocking=True)
                for s in slots
            ]
            local = gather_slots(mesh, torch.cat(outs))
            if mesh.distributed and mesh.rank != mesh.ranks[0]:
                return local
            return local[:n]

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
        'auto' (per stencil the banded products behind a record or
        MCIM_PREFER_MXU, the SWAR ghost kernels under MCIM_PREFER_SWAR, else
        the 'cuda' kernels; with no record and no switch, 'cuda'). An armed
        ``halo.exchange`` failpoint (resilience/failpoints.py) raises at
        the function's entry, before any shard is touched, inside the
        function's ``sharded.dispatch`` trace span (obs/trace.py; mesh and
        halo mode as its arguments). `halo_mode='overlap'`
        computes interior rows while the ghost strips are in flight
        (parallel.api.HALO_MODES). `plan` (PLAN_MODES) engages the fusion
        planner: a fused stage exchanges one `Stage.halo`-row ghost strip
        pair instead of one per stencil op, and under 'cuda'
        `plan='fused-pallas'` runs each eligible stage as one K4g launch per
        shard over that same pre-exchanged halo ('fused-pallas-mxu': with
        every eligible stencil on K5). Byte-identical output in every
        combination.

        On a 2-D ('rows', 'cols') mesh (parallel/mesh.make_mesh_2d) the
        image is tile-sharded with the two-phase corner-carrying exchange
        (parallel/api2d.py, the counterpart of the JAX package's
        ``sharded_pipeline_2d``): the tiles compute with the golden ops,
        so `backend` must be 'torch' or 'auto' (the JAX package's 'xla' and
        'auto'), and 'auto' says so at INFO; a fused plan stage pays one
        two-phase exchange round. Under a process group the ranks that do
        not hold slot 0 return their own tiles, stacked."""
        if len(mesh.axis_names) == 2:
            if backend not in ("torch", "auto"):
                raise ValueError(
                    "2-D sharding computes tiles with the golden torch ops (the "
                    "row-shard kernels are full-width by design, parallel/api2d "
                    f"docstring); use backend 'torch' or 'auto', got {backend!r}"
                )
            if backend == "auto":
                get_logger().info(
                    "2-D mesh: tile compute uses the torch ops (the row-shard "
                    "kernels are 1-D full-width by design; parallel/api2d.py "
                    "scope note)"
                )
            fn = sharded_pipeline_2d(self, mesh, halo_mode=halo_mode, plan=plan)
        else:
            fn = sharded_pipeline(self, mesh, backend=backend, halo_mode=halo_mode, plan=plan)
        mesh_shape = dict(mesh.shape)
        mesh_desc = str(mesh_shape)  # hoisted: no per-call build

        def run(img) -> torch.Tensor:
            # the host-side enqueue of the sharded program as a span: under
            # a traced run it nests below the caller's span; untraced it is
            # the shared no-op. It ends when the launches are enqueued, not
            # when the card has run them.
            with obs_trace.span("sharded.dispatch", mesh=mesh_desc, halo_mode=halo_mode):
                failpoints.maybe_fail("halo.exchange", mesh_shape=mesh_shape)
                return fn(img)

        return run


def _donate(x: torch.Tensor) -> None:
    """Drop the donated input (``jit``/``batched`` with ``donate=True``):
    the tensor object is emptied (``set_()``: no elements, no storage), so
    that its memory goes back to the caching allocator once no other tensor
    shares it; the allocator hands it out again only to work ordered after
    the kernels that read it. A tensor of the caller's that shares the
    storage (a view, the output of a pipeline with no ops) keeps it."""
    x.set_()


def reference_pipeline() -> Pipeline:
    """The reference's exact pipeline: grayscale -> contrast 3.5 -> emboss 3x3
    (kernel.cu:192-195, smallEmboss=true)."""
    return Pipeline.parse(REFERENCE_PIPELINE_SPEC)


def reference_cpu_pipeline() -> Pipeline:
    """The reference's CPU/OpenCV program (kern.cpp:73-75): Rec.601
    grayscale, contrast 3, reflect-101 emboss."""
    return Pipeline.parse(REFERENCE_CPU_PIPELINE_SPEC)
