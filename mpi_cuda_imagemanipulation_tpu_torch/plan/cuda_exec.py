"""The fused-pallas stage executor on the card: ``plan='fused-pallas'``
under the ``cuda`` backend. The counterpart of the JAX package's
``plan/pallas_exec.py``, with the CUDA megakernel K4
(``ops/cuda_kernels.fused_stage``, ``ops/csrc/fused_stage.cu``) in place
of the Pallas megakernel.

Each eligible fused stage runs as one K4 launch: its pointwise runs, every
member stencil, the per-op edge extension and the finalize, reading the u8
image once and writing the u8 stage output once. The routing is decided
per stage and image shape before any launch, as in the JAX package:

  * a stage K4 rejects is counted by reason in
    ``plan_metrics.pallas_fallbacks`` and runs, under the ``cuda`` backend,
    through the K1/K2 group runner (``pipeline_cuda``, lookup tables as
    plain gathers), never through plain PyTorch ops on the card; under the
    ``mxu`` backend through ``pipeline_mxu``, which keeps the whole-op
    banded products for its eligible stencils (where the JAX package's
    rejected stage re-enters its walker under the pipeline's impl) and
    runs the rest through the same group runner;
  * barrier stages run their golden op.

``mxu_stage`` (ops/mxu_kernels.MXU_STAGE_SETTINGS; 'on' under
``plan='fused-pallas-mxu'``, else None: ``MCIM_MXU_STAGE``, by default
'auto', which follows the calibration store's ``stage_arm`` records on a
card) sets each stencil's in-stage arm: on a tensor-core arm the stencil
runs K5, the ``mma.sync`` arm of K4/K4g.

The closed reason vocabulary is the JAX package's (`stage_pallas_reject`)
with ``smem-budget`` in place of ``vmem-budget``. Like the JAX megakernel,
K4 takes a stage of any number of ops and stencils: its stage goes to the
card as a table (ops/cuda_kernels.stage_program).
"""

from __future__ import annotations

from mpi_cuda_imagemanipulation_tpu_torch.ops import cuda_kernels as ck
from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import pipeline_mxu
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import Plan, Stage
from mpi_cuda_imagemanipulation_tpu_torch.plan.metrics import plan_metrics

REJECT_REASONS = (
    "barrier", "lut-op", "no-f32-core", "halo-too-large", "image-too-small", "smem-budget",
)


def stage_kernel_reject(
    stage: Stage, height: int, width: int, channels: int, tile_h: int | None = None
) -> str | None:
    """Why this stage cannot run as one K4 launch on a (height, width,
    channels) image with output tiles `tile_h` rows high, or None when it
    can (one of REJECT_REASONS)."""
    if stage.kind != "fused":
        return "barrier"
    return ck.fused_stage_reject(stage.ops, height, width, channels, tile_h)


def run_stage_cuda_ext(
    stage: Stage,
    ext,
    *,
    y0: int,
    image_h: int,
    image_w: int,
    block_h: int | None = None,
    mxu_stage: str | None = None,
    arms=None,
):
    """One K4g launch over a (local_h + 2 * Stage.halo, W[, C]) tile whose
    context rows came from the stage's one ghost exchange (parallel/api.py);
    `y0` is the global row of the shard's first row. The counterpart of the
    JAX package's ``run_stage_pallas_ext``. The caller has asked
    `stage_kernel_reject` with the shard's local height. `arms` are the
    stage's in-stage arms if the caller resolved them, else they are
    resolved from `mxu_stage` for this call."""
    return ck.fused_stage_ext(
        stage.ops, ext, y0=y0, image_h=image_h, image_w=image_w, tile_h=block_h,
        mxu_stage=mxu_stage, arms=arms,
    )


def plan_callable_cuda(
    plan: Plan,
    *,
    block_h: int | None = None,
    mxu_stage: str | None = None,
    impl: str = "cuda",
    batched: bool = False,
):
    """The full-image fused-pallas executor: an image -> image function
    (`batched`: an (N, H, W[, C]) stack -> stack function, each eligible
    stage one K4 launch over the stack, each barrier op per image).
    Eligible fused stages run as one K4 launch each (`block_h` sets K4's
    and K2's tile height), with each stencil's in-stage arm from
    `mxu_stage`, resolved once per stage at its first launch (so build one
    executor per image shape where the store may decide them); rejected
    stages run through the K1/K2 group runner under `impl` 'cuda' and
    through `pipeline_mxu` (the banded products, K1/K2 for the rest) under
    'mxu';
    barrier stages run their golden op. Every decision is counted in
    `plan_metrics`."""
    if impl not in ("cuda", "mxu"):
        raise ValueError(f"unknown impl {impl!r}; known: ('cuda', 'mxu')")
    arms: dict[int, tuple] = {}  # stage index -> its arms, at its first launch

    def run(stack):
        for si, stage in enumerate(plan.stages):
            if stage.kind in ("geometric", "global"):
                stack = ck.per_image(stage.ops[0], stack)
                continue
            height, width = stack.shape[1:3]
            ch = stack.shape[3] if stack.ndim == 4 else 1
            reason = stage_kernel_reject(stage, height, width, ch, block_h)
            if reason is None:
                plan_metrics.pallas_stages += 1
                if si not in arms:  # the image's width keys the stage_arm record
                    arms[si] = ck.stage_arms(stage.ops, mxu_stage, width, device=stack.device)
                stack = ck.fused_stage(stage.ops, stack, tile_h=block_h, arms=arms[si],
                                       batched=True)
            else:
                plan_metrics.pallas_fallbacks[reason] += 1
                runner = pipeline_mxu if impl == "mxu" else ck.pipeline_cuda
                stack = runner(stage.ops, stack, block_h=block_h, batched=True)
        return stack

    return run if batched else ck.one_image(run)
