"""Bucket-padded execution, byte-identical to the per-request golden path.
The counterpart of the JAX package's ``serve/padded.py``, in PyTorch.

The compile cache (serve/cache.py) builds one function per shape bucket, so
a request image is zero-padded up to the bucket and its TRUE shape rides
along as two (B,) integer tensors, one entry per image of the stack.
Running `Pipeline.apply` on the padded array would change the numbers near
the true border: reflect-101 or edge extension would read pad garbage
instead of the virtual border, the 'interior' guard would treat true-edge
pixels as interior (it sees the bucket edge, not the image edge), and
global statistics would count pad pixels. This module re-applies each op
with the true border rebuilt, for every image of the stack at once:

  * StencilOp: the (B, Hb+2h, Wb+2h) padded window stack is one indexed
    read of the (B, Hb, Wb) plane stack through per-image row and column
    index maps (`_ext_ids`, (B, Hb+2h) and (B, Wb+2h) on the device) that
    implement the op's edge mode at each image's own true border
    (reflect101: r >= th -> 2*th-2-r; edge: clamp to th-1; zero: mask
    outside [0, th)). Every output pixel inside an image's true region sees
    exactly the neighbourhood `pad2d` hands the unpadded op, so the
    accumulation is the same. The interior guard is a (B, 1, 1)-broadcast
    mask in TRUE coordinates (`_finalize_f32`): ``StencilOp.interior_mask``
    takes Python ints and stays as its scalar callers use it.
  * GlobalOp: one statistic per image, under that image's own
    (row < th) & (col < tw) mask; the same integer histogram gives the same
    table and the same output. (A statistic summed over the stack would be
    a wrong answer that only a batch of differing images shows.)
  * PointwiseOp: per image; pad pixels compute garbage the crop drops.

By induction over the chain, each op's true region depends only on the
previous op's true region, so garbage never reaches it and the cropped
output equals the unpadded pipeline byte for byte (tests/
test_torch_serve_padded.py holds it against the JAX package's executor).

Reflect-101 needs true_dim >= halo + 1, the bound the golden path's own
padding has, and admission rejects smaller requests (`min_true_dim`).
Geometric ops change the shape and are not servable (`check_servable`).

The executor runs the golden torch ops and, under backend 'mxu', the
banded products (ops/mxu_kernels.mxu_valid) on the gathered windows; it
runs no hand-written kernel, as the JAX package's runs no Pallas kernel:
those kernels extend edges at the bucket border, the one thing padding
must not do.
"""

from __future__ import annotations

from typing import Callable

import torch

from mpi_cuda_imagemanipulation_tpu_torch.ops.mxu_kernels import (
    mxu_eligible,
    mxu_valid,
    use_mxu_for_stencil,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import (
    F32,
    QUANTIZERS_F32,
    U8,
    GeometricOp,
    GlobalOp,
    PointwiseOp,
    StencilOp,
    _check_channels,
    exact_f32,
    per_image,
)
from mpi_cuda_imagemanipulation_tpu_torch.plan.exec import apply_pointwise_f32
from mpi_cuda_imagemanipulation_tpu_torch.plan.ir import pipeline_fingerprint
from mpi_cuda_imagemanipulation_tpu_torch.plan.planner import (
    _norm_mode,
    build_plan,
    resolve_plan_mode,
)
from mpi_cuda_imagemanipulation_tpu_torch.tune.store import effective_plan_choice
from mpi_cuda_imagemanipulation_tpu_torch.utils import calibration
from mpi_cuda_imagemanipulation_tpu_torch.utils import env as env_registry
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import as_image_tensor, resolve_device

# the JAX package's 'xla' | 'mxu' | 'auto'
SERVING_BACKENDS = ("torch", "mxu", "auto")


class UnservablePipeline(ValueError):
    """Raised at server start for pipelines the padded executor cannot
    serve byte-exactly (any GeometricOp: it changes the shape)."""


def check_servable(pipe) -> None:
    for op in pipe.ops:
        if isinstance(op, GeometricOp):
            raise UnservablePipeline(
                f"op {op.name!r} changes the image shape; shape-changing "
                "(geometric) ops cannot run under bucket padding: serve a "
                "pipeline without them"
            )


def accepts_channels(pipe, ch: int) -> bool:
    """Whether the pipeline's channel chain admits a `ch`-channel input
    (in_channels/out_channels of 0 mean 'any'/'same'): the warmup grid and
    admission both ask, so a grayscale-first pipeline never builds or
    admits a 1-channel cell it would refuse."""
    for op in pipe.ops:
        if op.in_channels and op.in_channels != ch:
            return False
        ch = op.out_channels or ch
    return True


def min_true_dim(pipe) -> int:
    """Smallest servable image dimension: reflect-101 extension (and the
    golden path's own padding) needs dim >= halo + 1 for every stencil."""
    return pipe.max_halo + 1


def _ext_ids(n_ext: int, halo: int, true_n: torch.Tensor, bucket_n: int,
             edge_mode: str) -> torch.Tensor:
    """(B, n_ext) index maps, n_ext = bucket_n + 2*halo: row b, position j
    holds the TRUE-image index whose value belongs at virtual coordinate
    r = j - halo of image b under the op's edge mode, with the border at
    that image's true extent `true_n[b]`. Indices past the region any
    true-output window reads are clamped garbage: deterministic, unread."""
    r = (torch.arange(n_ext, device=true_n.device) - halo).view(1, n_ext)
    tn = true_n.view(-1, 1)
    if edge_mode == "reflect101":
        idx = torch.where(r < 0, -r, torch.where(r >= tn, 2 * tn - 2 - r, r))
    else:  # edge; and the constant family ('interior'/'zero'): clamp, zero masks after
        idx = torch.minimum(r, tn - 1)
    idx = torch.clamp(idx, min=0)
    return torch.clamp(idx, max=bucket_n - 1)  # safety for the unread tail


def _valid(op: StencilOp, xpad: torch.Tensor) -> torch.Tensor:
    """``op.valid`` over a (B, H+2h, W+2h) stack: the correlations take the
    stack as it is (shifted slices of the last two axes, exact integer
    sums), the window reductions and the median network one plane at a
    time."""
    if op.reduce == "corr":
        return op.valid(xpad)
    return torch.stack([op.valid(p) for p in xpad])


def _finalize_f32(op: StencilOp, acc: torch.Tensor, orig_f32: torch.Tensor,
                  th: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """``StencilOp.finalize_f32`` over a (B, H, W) stack at offset (0, 0),
    the interior guard (kernel.cu:83: x > o && x <= W-1-o, likewise y) at
    each image's TRUE extent, broadcast (B, 1, 1)."""
    q = QUANTIZERS_F32[op.quantize](acc)
    if op.edge_mode != "interior":
        return q
    h, w = acc.shape[-2:]
    yy = torch.arange(h, device=acc.device).view(1, h, 1)
    xx = torch.arange(w, device=acc.device).view(1, 1, w)
    gh, gw = th.view(-1, 1, 1), tw.view(-1, 1, 1)
    o = op.halo
    mask = (xx > o) & (xx <= gw - 1 - o) & (yy > o) & (yy <= gh - 1 - o)
    return torch.where(mask, q, orig_f32)


def _stencil_plane_f32(op: StencilOp, xf: torch.Tensor, th: torch.Tensor, tw: torch.Tensor,
                       backend: str = "torch") -> torch.Tensor:
    """One stencil on a (B, Hb, Wb) f32 exact-integer plane stack; f32
    exact integers out. The planned executor chains these without u8 in
    between; the per-op path wraps them with the u8 casts."""
    h = op.halo
    n, bh, bw = xf.shape
    rid = _ext_ids(bh + 2 * h, h, th, bh, op.edge_mode)
    cid = _ext_ids(bw + 2 * h, h, tw, bw, op.edge_mode)
    b = torch.arange(n, device=xf.device).view(n, 1, 1)
    xpad = xf[b, rid[:, :, None], cid[:, None, :]]  # one indexed read of the stack
    if op.edge_mode == "zero":
        rr = (torch.arange(bh + 2 * h, device=xf.device) - h).view(1, -1)
        cc = (torch.arange(bw + 2 * h, device=xf.device) - h).view(1, -1)
        inside = (((rr >= 0) & (rr < th.view(-1, 1)))[:, :, None]
                  & ((cc >= 0) & (cc < tw.view(-1, 1)))[:, None, :])
        xpad = torch.where(inside, xpad, torch.zeros((), dtype=F32, device=xf.device))
    # the banded products are a drop-in for op.valid on the same gathered
    # windows (TF32 off inside mxu_valid), so they serve byte-identically
    acc = mxu_valid(op, xpad) if backend == "mxu" else _valid(op, xpad)
    return _finalize_f32(op, acc, xf, th, tw)


def _stencil_plane(op: StencilOp, x: torch.Tensor, th, tw, backend: str = "torch") -> torch.Tensor:
    # the cast StencilOp._apply2d makes on entry; exact u8 integers out
    return _stencil_plane_f32(op, x.to(F32), th, tw, backend).to(U8)


def _stencil_backend(op: StencilOp, backend: str, bucket_w: int, device) -> str:
    """Per-op serving backend: 'mxu' sends eligible families to the banded
    products (golden otherwise); 'auto' follows the calibration-gated
    routing (`use_mxu_for_stencil`: never off a CUDA device)."""
    if backend == "mxu":
        return "mxu" if mxu_eligible(op) else "torch"
    if backend == "auto" and use_mxu_for_stencil(op, bucket_w, device) is not None:
        return "mxu"
    return "torch"


def stencil_routes(ops, backend: str, bucket_w: int, device) -> dict[int, str]:
    """``id(op) -> 'torch' | 'mxu'`` for each stencil of `ops`: the routing
    reads the environment and the calibration store, so a built function
    resolves it once, as a JAX trace does, and not per dispatch."""
    return {id(op): _stencil_backend(op, backend, bucket_w, device)
            for op in ops if isinstance(op, StencilOp)}


def _planes(fn, x: torch.Tensor) -> torch.Tensor:
    """`fn` on each channel plane of a (B, H, W[, C]) stack."""
    if x.ndim == 4:
        return torch.stack([fn(x[..., c]) for c in range(x.shape[-1])], dim=-1)
    return fn(x)


def _apply_stencil(op: StencilOp, x: torch.Tensor, th, tw, route: str) -> torch.Tensor:
    _check_channels(op.name, op.in_channels, x[0])  # the gate of op.__call__
    return _planes(lambda p: _stencil_plane(op, p, th, tw, route), x)


def _apply_stencil_f32(op: StencilOp, xf: torch.Tensor, th, tw, route: str) -> torch.Tensor:
    _check_channels(op.name, op.in_channels, xf[0])
    return _planes(lambda p: _stencil_plane_f32(op, p, th, tw, route), xf)


def _apply_global(op: GlobalOp, x: torch.Tensor, th, tw) -> torch.Tensor:
    """One statistic per image under its own true-region mask, then the
    op's apply with that image's statistic."""
    _check_channels(op.name, op.in_channels, x[0])
    bh, bw = x.shape[1:3]
    rows = torch.arange(bh, device=x.device)[:, None]
    cols = torch.arange(bw, device=x.device)[None, :]
    out = []
    for k in range(x.shape[0]):
        valid = (rows < th[k]) & (cols < tw[k])
        if x.ndim == 4:
            valid = valid[..., None]
        out.append(op.apply(x[k], op.stats(x[k], valid)))
    return torch.stack(out)


def padded_apply(pipe, x: torch.Tensor, th: torch.Tensor, tw: torch.Tensor,
                 backend: str = "torch", plan=None, routes=None) -> torch.Tensor:
    """The pipeline over a (B, Hb, Wb[, C]) u8 stack of bucket-shaped
    images with per-image true shapes `th`, `tw` ((B,) integer tensors on
    the stack's device). The output is bucket-shaped; only image b's
    [:th[b], :tw[b]] is meaningful.

    With a built `plan` (plan.ir.Plan), a fused stage keeps the carried
    stack in f32 exact integers between member ops (spec.exact_f32,
    plan/exec.apply_pointwise_f32) and materialises u8 once per stage.
    The true border is rebuilt PER OP either way, by each stencil's gather:
    the per-op extension the induction in the module docstring is proven
    over. `plan=None` is the per-op golden reference. `routes`
    (`stencil_routes`) is each stencil's accumulation as `backend` resolves
    it at the bucket's width; None resolves it here."""
    if routes is None:
        routes = stencil_routes(pipe.ops, backend, x.shape[2], x.device)
    if plan is None:
        for op in pipe.ops:
            if isinstance(op, StencilOp):
                x = _apply_stencil(op, x, th, tw, routes[id(op)])
            elif isinstance(op, GlobalOp):
                x = _apply_global(op, x, th, tw)
            elif isinstance(op, PointwiseOp):
                x = per_image(op, x)
            else:  # pragma: no cover - check_servable refuses these up front
                raise UnservablePipeline(f"op {op.name!r} is not servable")
        return x
    for stage in plan.stages:
        if stage.kind == "global":
            x = _apply_global(stage.ops[0], x, th, tw)
            continue
        if stage.kind == "geometric":  # pragma: no cover - check_servable
            raise UnservablePipeline(f"op {stage.ops[0].name!r} is not servable")
        xf = exact_f32(x)
        for op in stage.ops:
            if isinstance(op, StencilOp):
                xf = _apply_stencil_f32(op, xf, th, tw, routes[id(op)])
            else:
                xf = per_image(lambda c, op=op: apply_pointwise_f32(op, c), xf)
        x = xf.to(U8)
    return x


def _serving_plan_mode(ops, plan: str, backend: str, width: int | None, device) -> str:
    """The build mode. Under 'torch' and 'mxu' the planner's own
    resolution (default 'fused'). Under 'auto' the JAX package's serving
    rule: every mode runs (the executor is the gather walker here, not a
    kernel route), and with no MCIM_PLAN and no recorded choice it stays
    per-op ('off')."""
    if backend != "auto":
        return resolve_plan_mode(ops, plan, backend=backend, width=width, device=device)
    mode = _norm_mode(plan)
    if mode == "auto":
        env_mode = env_registry.get("MCIM_PLAN")
        if env_mode:
            mode = _norm_mode(env_mode)
    if mode != "auto":
        return mode
    choice = effective_plan_choice(
        pipeline_fingerprint(ops), device_kind=calibration.current_device_kind(device),
        width=width,
    )
    return choice if choice is not None else "off"


def resolve_serving_plan(pipe, plan: str, backend: str, bucket_w: int | None, device=None):
    """The built fusion plan this (pipeline, plan knob, backend, bucket
    width, device) serves with, or None for per-op execution. The one
    resolution point `make_serving_fn` (which runs the plan) and
    serve/cache.CompileCache (which keys functions by its fingerprint)
    share, so the two never disagree. 'fused-pallas[-mxu]' serve through
    the same gather walker as 'fused' (a kernel stage extends edges at the
    bucket border), but stay distinct build modes, so their fingerprints
    key the cache apart and a recorded flip to or from them rebuilds."""
    mode = _serving_plan_mode(pipe.ops, plan, backend, bucket_w, device)
    if mode == "off":
        return None
    return build_plan(pipe.ops, mode)


def make_serving_fn(
    pipe,
    bucket_h: int,
    bucket_w: int,
    channels: int,
    batch: int,
    *,
    backend: str = "torch",
    mesh=None,
    on_trace: Callable[[], None] | None = None,
    plan: str = "auto",
    device=None,
):
    """The serving function of one (bucket, channels, batch) cell:

        fn(imgs_u8[B, Hb, Wb(, C)], true_h[B], true_w[B]) -> out[B, ...]

    on `device` (default CUDA; raises without it unless `device='cpu'`).
    The inputs may be numpy arrays or tensors; they are moved to the
    device, and the output is a tensor there. Cropped to
    [:true_h[b], :true_w[b]], image b is byte-equal to the per-request
    golden pipeline. The true shapes are data, so every request shape that
    rounds to this bucket reuses the one function.

    With `mesh` (parallel/mesh.make_mesh), the stack splits over the mesh's
    slots in slot order as ``Pipeline.data_parallel`` splits it, each chunk
    runs on its slot's device, and the chunks are gathered on slot 0's;
    `batch` must divide by the slot count (serve/bucketing.batch_buckets
    guarantees it). `on_trace` fires at the first call for each input
    shape, the counterpart of a JAX trace: the compile cache counts them to
    show warmup covered the grid.

    `backend` chooses the stencil accumulation: 'torch' (the golden
    ``op.valid``), 'mxu' (the banded products for eligible families, a
    drop-in for op.valid on the same gathered windows) or 'auto' (the
    calibration-gated banded routing). The hand-written kernels are refused.
    `plan` (models.pipeline.PLAN_MODES) stages the executor through the
    fusion planner, resolved once here at the bucket's width."""
    if backend not in SERVING_BACKENDS:
        raise ValueError(
            f"serving computes with the golden torch ops or the banded products "
            f"(backend 'torch', 'mxu' or 'auto'; got {backend!r}): the hand-written "
            "kernels ('cuda', 'swar') extend edges at the bucket border, and a "
            "bucket-padded request needs its border rebuilt at its own true shape; "
            "see make_serving_fn's docstring"
        )
    check_servable(pipe)
    if mesh is not None:
        slots = mesh.devices
        if batch % len(slots):
            raise ValueError(f"batch {batch} does not divide over the {len(slots)}-slot mesh")
        dev = slots[0]
    else:
        slots = None
        dev = resolve_device(device)
    built_plan = resolve_serving_plan(pipe, plan, backend, bucket_w, dev)
    routes = stencil_routes(pipe.ops, backend, bucket_w, dev)
    del bucket_h, channels, batch  # keyed by the caller's shapes
    seen: set = set()

    def run(imgs, th, tw) -> torch.Tensor:
        x = as_image_tensor(imgs, dev)
        th = torch.as_tensor(th).to(dev, torch.int64)
        tw = torch.as_tensor(tw).to(dev, torch.int64)
        key = tuple(x.shape)
        if on_trace is not None and key not in seen:
            seen.add(key)
            on_trace()  # once per built function and input shape
        if slots is None:
            return padded_apply(pipe, x, th, tw, backend, built_plan, routes)
        per = x.shape[0] // len(slots)
        outs = [
            padded_apply(pipe, x[s * per:(s + 1) * per].to(d), th[s * per:(s + 1) * per].to(d),
                         tw[s * per:(s + 1) * per].to(d), backend, built_plan, routes).to(dev)
            for s, d in enumerate(slots)
        ]
        return torch.cat(outs)

    return run
