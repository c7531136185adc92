"""The port's bucket-padded executor (serve/padded.py) against the JAX
package's, on the CPU, byte for byte.

The same seeded stacks (io.image.synthetic_image, numpy) go through the
port's ``make_serving_fn(device='cpu')`` and the JAX package's jitted
``make_serving_fn``: every image of a stack with its own true shape, so a
statistic summed over the stack (one histogram for the batch) or an
interior guard at the bucket edge shows as a byte difference. Cases: the
JAX package's tests/test_serve.py specs at its shapes (33x47, 17x64,
64x64) in one batch of four with a fourth true shape at the pipeline's
minimum dimension; every edge mode (interior, reflect101, edge, zero);
plans off, fused and auto under backend torch (JAX: xla) and mxu; one and
three channels; the mesh split over CPU slots. Each JAX function is built
once per module (`_jax_out`), and every crop is also held to the port's
golden ``Pipeline.jit(backend='torch', plan='off')``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpi_cuda_imagemanipulation_tpu.models.pipeline import Pipeline as JaxPipeline
from mpi_cuda_imagemanipulation_tpu.serve import padded as jax_padded
from mpi_cuda_imagemanipulation_tpu_torch.io.image import synthetic_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline
from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import make_mesh
from mpi_cuda_imagemanipulation_tpu_torch.serve import bucketing, padded

REFERENCE_OPS = "grayscale,contrast:3.5,emboss:3"
# tests/test_serve.py:105-115 of the JAX package
JAX_SPECS = [
    REFERENCE_OPS,  # interior-mode stencil + pointwise chain
    "gaussian:5,sobel",  # reflect101, magnitude combine
    "erode:5",  # edge mode, min reduce
    "median:3",  # median network
    "grayscale,equalize",  # global statistic (masked histogram)
    "grayscale,contrast:4.3,gamma:2.2",  # lookup-table pointwise ops
]
GLOBAL_SPEC = "grayscale,equalize,gaussian:5"
SHAPES = [(33, 47), (17, 64), (64, 64)]
BUCKET = 64
# (port backend, JAX backend, plan)
ROUTES = [
    ("torch", "xla", "off"), ("torch", "xla", "fused"), ("torch", "xla", "auto"),
    ("mxu", "mxu", "off"), ("mxu", "mxu", "fused"), ("mxu", "mxu", "auto"),
]
ROUTE_IDS = [f"{b}-{p}" for b, _, p in ROUTES]
EDGE_MODES = ("interior", "reflect101", "edge", "zero")


def _pipes(spec):
    return Pipeline.parse(spec), JaxPipeline.parse(spec)


def _edge_pipes(mode: str):
    """gaussian:5 (separable, halo 2) and box:3 with their edge mode set to
    `mode` in both packages (no registry op extends with zeros)."""
    port, jax_pipe = _pipes("gaussian:5,box:3")
    return (Pipeline(tuple(dataclasses.replace(op, edge_mode=mode) for op in port.ops)),
            JaxPipeline(tuple(dataclasses.replace(op, edge_mode=mode) for op in jax_pipe.ops)))


def _batch(pipe, channels: int, seed: int, shapes=None):
    """A stack of four images padded to the bucket: SHAPES and a fourth at
    the pipeline's minimum true dimension, each drawn from its own seed."""
    shapes = list(shapes or SHAPES) + [(padded.min_true_dim(pipe), 40)]
    imgs = [synthetic_image(h, w, channels=channels, seed=seed + k)
            for k, (h, w) in enumerate(shapes)]
    stack = bucketing.pad_stack([bucketing.pad_to_bucket(i, BUCKET, BUCKET) for i in imgs],
                                len(imgs))
    th = np.asarray([h for h, _ in shapes], np.int32)
    tw = np.asarray([w for _, w in shapes], np.int32)
    return imgs, stack, th, tw


_JAX_OUTS: dict = {}


def _jax_out(key, jax_pipe, jax_backend, plan, stack, th, tw):
    """The JAX package's jitted serving function's output, built once per
    module and key."""
    if key not in _JAX_OUTS:
        fn = jax_padded.make_serving_fn(jax_pipe, BUCKET, BUCKET, stack.shape[-1]
                                        if stack.ndim == 4 else 1, stack.shape[0],
                                        backend=jax_backend, plan=plan)
        _JAX_OUTS[key] = np.asarray(fn(stack, th, tw))
    return _JAX_OUTS[key]


def _check(pipe, jax_pipe, key, backend, jax_backend, plan, channels=3, seed=0, shapes=None):
    imgs, stack, th, tw = _batch(pipe, channels, seed, shapes)
    fn = pipe.serving(BUCKET, BUCKET, channels, len(imgs), backend=backend, plan=plan,
                      device="cpu")
    out = fn(stack, th, tw)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    out = out.numpy()
    want = _jax_out((key, channels, seed, tuple(th), tuple(tw)), jax_pipe, jax_backend, plan,
                    stack, th, tw)
    assert out.shape == want.shape
    golden = pipe.jit("torch", device="cpu", plan="off")
    for k, img in enumerate(imgs):
        h, w = int(th[k]), int(tw[k])
        np.testing.assert_array_equal(out[k, :h, :w], want[k, :h, :w], err_msg=f"image {k}")
        np.testing.assert_array_equal(out[k, :h, :w], golden(img).numpy(),
                                      err_msg=f"image {k} vs golden")


@pytest.mark.parametrize("spec", JAX_SPECS)
@pytest.mark.parametrize("route", ROUTES[:2], ids=ROUTE_IDS[:2])
def test_jax_specs_byte_equal(spec, route):
    backend, jax_backend, plan = route
    _check(*_pipes(spec), (spec, route), backend, jax_backend, plan)


@pytest.mark.parametrize("spec", JAX_SPECS)
def test_jax_specs_mxu_byte_equal_golden(spec):
    """The banded products (morphology's threshold decomposition too) on
    the same stacks, held to the port's golden ops: JAX's own mxu
    morphology takes 20 s to build on the CPU, so the JAX comparison of
    the mxu route is on the chains below."""
    pipe = Pipeline.parse(spec)
    # morphology's decomposition is 255 products a plane: one gray stack
    ch, plans = (1, ("off",)) if spec == "erode:5" else (3, ("off", "fused"))
    imgs, stack, th, tw = _batch(pipe, ch, 0)
    for plan in plans:
        out = pipe.serving(BUCKET, BUCKET, ch, 4, backend="mxu", plan=plan, device="cpu")(
            stack, th, tw).numpy()
        for k, img in enumerate(imgs):
            np.testing.assert_array_equal(out[k, :th[k], :tw[k]],
                                          pipe.jit("torch", device="cpu", plan="off")(img).numpy())


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("spec", [REFERENCE_OPS, GLOBAL_SPEC])
def test_every_backend_and_plan_byte_equal(spec, route):
    """The reference chain, and four images of four true shapes through a
    global op between stencils: one histogram per image, under its own
    mask."""
    backend, jax_backend, plan = route
    _check(*_pipes(spec), (spec, route), backend, jax_backend, plan, seed=11)


@pytest.mark.parametrize("route", [ROUTES[0], ROUTES[3], ROUTES[1]],
                         ids=[ROUTE_IDS[0], ROUTE_IDS[3], ROUTE_IDS[1]])
@pytest.mark.parametrize("mode", EDGE_MODES)
def test_every_edge_mode_byte_equal(mode, route):
    backend, jax_backend, plan = route
    _check(*_edge_pipes(mode), ("edge", mode, route), backend, jax_backend, plan, seed=5)


@pytest.mark.parametrize("spec", ["gaussian:5", "median:5,sharpen"])
def test_one_channel_at_the_minimum_dimension(spec):
    """Gray stacks, the fourth image min_true_dim rows tall."""
    _check(*_pipes(spec), ("gray", spec), "torch", "xla", "off", channels=1, seed=3,
           shapes=[(20, 64), (64, 9), (41, 33)])


def test_a_stack_histogram_would_differ():
    """The global-op batch is a real test of per-image statistics: one
    histogram over the whole stack gives other bytes."""
    pipe = Pipeline.parse("grayscale,equalize")
    imgs, stack, th, tw = _batch(pipe, 3, 11)
    gray = torch.stack([Pipeline.parse("grayscale").jit("torch", device="cpu")(s)
                        for s in torch.from_numpy(stack)])
    op = pipe.ops[1]
    rows = torch.arange(BUCKET)[:, None]
    valid = torch.stack([(rows < int(h)) & (torch.arange(BUCKET)[None, :] < int(w))
                         for h, w in zip(th, tw)])
    pooled = op.apply(gray[0], op.stats(gray, valid))
    mine = pipe.serving(BUCKET, BUCKET, 3, 4, device="cpu", plan="off")(stack, th, tw)[0]
    h, w = int(th[0]), int(tw[0])
    assert not torch.equal(pooled[:h, :w], mine[:h, :w])


def test_mesh_split_over_cpu_slots():
    pipe, jax_pipe = _pipes(GLOBAL_SPEC)
    imgs, stack, th, tw = _batch(pipe, 3, 11)
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    out = pipe.serving(BUCKET, BUCKET, 3, 4, mesh=mesh, plan="off")(stack, th, tw).numpy()
    want = pipe.serving(BUCKET, BUCKET, 3, 4, device="cpu", plan="off")(stack, th, tw).numpy()
    np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError, match="does not divide"):
        pipe.serving(BUCKET, BUCKET, 3, 3, mesh=mesh)


def test_on_trace_fires_once_per_input_shape():
    calls = []
    pipe = Pipeline.parse(REFERENCE_OPS)
    fn = pipe.serving(BUCKET, BUCKET, 3, 2, device="cpu", on_trace=lambda: calls.append(1))
    _, stack, th, tw = _batch(pipe, 3, 0)
    for _ in range(3):
        fn(stack[:2], th[:2], tw[:2])
    assert len(calls) == 1
    fn(stack, th, tw)  # another stack shape: another first call
    assert len(calls) == 2


@pytest.mark.parametrize("backend", ["cuda", "swar", "xla", "pallas"])
def test_kernel_backends_refused_with_the_reason(backend):
    with pytest.raises(ValueError, match="bucket border"):
        Pipeline.parse(REFERENCE_OPS).serving(BUCKET, BUCKET, 3, 2, backend=backend,
                                              device="cpu")
    with pytest.raises(ValueError):
        jax_padded.make_serving_fn(JaxPipeline.parse(REFERENCE_OPS), BUCKET, BUCKET, 3, 2,
                                   backend="cuda")


def test_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline.parse(REFERENCE_OPS).serving(BUCKET, BUCKET, 3, 2)


SERVABLE_SPECS = [REFERENCE_OPS, "fliph", "grayscale,rot:90", "gaussian:7", "grayscale,equalize",
                  "gray2rgb,gaussian:3", "erode:5,median:3", "resize:32x32"]


@pytest.mark.parametrize("spec", SERVABLE_SPECS)
def test_servable_channels_and_min_dim_twins(spec):
    port, jax_pipe = _pipes(spec)
    raised = []
    for check, pipe in ((padded.check_servable, port), (jax_padded.check_servable, jax_pipe)):
        try:
            check(pipe)
            raised.append(False)
        except ValueError as e:
            assert type(e).__name__ == "UnservablePipeline"
            raised.append(True)
    assert raised[0] == raised[1]
    for ch in (1, 3):
        assert padded.accepts_channels(port, ch) == jax_padded.accepts_channels(jax_pipe, ch)
    assert padded.min_true_dim(port) == jax_padded.min_true_dim(jax_pipe) == port.max_halo + 1


@pytest.mark.parametrize("plan", ["off", "fused", "pointwise", "fused-pallas", "auto"])
@pytest.mark.parametrize("backend", ["torch", "mxu", "auto"])
def test_resolved_plan_matches_jax(backend, plan):
    jb = {"torch": "xla"}.get(backend, backend)
    port, jax_pipe = _pipes("grayscale,contrast:3.5,gaussian:5,sharpen,quantize:6")
    mine = padded.resolve_serving_plan(port, plan, backend, BUCKET, torch.device("cpu"))
    want = jax_padded.resolve_serving_plan(jax_pipe, plan, jb, BUCKET)
    assert (mine is None) == (want is None)
    if mine is not None:
        assert (mine.mode, mine.fingerprint) == (want.mode, want.fingerprint)
