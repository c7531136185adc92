"""Pipeline: an op sequence over an image, with two backends.

* ``backend='torch'``: the golden PyTorch ops, op by op (the oracle).
* ``backend='cuda'`` : the hand-written kernels, one launch per
  ``[pointwise*, stencil?]`` group (ops/cuda_kernels.py).

Both give the same u8 bytes.
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
from mpi_cuda_imagemanipulation_tpu_torch.ops.spec import Op
from mpi_cuda_imagemanipulation_tpu_torch.utils.device import (
    as_image_tensor,
    resolve_device,
)

BACKENDS = ("torch", "cuda")


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

    def _callable(self, backend: str, block_h: int | None = None):
        if backend == "torch":
            return self.apply
        if backend == "cuda":
            from mpi_cuda_imagemanipulation_tpu_torch.ops.cuda_kernels import (
                pipeline_cuda,
            )

            return partial(pipeline_cuda, self.ops, block_h=block_h)
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")

    def jit(
        self,
        backend: str = "cuda",
        block_h: int | None = None,
        *,
        device: str | torch.device | None = None,
    ):
        """An image -> image function on `device` (default CUDA), the
        counterpart of the JAX package's ``Pipeline.jit``. PyTorch runs
        eagerly: nothing is traced or compiled here; the CUDA kernels are
        built at their first launch.

        The function takes a uint8 numpy array or tensor, moves it to the
        device, and returns a tensor there. `block_h` sets the stencil
        kernel's tile height. With no CUDA device, the default raises."""
        dev = resolve_device(device)
        fn = self._callable(backend, block_h)

        def run(img) -> torch.Tensor:
            return fn(as_image_tensor(img, dev))

        return run


def reference_pipeline() -> Pipeline:
    """The reference's exact pipeline: grayscale -> contrast 3.5 -> emboss 3x3
    (kernel.cu:192-195, smallEmboss=true)."""
    return Pipeline.parse(REFERENCE_PIPELINE_SPEC)


def reference_cpu_pipeline() -> Pipeline:
    """The reference's CPU/OpenCV program (kern.cpp:73-75): Rec.601
    grayscale, contrast 3, reflect-101 emboss."""
    return Pipeline.parse(REFERENCE_CPU_PIPELINE_SPEC)
