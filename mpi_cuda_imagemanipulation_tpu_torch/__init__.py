"""mpi_cuda_imagemanipulation_tpu_torch: the image-manipulation pipeline in
PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

The port of the JAX package ``mpi_cuda_imagemanipulation_tpu``, which stays
the reference: the same op registry, the same golden u8 semantics, held
byte for byte against it by the tests. It imports neither JAX nor the JAX
package.

Public API:
  - ``ops``    : op registry, golden semantics, the CUDA kernels and their
                 plain PyTorch versions
  - ``models`` : ``Pipeline`` with backends ``torch`` (golden) and ``cuda``
  - ``io``     : image load/save and the seeded synthetic images
"""

from mpi_cuda_imagemanipulation_tpu_torch._version import __version__
from mpi_cuda_imagemanipulation_tpu_torch.io.image import load_image, save_image
from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import (
    Pipeline,
    reference_pipeline,
)
from mpi_cuda_imagemanipulation_tpu_torch.ops.registry import make_op, make_pipeline_ops

__all__ = [
    "__version__",
    "Pipeline",
    "load_image",
    "make_op",
    "make_pipeline_ops",
    "reference_pipeline",
    "save_image",
]
