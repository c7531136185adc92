"""Asynchronous pipelined execution engine (engine/core.py): bounded
in-flight dispatch, pinned side-stream H2D and D2H, in-order completion,
an encode and write worker pool; ``batch --inflight`` runs on it."""

from mpi_cuda_imagemanipulation_tpu_torch.engine.core import (
    DEFAULT_INFLIGHT,
    DEFAULT_IO_THREADS,
    Engine,
    device_stager,
)
from mpi_cuda_imagemanipulation_tpu_torch.engine.metrics import EngineMetrics

__all__ = [
    "DEFAULT_INFLIGHT",
    "DEFAULT_IO_THREADS",
    "Engine",
    "EngineMetrics",
    "device_stager",
]
