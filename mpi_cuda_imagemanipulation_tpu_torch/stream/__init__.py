"""Constant-footprint streaming tile engine: gigapixel images and video as
row-band streams through the engine (engine/core.py), with fixed-shape
tiles, seam-stitched halos (parallel/halo host strips) and incremental
decode and encode (io/stream_codec). The counterpart of the JAX package's
``stream/``; its live video sessions (stream/video.py VideoSessionHost)
serve frames behind the fabric router."""

from mpi_cuda_imagemanipulation_tpu_torch.stream.metrics import StreamMetrics
from mpi_cuda_imagemanipulation_tpu_torch.stream.runner import (
    DEFAULT_TILE_ROWS,
    StreamResult,
    resumable_tiles,
    stream_fingerprint,
    stream_pipeline,
)
from mpi_cuda_imagemanipulation_tpu_torch.stream.tiles import (
    StreamabilityError,
    plan_tiles,
    validate_stream_ops,
)
from mpi_cuda_imagemanipulation_tpu_torch.stream.video import stream_video

__all__ = [
    "DEFAULT_TILE_ROWS",
    "StreamMetrics",
    "StreamResult",
    "StreamabilityError",
    "plan_tiles",
    "resumable_tiles",
    "stream_fingerprint",
    "stream_pipeline",
    "stream_video",
    "validate_stream_ops",
]
