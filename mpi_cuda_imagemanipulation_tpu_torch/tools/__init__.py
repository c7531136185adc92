"""The tools: the counterparts of the JAX repository's ``tools/`` probes,
each runnable as ``python -m mpi_cuda_imagemanipulation_tpu_torch.tools.<name>``.

* ``roofline_probe``: T4, the copy kernels that measure the card's reachable
  streaming rate (``ops/csrc/copy_probe.cu``).
* ``packed_proto``: T2, a pointwise chain on four-pixel words
  (``ops/csrc/packed_proto.cu``), with the packed-lane helpers.
* ``swar_proto``: T3, the 5x5 Gaussian on quarter-strip words, SWAR
  (``ops/csrc/swar_proto.cu``).

Each runs on the card unless ``--device cpu`` is given, which runs the plain
versions. Records name the card and its power limit; times on the card come
from CUDA events (``utils/timing.device_time_ms``).
"""
