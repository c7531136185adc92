"""Sharded execution: the meshes (mesh.py), the ghost-strip exchange
(halo.py), the row-sharded pipeline runner (api.py), the 2-D tile-sharded
runner (api2d.py) and the systolic stage-mesh runner (systolic.py). The
counterpart of the JAX package's ``parallel/``."""

from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import (  # noqa: F401
    COLS,
    ROWS,
    Mesh,
    Mesh2D,
    distributed_init,
    make_mesh,
    make_mesh_2d,
    mesh_from_shards,
    parse_shards,
)
