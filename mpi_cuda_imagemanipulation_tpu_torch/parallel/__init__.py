"""Row-sharded execution: the mesh (mesh.py), the ghost-strip exchange
(halo.py) and the sharded pipeline runner (api.py). The counterpart of the
JAX package's ``parallel/``; ``api2d`` (2-D tile shards) is not ported
yet."""

from mpi_cuda_imagemanipulation_tpu_torch.parallel.mesh import (  # noqa: F401
    ROWS,
    Mesh,
    distributed_init,
    make_mesh,
    mesh_from_shards,
    parse_shards,
)
