"""``Pipeline.jit``: one frame a call, on the first card, by the backend
and plan the mix names."""


def make(cell, devices):
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    if cell.stack != 1:
        raise ValueError("the jit entry takes one frame a call")
    t = cell.traffic
    return Pipeline.parse(cell.config["pipeline"]).jit(
        backend=t["backend"], plan=t["plan"], device=devices[0])
