"""``Pipeline.batched``: a stack of frames a call, on the first card, by
the backend and plan the mix names; inputs are not donated, since the
pool is reused."""


def make(cell, devices):
    from mpi_cuda_imagemanipulation_tpu_torch.models.pipeline import Pipeline

    t = cell.traffic
    return Pipeline.parse(cell.config["pipeline"]).batched(
        backend=t["backend"], plan=t["plan"], device=devices[0])
