"""Seconds from the start of the harness's process to the start of the
measured window: imports, the CUDA context, the kernels' build where it is
the checkout's first run, the pool made on the card, the warm calls."""


def read(rec):
    return rec.setup_s
