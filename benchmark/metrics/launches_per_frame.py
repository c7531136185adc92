"""Kernel launches on the cards in the traced slice over the frames its
calls completed (a stack counts its frames)."""

import tracing


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    kernels = sum(1 for d in tr.device if d[1] in tracing.KERNEL_CATS)
    return kernels / (tr.calls * rec.frames_per_call)
