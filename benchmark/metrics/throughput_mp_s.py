"""Megapixels of every frame completed in the window over the window's
seconds on the host clock (from its start to the end of its last call's
wait)."""


def read(rec):
    if not rec.calls or rec.window is None:
        return None
    start, end = rec.window
    return len(rec.calls) * rec.frames_per_call * rec.megapixels_per_frame / (end - start)
