"""The share, in percent, of the cards' busy time in the traced slice that
the pipeline's least bytes would take at the HBM's published rate
(roofline.py): the frames' u8 inputs read once and outputs written once,
over 3.35 TB/s a card, against the union of every kernel, copy and fill,
summed over the cards. It counts the work the pipeline needs, whatever
kernels or route implement it."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    frames = tr.calls * rec.frames_per_call
    return 100.0 * frames * rec.least_seconds_per_frame / tr.busy_total
