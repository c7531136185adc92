"""The share of the traced slice in which nothing ran on the card: one
less the union of every kernel, copy and fill over the slice's length,
averaged over the cards the cell uses."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    return 1.0 - tr.busy / tr.length
