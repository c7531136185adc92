"""The 95th percentile of every call's latency in the window, by nearest
rank: from the call's start to the end of the wait on its result, on the
host clock, in milliseconds."""

import math


def p95(values):
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def read(rec):
    if not rec.calls:
        return None
    return 1e3 * p95([done - start for start, _ret, done in rec.calls])
