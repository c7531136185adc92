"""The median host time of the entry, from its call to its return and
before any wait, in milliseconds: the pipeline's Python entry, the routing
it resolves and the wrappers that enqueue its launches. Read from the
traced run's untraced slice, so that the profiler's own cost is not in
it."""

import statistics


def read(rec):
    if not rec.calls:
        return None
    return 1e3 * statistics.median(ret - start for start, ret, _done in rec.calls)
