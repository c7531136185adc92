"""The closed loop: one call in flight. Take the next input of the pool,
call the entry, wait until its work is done on the card, record the
call's start, return and end on the host clock, and go on. A call's
latency runs from its start to the end of its wait. The mix gives no
parameter here."""

import time


def drive(fn, pool, *, wait, reservoir, mix, seconds=None, calls=None, first=0):
    if (seconds is None) == (calls is None):
        raise ValueError("give seconds or calls, not both")
    clock = time.perf_counter
    n = len(pool)
    i = first
    times = []
    start = clock()
    while True:
        k = i % n
        x = pool[k]
        t0 = clock()
        out = fn(x)
        t1 = clock()
        wait()
        t2 = clock()
        times.append((t0, t1, t2))
        if reservoir is not None:
            reservoir.offer(k, out)
        del out
        i += 1
        if seconds is not None and t2 - start >= seconds:
            break
        if calls is not None and len(times) >= calls:
            break
    return start, times, i
