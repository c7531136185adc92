"""Processes a test module left running.

A pod's replicas (and the supervisor tests' stand-in workers) are
``subprocess.Popen`` children of the process that runs the tests. The
`no_children_left` fixture notes this process's live children before the
module and, after it, fails if any new one is still running a few seconds
later, killing it first so that nothing outlives the run.
"""

import os
import signal
import time

import pytest


def live_children(parent: int | None = None) -> dict[int, str]:
    """The live (not zombie) children of `parent` (default: this process),
    pid -> command line, read from /proc."""
    parent = os.getpid() if parent is None else parent
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        if int(fields[1]) == parent and fields[0] != "Z":
            out[int(name)] = cmd
    return out


@pytest.fixture(autouse=True, scope="module")
def no_children_left():
    before = set(live_children())
    yield
    deadline = time.monotonic() + 10.0
    while True:
        left = {pid: cmd for pid, cmd in live_children().items() if pid not in before}
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    if left:
        pytest.fail(f"processes left running after the module: {left}")
