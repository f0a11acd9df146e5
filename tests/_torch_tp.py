"""Helpers of the port's tensor-parallel tests (``test_torch_tp``): a
hard time limit for tests that start rank processes, and the cleanup of
those processes.

A test that starts ranks runs under ``rank_limit``: past its seconds a
timer kills every child process of this one. A rank blocked in a gloo
collective then sees its peer's connection close and raises, so the test
fails instead of hanging the run. Whatever the outcome, the children are
killed and reaped on the way out.
"""

import contextlib
import multiprocessing
import os
import signal
import threading
import time


def kill_children() -> None:
    """Kill and reap every child process this process started."""
    for p in multiprocessing.active_children():
        p.kill()
        p.join(5)


@contextlib.contextmanager
def rank_limit(seconds: float):
    """Run the body with ``seconds`` to finish; its rank processes are
    killed past them, and on the way out in any case."""
    fired = threading.Event()

    def expire():
        fired.set()
        kill_children()

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    try:
        yield fired
    finally:
        timer.cancel()
        kill_children()
    assert not fired.is_set(), f"ranks killed after {seconds} s"


def alive(pid: int) -> bool:
    """Whether ``pid`` is a live (not zombie) process."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False
    return state not in ("Z", "X")


def wait_gone(pids, seconds: float) -> list:
    """Wait up to ``seconds`` for ``pids`` to end; returns those left."""
    t_end = time.monotonic() + seconds
    left = [p for p in pids if alive(p)]
    while left and time.monotonic() < t_end:
        time.sleep(0.1)
        left = [p for p in left if alive(p)]
    return left


def kill_pids(pids) -> None:
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
