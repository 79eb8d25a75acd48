"""Every process a run started is stopped and waited for before it exits.

The reference's worker pool is joined where it is closed.  What can
outlive it is multiprocessing's resource tracker: the pool's locks start
it, and Python 3.12 releases before the fix of CPython issue 88887 leave
it to notice on its own, after the run has exited, that its parent is
gone.  `stop_all` stops and reaps every child still there (a pool left
open by an exception, a compiler), then closes the tracker's pipe and
waits for it.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.util
import os
import signal
import sys
import time


def children() -> list:
    """Pids of this process's children, zombies included."""
    pid = os.getpid()
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return sorted(out)


def _tracker():
    from multiprocessing import resource_tracker

    return resource_tracker._resource_tracker


def _reap(pid: int, deadline: float) -> bool:
    """Wait for `pid` until `deadline`; True once it is reaped or gone."""
    while True:
        try:
            done, _ = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            return True
        if done:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.02)


def _end(pids: list, grace_s: float) -> None:
    """Reap each of `pids`, killing those still there after `grace_s`."""
    deadline = time.monotonic() + grace_s
    for pid in pids:
        if not _reap(pid, deadline):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            _reap(pid, float("inf"))


def stop_all(grace_s: float = 10.0) -> list:
    """Stop every child of this process and wait for each to end: open
    pools (their finalizers, as at interpreter exit, so that no pool
    starts new workers), other multiprocessing children, any other child
    (SIGTERM, SIGKILL after `grace_s`), and last the resource tracker,
    which ends once no child holds its pipe.  Returns the pids found in
    the third step, which a sound run leaves empty."""
    run_finalizers = getattr(multiprocessing.util, "_run_finalizers", None)
    if run_finalizers is not None:
        run_finalizers(0)
    for p in multiprocessing.active_children():
        p.terminate()
        p.join(grace_s)
    tracker = _tracker()
    tracker_pid = getattr(tracker, "_pid", None)
    left = [pid for pid in children() if pid != tracker_pid]
    if left:
        print(f"[perfbench] stopping leftover child processes {left}",
              file=sys.stderr, flush=True)
    for pid in left:
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    _end(left, grace_s)
    if tracker_pid is not None:
        if getattr(tracker, "_fd", None) is not None:
            os.close(tracker._fd)
            tracker._fd = None
        _end([tracker_pid], grace_s)
        tracker._pid = None
    return left
