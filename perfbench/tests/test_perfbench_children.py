"""A run leaves no process behind: `children.stop_all` stops the
reference's pool, the resource tracker its locks start, and any other
child, and waits for each, so nothing of the run's session is left the
moment it exits.  The tracker's own stop at exit (CPython issue 88887) is
switched off in the child, as Python 3.12 releases without that fix
have it."""

import os
import signal
import subprocess
import sys
import textwrap

import pytest

from perfbench.harness import registry

SCRIPT = textwrap.dedent("""
    import subprocess, sys
    sys.path.insert(0, {root!r})
    import multiprocessing.resource_tracker as rt
    rt.ResourceTracker.__del__ = lambda self: None
    from perfbench.harness import children
    from perfbench.reference.workers import Workers

    def square(xs):
        return [x * x for x in xs]

    if __name__ == "__main__":
        with Workers(2) as w:
            assert w.map_items(square, (), list(range(100)))[-1] == 99 ** 2
        open_pool = Workers(2)
        sleeper = subprocess.Popen(["sleep", "60"])
        if {stop}:
            left = children.stop_all(grace_s=2.0)
            assert sleeper.pid in left, left
        print("done", flush=True)
""")


def _in_session(sid: int) -> list:
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            out.append(int(entry))
    return out


@pytest.mark.parametrize("stop", [True, False])
def test_nothing_outlives_a_run(tmp_path, stop):
    path = tmp_path / "run.py"
    path.write_text(SCRIPT.format(root=registry.REPO_ROOT, stop=stop))
    # the output goes to a file, so the wait ends when the run exits, not
    # when the last holder of a pipe does
    with open(tmp_path / "out", "w") as fh:
        proc = subprocess.Popen([sys.executable, str(path)], cwd=tmp_path,
                                start_new_session=True, stdout=fh)
    try:
        proc.wait(timeout=120)
        left = _in_session(proc.pid)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    out = (tmp_path / "out").read_text()
    assert proc.returncode == 0 and out.strip() == "done"
    if stop:
        assert left == []
    else:
        # without it the sleeper and the tracker outlive the run
        assert left
