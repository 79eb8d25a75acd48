"""Where the port's compiled objects go, and how they are built.

Nothing compiled is committed: the host engine (`native/poseidon.cpp`,
g++) and the CUDA kernels (`csrc/*.cu`, nvcc for sm_90a) are built at
first use into `build/` at the root of the checkout (git-ignored).
"""

from __future__ import annotations

import os
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))


def build_dir() -> str:
    d = os.path.join(os.path.dirname(_PKG), "build")
    os.makedirs(d, exist_ok=True)
    return d


def stale(target: str, sources) -> bool:
    if not os.path.exists(target):
        return True
    mt = os.path.getmtime(target)
    return any(os.path.getmtime(s) > mt for s in sources)


def start(cmd, target: str):
    """Start a compiler writing `target` (through a per-process temporary,
    so concurrent builds never load a half-written file)."""
    tmp = f"{target}.tmp.{os.getpid()}"
    full = [tmp if a == target else a for a in cmd]
    proc = subprocess.Popen(full, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, full


def finish(job, target: str) -> str:
    """Wait for a compiler started with `start`; raises with its output."""
    proc, tmp, full = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"build failed ({proc.returncode}): {' '.join(full)}\n{out}")
    os.replace(tmp, target)
    return out
