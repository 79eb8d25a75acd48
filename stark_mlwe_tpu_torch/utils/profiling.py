"""Profiling: `torch.profiler` traces, phase accounting, device memory.

Counterpart of `utils/profiling.py` of the JAX package (the reference's
tracing surface: criterion benches, the `fri_bench_log` gate and the CSV
emitter, deep_ali/src/fri.rs:12-19, end_to_end.rs:26-78):

  - `trace(logdir)`: a `torch.profiler` capture of the CPU and CUDA
    activities, written into `logdir` as a Chrome/Perfetto trace,
  - the phase accumulator fed by `utils.phase_timer`; `phase_report()`
    gives {phase: {calls, total_s}} and `phase_report_csv()` the CSV,
  - `device_memory_stats(device=None)`: the card's allocator counters.
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import defaultdict

_phase_acc: dict = defaultdict(lambda: [0, 0.0])
_phase_lock = threading.Lock()     # phases are also timed in worker threads


def record_phase(name: str, seconds: float) -> None:
    with _phase_lock:
        cell = _phase_acc[name]
        cell[0] += 1
        cell[1] += seconds


def reset_phases() -> None:
    with _phase_lock:
        _phase_acc.clear()


def phase_report() -> dict:
    with _phase_lock:
        return {k: {"calls": v[0], "total_s": v[1]}
                for k, v in sorted(_phase_acc.items())}


def phase_report_csv() -> str:
    lines = ["phase,calls,total_s"]
    for k, v in phase_report().items():
        lines.append(f"{k},{v['calls']},{v['total_s']:.6f}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """A `torch.profiler` trace of the block, written to
    `logdir/trace.json` (open in Perfetto or chrome://tracing); yields the
    profiler, whose `key_averages()` sum the events by name:

        with profiling.trace("build/trace"):
            prove(...)

    CPU activities always; CUDA activities where `device` is a card
    (`None`: the card, which raises where there is none)."""
    from torch.profiler import ProfilerActivity, profile

    from ..device import resolve

    activities = [ProfilerActivity.CPU]
    if resolve(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """`torch.cuda.memory_stats` of the card, with `device` and
    `max_memory_allocated`.  `device=None` is the current card; without
    one, or for a device that is not a card, this raises."""
    import torch

    from ..device import resolve

    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError(f"device_memory_stats: {dev} is not a CUDA "
                           f"device")
    return {"device": str(dev), **torch.cuda.memory_stats(dev),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (the first card); a
    time is compared only beside the same line."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def host_facts() -> dict:
    """The host CPU's model, its logical cores and whether it has AVX-512
    IFMA (the flag `avx512ifma` in /proc/cpuinfo): the host engine runs the
    Fiat-Shamir absorb of a host-resident witness."""
    model, flags = None, set()
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            key, _, value = line.partition(":")
            key = key.strip()
            if key == "model name" and model is None:
                model = value.strip()
            elif key == "flags" and not flags:
                flags = set(value.split())
    return {"cpu_model": model, "cpu_cores": os.cpu_count(),
            "cpu_cores_usable": len(os.sched_getaffinity(0)),
            "avx512ifma": "avx512ifma" in flags}
