"""A `torch.profiler` trace of a stretch of whole proofs, and what the
per-layer readers take from it.

The stretch follows the measured window: one proof lets the profiler
settle, then proofs run until `trace_seconds` have passed.  Each proof
is a `record_function` span ("perfbench.proof"), which places the
harness's clock on the trace's.  The program's phase timers report to
`stark_mlwe_tpu_torch.utils.profiling.record_phase`; while the stretch
runs, a wrapper keeps each phase's start and end, so that an idle gap on
the device is named by the phase the host was in.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import tempfile
import time
from dataclasses import dataclass, field

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROOF_SPAN = "perfbench.proof"
SETTLE_SPAN = "perfbench.settle"


@dataclass
class Stretch:
    """What a traced stretch read: seconds on the trace's clock."""

    proofs: int
    window_s: float
    busy_s: float
    device_s: dict                    # short kernel name -> seconds
    idle_gaps: list = field(default_factory=list)   # (phase, seconds)

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, s in self.device_s.items() if rx.search(name))

    def top_ops(self, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.device_s.items(),
                                          key=lambda kv: -kv[1])[:n]]


def short_name(name: str) -> str:
    """'void poseidon_permute_warp_kernel<17>(unsigned int const*, ...)'
    -> 'poseidon_permute_warp_kernel<17>'."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:160].strip()


class PhaseSpans:
    """Keeps (name, start, end) of every program phase that ends while it
    is entered, on `time.perf_counter`'s clock."""

    def __init__(self):
        self.spans: list = []
        self._mod = None
        self._orig = None

    def __enter__(self):
        import importlib

        try:
            self._mod = importlib.import_module(
                "stark_mlwe_tpu_torch.utils.profiling")
        except ImportError:
            return self
        self._orig = getattr(self._mod, "record_phase", None)
        if self._orig is None:
            return self
        orig, spans = self._orig, self.spans

        def record_phase(name, seconds):
            end = time.perf_counter()
            spans.append((name, end - seconds, end))
            return orig(name, seconds)

        self._mod.record_phase = record_phase
        return self

    def __exit__(self, *exc):
        if self._orig is not None:
            self._mod.record_phase = self._orig
        return False


def profile_stretch(prove_next, min_seconds: float, cuda: bool) -> tuple:
    """Runs `prove_next()` under the profiler: once to settle, then until
    `min_seconds` have passed, whole proofs.  Returns (records of every
    proof run, each (start, end, proof or None, error or None), the
    parsed Stretch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    records, spans = [], []

    def one(label):
        s = time.perf_counter()
        with record_function(label):
            proof, err = prove_next()
        e = time.perf_counter()
        records.append((s, e, proof, err))
        return s, e

    tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
    try:
        with PhaseSpans() as phases, profile(activities=acts) as prof:
            one(SETTLE_SPAN)
            t0 = time.perf_counter()
            while True:
                spans.append(one(PROOF_SPAN))
                if spans[-1][1] - t0 >= min_seconds:
                    break
            if cuda:
                torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return records, read_stretch(events, spans, phases.spans)


def read_stretch(events: list, proof_spans: list, phase_spans: list):
    """The Stretch of a chrome trace's events: `proof_spans` are the
    harness's (start, end) of the traced proofs, in order; `phase_spans`
    the program's (name, start, end); both on perf_counter seconds."""
    marks = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
                   if e.get("ph") == "X" and e.get("name") == PROOF_SPAN
                   and e.get("cat") == "user_annotation")
    if not marks or len(marks) != len(proof_spans):
        return None
    # trace microseconds = perf_counter seconds * 1e6 + offset
    offset = statistics.median(m[0] - s * 1e6
                               for m, (s, _) in zip(marks, proof_spans))
    lo, hi = marks[0][0], marks[-1][1]
    dev, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if s + d <= lo or s >= hi:
            continue
        dev.append((s, s + d))
        name = short_name(e.get("name", "?"))
        clipped = min(s + d, hi) - max(s, lo)
        by_name[name] = by_name.get(name, 0.0) + clipped / 1e6
    proof_us = [(s * 1e6 + offset, e * 1e6 + offset) for s, e in proof_spans]
    phase_us = [(n, s * 1e6 + offset, e * 1e6 + offset)
                for n, s, e in phase_spans]
    gaps = []
    for g0, g1 in stats.gaps(dev, lo, hi):
        gaps.append((_host_state((g0 + g1) / 2, phase_us, proof_us),
                     (g1 - g0) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return Stretch(len(proof_spans), (hi - lo) / 1e6,
                   stats.covered(dev, lo, hi) / 1e6, by_name, gaps)


def _host_state(t: float, phases: list, proofs: list) -> str:
    """The innermost program phase open at t, else where in a proof."""
    inner = [(e - s, n) for n, s, e in phases if s <= t <= e]
    if inner:
        return min(inner)[1]
    if any(s <= t <= e for s, e in proofs):
        return "proof, outside the program's phases"
    return "harness, between proofs"
