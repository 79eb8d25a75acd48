"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

A closed loop with one client: a prover worker takes the next witness
of the pool as soon as the last proof is returned.  The window opens at
the first proof's start, no proof starts after `seconds`, and it closes
at the last proof's end; only whole proofs count.  Nothing else runs in
the window.  After it, with `trace`, a stretch of proofs runs under the
profiler.  Then the program's device state is dropped and the reference
proves the sampled witnesses again on the host's cores.
"""

from __future__ import annotations

import gc
import os
import random
import sys
import time
from dataclasses import dataclass

from . import canon, registry, stats, tracing
from .readers import ReadContext

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "stark_mlwe_tpu")


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def process_age() -> float:
    """Seconds since this process started (its start time in
    /proc/self/stat against the boot clock)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


@dataclass
class Record:
    witness: int
    start: float
    end: float
    proof: object
    error: str | None


def _log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def _sync(cuda: bool) -> None:
    if cuda:
        import torch

        torch.cuda.synchronize()


def _phases():
    try:
        from stark_mlwe_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def _device_facts(cuda: bool, chips: int) -> dict:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips,
           "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                    for d in range(chips))}
    try:
        import subprocess

        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()[0]
        out["power_limit_w"] = float(line)
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, root: str = registry.REPO_ROOT,
             prove_override=None, workers: int | None = None) -> dict:
    """The result line of one run.  `device=None` is the card; tests pass
    "cpu".  `prove_override(system, j)`, where given, replaces the
    program's timed call (the control and the fault tests)."""
    from perfbench.reference.poseidon import Suite
    from perfbench.reference.workers import Workers

    try:
        t_born = time.perf_counter() - process_age()
    except (OSError, ValueError, IndexError):
        t_born = time.perf_counter()
    bench = registry.load_benchmark(root)
    cell = registry.cell(bench, workload)
    config = registry.config(bench, cell["config"], root)
    traffic = registry.traffic(cell["traffic"], root)
    if traffic.get("loop", "closed") != "closed" or \
            int(traffic.get("clients", 1)) != 1:
        raise ValueError("the harness drives one client in a closed loop")
    cuda = device is None or str(device).startswith("cuda")
    chips = int(cell.get("chips", 1))

    import torch  # noqa: F401  (imported here: the CUDA context is set-up)

    sysmod = registry.system(config["system"], root)
    system = sysmod.System(config, traffic, seed, device)
    t = time.perf_counter()
    system.setup()
    t_pool = time.perf_counter() - t

    def prove(j):
        if prove_override is not None:
            return prove_override(system, j)
        return system.prove(j)

    def attempt(j):
        try:
            return prove(j), None
        except Exception as exc:       # a failed proof is counted, not fatal
            return None, f"{type(exc).__name__}: {exc}"

    t = time.perf_counter()
    for j in range(int(traffic.get("warmup_proofs", 1))):
        _, err = attempt(j % system.pool)
        if err:
            _log(f"warm-up proof failed: {err}")
    _sync(cuda)
    t_warm = time.perf_counter() - t

    profiling = _phases()
    if profiling is not None:
        profiling.reset_phases()
    records: list = []
    # The proofs are kept for the check after the window; a prover would
    # hand them out and free them.  Frozen, they and the set-up's objects
    # are not walked by the collector in the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_born
    t_open = time.perf_counter()
    min_proofs = int(traffic.get("min_proofs", 1))
    while len(records) < min_proofs or \
            time.perf_counter() - t_open < seconds:
        j = len(records) % system.pool
        s = time.perf_counter()
        proof, err = attempt(j)
        records.append(Record(j, s, time.perf_counter(), proof, err))
        gc.freeze()
    _sync(cuda)
    window_records = list(records)
    phases = ({k: v["total_s"] for k, v in profiling.phase_report().items()}
              if profiling is not None else {})

    stretch = None
    if trace:
        def prove_next():
            j = (len(records) + len(pending)) % system.pool
            out = attempt(j)
            pending.append(j)
            return out

        pending: list = []
        traced, stretch = tracing.profile_stretch(
            prove_next, float(traffic.get("trace_seconds", 3.0)), cuda)
        for j, (s, e, proof, err) in zip(pending, traced):
            records.append(Record(j, s, e, proof, err))

    facts = _device_facts(cuda, chips)
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(", ".join(found))

    system.release()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    checks = check(system, records, seed, config, Suite(), Workers(workers))
    t_ref = time.perf_counter() - t

    spans = [(r.start, r.end) for r in window_records]
    ok = [r for r in window_records if r.error is None]
    _log(f"{workload}: seed {seed}, {len(window_records)} proofs in "
         f"{stats.window(spans)[1] - stats.window(spans)[0]:.3f} s "
         f"({len(window_records) - len(ok)} failed); set-up {setup_s:.3f} s "
         f"(witness pool and program {t_pool:.3f}, warm-up {t_warm:.3f}); "
         f"reference check {t_ref:.3f} s")
    if window_records:
        lat = [r.end - r.start for r in window_records]
        _log(f"latency s: first {lat[0]:.4f}, median "
             f"{stats.percentile(lat, 50):.4f}, max {max(lat):.4f}")
    for r in records:
        if r.error:
            _log(f"proof of witness {r.witness} failed: {r.error}")
            break

    metrics = {}
    if not trace:
        lat_ms = [(r.end - r.start) * 1e3 for r in window_records]
        values = {"proofs_per_s": stats.rate(spans, len(ok)),
                  "prove_p95_ms": stats.percentile(lat_ms, 95),
                  "setup_s": setup_s}
        # a metric named `<quantity>.<suffix>` is that quantity in the
        # cells it lists, each such name with a bound of its own
        for m in registry.metrics_of_cell(bench, workload, "end_to_end"):
            quantity = m["name"].split(".", 1)[0]
            if quantity in values:
                metrics[m["name"]] = {"value": values[quantity],
                                      "unit": m["unit"]}
    else:
        ctx = ReadContext(config=config, traffic=traffic, cell=cell,
                          proofs=len(window_records), phases=phases,
                          stretch=stretch)
        for m in registry.metrics_of_cell(bench, workload, "per_layer"):
            value = registry.metric_reader(m["name"], root).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if stretch is not None:
            facts["busy_s"] = stretch.busy_s
            facts["window_s"] = stretch.window_s

    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(records),
           "failed": sum(1 for r in records if r.error is not None),
           "metrics": metrics, "device": facts}
    if stretch is not None:
        out["breakdown"] = {
            "device_ops": stretch.top_ops(10),
            "idle_gaps": [[n, s] for n, s in stretch.idle_gaps[:10]]}
    out["checks"] = checks
    return out


def check(system, records: list, seed: int, config: dict, suite,
          workers) -> dict:
    """The numbers `correct` is decided on, each with its limit:
    `ref_mismatch`: leaves in which the sampled proofs differ from the
    reference's proofs of the same witnesses; `repeat_mismatch`: proofs
    that differ from the first proof of their witness in the run;
    `failed`: proofs that raised; `unchecked`: sampled proofs the
    reference did not reach (the run made too few)."""
    ok = [r for r in records if r.error is None]
    want = int(config.get("check_proofs", 1))
    first, repeat = {}, 0
    for r in ok:
        lv = canon.leaves(r.proof)
        if r.witness not in first:
            first[r.witness] = lv
        elif canon.mismatches(first[r.witness], lv):
            repeat += 1
    rng = random.Random(f"perfbench-check:{seed}")
    order = list(range(len(ok)))
    rng.shuffle(order)
    picked = []
    for i in order:
        if ok[i].witness not in picked:
            picked.append(ok[i].witness)
        if len(picked) == want:
            break
    ref_mismatch = 0
    with workers:
        for j in picked:
            ref = canon.leaves(system.reference(j, suite, workers))
            ref_mismatch += canon.mismatches(first[j], ref)
    return {"ref_mismatch": {"value": ref_mismatch, "limit": 0},
            "repeat_mismatch": {"value": repeat, "limit": 0},
            "failed": {"value": len(records) - len(ok), "limit": 0},
            "unchecked": {"value": want - len(picked), "limit": 0}}
