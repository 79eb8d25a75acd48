"""Profile one prove of the PyTorch/CUDA port on the GPU.

    python3 scripts/profile_torch_prove.py [--k 16] [--schedule 16,16,8]
                                           [--device-witness] [--out DIR]

Proves `MlweWitness.random(k, seed=1234)` at the given schedule (default:
the paper schedule [16,16,8]), r=32, from host columns or, with
`--device-witness`, from columns that already lie on the card (the device
branch of `build_f0`), once to warm up (kernel build, constants), then once more under
`torch.profiler` (CPU + CUDA activities) and prints one JSON line: wall
seconds of the traced prove, seconds the card was busy (sum of device time
over all kernels and copies), the idle share, and device time by kernel
name, with the launches of the traced prove by counter
(`kernels.launches`: K1's two layouts apart).  The three launches of the
f0 quotient (`fr_batch_inv_scan`, `_total`, `_sweep`) are always listed,
and summed in `fr_batch_inv_device_ms`.  A second untraced prove is
timed as well, so the cost of tracing shows.  With `--out` the chrome
trace is written there.  Needs a CUDA device; exits with code 2 without
one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--schedule", default="16,16,8")
    ap.add_argument("--device-witness", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from stark_mlwe_tpu_torch import fri, kernels
    from stark_mlwe_tpu_torch.stark import DeepFriParams, MlweWitness, prove

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    schedule = [int(m) for m in args.schedule.split(",")]
    params = DeepFriParams(schedule=schedule, r=32, seed_z=0xDEEFBAAD)
    w = MlweWitness.random(k=args.k, seed=1234)
    cols = w.to_device() if args.device_witness else None

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cols is None:
            prove(w, params)
        else:
            fri.deep_fri_prove(fri.DeviceDeepAliRealBuilder(), *cols,
                               1 << args.k, params)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm = timed()
    plain = timed()
    phases = dict(fri.phase_seconds)
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = timed()
    by_name = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        self_us = getattr(ev, "self_device_time_total", None)
        if self_us is None:
            self_us = getattr(ev, "self_cuda_time_total", 0.0)
        if self_us > 0:
            by_name[ev.key] = {"calls": ev.count, "device_ms": self_us / 1e3}
    busy = sum(v["device_ms"] for v in by_name.values()) / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms"])
               [:12])
    quotient = {k: v for k, v in by_name.items() if "fr_batch_inv" in k}
    top |= quotient
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "prove_trace.json"))
    print(json.dumps({
        "card": card, "k": args.k, "schedule": schedule,
        "device_witness": args.device_witness, "first_prove_seconds": warm,
        "prove_seconds": plain, "traced_prove_seconds": traced,
        "device_busy_seconds": busy,
        "device_idle_share": (1.0 - busy / traced) if busy else None,
        "phase_seconds": phases, "device_ms_by_kernel": top,
        "fr_batch_inv_device_ms": sum(v["device_ms"]
                                      for v in quotient.values()),
        "launches": {n: c for n, c in kernels.launches.items() if c}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
