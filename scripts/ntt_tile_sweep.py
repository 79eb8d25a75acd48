#!/usr/bin/env python3
"""K6's layouts side by side on the card, at the two launches of 2^22, and
where its time goes.

    python3 scripts/ntt_tile_sweep.py [--reps 7]

Builds `csrc/fr_ntt.cu` (K6) and `scripts/ntt_tile_sweep.cu` (K6's block
routine under other launch parameters) and runs the two launches that
`ops.ntt.ntt` gives a transform of n = 2^22 (2,048 x 2,048): the columns
(element stride 2,048, the 128 MiB step-twiddle epilogue, a transposed
store) and the rows (no epilogue, a transposed store).

  layouts     every (r, bound, tpb, threads): the passes' radix r = 2, 3, 4
              (2^r elements a thread, r stages between two barriers) under
              a `__launch_bounds__` of 512 or 256 threads (which caps a
              thread's registers at 128 or 255), one or two transforms a
              block (tpb), and one thread a group of 2^r slots (at most the
              bound) or half of that (two groups a thread).  Each output
              must equal `ntt_tiles_plain` exactly.
  dispatched  K6 as `ops.ntt.ntt_tiles` launches it, exact, timed the same
              way: the sweep's (2, 512, 1, 256) row is the same code.
  parts       at K6's layout, K6 and the same steps with no twiddle load
              and no product, in turns (K6, parts, parts, K6): the
              products' share of the time.
  instances   registers and spill bytes of each instance of the sweep's
              build (`ptxas -v`; K6's own are on its `chip_smoke.py` row),
              and the SASS instructions of K6 by opcode (`cuobjdump -sass`).

Times are medians of `--reps` CUDA-event samples after a warm-up, samples
printed.  Prints the card's name and power limit, then one JSON line.
`NTT_R` and `NTT_THREADS` (csrc/ntt.cuh) and `_BLOCK_ELEMS` (ops/ntt.py) are
read from this script's output.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (r, __launch_bounds__) of the instances in scripts/ntt_tile_sweep.cu; the
# first is K6's.
INSTANCES = [(2, 512), (3, 512), (3, 256), (4, 256)]


def sass_opcodes(so: str, kernel: str) -> dict:
    """Opcode counts (the mnemonic before the first dot) of the kernel
    whose mangled name holds `kernel`, in a built library."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", so], check=True, capture_output=True,
                         text=True).stdout
    counts, inside = collections.Counter(), False
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = kernel in m.group(1)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1)] += 1
    return dict(counts.most_common())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ntt_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import ptxas_registers
    from stark_mlwe_tpu_torch import _build, kernels
    from stark_mlwe_tpu_torch.ops import fr
    from stark_mlwe_tpu_torch.ops import ntt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.lib("fr_ntt")
    so = os.path.join(_build.build_dir(), "libntt_tile_sweep.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    build = subprocess.run(
        [nvcc] + kernels.NVCC_FLAGS
        + ["-o", so, os.path.join(ROOT, "scripts", "ntt_tile_sweep.cu")],
        capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{build.stdout}{build.stderr}")
    lib = ctypes.CDLL(so)
    vp, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lp = ctypes.POINTER(l)
    lib.ntt_sweep.argtypes = [vp, vp, vp, vp, l, i, i, l, l, l, i, lp, lp,
                              lp, i, i, i, i, vp]
    lib.ntt_sweep.restype = i
    instances = {
        "ntt_sweep_kernel<{}>".format(",".join(
            re.findall(r"L[ib](\d+)E", name))): v
        for name, v in ptxas_registers(build.stdout + build.stderr).items()
        if "ntt_sweep_kernel" in name}

    dev = torch.device("cuda", 0)
    n = 1 << 22
    m1, m2 = ntt._split(n, ntt.TILE_MAX)
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    raw[:, 7] &= 0x3FFFFFFF                       # < 2^254 < P
    x = fr.to_device(raw.astype(np.uint32).view(np.int32), dev)
    wt1 = ntt.stage_twiddles(m1, False, dev)
    wt2 = ntt.stage_twiddles(m2, False, dev)
    ep = ntt.step_twiddles(n, m1, m2, False, False, dev)
    cols = x.reshape(m1, m2, 8).transpose(0, 1)
    tmp = torch.empty((m1, m2, 8), dtype=torch.int32, device=dev)
    out = torch.empty((m2, m1, 8), dtype=torch.int32, device=dev)
    launches = {
        "columns": (cols, wt1, ep, tmp.transpose(0, 1)),
        "rows": (tmp, wt2, None, out.transpose(0, 1)),
    }
    # The rows read the columns' output: make it the plain columns' once.
    want = {"columns": ntt.ntt_tiles_plain(cols, wt1, ep)}
    tmp.copy_(want["columns"].transpose(0, 1))
    want["rows"] = ntt.ntt_tiles_plain(tmp, wt2)

    def samples(fn):
        fn()
        torch.cuda.synchronize()
        got = []
        for _ in range(args.reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(200_000)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            got.append(e0.elapsed_time(e1))
        return got

    def sweep_fn(xi, wi, ei, o, r, bound, tpb, threads, products=1):
        kargs = list(ntt._kernel_args(xi, wi, ei, o))
        kargs[6] = tpb

        def fn():
            kernels.check(lib.ntt_sweep(*kargs, r, bound, products, threads,
                                        kernels.stream_ptr()), "ntt_sweep")
        return fn

    def exact(what, got, name):
        torch.cuda.synchronize()
        if not torch.equal(got, want[name]):
            raise AssertionError(f"{what}, {name}: the kernel and the plain "
                                 f"version differ")

    res = []
    for r, bound in INSTANCES:
        for tpb in (1, 2):
            full = min((tpb * m1) >> r, bound)
            for threads in (full, full // 2):
                row = {"r": r, "bound": bound, "tpb": tpb, "threads": threads}
                for name, (xi, wi, ei, oi) in launches.items():
                    o = torch.empty_like(oi)
                    fn = sweep_fn(xi, wi, ei, o, r, bound, tpb, threads)
                    fn()
                    exact(f"layout {row}", o, name)
                    ts = samples(fn)
                    row[name] = {"ms": statistics.median(ts), "samples": ts}
                res.append(row)
    disp, parts = {}, {}
    for name, (xi, wi, ei, oi) in launches.items():
        o = torch.empty_like(oi)
        ntt.ntt_tiles(xi, wi, ei, out=o)
        exact("K6", o, name)
        ts = samples(lambda: ntt.ntt_tiles(xi, wi, ei, out=o))
        disp[name] = {"ms": statistics.median(ts), "samples": ts}
        kargs = ntt._kernel_args(xi, wi, ei, o)
        threads = min((kargs[6] << kargs[5]) >> 2, 256)   # ntt_threads
        without = sweep_fn(xi, wi, ei, o, 2, 512, kargs[6], threads, 0)
        k1, p1, p2, k2 = (samples(lambda: ntt.ntt_tiles(xi, wi, ei, out=o)),
                          samples(without), samples(without),
                          samples(lambda: ntt.ntt_tiles(xi, wi, ei, out=o)))
        ms, rest = statistics.median(k1 + k2), statistics.median(p1 + p2)
        parts[name] = {"kernel_ms": ms, "without_products_ms": rest,
                       "products_ms": ms - rest, "kernel_samples": k1 + k2,
                       "without_products_samples": p1 + p2,
                       "tpb": kargs[6], "threads": threads}
    best = {name: min(res, key=lambda row: row[name]["ms"])
            for name in launches}
    print(json.dumps({
        "card": card, "n": n, "split": [m1, m2], "reps": args.reps,
        "exact": True, "instances": instances, "layouts": res,
        "dispatched": disp, "parts": parts,
        "fastest": {k: {kk: v[kk] for kk in ("r", "bound", "tpb", "threads")}
                    for k, v in best.items()},
        "sass_opcodes_fr_ntt_tiles_kernel": sass_opcodes(
            kernels.library_path("fr_ntt"), "fr_ntt_tiles_kernel")}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
