#!/usr/bin/env python3
"""How long one field product takes on the card when nothing hides it.

    python3 scripts/fr32_latency.py [--iters 4096]

The chain kernel K4 runs one warp per chain, so its time is the latency of
its dependent path, not a throughput.  This script builds
`scripts/fr32_latency.cu` (nvcc, sm_90a) and, in one warp, times `--iters`
dependent Montgomery products by the SM clock: with the 32-bit PTX carry
chains of `csrc/fr32.cuh` (every kernel's since the 64-bit limbs of
`fr.cuh` were removed: 1,392 cycles a product on the H100 against 909,
when this script still timed them) and 32-bit limbs with 64-bit
intermediates in plain C; and one lazy product into a row sum
(`fr32_acc_mul`).  Each runs as one chain and as two independent chains in
the same loop: equal cycles per iteration mean the two products overlap,
twice the cycles mean they run one after the other.  The two product
variants must give the same bytes.  One JSON line; exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {0: "fr32_mont_mul (32-bit limbs, PTX carry chains)",
            1: "u64_cios_mul (32-bit limbs, 64-bit intermediates in C)",
            2: "fr32_acc_mul (lazy product into a 17-limb row sum)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4096)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fr32_latency: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    bdir = os.path.join(ROOT, "build")
    os.makedirs(bdir, exist_ok=True)
    so = os.path.join(bdir, "libfr32_latency.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    build = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so,
         os.path.join(ROOT, "scripts", "fr32_latency.cu")],
        capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{build.stdout}{build.stderr}")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                       build.stdout + build.stderr)]
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.fr32_latency.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp,
                                 ctypes.c_long, vp]
    lib.fr32_latency.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 1 << 32, size=(96, 8), dtype=np.uint64)
    raw[:, 7] &= 0x3FFFFFFF                       # < 2^254 < P
    inp = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(dev)
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)
    res, outs = {}, {}
    for v in VARIANTS:
        for chains in (1, 2):
            out = torch.zeros((64, 8), dtype=torch.int32, device=dev)

            def run(iters):
                rc = lib.fr32_latency(v, chains, inp.data_ptr(),
                                      out.data_ptr(), iters, cyc.data_ptr())
                if rc != 0:
                    raise RuntimeError(f"launch failed with error {rc}")

            run(64)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run(args.iters)
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1)
            cycles = int(cyc.item())
            res[f"v{v}_chains{chains}"] = {
                "cycles_per_iteration": cycles / args.iters,
                "ns_per_iteration": ms * 1e6 / args.iters,
                "sm_ghz": cycles / (ms * 1e6)}
            outs[(v, chains)] = out.clone()
    same = all(torch.equal(outs[(0, c)], outs[(v, c)])
               for v in (1,) for c in (1, 2))
    summary = {}
    for v, name in VARIANTS.items():
        one = res[f"v{v}_chains1"]["cycles_per_iteration"]
        two = res[f"v{v}_chains2"]["cycles_per_iteration"]
        summary[name] = {"cycles_one_chain": one, "cycles_two_chains": two,
                         "two_over_one": two / one}
    print(json.dumps({
        "card": card, "iters": args.iters, "products_equal": same,
        "registers": regs, "summary": summary, "runs": res}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
