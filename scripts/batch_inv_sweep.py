#!/usr/bin/env python3
"""The batch inversion's layouts side by side on the card.

    python3 scripts/batch_inv_sweep.py [--n 65536] [--reps 7]

Builds `csrc/fr_batch_inv.cu` and computes the f0 quotient phi * (w - z)^-1
of `--n` random elements at every layout (T threads a block, runs of E
elements a thread; the total block's threads from `fr.batch_inv_layout`)
for T in 32, 64, 128, 256 and E in 1, 2, 4.  Each output must equal
`fr.f0_quotient_plain` exactly.  Prints the card's name and power limit,
then one JSON line: for each layout its blocks, the median ms of `--reps`
calls (three launches, CUDA events), and whether it is the layout
`fr.batch_inv_layout(n)` dispatches.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("batch_inv_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stark_mlwe_tpu_torch import kernels
    from stark_mlwe_tpu_torch.ops import fr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    n = args.n
    rng = np.random.default_rng(8)
    raw = rng.integers(0, 1 << 32, size=(2 * n + 1, 8), dtype=np.uint64)
    raw[:, 7] &= 0x3FFFFFFF                       # < 2^254 < P
    elems = fr.to_device(raw.astype(np.uint32).view(np.int32), dev)
    phi, w, z = elems[:n], elems[n:2 * n], elems[2 * n]
    want = fr.f0_quotient_plain(phi, w, z)
    lib = kernels.lib("fr_batch_inv")
    dispatched = fr.batch_inv_layout(n)

    res = {}
    for T in (32, 64, 128, 256):
        for E in (1, 2, 4):
            layout = fr.batch_inv_layout(n, T, E)
            out = torch.empty_like(w)
            scratch = torch.empty((fr.batch_inv_scratch(n, layout), 8),
                                  dtype=torch.int32, device=dev)

            def call():
                kernels.check(lib.fr_batch_inv(
                    w.data_ptr(), z.data_ptr(), phi.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(),
                    int(scratch.shape[0]), n, *layout, 7,
                    kernels.stream_ptr()), "fr_batch_inv")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"layout {layout}: the kernel and "
                                     f"f0_quotient_plain disagree")
            samples = []
            for _ in range(args.reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(200_000)
                e0.record()
                call()
                e1.record()
                torch.cuda.synchronize()
                samples.append(e0.elapsed_time(e1))
            res[f"T={T}, E={E}, TB={layout[2]}"] = {
                "blocks": -(-n // (T * E)), "ms": statistics.median(samples),
                "equal_to_plain": True, "dispatch": layout == dispatched}
    print(json.dumps({"card": card, "n": n, "reps": args.reps,
                      "layouts": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
