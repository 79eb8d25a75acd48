#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: DEEP-ALI + m-ary FRI prove
on the card, paper schedule [16,16,8], r=32, the bench harness's witness.

    python3 bench_torch.py

Prints the card line (`nvidia-smi --query-gpu=name,power.limit`) first, a
`#` line with the samples, their median and the proof size, then ONE JSON
line:
  {"metric": "deep_fri_prove_paper_k16", "value": ..., "unit": "s",
   "vs_baseline": ...}
`value` is the mean prove time over the harness's reps (the CSV's
`prove_s`); `vs_baseline` is the Rust reference's CPU criterion mean of
e2e_mf_fri/prove-paper at the same k over it (a speedup factor).

Env: BENCH_K (default 16), BENCH_VERIFY=0 to skip verify timing.
Without a CUDA device it raises and exits non-zero.
"""

import json
import os
import sys
import time

# The Rust reference's criterion means (seconds, one CPU thread),
# e2e_mf_fri/prove-paper/<k> (BASELINE.md).
BASELINE_PROVE_S = {
    11: 1.834, 12: 3.570, 13: 7.102, 14: 14.188,
    15: 28.153, 16: 56.456, 17: 112.844, 18: 225.628,
}


def main():
    from stark_mlwe_tpu_torch.bench import run_mf_fri
    from stark_mlwe_tpu_torch.device import resolve
    from stark_mlwe_tpu_torch.utils.profiling import card_line

    k = int(os.environ.get("BENCH_K", "16"))
    check_verify = os.environ.get("BENCH_VERIFY", "1") != "0"
    dev = resolve(None)
    print(card_line(), flush=True)
    t0 = time.time()
    res = run_mf_fri("paper", k, warmup=True, check_verify=check_verify,
                     device=dev)
    print(f"# k={k} schedule=[16,16,8] r=32 "
          f"prove_s={res['prove_s']:.6f} "
          f"prove_median_s={res['prove_median_s']:.6f} "
          f"prove_samples={[round(x, 6) for x in res['prove_samples']]} "
          f"verify_median_ms={res['verify_median_ms']:.3f} "
          f"verify_samples={[round(x, 3) for x in res['verify_samples']]} "
          f"proof_bytes={res['proof_bytes']} "
          f"total_wall={time.time() - t0:.1f}s", flush=True)
    base = BASELINE_PROVE_S.get(k)
    vs = (base / res["prove_s"]) if base else None
    print(json.dumps({
        "metric": f"deep_fri_prove_paper_k{k}",
        "value": round(res["prove_s"], 4),
        "unit": "s",
        "vs_baseline": round(vs, 3) if vs else None,
    }))


if __name__ == "__main__":
    sys.exit(main())
