#!/usr/bin/env python3
"""Full benchmark sweep of the PyTorch/CUDA port, mirroring the reference's
end_to_end driver.

    python3 bench_all_torch.py

Writes `benchmarkdata_torch.csv` with the reference CSV schema
(end_to_end.rs:41-59): one row per (schedule label, k) with prove/verify
times, proof sizes and %-deltas vs the "paper" schedule; the plain and MF
sum-check NIZK rows go to `benchmarkdata_torch_nizk.csv`.  Each file's
first line is `# <card line>` (`nvidia-smi --query-gpu=name,power.limit`),
and a session appended with BENCH_APPEND=1 starts with one too.  Beside
each row the output prints a `#` line with the prove and verify samples,
their medians and the card's peak allocated memory in that run.

Env: BENCH_KS="11,12,16" to restrict k values; BENCH_K_HI to raise the
k ceiling past the reference grid (default 19); BENCH_LABELS to restrict
schedules; BENCH_NIZK=0 to skip the sum-check track; BENCH_APPEND=1 to
append to the files (their paper rows are the delta baseline);
BENCH_CSV / BENCH_NIZK_CSV for other file names; BENCH_WITNESS_CACHE=<dir>
keeps the packed witnesses.  Without a CUDA device it raises.
"""

import os
import sys


def paper_baseline_from(path: str) -> dict:
    """The paper rows of a recorded CSV as the delta baseline, by k; lines
    that are not rows (`#` lines, the header) are skipped."""
    out = {}
    with open(path) as f:
        for line in f:
            p = line.strip().split(",")
            if len(p) >= 8 and p[0] == "csv" and p[1] == "paper":
                out[int(p[2])] = {
                    "proof_bytes": int(p[4]), "prove_s": float(p[5]),
                    "verify_ms": float(p[6]), "eps": float(p[7])}
    return out


def _open(path: str, append: bool, header: str, card: str):
    fresh = not (append and os.path.exists(path))
    f = open(path, "w" if fresh else "a")
    f.write(f"# {card}\n")
    if fresh:
        f.write(header + "\n")
    f.flush()
    return f


def main():
    import torch

    from stark_mlwe_tpu_torch.bench import (CSV_HEADER, PRESETS, csv_line,
                                            ks_for_schedule, run_mf_fri,
                                            run_mf_nizk, run_plain_nizk)
    from stark_mlwe_tpu_torch.device import resolve
    from stark_mlwe_tpu_torch.utils import ByteSize
    from stark_mlwe_tpu_torch.utils.profiling import (card_line,
                                                      device_memory_stats)

    ks_filter = None
    if os.environ.get("BENCH_KS"):
        ks_filter = {int(x) for x in os.environ["BENCH_KS"].split(",")}
    labels_filter = None
    if os.environ.get("BENCH_LABELS"):
        labels_filter = set(os.environ["BENCH_LABELS"].split(","))
    k_hi = int(os.environ.get("BENCH_K_HI", "19"))
    dev = resolve(None)
    card = card_line()
    print(f"# {card}", flush=True)

    out_path = os.environ.get("BENCH_CSV", "benchmarkdata_torch.csv")
    append = os.environ.get("BENCH_APPEND", "0") not in ("", "0")
    paper_baseline = (paper_baseline_from(out_path)
                      if append and os.path.exists(out_path) else {})
    print(CSV_HEADER)
    with _open(out_path, append, CSV_HEADER, card) as f:
        # incremental: partial sweeps persist
        for label, schedule in PRESETS:
            if labels_filter and label not in labels_filter:
                continue
            for k in ks_for_schedule(schedule, k_hi=k_hi):
                if ks_filter and k not in ks_filter:
                    continue
                torch.cuda.reset_peak_memory_stats(dev)
                res = run_mf_fri(label, k, device=dev)
                peak = device_memory_stats(dev)["max_memory_allocated"]
                eps = (1 << k) / res["prove_s"]
                base = paper_baseline.get(k)
                if label == "paper":
                    paper_baseline[k] = {
                        "proof_bytes": res["proof_bytes"],
                        "prove_s": res["prove_s"],
                        "verify_ms": res["verify_ms"], "eps": eps}
                    base = None
                line = csv_line(label, k, schedule, res["proof_bytes"],
                                res["prove_s"], res["verify_ms"], base)
                print(line, flush=True)
                print(f"# {label} k={k} "
                      f"prove_median_s={res['prove_median_s']:.6f} "
                      f"prove_samples="
                      f"{[round(x, 6) for x in res['prove_samples']]} "
                      f"verify_median_ms={res['verify_median_ms']:.3f} "
                      f"verify_samples="
                      f"{[round(x, 3) for x in res['verify_samples']]} "
                      f"peak_allocated_bytes={peak} ({ByteSize(peak)})",
                      flush=True)
                f.write(line + "\n")
                f.flush()

    if os.environ.get("BENCH_NIZK", "1") != "0":
        # Sum-check NIZK rows (end_to_end.rs:130-172, protocol.rs:176-273)
        # in their own file: their schema differs from CSV_HEADER.
        nizk_path = os.environ.get(
            "BENCH_NIZK_CSV", os.path.splitext(out_path)[0] + "_nizk.csv")
        with _open(nizk_path, append,
                   "nizk,variant,k,proof_bytes,prove_s,verify_ms",
                   card) as f:
            for variant, run in (("plain", run_plain_nizk),
                                 ("mf", run_mf_nizk)):
                for k in sorted(ks_filter or {12, 14, 16}):
                    r = run(k, device=dev)
                    line = (f"nizk,{variant},{k},{r['proof_bytes']},"
                            f"{r['prove_s']:.6f},{r['verify_ms']:.3f}")
                    print(line, flush=True)
                    f.write(line + "\n")
                    f.flush()


if __name__ == "__main__":
    sys.exit(main())
