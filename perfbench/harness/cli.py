"""The command line of one run:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

prints diagnostics on standard error, ending in each number `correct`
is decided on beside its limit, and one JSON object as the last line of
standard output.  Without a CUDA card, or with fewer than the cell asks
for, it exits with code 3 and prints no result; with a JAX module loaded
once the window has closed, code 4.  On every way out, every process the
run started has been stopped and waited for (`children.stop_all`).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import children, registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = registry.cell(registry.load_benchmark(), args.workload)
    import torch

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s), "
              f"found {have}", file=sys.stderr)
        return 3

    from .bench import ForbiddenImport, run_cell

    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except ForbiddenImport as exc:
        print(f"perfbench: modules of JAX or the JAX package loaded: {exc}",
              file=sys.stderr)
        return 4
    finally:
        children.stop_all()
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
