#!/usr/bin/env python3
"""The control of a cell's `correct`: a whole run of the cell in which the
reference, one Poseidon partial round short of the configuration's rounds
in every width, takes the program's place in the window.  It has to
come out not correct; the numbers it reads set the upper end of each
limit.  On the machine with the card, from the root of a checkout:

    python3 perfbench/control.py --workload stark_paper.k16_host \
        --seed 11 --seed 12 --seed 13

prints one JSON line a seed: the cell, the seed, `correct` and the
numbers compared with their limits.  The benchmark's own runs never run
it.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import argparse
    import json

    from perfbench.harness import children
    from perfbench.harness.bench import run_cell
    from perfbench.reference.poseidon import Suite
    from perfbench.reference.workers import Workers

    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)

    for seed in args.seed:
        made: dict = {}

        def control(system, j):
            if j not in made:
                with Workers() as w:
                    made[j] = system.reference(j, Suite(rp_cut=1), w)
            return made[j]

        try:
            out = run_cell(args.workload, seed, 0.0, False,
                           prove_override=control)
        finally:
            children.stop_all()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
