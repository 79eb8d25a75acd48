#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (`stark_mlwe_tpu_torch`): one run of
one cell of BENCHMARK.json, from the root of a checkout:

    python3 perfbench/run.py --workload stark_paper.k16_host --seed 7 \
        --seconds 45 --trace 0

See `perfbench/harness/cli.py` for the output and the exit codes.  The
top level imports the standard library only: the reference's worker
processes are spawned and run this file's top level again.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    from perfbench.harness.cli import main

    sys.exit(main())
