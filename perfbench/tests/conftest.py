"""CPU tests of the benchmark: `python -m pytest perfbench/tests -q` from
the root of the repo (the repo's own `tests/` do not collect them).
None needs a card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
