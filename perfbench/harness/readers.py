"""What a per-layer metric's reader is given.

A reader is `perfbench/metrics/<name>.py` with `read(ctx) -> float |
None`; None means it found nothing to read, and the metric is left out
of the line.
"""

from __future__ import annotations

from dataclasses import dataclass

from .tracing import Stretch


@dataclass
class ReadContext:
    config: dict           # the configuration's file
    traffic: dict          # the traffic mix's file
    cell: dict             # the cell's entry in BENCHMARK.json
    proofs: int            # proofs of the measured window
    phases: dict           # program phase -> seconds summed over the window
    stretch: Stretch | None  # the traced stretch after the window

    def phase_ms(self, *names: str):
        """Milliseconds a proof, over the window, of the named phases
        together; None where none of them ran."""
        present = [self.phases[n] for n in names if n in self.phases]
        if not present or not self.proofs:
            return None
        return sum(present) / self.proofs * 1e3
