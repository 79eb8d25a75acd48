"""Small shared utilities (the Rust reference's crates/utils + logging).

Counterpart of `utils/__init__.py` of the JAX package:

- `ByteSize`, a byte-size pretty-printer (utils/src/lib.rs:42-58),
- the hash-to-field helpers, re-exported from the port's `spec.field`,
- `logln`: opt-in phase logging matching the reference's `fri_bench_log`
  feature gate (deep_ali/src/fri.rs:12-19), on with STARK_MLWE_LOG=1,
- `phase_timer`, which feeds the process-wide phase accumulator of
  `utils.profiling` and, where the caller passes one, its own dict.
"""

from __future__ import annotations

import os
import sys
import time

from ..spec.field import (ds_tag_for_arity, fr_from_hash,
                          fr_from_le_bytes_mod_p, salt_for_node)

__all__ = ["ByteSize", "logln", "phase_timer", "fr_from_hash",
           "fr_from_le_bytes_mod_p", "salt_for_node", "ds_tag_for_arity"]

_LOG = os.environ.get("STARK_MLWE_LOG", "0") not in ("", "0", "false")


class ByteSize:
    """Human-readable byte size (utils/src/lib.rs:42-58)."""

    def __init__(self, n: int):
        self.n = int(n)

    def __str__(self) -> str:
        n = float(self.n)
        for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
            if n < 1024.0 or unit == "TiB":
                if unit == "B":
                    return f"{int(n)} {unit}"
                return f"{n:.2f} {unit}"
            n /= 1024.0
        raise AssertionError

    __repr__ = __str__


def logln(msg: str) -> None:
    if _LOG:
        print(f"[stark-mlwe-tpu] {msg}", file=sys.stderr, flush=True)


class phase_timer:
    """`with phase_timer("fold"): ...` logs the elapsed ms when logging is
    on and adds them to the phase accumulator (`utils.profiling`); with
    `into=d` also to `d[name]` (a module's record of its last call)."""

    def __init__(self, name: str, into: dict | None = None):
        self.name = name
        self.into = into

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        logln(f"{self.name}: {dt * 1e3:.1f} ms")
        from . import profiling
        profiling.record_phase(self.name, dt)
        if self.into is not None:
            self.into[self.name] = self.into.get(self.name, 0.0) + dt
        return False
