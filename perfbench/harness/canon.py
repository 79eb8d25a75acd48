"""Proofs as flat lists of (path, value) leaves, and their differences.

The program's proof objects and the reference's carry the upstream
proof's field names, so two proofs are compared leaf by leaf through
their paths, whatever classes hold them.  A list also gives its length
as a leaf, so a missing or extra element counts.
"""

from __future__ import annotations

import dataclasses


def leaves(obj, path: str = "") -> list:
    out: list = []
    _walk(obj, path, out)
    return out


def _walk(obj, path: str, out: list) -> None:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _walk(getattr(obj, f.name), f"{path}.{f.name}", out)
    elif isinstance(obj, (list, tuple)):
        out.append((path + "#len", len(obj)))
        for i, x in enumerate(obj):
            _walk(x, f"{path}[{i}]", out)
    elif isinstance(obj, (bool, int, bytes, str)) or obj is None:
        out.append((path, obj))
    else:
        # a value of no plain type (a tensor, a view): its type, which no
        # reference leaf has
        out.append((path, f"<{type(obj).__module__}.{type(obj).__name__}>"))


def mismatches(a: list, b: list) -> int:
    """Leaves whose values differ, and paths only one side has."""
    da, db = dict(a), dict(b)
    return (sum(1 for k, v in da.items() if k not in db or db[k] != v)
            + sum(1 for k in db if k not in da))
