"""Multilinear extensions on {0,1}^n: golden spec.

Mirrors `the Rust reference, crates/mle/src/lib.rs` (standalone crate) and the
duplicate `Mle` inside channel (`channel/src/lib.rs:252-297`) — both use the
same low-bit-first pairwise folding convention.
"""

from __future__ import annotations

from .field import P


class MLE:
    """values has length 2^n; bit i of the index is the assignment of x_i."""

    def __init__(self, values: list):
        assert values, "MLE: empty values"
        n = len(values)
        assert n & (n - 1) == 0, "MLE: length must be power of two"
        self.values = list(values)
        self.n = n.bit_length() - 1

    @classmethod
    def zero(cls, n: int) -> "MLE":
        return cls([0] * (1 << n))

    def eval(self, r: list) -> int:
        """Pairwise folding v0,v1 -> (1-r_i)v0 + r_i v1 (mle/src/lib.rs:50-73)."""
        assert len(r) == self.n
        buf = list(self.values)
        size = len(buf)
        for ri in r:
            half = size // 2
            om = (1 - ri) % P
            for j in range(half):
                buf[j] = (om * buf[2 * j] + ri * buf[2 * j + 1]) % P
            size = half
        return buf[0]

    def fold_last(self, r_i: int) -> "MLE":
        """mle/src/lib.rs:78-94 (variable 0, the low bit)."""
        if self.n == 0:
            return self
        om = (1 - r_i) % P
        vals = [(om * self.values[2 * j] + r_i * self.values[2 * j + 1]) % P
                for j in range(len(self.values) // 2)]
        out = MLE.__new__(MLE)
        out.values = vals
        out.n = self.n - 1
        return out

    def fold(self, var_idx: int, r_i: int) -> "MLE":
        """Strided fold at an arbitrary variable (mle/src/lib.rs:133-161)."""
        assert var_idx < self.n
        om = (1 - r_i) % P
        stride = 1 << var_idx
        period = stride << 1
        vals = []
        base = 0
        while base < len(self.values):
            for o in range(stride):
                v0 = self.values[base + o]
                v1 = self.values[base + o + stride]
                vals.append((om * v0 + r_i * v1) % P)
            base += period
        out = MLE.__new__(MLE)
        out.values = vals
        out.n = self.n - 1
        return out

    def fix(self, var_idx: int, bit: bool) -> "MLE":
        """Boolean projection (mle/src/lib.rs:100-128)."""
        assert var_idx < self.n
        stride = 1 << var_idx
        period = stride << 1
        want = stride if bit else 0
        vals = []
        base = 0
        while base < len(self.values):
            vals.extend(self.values[base + want:base + want + stride])
            base += period
        out = MLE.__new__(MLE)
        out.values = vals
        out.n = self.n - 1
        return out
