"""Dense univariate polynomials over Fr.

Counterpart of `poly.py` of the JAX package (itself kept for parity with
the Rust reference's `Poly`, an orphan crate with no dependents).
Multiplication runs through the radix-2 NTT (`ops.ntt`, on the card unless
the caller asks for the CPU) above 64 coefficients; evaluation is Horner on
host ints.
"""

from __future__ import annotations

import torch

from .device import resolve
from .ops import fr, ntt
from .spec.field import P


def _trim(coeffs):
    while coeffs and coeffs[-1] % P == 0:
        coeffs = coeffs[:-1]
    return coeffs


class Poly:
    """coeffs: canonical ints, low degree first; empty list == zero."""

    def __init__(self, coeffs):
        self.coeffs = _trim([c % P for c in coeffs])

    @classmethod
    def from_coeffs(cls, coeffs) -> "Poly":
        return cls(coeffs)

    def degree(self) -> int:
        return max(len(self.coeffs) - 1, 0)

    def is_zero(self) -> bool:
        return not self.coeffs

    def evaluate(self, x: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % P
        return acc

    def add(self, other: "Poly") -> "Poly":
        n = max(len(self.coeffs), len(other.coeffs))
        a = self.coeffs + [0] * (n - len(self.coeffs))
        b = other.coeffs + [0] * (n - len(other.coeffs))
        return Poly([(x + y) % P for x, y in zip(a, b)])

    def scale(self, s: int) -> "Poly":
        return Poly([c * s % P for c in self.coeffs])

    def mul(self, other: "Poly", device=None) -> "Poly":
        """The product; above 64 coefficients through the NTT on `device`
        (None: the CUDA device)."""
        if self.is_zero() or other.is_zero():
            return Poly([])
        out_len = len(self.coeffs) + len(other.coeffs) - 1
        if out_len <= 64:  # schoolbook for small sizes
            out = [0] * out_len
            for i, a in enumerate(self.coeffs):
                for j, b in enumerate(other.coeffs):
                    out[i + j] = (out[i + j] + a * b) % P
            return Poly(out)
        dev = resolve(device)
        n = 1
        while n < out_len:
            n *= 2
        both = torch.stack([
            fr.to_device(fr.pack_ints(c + [0] * (n - len(c)), mont=True), dev)
            for c in (self.coeffs, other.coeffs)])
        ev = ntt.ntt(both)
        prod = ntt.intt(fr.mont_mul(ev[0], ev[1]))
        return Poly(fr.unpack_ints(prod, mont=True)[:out_len])

    def __eq__(self, other) -> bool:
        return isinstance(other, Poly) and self.coeffs == other.coeffs
