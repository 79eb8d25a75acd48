"""The witnesses of a run, drawn from `--seed` by NumPy's generator.

Every value is uniform below the Pallas modulus P: four 64-bit limbs,
the top one cut to 63 bits, rows at or above P drawn again.  A STARK
witness column is such rows read as Montgomery limbs, `[n, 8] int32`
(the bytes of `[n, 4] uint64`), as the port takes host columns; the
field value of a row x is x * 2^-256 mod P.  A NIZK witness is the rows
as ints.
"""

from __future__ import annotations

import zlib

import numpy as np

from perfbench.reference.field import P

_P_LIMBS = [np.uint64((P >> (64 * i)) & (2**64 - 1)) for i in range(4)]


def generator(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of a run's seed: any whole
    number, however large or negative."""
    mag = abs(int(seed))
    words = []
    while True:
        words.append(mag & (2**32 - 1))
        mag >>= 32
        if not mag:
            break
    entropy = words + [int(seed < 0), zlib.crc32(stream.encode())]
    return np.random.default_rng(np.random.SeedSequence(entropy))


def _below_p(x: np.ndarray) -> np.ndarray:
    """Rows of [m, 4] uint64 limbs (low first) whose value is below P."""
    lt = np.zeros(x.shape[0], dtype=bool)
    eq = np.ones(x.shape[0], dtype=bool)
    for i in (3, 2, 1, 0):
        lt |= eq & (x[:, i] < _P_LIMBS[i])
        eq &= x[:, i] == _P_LIMBS[i]
    return lt


def field_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    """[n, 4] uint64: n values uniform below P."""
    out, have = np.empty((n, 4), dtype=np.uint64), 0
    while have < n:
        x = rng.integers(0, 2**64, size=(2 * (n - have) + 16, 4),
                         dtype=np.uint64)
        x[:, 3] &= np.uint64(2**63 - 1)
        x = x[_below_p(x)][:n - have]
        out[have:have + x.shape[0]] = x
        have += x.shape[0]
    return out


def as_limbs_int32(rows: np.ndarray) -> np.ndarray:
    """[n, 4] uint64 -> the same bytes as [n, 8] int32."""
    return np.ascontiguousarray(rows).view(np.int32).reshape(-1, 8)


def as_ints(rows: np.ndarray) -> list:
    return [a | b << 64 | c << 128 | d << 192 for a, b, c, d in rows.tolist()]
