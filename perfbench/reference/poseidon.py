"""Poseidon over Fr: parameters, the permutation, the DS sponge.

The upstream construction (crates/poseidon/src/lib.rs of
saholmes/stark-mlwe): x^5 S-box, RF = 8 full rounds, RP partial rounds
by width (t = 9, 17, 33, 65, 129: RP = 60, 64, 68, 76, 84), every
constant drawn by BLAKE3 hash-to-field under the tags "POSEIDON-MDS",
"POSEIDON-RC-FULL" and "POSEIDON-RC-PART" from a seed: per width
b"POSEIDON-PALLAS-T" || t as 8 LE bytes, or for t = 17 one of the two
fixed seeds of the transcript and of the Merkle default.

`Params.permute` evaluates the partial rounds through the exact sparse
factorisation of the MDS matrix (M = P.Q per round, one dense matrix at
the end): the same field values as `permute_dense`, which applies the
dense matrix after every round and is kept as the definition the tests
hold it to.

`Suite` is the set of parameters a proof uses.  `Suite(rp_cut=1)` drops
the last partial round of every width: the control, a permutation one
round short of the configuration's security level.
"""

from __future__ import annotations

from dataclasses import dataclass

from .field import P, fr_from_hash

RF = 8
RP_FOR_T = {9: 60, 17: 64, 33: 68, 65: 76, 129: 84}

SEED_TRANSCRIPT = b"POSEIDON-T17-X5-TRANSCRIPT"
SEED_MERKLE = b"POSEIDON-T17-X5-SEED"


def seed_for_width(t: int) -> bytes:
    return b"POSEIDON-PALLAS-T" + t.to_bytes(8, "little")


def width_for_arity(arity: int) -> int:
    for t in (9, 17, 33, 65, 129):
        if arity <= t - 1:
            return t
    raise ValueError(f"unsupported Merkle arity {arity}")


def _sbox(x: int) -> int:
    y = x * x % P
    return y * y % P * x % P


def _mat_inv(m):
    """Inverse of a square matrix mod P (Gauss-Jordan)."""
    n = len(m)
    a = [list(row) + [int(i == j) for j in range(n)]
         for i, row in enumerate(m)]
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r][col] % P), None)
        if piv is None:
            raise ZeroDivisionError("singular matrix mod P")
        a[col], a[piv] = a[piv], a[col]
        iv = pow(a[col][col], P - 2, P)
        a[col] = [x * iv % P for x in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(x - f * y) % P for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def _mat_mul(a, b):
    bt = list(zip(*b))
    return [[sum(x * y for x, y in zip(row, col)) % P for col in bt]
            for row in a]


def _factorize(mds, t: int, rp: int):
    """(q_rows, q_cols, m_final): partial round r < rp - 1 maps s to
    [q_rows[r] . s, s[i] + q_cols[r][i-1] * s[0] for i >= 1]; m_final is
    applied once after the last partial S-box."""
    q_rows, q_cols = [], []
    mi = mds
    for _ in range(rp - 1):
        mhat = [row[1:] for row in mi[1:]]
        v = [row[0] for row in mi[1:]]
        mhat_inv = _mat_inv(mhat)
        q_rows.append([mi[0][0]] + list(mi[0][1:]))
        q_cols.append([sum(mhat_inv[i][j] * v[j] for j in range(t - 1)) % P
                       for i in range(t - 1)])
        right = _mat_mul([row[1:] for row in mds], mhat)
        mi = [[mds[i][0]] + right[i] for i in range(t)]
    return q_rows, q_cols, mi


class Params:
    """One width's constants and its sparse factorisation.  Pickles
    without the factorisation's closure, which each process builds."""

    def __init__(self, seed: bytes, t: int, rp: int):
        self.t, self.rf, self.rp = t, RF, rp
        self.mds = [[fr_from_hash("POSEIDON-MDS", i.to_bytes(8, "little")
                                  + j.to_bytes(8, "little") + seed)
                     for j in range(t)] for i in range(t)]
        self.rc_full = [[fr_from_hash("POSEIDON-RC-FULL",
                                      r.to_bytes(8, "little")
                                      + i.to_bytes(8, "little") + seed)
                         for i in range(t)] for r in range(RF)]
        self.rc_partial = [fr_from_hash("POSEIDON-RC-PART",
                                        r.to_bytes(8, "little") + seed)
                           for r in range(rp)]
        self.factors = _factorize(self.mds, t, rp)
        self._fn = None

    @property
    def rate(self) -> int:
        return self.t - 1

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_fn"] = None
        return state

    def permute(self, state: list) -> list:
        if self._fn is None:
            self._fn = self._compile()
        return self._fn(list(state))

    def _compile(self):
        half = self.rf // 2
        mds = [tuple(r) for r in self.mds]
        q_rows, q_cols, m_final = self.factors
        m_final = [tuple(r) for r in m_final]
        first = [tuple(r) for r in self.rc_full[:half]]
        last = [tuple(r) for r in self.rc_full[half:]]
        partial = list(zip(self.rc_partial[:-1], q_rows, q_cols))
        rc_last = self.rc_partial[-1]
        mul = int.__mul__

        def full(s, rc):
            u = [_sbox((x + c) % P) for x, c in zip(s, rc)]
            return [sum(map(mul, row, u)) % P for row in mds]

        def perm(s):
            for rc in first:
                s = full(s, rc)
            for c, q_row, q_col in partial:
                s0 = _sbox((s[0] + c) % P)
                s[0] = s0
                n0 = sum(map(mul, q_row, s)) % P
                s = [n0] + [(a + b * s0) % P for a, b in zip(s[1:], q_col)]
            s[0] = _sbox((s[0] + rc_last) % P)
            s = [sum(map(mul, row, s)) % P for row in m_final]
            for rc in last:
                s = full(s, rc)
            return s

        return perm


def permute_dense(state: list, p: Params) -> list:
    """The permutation as the construction states it: the dense MDS
    matrix after every round."""
    t, half = p.t, p.rf // 2
    s = list(state)

    def mds(v):
        return [sum(p.mds[i][j] * v[j] for j in range(t)) % P
                for i in range(t)]

    for r in range(half):
        s = mds([_sbox((s[i] + p.rc_full[r][i]) % P) for i in range(t)])
    for r in range(p.rp):
        s[0] = _sbox((s[0] + p.rc_partial[r]) % P)
        s = mds(s)
    for r in range(half, p.rf):
        s = mds([_sbox((s[i] + p.rc_full[r][i]) % P) for i in range(t)])
    return s


def hash_with_ds_dynamic(ds_fields: list, inputs: list, p: Params) -> int:
    """DS-preamble sponge with 10* padding (poseidon/src/lib.rs:288-312):
    the preamble, the inputs and a 1 absorbed at rate t - 1, zeros to the
    block boundary; the digest is lane 0."""
    rate = p.rate
    items = list(ds_fields) + list(inputs) + [1]
    items += [0] * (-len(items) % rate)
    state = [0] * p.t
    for off in range(0, len(items), rate):
        for i in range(rate):
            state[i] = (state[i] + items[off + i]) % P
        state = p.permute(state)
    return state[0]


_PARAMS: dict = {}


def params(seed: bytes, t: int, rp: int) -> Params:
    key = (seed, t, rp)
    if key not in _PARAMS:
        _PARAMS[key] = Params(seed, t, rp)
    return _PARAMS[key]


@dataclass(frozen=True)
class Suite:
    """The Poseidon parameters of one proof; `rp_cut` partial rounds are
    left out of every width (0: the configuration's own)."""

    rp_cut: int = 0

    def transcript(self) -> Params:
        return params(SEED_TRANSCRIPT, 17, RP_FOR_T[17] - self.rp_cut)

    def merkle_default(self) -> Params:
        return params(SEED_MERKLE, 17, RP_FOR_T[17] - self.rp_cut)

    def width(self, t: int) -> Params:
        return params(seed_for_width(t), t, RP_FOR_T[t] - self.rp_cut)

    def arity(self, arity: int) -> Params:
        return self.width(width_for_arity(arity))
