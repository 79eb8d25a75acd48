"""Poseidon permutation & sponge: golden spec (pure Python ints mod P).

Mirrors `the Rust reference, crates/poseidon/src/lib.rs`:
  - static width t=17 (rate 16, capacity 1), x^5 S-box, RF=8, RP=64,
  - dynamic widths t in {9,17,33,65,129} for Merkle arities up to 128,
    with RP in {60,64,68,76,84} (poseidon/src/lib.rs:120-127),
  - deterministic parameter derivation via BLAKE3 hash-to-field with tags
    "POSEIDON-MDS" / "POSEIDON-RC-FULL" / "POSEIDON-RC-PART" and per-width
    seeds b"POSEIDON-PALLAS-T" || t_le8 (poseidon/src/lib.rs:168-216),
  - sponge `hash_with_ds` (DS tag in the capacity slot, raw chunk absorb,
    no padding; poseidon/src/lib.rs:85-100),
  - sponge `hash_with_ds_dynamic` (DS preamble fields, then inputs, then
    10* padding to the block boundary; poseidon/src/lib.rs:288-312).
"""

from __future__ import annotations

from functools import lru_cache

from .field import P, fr_from_hash

RF = 8
ALPHA = 5

# width -> partial rounds (poseidon/src/lib.rs:121-127)
RP_FOR_T = {9: 60, 17: 64, 33: 68, 65: 76, 129: 84}


class PoseidonParams:
    """Parameters for one width; `mds` is t x t, `rc_full` RF x t,
    `rc_partial` RP, all canonical ints."""

    __slots__ = ("t", "rate", "rf", "rp", "mds", "rc_full", "rc_partial")

    def __init__(self, t, rate, rf, rp, mds, rc_full, rc_partial):
        self.t = t
        self.rate = rate
        self.rf = rf
        self.rp = rp
        self.mds = mds
        self.rc_full = rc_full
        self.rc_partial = rc_partial


def _derive_mds(seed: bytes, t: int):
    return [
        [
            fr_from_hash(
                "POSEIDON-MDS",
                i.to_bytes(8, "little") + j.to_bytes(8, "little") + seed,
            )
            for j in range(t)
        ]
        for i in range(t)
    ]


def _derive_rc_full(seed: bytes, rf: int, t: int):
    return [
        [
            fr_from_hash(
                "POSEIDON-RC-FULL",
                r.to_bytes(8, "little") + i.to_bytes(8, "little") + seed,
            )
            for i in range(t)
        ]
        for r in range(rf)
    ]


def _derive_rc_partial(seed: bytes, rp: int):
    return [
        fr_from_hash("POSEIDON-RC-PART", r.to_bytes(8, "little") + seed)
        for r in range(rp)
    ]


@lru_cache(maxsize=None)
def generate_params_t17(seed: bytes) -> PoseidonParams:
    """Static t=17 params from an explicit seed
    (poseidon/src/lib.rs:318-356).  Used with seeds
    b"POSEIDON-T17-X5-SEED" (merkle default) and
    b"POSEIDON-T17-X5-TRANSCRIPT" (transcript default)."""
    t, rp = 17, 64
    return PoseidonParams(
        t, t - 1, RF, rp,
        _derive_mds(seed, t),
        _derive_rc_full(seed, RF, t),
        _derive_rc_partial(seed, rp),
    )


def _seed_for_t(t: int) -> bytes:
    return b"POSEIDON-PALLAS-T" + t.to_bytes(8, "little")


@lru_cache(maxsize=None)
def params_for_width(t: int) -> PoseidonParams:
    """Dynamic-width params (poseidon/src/lib.rs:120-146)."""
    if t not in RP_FOR_T:
        raise ValueError(f"unsupported Poseidon width t={t}")
    rp = RP_FOR_T[t]
    seed = _seed_for_t(t)
    return PoseidonParams(
        t, t - 1, RF, rp,
        _derive_mds(seed, t),
        _derive_rc_full(seed, RF, t),
        _derive_rc_partial(seed, rp),
    )


def width_for_arity(arity: int) -> int:
    """Merkle arity -> Poseidon width bucket (poseidon/src/lib.rs:155-166)."""
    if arity <= 8:
        return 9
    if arity <= 16:
        return 17
    if arity <= 32:
        return 33
    if arity <= 64:
        return 65
    if arity <= 128:
        return 129
    raise ValueError(f"unsupported Merkle arity {arity}")


def params_for_arity(arity: int) -> PoseidonParams:
    return params_for_width(width_for_arity(arity))


def _sbox5(x: int) -> int:
    return pow(x, 5, P)


def permute(state: list, params: PoseidonParams) -> list:
    """Full permutation; returns a new state list
    (poseidon/src/lib.rs:31-68 static == :219-258 dynamic)."""
    t = params.t
    assert len(state) == t
    s = list(state)
    half = params.rf // 2
    mds = params.mds

    def mds_mul(v):
        return [sum(mds[i][j] * v[j] for j in range(t)) % P for i in range(t)]

    for r in range(half):
        rc = params.rc_full[r]
        s = [_sbox5((s[i] + rc[i]) % P) for i in range(t)]
        s = mds_mul(s)
    for r in range(params.rp):
        s[0] = _sbox5((s[0] + params.rc_partial[r]) % P)
        s = mds_mul(s)
    for r in range(half, params.rf):
        rc = params.rc_full[r]
        s = [_sbox5((s[i] + rc[i]) % P) for i in range(t)]
        s = mds_mul(s)
    return s


def hash_with_ds(inputs: list, ds_tag: int, params: PoseidonParams) -> int:
    """Legacy fixed-width sponge: DS tag in capacity, absorb RATE-chunks,
    permute per chunk, digest = state[0] (poseidon/src/lib.rs:85-100)."""
    t, rate = params.t, params.rate
    state = [0] * t
    state[t - 1] = ds_tag % P
    for off in range(0, len(inputs), rate):
        chunk = inputs[off:off + rate]
        for i, x in enumerate(chunk):
            state[i] = (state[i] + x) % P
        state = permute(state, params)
    return state[0]


def hash_with_ds_dynamic(ds_fields: list, inputs: list,
                         params: PoseidonParams) -> int:
    """DS-preamble sponge with 10* padding (poseidon/src/lib.rs:288-312)."""
    t, rate = params.t, params.rate
    state = [0] * t
    cursor = 0

    def absorb(x):
        nonlocal state, cursor
        state[cursor] = (state[cursor] + x) % P
        cursor += 1
        if cursor == rate:
            cursor = 0
            state = permute(state, params)

    for x in ds_fields:
        absorb(x)
    for x in inputs:
        absorb(x)
    absorb(1)
    while cursor != 0:
        absorb(0)
    return state[0]
