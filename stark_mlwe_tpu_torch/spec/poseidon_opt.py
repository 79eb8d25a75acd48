"""Optimized partial-round factorization of the Poseidon permutation.

The reference permutation (poseidon/src/lib.rs:31-68) applies the dense
t x t MDS matrix after EVERY round, including the RP partial rounds where
only lane 0 goes through the S-box.  Because the partial-round ARK adds a
constant to lane 0 only (:49-56), the linear algebra of the partial-round
block can be refactored exactly (no approximation -- identical field
values):

  Write M = P @ Q with
      P = [[1, 0], [0, Mhat]]                (dense, does not touch lane 0)
      Q = [[m00, w^T], [Mhat^-1 @ v, I]]     (sparse: 2t-1 multiplies)
  where Mhat = M[1:,1:], w = M[0,1:], v = M[1:,0].

  A partial round is M . S_r where S_r is (ARK + S-box) on lane 0 only.
  P commutes with S_r (P never reads or writes lane 0), so the chain of
  RP partial rounds telescopes to

      M_final . S_rp . Q_{rp-1} . S_{rp-1} . ... . Q_1 . S_1

  with M^(1) = M, M^(i) = P_i @ Q_i, M^(i+1) = M @ P_i, and
  M_final = M^(rp).  Each partial round now costs ~3t multiplies
  (t for the Q row-dot, 2(t-1) for the column update) instead of t^2,
  plus ONE dense matrix at the end of the block.

This module computes the factorization with exact mod-p arithmetic and
provides `permute_opt`, bit-identical to `poseidon.permute`.
"""

from __future__ import annotations

from functools import lru_cache

from .field import P
from .poseidon import PoseidonParams, _sbox5


def _mat_inv_mod_p(m):
    """Exact inverse of a square matrix mod P (Gauss-Jordan).

    Raises ZeroDivisionError if singular.
    """
    n = len(m)
    a = [list(row) + [1 if i == j else 0 for j in range(n)]
         for i, row in enumerate(m)]
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r][col] % P != 0), None)
        if piv is None:
            raise ZeroDivisionError("singular matrix mod p")
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], P - 2, P)
        a[col] = [(x * inv) % P for x in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(x - f * y) % P for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def _mat_mul(a, b):
    n, k, m = len(a), len(b), len(b[0])
    bt = [[b[r][c] for r in range(k)] for c in range(m)]
    return [[sum(ar[j] * bc[j] for j in range(k)) % P for bc in bt]
            for ar in a]


class PartialRoundFactors:
    """q_rows[i] (t ints) and q_cols[i] (t-1 ints) for rounds i=0..rp-2,
    plus the dense m_final applied once after the last partial S-box."""

    __slots__ = ("q_rows", "q_cols", "m_final")

    def __init__(self, q_rows, q_cols, m_final):
        self.q_rows = q_rows
        self.q_cols = q_cols
        self.m_final = m_final


_factor_cache: dict = {}

_CACHE_DIR = __import__("os").path.join(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__)),
    "_fac_cache")


def _cache_key(params: PoseidonParams) -> str:
    import hashlib
    h = hashlib.sha256()
    h.update(b"poseidon-fac-v1")
    h.update(params.t.to_bytes(4, "little"))
    h.update(params.rp.to_bytes(4, "little"))
    for row in params.mds:
        for v in row:
            h.update(int(v).to_bytes(32, "little"))
    return f"t{params.t}_rp{params.rp}_{h.hexdigest()[:16]}"


def _ints_to_u64(rows):
    import numpy as np
    out = np.zeros((len(rows), len(rows[0]), 4), dtype=np.uint64)
    for i, row in enumerate(rows):
        for j, v in enumerate(row):
            for k in range(4):
                out[i, j, k] = (int(v) >> (64 * k)) & 0xFFFFFFFFFFFFFFFF
    return out


def _u64_to_ints(arr):
    return [[int(a[0]) | int(a[1]) << 64 | int(a[2]) << 128 | int(a[3]) << 192
             for a in row] for row in arr]


def _factorize_python(params: PoseidonParams):
    t, rp, M = params.t, params.rp, params.mds
    q_rows, q_cols = [], []
    Mi = M
    for _ in range(rp - 1):
        mhat = [row[1:] for row in Mi[1:]]
        w = Mi[0][1:]
        v = [row[0] for row in Mi[1:]]
        mhat_inv = _mat_inv_mod_p(mhat)
        r = [sum(mhat_inv[i][j] * v[j] for j in range(t - 1)) % P
             for i in range(t - 1)]
        q_rows.append([Mi[0][0]] + list(w))
        q_cols.append(r)
        # M^(i+1) = M @ P_i, P_i = blockdiag(1, mhat):
        # col 0 unchanged; cols 1.. = M[:,1:] @ mhat
        right = _mat_mul([row[1:] for row in M], mhat)
        Mi = [[M[i][0]] + right[i] for i in range(t)]
    return q_rows, q_cols, Mi


def partial_round_factorization(params: PoseidonParams) -> PartialRoundFactors:
    """Factorization for `params`, from (in order): process cache, disk
    cache, the native C++ routine, pure Python."""
    import os

    import numpy as np

    # the entry keeps `params` alive, so its id cannot be handed to another
    # parameter object while the entry exists
    key = id(params)
    if key in _factor_cache:
        return _factor_cache[key][1]
    assert params.rp >= 1, "factorization requires at least one partial round"
    path = os.path.join(_CACHE_DIR, _cache_key(params) + ".npz")
    if os.path.exists(path):
        try:
            z = np.load(path)
            fac = PartialRoundFactors(_u64_to_ints(z["qrow"]),
                                      _u64_to_ints(z["qcol"]),
                                      _u64_to_ints(z["mfinal"]))
            _factor_cache[key] = (params, fac)
            return fac
        except Exception:
            # corrupt cache entry (e.g. crash mid-write): recompute
            try:
                os.remove(path)
            except OSError:
                pass
    res = None
    try:
        from .. import native
        if native.available():
            res = native.factorize_mds(params.mds, params.t, params.rp)
    except Exception:
        res = None
    if res is None:
        res = _factorize_python(params)
    fac = PartialRoundFactors(*res)
    try:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        np.savez(tmp, qrow=_ints_to_u64(fac.q_rows),
                 qcol=_ints_to_u64(fac.q_cols),
                 mfinal=_ints_to_u64(fac.m_final))
        # np.savez appends .npz when the target lacks it
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)
    except Exception:
        pass
    _factor_cache[key] = (params, fac)
    return fac


# ---------------------------------------------------------------------------
# Affine expansion of the whole partial-round block.
#
# In the factorized form (permute_opt below) the partial rounds are
#
#     for r in 0..rp-1:  y_r = sbox(s[0] + rc_partial[r])
#                        if r < rp-1: s = Q_r . [y_r, s[1:]]
#     out = m_final . [y_{rp-1}, s[1:]]
#
# where Q_r touches the state only through (a) a row dot producing the new
# lane 0 and (b) rank-1 column updates s[i] += q_col[i-1] * y_r.  Every
# lane except the S-box is LINEAR, so the entire block is an exact affine
# function of the block input s and the rp sequential S-box outputs y:
#
#     w_r  = W[r] . s  +  sum_{r'<r} V[r][r'] * y_{r'}     (S-box input)
#     y_r  = sbox(w_r + rc_partial[r])
#     out  = A_s . s  +  A_y . y
#
# with W [rp, t], V strictly lower-triangular [rp, rp], A_s [t, t]
# (column 0 zero), A_y [t, rp] -- all constants precomputed here with
# exact mod-p arithmetic.  This is what lets a device kernel evaluate all
# partial-round multiplies as constant int8 digit matmuls on the MXU,
# with only the rp sequential S-boxes left on the VPU.
# ---------------------------------------------------------------------------


class PartialAffine:
    """Constant matrices of the affine partial-round form (see above)."""

    __slots__ = ("w_s", "v", "a_s", "a_y")

    def __init__(self, w_s, v, a_s, a_y):
        self.w_s = w_s    # [rp][t]
        self.v = v        # [rp][rp] (strictly lower triangular)
        self.a_s = a_s    # [t][t]  (column 0 all zero)
        self.a_y = a_y    # [t][rp]


_affine_cache: dict = {}


def partial_round_affine(params: PoseidonParams) -> PartialAffine:
    key = id(params)
    if key in _affine_cache:
        return _affine_cache[key]
    fac = partial_round_factorization(params)
    t, rp = params.t, params.rp

    w_s = [[0] * t for _ in range(rp)]
    v = [[0] * rp for _ in range(rp)]
    w_s[0][0] = 1
    for r in range(1, rp):
        qrow = fac.q_rows[r - 1]
        # s_rest^{(r-1)} = s[1:] + sum_{r'<r-1} q_cols[r'] * y_{r'}
        for j in range(1, t):
            w_s[r][j] = qrow[j] % P
        v[r][r - 1] = qrow[0] % P
        for rp_ in range(r - 1):
            qcol = fac.q_cols[rp_]
            v[r][rp_] = sum(qrow[1 + i] * qcol[i]
                            for i in range(t - 1)) % P

    a_s = [[0] * t for _ in range(t)]
    a_y = [[0] * rp for _ in range(t)]
    for i in range(t):
        for j in range(1, t):
            a_s[i][j] = fac.m_final[i][j] % P
        a_y[i][rp - 1] = fac.m_final[i][0] % P
        for r in range(rp - 1):
            qcol = fac.q_cols[r]
            a_y[i][r] = sum(fac.m_final[i][1 + j] * qcol[j]
                            for j in range(t - 1)) % P

    aff = PartialAffine(w_s, v, a_s, a_y)
    _affine_cache[key] = aff
    return aff


def permute_affine(state: list, params: PoseidonParams) -> list:
    """Bit-identical to spec.poseidon.permute, evaluating the partial
    rounds through the affine form (a device kernel's reference)."""
    t = params.t
    s = list(state)
    half = params.rf // 2
    mds = params.mds

    def mds_mul(m, v_):
        return [sum(m[i][j] * v_[j] for j in range(t)) % P for i in range(t)]

    aff = partial_round_affine(params)
    for r in range(half):
        rc = params.rc_full[r]
        s = mds_mul(mds, [_sbox5((s[i] + rc[i]) % P) for i in range(t)])

    rp = params.rp
    y = []
    for r in range(rp):
        w = sum(aff.w_s[r][j] * s[j] for j in range(t))
        w += sum(aff.v[r][r_] * y[r_] for r_ in range(r))
        y.append(_sbox5((w + params.rc_partial[r]) % P))
    s = [(sum(aff.a_s[i][j] * s[j] for j in range(t))
          + sum(aff.a_y[i][r] * y[r] for r in range(rp))) % P
         for i in range(t)]

    for r in range(half, params.rf):
        rc = params.rc_full[r]
        s = mds_mul(mds, [_sbox5((s[i] + rc[i]) % P) for i in range(t)])
    return s


def _apply_q(q_row, q_col, s):
    t = len(s)
    s0 = sum(q_row[j] * s[j] for j in range(t)) % P
    return [s0] + [(s[i] + q_col[i - 1] * s[0]) % P for i in range(1, t)]


def permute_opt(state: list, params: PoseidonParams) -> list:
    """Bit-identical to spec.poseidon.permute, using the factorization."""
    t = params.t
    s = list(state)
    half = params.rf // 2
    mds = params.mds

    def mds_mul(m, v):
        return [sum(m[i][j] * v[j] for j in range(t)) % P for i in range(t)]

    fac = partial_round_factorization(params)
    for r in range(half):
        rc = params.rc_full[r]
        s = mds_mul(mds, [_sbox5((s[i] + rc[i]) % P) for i in range(t)])
    for r in range(params.rp):
        s[0] = _sbox5((s[0] + params.rc_partial[r]) % P)
        if r < params.rp - 1:
            s = _apply_q(fac.q_rows[r], fac.q_cols[r], s)
    s = mds_mul(fac.m_final, s)
    for r in range(half, params.rf):
        rc = params.rc_full[r]
        s = mds_mul(mds, [_sbox5((s[i] + rc[i]) % P) for i in range(t)])
    return s
