"""ctypes loader for the native host-side Poseidon engine.

Compiles `poseidon.cpp` at first use (g++ -O3 -fopenmp -shared) into the
build directory.  All values cross the boundary as Montgomery 4x64 u64
limbs - the same 32 bytes as the port's `[..., 8] int32` tensor layout, so
a CPU tensor's numpy view is passed as it is.  Parameter packs are cached
per spec `PoseidonParams` object.

This is host code by design: the Fiat-Shamir sponge over the witness
columns is one long sequential chain, and the verifier's batches are a
few dozen rows.  A build that fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import _build
from ..spec.field import P
from ..spec.poseidon import PoseidonParams

_R = (1 << 256) % P
_R_INV = pow(_R, P - 2, P)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "poseidon.cpp")

_lib = None
_lock = threading.Lock()


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = os.path.join(_build.build_dir(), "libposeidon_host.so")
        if _build.stale(so, [_SRC]):
            _build.finish(_build.start(
                ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-o", so,
                 _SRC], so), so)
        lib = ctypes.CDLL(so)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.poseidon_permute_batch_opt.argtypes = [
            u64p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u64p, u64p, u64p, u64p, u64p, u64p]
        lib.poseidon_permute_batch_opt.restype = None
        lib.poseidon_hash_ds_dynamic_batch_opt.argtypes = [
            u64p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u64p, u64p, u64p, u64p, u64p, u64p, u64p, u64p]
        lib.poseidon_hash_ds_dynamic_batch_opt.restype = None
        lib.poseidon_absorb_chains_opt.argtypes = [
            u64p, u64p, ctypes.c_long, ctypes.c_long, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u64p, u64p, u64p,
            u64p, u64p, u64p]
        lib.poseidon_absorb_chains_opt.restype = None
        lib.poseidon_factorize.argtypes = [
            u64p, ctypes.c_int, ctypes.c_int, u64p, u64p, u64p, u64p]
        lib.poseidon_factorize.restype = ctypes.c_int
        lib.fr_to_mont_batch.argtypes = [u64p, ctypes.c_long, u64p]
        lib.fr_to_mont_batch.restype = None
        lib.fr_from_mont_batch.argtypes = [u64p, ctypes.c_long]
        lib.fr_from_mont_batch.restype = None
        lib.fr_phi_batch.argtypes = [u64p, u64p, u64p, u64p, u64p,
                                     ctypes.c_long]
        lib.fr_phi_batch.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    """True once the engine is built and loaded (raises if it cannot be)."""
    return _get_lib() is not None


def _mont_limbs(x: int) -> list:
    v = x * _R % P
    return [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]


def _from_mont_limbs(arr) -> int:
    v = int(arr[0]) | int(arr[1]) << 64 | int(arr[2]) << 128 \
        | int(arr[3]) << 192
    return v * _R_INV % P


_MONT_ONE = np.array(_mont_limbs(1), dtype=np.uint64)

_R2 = pow(2, 512, P)
_R2_LIMBS = np.array([(_R2 >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                      for i in range(4)], dtype=np.uint64)


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def ints_to_mont_u64(values) -> np.ndarray:
    """Canonical ints -> flat Montgomery 4x64 limb buffer.  The bigint work
    is one `to_bytes` per value; the modmul by R^2 runs in C++."""
    lib = _get_lib()
    b = b"".join(int(v).to_bytes(32, "little") for v in values)
    buf = np.frombuffer(b, dtype=np.uint64).copy()
    lib.fr_to_mont_batch(_u64p(buf), len(values), _u64p(_R2_LIMBS))
    return buf


def mont_u64_to_ints(buf) -> list:
    """Montgomery 4x64 limb buffer -> canonical ints (`buf` is consumed:
    the conversion runs in place)."""
    lib = _get_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint64).reshape(-1)
    lib.fr_from_mont_batch(_u64p(buf), len(buf) // 4)
    b = buf.tobytes()
    return [int.from_bytes(b[32 * i:32 * i + 32], "little")
            for i in range(len(buf) // 4)]


_params_cache: dict = {}

_MDS_SCALE_320 = pow(2, 320, P)


def _mds320_limbs(x: int) -> list:
    v = x * _MDS_SCALE_320 % P
    return [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]


def factorize_mds(mds, t: int, rp: int):
    """Partial-round factorization computed in C++ (Montgomery mod-p
    Gauss-Jordan).  Returns (q_rows, q_cols, m_final) as canonical int
    lists, or None if a submatrix was singular."""
    lib = _get_lib()
    if rp < 2:
        return None
    m = np.array([l for row in mds for v in row for l in _mont_limbs(v)],
                 dtype=np.uint64)
    qrow = np.zeros((rp - 1) * t * 4, dtype=np.uint64)
    qcol = np.zeros((rp - 1) * (t - 1) * 4, dtype=np.uint64)
    mf = np.zeros(t * t * 4, dtype=np.uint64)
    rcode = lib.poseidon_factorize(_u64p(m), t, rp, _u64p(_MONT_ONE),
                                   _u64p(qrow), _u64p(qcol), _u64p(mf))
    if rcode != 0:
        return None

    def ints(arr, shape_outer):
        a = arr.reshape(-1, 4)
        vals = [_from_mont_limbs(a[i]) for i in range(a.shape[0])]
        per = len(vals) // shape_outer
        return [vals[i * per:(i + 1) * per] for i in range(shape_outer)]

    return ints(qrow, rp - 1), ints(qcol, rp - 1), ints(mf, t)


def pack_params(params: PoseidonParams):
    """(mds, rc_full, rc_part, qrow, qcol, mfinal) as flat u64 arrays in
    the scales `poseidon.cpp` (and the CUDA permutation kernel, which
    shares its arithmetic) expects: the dense matrices and the sparse
    rows pre-scaled by 2^320 for the lazy-accumulate + extended REDC,
    round constants and the sparse columns in plain Montgomery form."""
    key = id(params)
    if key not in _params_cache:
        from ..spec.poseidon_opt import partial_round_factorization
        mds = np.array([l for row in params.mds for v in row
                        for l in _mds320_limbs(v)], dtype=np.uint64)
        rcf = np.array([l for row in params.rc_full for v in row
                        for l in _mont_limbs(v)], dtype=np.uint64)
        rcp = np.array([l for v in params.rc_partial
                        for l in _mont_limbs(v)], dtype=np.uint64)
        fac = partial_round_factorization(params)
        qrow = np.array([l for row in fac.q_rows for v in row
                         for l in _mds320_limbs(v)], dtype=np.uint64)
        qcol = np.array([l for row in fac.q_cols for v in row
                         for l in _mont_limbs(v)], dtype=np.uint64)
        mfin = np.array([l for row in fac.m_final for v in row
                         for l in _mds320_limbs(v)], dtype=np.uint64)
        # the entry holds `params`, so its id is not reused while cached
        _params_cache[key] = (params, (mds, rcf, rcp, qrow, qcol, mfin))
    return _params_cache[key][1]


def permute_ints(state, params: PoseidonParams) -> list:
    """Spec-equivalent permutation on canonical ints via the native lib."""
    return permute_ints_batch([state], params)[0]


def permute_ints_batch(states, params: PoseidonParams) -> list:
    """B independent permutations in one native call."""
    lib = _get_lib()
    t = params.t
    buf = ints_to_mont_u64([v for st in states for v in st])
    packs = pack_params(params)
    lib.poseidon_permute_batch_opt(
        _u64p(buf), len(states), t, params.rf, params.rp,
        *[_u64p(a) for a in packs])
    flat = mont_u64_to_ints(buf)
    return [flat[b * t:(b + 1) * t] for b in range(len(states))]


def phi_batch(cols_u64) -> np.ndarray:
    """Host DEEP-ALI merge phi = a*s + e - t over Montgomery 4x64 columns;
    returns [n, 4] uint64 Montgomery limbs, ready to upload."""
    lib = _get_lib()
    a64, s64, e64, t64 = (np.ascontiguousarray(c, dtype=np.uint64)
                          for c in cols_u64)
    n = a64.shape[0]
    out = np.empty((n, 4), np.uint64)
    lib.fr_phi_batch(_u64p(a64), _u64p(s64), _u64p(e64), _u64p(t64),
                     _u64p(out), n)
    return out


def absorb_chains(states_ints, poss, cols_u64, params: PoseidonParams):
    """C sequential sponge absorb chains (transcript lazy-permute
    semantics), one OpenMP thread per chain.

    states_ints: list[C] of t-length canonical int states; poss: list[C]
    cursor positions; cols_u64: [C, n, 4] uint64 Montgomery limb columns.
    Returns (new state int lists, new positions).
    """
    lib = _get_lib()
    C = len(states_ints)
    t = params.t
    st = np.array([l for s in states_ints for v in s
                   for l in _mont_limbs(v)], dtype=np.uint64)
    pos = np.array(list(poss), dtype=np.int32)
    cols = np.ascontiguousarray(cols_u64, dtype=np.uint64)
    n = cols.shape[1]
    packs = pack_params(params)
    lib.poseidon_absorb_chains_opt(
        _u64p(st), _u64p(cols), C, n,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t, params.rf, params.rp, *[_u64p(a) for a in packs])
    out_states = [[_from_mont_limbs(st[(c * t + i) * 4:(c * t + i) * 4 + 4])
                   for i in range(t)] for c in range(C)]
    return out_states, [int(p) for p in pos]


def hash_ds_dynamic_rows(rows, params: PoseidonParams) -> list:
    """Batch of `hash_with_ds_dynamic` calls: rows is a list of equal-length
    field lists (DS preamble already prepended); returns digests."""
    lib = _get_lib()
    B = len(rows)
    nfields = len(rows[0])
    buf = ints_to_mont_u64([v for row in rows for v in row])
    out = np.zeros(B * 4, dtype=np.uint64)
    mds, rcf, rcp, qrow, qcol, mfin = pack_params(params)
    lib.poseidon_hash_ds_dynamic_batch_opt(
        _u64p(buf), B, nfields, params.t, params.rf, params.rp,
        _u64p(mds), _u64p(rcf), _u64p(rcp), _u64p(_MONT_ONE), _u64p(out),
        _u64p(qrow), _u64p(qcol), _u64p(mfin))
    return mont_u64_to_ints(out)
