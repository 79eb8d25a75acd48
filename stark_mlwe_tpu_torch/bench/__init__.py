"""Benchmark harness mirroring the reference's end_to_end criterion driver.

Counterpart of `bench/__init__.py` of the JAX package (the Rust
reference's crates/channel/benches/end_to_end.rs):
  - the 13 fold-schedule presets (:197-211) with k windows per schedule,
  - deterministic witness generation: the LCG-mutated `rng_seed` chain
    (seed0=1337, s <- s*1103515245+12345 mod 2^64 per (label,k) iteration)
    feeding StdRng::seed_from_u64 and ark `F::rand` (:247-253),
  - global r=32, seed_z=0xDEEF_BAAD (:187-188),
  - the CSV schema (:41-59) with %-deltas vs the "paper" schedule.

The proof sizes (`proof_bytes`, `spec.fri.deep_fri_proof_size_bytes`) are
functions of the witness and the prover alone, so they equal the JAX
package's `benchmarkdata.csv` byte for byte; the times are the card's.
Every run takes `device=None`, the card (it raises where there is none),
and every timed region ends in a synchronise of the card.
"""

from __future__ import annotations

import os
import statistics
import time

import numpy as np
import torch

from ..device import resolve
from ..spec.fri import DeepFriParams, deep_fri_proof_size_bytes
from ..spec.rng import StdRng

PRESETS = [
    ("paper", [16, 16, 8]),
    ("mod16", [16, 16, 16, 16]),
    ("uni32x3", [32, 32, 32]),
    ("uni64x2x8", [64, 64, 8]),
    ("hi64_32_8", [64, 32, 8]),
    ("hi32_32_16", [32, 32, 16]),
    ("uni128", [128]),
    ("uni128x2", [128, 128]),
    ("hi128_64", [128, 64]),
    ("hi128_32", [128, 32]),
    ("hi128_16", [128, 16]),
    ("hi128_64_8", [128, 64, 8]),
    ("hi128_32_8", [128, 32, 8]),
]

R_QUERIES = 32
SEED_Z = 0xDEEF_BAAD
K_LO, K_HI = 11, 19

_LCG_MUL = 1103515245
_LCG_ADD = 12345
_U64 = (1 << 64) - 1


def k_min_for_schedule(schedule) -> int:
    prod = 1
    for m in schedule:
        prod *= m
    return prod.bit_length() - 1


def _divides_chain(n0: int, schedule) -> bool:
    n = n0
    for m in schedule:
        if n % m:
            return False
        n //= m
    return True


def ks_for_schedule(schedule, k_lo=K_LO, k_hi=K_HI):
    """end_to_end.rs:114-124."""
    kmin = max(k_lo, k_min_for_schedule(schedule))
    return [k for k in range(kmin, k_hi + 1)
            if _divides_chain(1 << k, schedule)]


def witness_seed_for(label: str, k: int) -> int:
    """Replays the bench's rng_seed LCG chain up to iteration (label, k)
    (end_to_end.rs:247-248: mutation happens per executed (label,k) pair,
    presets in order, ks ascending).  Outside the reference grid (e.g.
    k=20+ scaling runs) a deterministic per-(label,k) seed is used."""
    seed = 1337
    for lab, schedule in PRESETS:
        for kk in ks_for_schedule(schedule):
            seed = (seed * _LCG_MUL + _LCG_ADD) & _U64
            if lab == label and kk == k:
                return seed
    return (0x5EED_0000_0000 + k) & _U64


def gen_witness(k: int, seed: int):
    """a, s, e, t as int lists via StdRng::seed_from_u64 + F::rand
    (end_to_end.rs:249-253)."""
    n0 = 1 << k
    rng = StdRng.seed_from_u64(seed)
    return [rng.ark_fr_rand_batch(n0) for _ in range(4)]


CSV_HEADER = ("csv,label,k,schedule,proof_bytes,prove_s,verify_ms,"
              "prove_elems_per_s,delta_size_pct_vs_paper,"
              "delta_prove_pct_vs_paper,delta_verify_pct_vs_paper,"
              "delta_throughput_pct_vs_paper")


def csv_line(label, k, schedule, proof_bytes, prove_s, verify_ms,
             baseline=None) -> str:
    eps = (1 << k) / prove_s
    if baseline:
        d = (100.0 * (proof_bytes - baseline["proof_bytes"])
             / baseline["proof_bytes"],
             100.0 * (prove_s - baseline["prove_s"]) / baseline["prove_s"],
             100.0 * (verify_ms - baseline["verify_ms"])
             / baseline["verify_ms"],
             100.0 * (eps - baseline["eps"]) / baseline["eps"])
    else:
        d = (0.0, 0.0, 0.0, 0.0)
    sched = "x".join(str(m) for m in schedule)
    return (f"csv,{label},{k},{sched},{proof_bytes},{prove_s:.6f},"
            f"{verify_ms:.3f},{eps:.6f},{d[0]:.2f},{d[1]:.2f},{d[2]:.2f},"
            f"{d[3]:.2f}")


def _cache_path(label: str, k: int, seed: int):
    cache_dir = os.environ.get("BENCH_WITNESS_CACHE")
    if not cache_dir:
        return None
    # not the JAX package's `wit_*.npy` ([4, n, 16] uint32): a shared
    # directory must not hand one layout to the other
    return os.path.join(cache_dir, f"torch_wit_{label}_{k}_{seed:x}.npy")


def packed_witness(label: str, k: int, seed: int):
    """The four columns of `gen_witness(k, seed)` as the port's [n, 8]
    int32 Montgomery limb arrays (`fr.pack_ints(col, mont=True)`), the form
    `stark.prove` hands to the host engine and uploads.  With
    BENCH_WITNESS_CACHE=<dir> set, they persist as
    `torch_wit_{label}_{k}_{seed:x}.npy` ([4, n, 8] int32)."""
    n = 1 << k
    path = _cache_path(label, k, seed)
    if path and os.path.exists(path):
        arr = np.load(path)
        if arr.shape != (4, n, 8) or arr.dtype != np.int32:
            raise ValueError(f"{path}: {arr.dtype} {arr.shape}, expected "
                             f"int32 (4, {n}, 8)")
        return [arr[i] for i in range(4)]
    arr = StdRng.seed_from_u64(seed).ark_fr_rand_mont_limbs(4 * n)
    arr = arr.view(np.int32).reshape(4, n, 8)
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, arr)
    return [arr[i] for i in range(4)]


def _reps_for_k(k: int) -> int:
    """Criterion-style repetition: more samples where runs are short."""
    if k <= 13:
        return 5
    if k <= 16:
        return 3
    return 2


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_mf_fri(label: str, k: int, warmup: bool = True,
               check_verify: bool = True, reps: int | None = None,
               device=None):
    """Times prove(+verify) at (label, k) on the port's prover from the
    host-resident witness, after one warm-up prove.

    Returns a dict with `prove_s` and `verify_ms` (means over `reps` runs,
    the criterion-mean-equivalent the CSV records), their samples
    (`prove_samples` in s, `verify_samples` in ms) and medians
    (`prove_median_s`, `verify_median_ms`), `proof_bytes`
    (`deep_fri_proof_size_bytes`) and the last `proof`."""
    from ..fri import (DeviceDeepAliRealBuilder, deep_fri_prove,
                       deep_fri_verify)

    dev = resolve(device)
    schedule = dict(PRESETS)[label]
    seed = witness_seed_for(label, k)
    cols = packed_witness(label, k, seed)
    params = DeepFriParams(schedule=list(schedule), r=R_QUERIES,
                           seed_z=SEED_Z)
    builder = DeviceDeepAliRealBuilder()
    n0 = 1 << k

    if reps is None:
        reps = _reps_for_k(k)
    if warmup:
        deep_fri_prove(builder, *cols, n0, params, device=dev)
        _sync(dev)

    prove_samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        proof = deep_fri_prove(builder, *cols, n0, params, device=dev)
        _sync(dev)
        prove_samples.append(time.perf_counter() - t0)

    verify_samples = []
    if check_verify:
        deep_fri_verify(params, proof, device=dev)
        for _ in range(reps):
            t0 = time.perf_counter()
            ok = deep_fri_verify(params, proof, device=dev)
            _sync(dev)
            verify_samples.append((time.perf_counter() - t0) * 1e3)
            if not ok:
                raise AssertionError(f"{label} k={k}: the proof failed "
                                     f"verification")

    return {
        "label": label, "k": k, "schedule": schedule,
        "prove_s": statistics.fmean(prove_samples),
        "verify_ms": (statistics.fmean(verify_samples)
                      if verify_samples else 0.0),
        "prove_samples": prove_samples, "verify_samples": verify_samples,
        "prove_median_s": statistics.median(prove_samples),
        "verify_median_ms": (statistics.median(verify_samples)
                             if verify_samples else 0.0),
        "proof_bytes": deep_fri_proof_size_bytes(proof),
        "proof": proof,
    }


def _run_nizk(prove, verify, vk, witness, warmup: bool, dev):
    if warmup:
        prove(vk, witness, device=dev)
        _sync(dev)
    t0 = time.perf_counter()
    proof = prove(vk, witness, device=dev)
    _sync(dev)
    prove_s = time.perf_counter() - t0
    verify(vk, proof, device=dev)
    t1 = time.perf_counter()
    ok = verify(vk, proof, device=dev)
    verify_ms = (time.perf_counter() - t1) * 1e3
    if not ok:
        raise AssertionError(f"{vk.variant} NIZK k={vk.k}: the proof "
                             f"failed verification")
    return {"k": vk.k, "prove_s": prove_s, "verify_ms": verify_ms,
            "proof_bytes": proof.size_bytes()}


def run_plain_nizk(k: int, seed: int = 42, warmup: bool = True,
                   device=None):
    """Plain sum-check NIZK timings (end_to_end.rs:130-172)."""
    from ..channel import prove_plain, verify_plain
    from ..spec.channel import build_vk_plain

    witness = StdRng.seed_from_u64(seed).ark_fr_rand_batch(1 << k)
    vk = build_vk_plain(k, ds_tag=0xA11CE)
    return _run_nizk(prove_plain, verify_plain, vk, witness, warmup,
                     resolve(device))


def run_mf_nizk(k: int, queries_per_round: int = 3, seed: int = 43,
                warmup: bool = True, device=None):
    """Merkle-folded sum-check NIZK timings (protocol.rs:176-273)."""
    from ..channel import prove_mf, verify_mf
    from ..spec.channel import build_vk_mf

    witness = StdRng.seed_from_u64(seed).ark_fr_rand_batch(1 << k)
    vk = build_vk_mf(k, ds_tag=0xB0B, queries_per_round=queries_per_round)
    return _run_nizk(prove_mf, verify_mf, vk, witness, warmup,
                     resolve(device))
