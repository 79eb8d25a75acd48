#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

builds the CUDA kernels from `stark_mlwe_tpu_torch/csrc/` (nvcc, sm_90a) and
the host engine (g++) into `build/`, then runs four phases, one JSON line
each, and exits non-zero as soon as one fails:

  device     the card (`nvidia-smi` name and power limit), versions, build
  kernels    every kernel against its plain PyTorch version on the card,
             exact equality, at the shapes the prover gives it and on
             worst-case inputs; times by CUDA events
  golden     paper schedule [16,16,8], r=32, proved on the card at k=12
             (satisfying witness) and k=11 (four random columns, so the
             folded values are not all zero); the sha256 of
             `serialize_proof` must equal the JAX package's, recorded in
             tests/data/torch_golden.json, and the pure-int spec verifier
             must accept
  main_path  `MlweWitness.random(k=16, seed=1234)` at the paper schedule:
             prove, verify, two tampered proofs refused, phase times, and
             launch counts taken over the prove + verify alone

The line before the last lists every kernel with its launches on the main
path, its error against the plain version, its time, the plain version's
time and the least time the card could take (`bound_ms`).  The last line is
`{"ok": true, "device": {...}}`.  Without a CUDA device the script prints
no result and exits with code 2.

The compiler's report (registers, stack and spills of every kernel) is
written to `ptxas.log` in `build/`, or in `--log-dir`.

`--rehearse-cpu` walks the same control flow on the CPU at a small size
(plain versions only, no kernel is built or compared); it is for checking
the script itself and prints no `ok` line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
# The data sheet gives no rate for 32-bit integer multiply-adds outside the
# tensor cores; the float32 rate of the same pipes is taken as the ceiling
# (67e12 operations/s, one multiply-add = 2 operations).  The integer pipes
# are no faster than that, so `bound_ms` stays a lower bound.
INT_OPS_PER_S = 67e12
OPS_PER_MAC64 = 8              # 64x64->128 multiply-add = 4 32-bit ones

# 64-bit multiplies of the field primitives (csrc/fr.cuh).
MAC_MONT_MUL = 36              # 16 a*b + 16 m*P + 4 m
MAC_ACC_MUL = 16
MAC_REDC320 = 25
MAC_POW5 = 3 * MAC_MONT_MUL

SEED = 1234
GOLDEN_ENTRIES = ["paper_k12", "paper_k11_unstructured"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def permute_macs(t: int, rf: int, rp: int) -> int:
    """64-bit multiplies of one permutation as the kernel computes it
    (dense full rounds, sparse partial rounds, one dense matrix after)."""
    dense = t * t * MAC_ACC_MUL + t * MAC_REDC320
    full = rf * (t * MAC_POW5 + dense)
    part = rp * MAC_POW5 + (rp - 1) * (
        t * MAC_ACC_MUL + MAC_REDC320 + (t - 1) * MAC_MONT_MUL)
    return full + part + dense


def bound(nbytes: int, macs: int):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = macs * OPS_PER_MAC64 / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", default=None,
                    help="where ptxas.log goes (default: build/)")
    ap.add_argument("--rehearse-cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    rehearse = args.rehearse_cpu
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    from stark_mlwe_tpu_torch import fri, kernels, native
    from stark_mlwe_tpu_torch.ops import fr
    from stark_mlwe_tpu_torch.ops import poseidon as dpos
    from stark_mlwe_tpu_torch.spec import fri as spec_fri
    from stark_mlwe_tpu_torch.spec.field import P
    from stark_mlwe_tpu_torch.spec.merkle import MerkleChannelCfg
    from stark_mlwe_tpu_torch.spec.transcript import default_params
    from stark_mlwe_tpu_torch.stark import (DeepFriParams, MlweWitness,
                                            deserialize_proof, prove,
                                            serialize_proof, verify)

    dev = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---- phase 1: device ------------------------------------------------
    card = "cpu rehearsal" if rehearse else smi_line()
    native.available()
    if not rehearse:
        kernels.build_all()
        logdir = args.log_dir or os.path.join(ROOT, "build")
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "ptxas.log"), "w") as f:
            for name, log in kernels.build_log.items():
                f.write(f"==== {name}\n{log}\n")
    print(card, flush=True)
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kind": None if rehearse else torch.cuda.get_device_name(0),
          "kernel_build_seconds": kernels.build_seconds,
          "setup_seconds": time.perf_counter() - t_start})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def time_ms(fn, reps: int, inner: int = 1) -> float:
        """Median over `reps` of the device time of one call: each sample
        is `inner` back-to-back calls between two CUDA events, after one
        warm-up.  A spin kernel is queued ahead of the first event so the
        host runs ahead of the card and the launches' host cost (tens of
        microseconds each) does not show as device time."""
        fn()
        sync()
        samples = []
        for _ in range(reps):
            if dev.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(4_000_000 if inner > 1 else 200_000)
                e0.record()
                for _ in range(inner):
                    fn()
                e1.record()
                torch.cuda.synchronize()
                samples.append(e0.elapsed_time(e1) / inner)
            else:
                t0 = time.perf_counter()
                for _ in range(inner):
                    fn()
                samples.append((time.perf_counter() - t0) * 1e3 / inner)
        return statistics.median(samples)

    def max_abs_err(a, b) -> int:
        if a.shape != b.shape:
            raise AssertionError(f"shape {a.shape} vs {b.shape}")
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    rng = np.random.default_rng(SEED)

    def rand_elems(*shape):
        """Uniform canonical field elements as limb tensors on `dev`."""
        n = int(np.prod(shape))
        raw = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        raw[:, 7] &= 0x3FFFFFFF          # < 2^254 < P
        return fr.to_device(raw.astype(np.uint32).view(np.int32), dev
                            ).reshape(*shape, 8)

    R = fr.R_MONT
    edge_ints = [0, 1, P - 1, P - 2, R, fr.R2_MONT, (1 << 254) - 1,
                 (1 << 192) - 1, ((1 << 128) - 1) << 64, (1 << 64) - 1,
                 0xFFFFFFFF00000000FFFFFFFF, P - (1 << 64), (P - 1) // 2]
    edge_ints = [x % P for x in edge_ints]

    def edge_pairs():
        xs = [x for x in edge_ints for _ in edge_ints]
        ys = [y for _ in edge_ints for y in edge_ints]
        return (fr.to_device(fr.pack_ints(xs), dev),
                fr.to_device(fr.pack_ints(ys), dev))

    # ---- phase 2: kernels ------------------------------------------------
    full_n = 1 << (16 if not rehearse else 6)
    rows = []          # the "kernels" line, filled in after the main path

    def check_exact(name, got, want):
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel and plain version "
                                 f"disagree (max abs limb error {err})")
        return err

    # K2 fr_elementwise: mont_mul, add, sub
    ea, eb = edge_pairs()
    for name, fn, plain, replaces, bcast in (
            ("fr_mont_mul", fr.mont_mul, fr.mont_mul_plain,
             "stark_mlwe_tpu/ops/fr.py:382", False),
            ("fr_add", fr.add, fr.add_plain,
             "stark_mlwe_tpu/ops/fr.py:246", False),
            ("fr_sub", fr.sub, fr.sub_plain,
             "stark_mlwe_tpu/ops/fr.py:253", True)):
        a = rand_elems(full_n)
        b = rand_elems(1)[0] if bcast else rand_elems(full_n)
        err = check_exact(name, fn(a, b), plain(a, b))
        err = max(err, check_exact(name + " (edge values)", fn(ea, eb),
                                   plain(ea, eb)))
        err = max(err, check_exact(name + " (broadcast, ragged)",
                                   fn(a[:1001], eb[5]),
                                   plain(a[:1001], eb[5])))
        ms = time_ms(lambda: fn(a, b), 7, inner=20)
        pms = time_ms(lambda: plain(a, b), 3)
        nbytes = 32 * (full_n + (1 if bcast else full_n) + full_n)
        macs = full_n * (MAC_MONT_MUL if name == "fr_mont_mul" else 0)
        bms, by = bound(nbytes, macs)
        rows.append({"name": name, "route": "cuda",
                     "source": "stark_mlwe_tpu_torch/csrc/fr_elementwise.cu",
                     "replaces": replaces, "shape": f"n={full_n}",
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "tolerance": 0, "bound_ms": bms, "bound_by": by,
                     "library_ms": None})

    # K3 fr_fold
    m = 16
    f = rand_elems(full_n)
    zp = rand_elems(m)
    err = check_exact("fr_fold", fr.fold(f, zp), fr.fold_plain(f, zp))
    worst = fr.to_device(fr.pack_ints([P - 1] * (m * 7)), dev)
    err = max(err, check_exact("fr_fold (all P-1)",
                               fr.fold(worst, worst[:m]),
                               fr.fold_plain(worst, worst[:m])))
    f8 = f[:8 * 37]
    err = max(err, check_exact("fr_fold (m=8, ragged)", fr.fold(f8, zp[:8]),
                               fr.fold_plain(f8, zp[:8])))
    ms = time_ms(lambda: fr.fold(f, zp), 7, inner=20)
    pms = time_ms(lambda: fr.fold_plain(f, zp), 3)
    nout = full_n // m
    bms, by = bound(32 * (full_n + m + nout),
                    nout * (m * MAC_ACC_MUL + MAC_REDC320))
    rows.append({"name": "fr_fold", "route": "cuda",
                 "source": "stark_mlwe_tpu_torch/csrc/fr_fold.cu",
                 "replaces": "stark_mlwe_tpu/fri/__init__.py:198",
                 "shape": f"n={full_n}, m={m}", "max_abs_err": err,
                 "tolerance": 0, "ms": ms, "plain_ms": pms, "bound_ms": bms,
                 "bound_by": by, "library_ms": None})

    # K1 poseidon_permute, t = 17 (transcript parameters: the leaf hash of
    # layer 0 is one permutation per leaf) and t = 9 (the arity-8 and
    # arity-2 trees; 32 parents is the largest level the paper schedule
    # gives it at k = 16, 256 is checked as well).
    for t, params, B_main, B_extra in (
            (17, default_params(), full_n, 1001),
            (9, MerkleChannelCfg.new(8).params, 32, 256)):
        dp = dpos.device_params(params)
        if rehearse:
            B_main, B_extra = 5, 3
        st = rand_elems(B_main, t)
        name = f"poseidon_permute_t{t}"
        out_k = dpos.permute(st, dp)
        sync()
        err = check_exact(name, out_k, dpos.permute_plain(st, dp))
        st2 = rand_elems(B_extra, t)
        err = max(err, check_exact(f"{name} (B={B_extra})",
                                   dpos.permute(st2, dp),
                                   dpos.permute_plain(st2, dp)))
        edge = fr.to_device(fr.pack_ints(
            [v for x in edge_ints for v in [x] * t]), dev).reshape(-1, t, 8)
        err = max(err, check_exact(f"{name} (edge values)",
                                   dpos.permute(edge, dp),
                                   dpos.permute_plain(edge, dp)))
        if t == 17:
            # the second oracle: the pure-int spec on a few states
            from stark_mlwe_tpu_torch.spec import poseidon as spos
            few = fr.unpack_ints(st[:3], mont=True)
            want = [v for i in range(3)
                    for v in spos.permute(few[i * t:(i + 1) * t], params)]
            if fr.unpack_ints(out_k[:3], mont=True) != want:
                raise AssertionError(f"{name}: disagrees with the spec")
        ms = time_ms(lambda: dpos.permute(st, dp), 5)
        pms = time_ms(lambda: dpos.permute_plain(st, dp), 2)
        bms, by = bound(2 * 32 * t * B_main,
                        B_main * permute_macs(t, params.rf, params.rp))
        row = {"name": name, "route": "cuda",
               "source": "stark_mlwe_tpu_torch/csrc/poseidon_permute.cu",
               "replaces": "stark_mlwe_tpu/ops/poseidon_pallas.py:486",
               "shape": f"B={B_main}, t={t}", "max_abs_err": err, "ms": ms,
               "plain_ms": pms, "tolerance": 0, "bound_ms": bms,
               "bound_by": by, "library_ms": None}
        if not rehearse:
            row[f"ms_B{B_extra}"] = time_ms(lambda: dpos.permute(st2, dp), 5)
        rows.append(row)
    emit({"phase": "kernels", "card": card, "exact": True,
          "kernels": [{k: r[k] for k in ("name", "shape", "ms", "plain_ms",
                                         "max_abs_err")} for r in rows],
          "seconds": time.perf_counter() - t_start})

    # ---- phase 3: golden --------------------------------------------------
    with open(os.path.join(ROOT, "tests", "data", "torch_golden.json")) as fh:
        golden = {e["name"]: e for e in json.load(fh)["entries"]}
    names = ["small_k6"] if rehearse else GOLDEN_ENTRIES
    for name in names:
        ent = golden[name]
        gparams = DeepFriParams(schedule=list(ent["schedule"]), r=ent["r"],
                                seed_z=ent["seed_z"])
        make = (MlweWitness.random_unstructured if ent.get("unstructured")
                else MlweWitness.random)
        t0 = time.perf_counter()
        gproof = prove(make(k=ent["k"], seed=ent["seed"]), gparams,
                       device=dev)
        gbuf = serialize_proof(gproof)
        gsha = hashlib.sha256(gbuf).hexdigest()
        if gsha != ent["sha256"] or len(gbuf) != ent["proof_bytes"]:
            raise AssertionError(
                f"golden {name}: port proof {len(gbuf)} bytes {gsha} != JAX "
                f"package's {ent['proof_bytes']} bytes {ent['sha256']}")
        if not verify(gparams, gproof, device=dev):
            raise AssertionError(f"golden {name}: verify refused the proof")
        # the copied pure-int verifier is the independent judge
        t1 = time.perf_counter()
        if not spec_fri.deep_fri_verify(gparams, gproof):
            raise AssertionError(f"golden {name}: spec.fri.deep_fri_verify "
                                 f"refused the proof")
        spec_s = time.perf_counter() - t1
        emit({"phase": "golden", "entry": name, "k": ent["k"],
              "proof_bytes": len(gbuf), "sha256": gsha, "matches_jax": True,
              "verify": True, "spec_verify": True,
              "spec_verify_seconds": spec_s,
              "seconds": time.perf_counter() - t0})

    # ---- phase 4: main path ----------------------------------------------
    k = 7 if rehearse else 16
    params = (DeepFriParams(schedule=[8, 4], r=6, seed_z=0xDEEFBAAD)
              if rehearse else
              DeepFriParams(schedule=[16, 16, 8], r=32, seed_z=0xDEEFBAAD))
    t0 = time.perf_counter()
    witness = MlweWitness.random(k=k, seed=SEED)
    witness_s = time.perf_counter() - t0

    kernels.reset_launches()
    sync()
    t0 = time.perf_counter()
    proof = prove(witness, params, device=dev)
    sync()
    prove_s = time.perf_counter() - t0
    phases = dict(fri.phase_seconds)
    t0 = time.perf_counter()
    accepted = verify(params, proof, device=dev)
    verify_s = time.perf_counter() - t0
    counts = dict(kernels.launches)

    if not accepted:
        raise AssertionError("main path: verify refused the proof")
    buf = serialize_proof(proof)
    if serialize_proof(deserialize_proof(buf)) != buf:
        raise AssertionError("main path: wire format does not round-trip")
    L = len(params.schedule)
    per_query = 8 + 32 * L + 8 + 128 * L + 8 + 64      # the format's tail
    for what, off in (("root", 8 + 32 + 8 + 3),
                      ("opened value",
                       len(buf) - per_query + 8 + 32 * L + 8 + 1)):
        bad = bytearray(buf)
        bad[off] ^= 1
        if verify(params, deserialize_proof(bytes(bad)), device=dev):
            raise AssertionError(f"main path: a proof with a flipped byte "
                                 f"in a {what} was accepted")
    if len(proof.roots) != len(params.schedule) + 1 \
            or len(proof.queries) != params.r or proof.n0 != 1 << k:
        raise AssertionError("main path: proof of unexpected shape")
    if not rehearse:
        missing = [n for n, c in counts.items() if c == 0]
        if missing:
            raise AssertionError(f"main path launched no {missing}")
    emit({"phase": "main_path", "k": k, "schedule": params.schedule,
          "r": params.r, "verify": True, "tamper_refused": True,
          "proof_bytes": len(buf),
          "spec_proof_bytes": spec_fri.deep_fri_proof_size_bytes(proof),
          "witness_seconds": witness_s, "prove_seconds": prove_s,
          "verify_seconds": verify_s, "phase_seconds": phases,
          "launches": counts, "card": card})

    for r in rows:
        r["launches"] = counts[r["name"]]
    if rehearse:
        emit({"kernels": rows})
        print("rehearsal on the CPU finished: no kernel was built or run",
              file=sys.stderr)
        return 0

    print(smi_line(), flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
