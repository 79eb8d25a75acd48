#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

builds the CUDA kernels from `stark_mlwe_tpu_torch/csrc/` (nvcc, sm_90a) and
the host engine (g++) into `build/`, then runs eight phases, one JSON line
each (nizk_path and bench_path one a proof and one to close), and exits
non-zero as soon as one fails:

  device     the card (`nvidia-smi` name and power limit), versions, build,
             the host CPU (model, cores, whether it has AVX-512 IFMA)
  kernels    every kernel against its plain PyTorch version on the card,
             exact equality, at the shapes the prover gives it and on
             worst-case inputs; times by CUDA events.  K1's two layouts (a
             warp per state, a thread per state) are each held against the
             plain version, the edge values and the spec at t=17 and t=9,
             and swept over batch sizes side by side (`k1_sweep`: the ms of
             each layout, medians of 5, and the two outputs compared
             exactly at every size), which is where `WARP_MAX_B` comes
             from.  K5 (the wide widths 33, 65, 129) likewise: every
             layout (S states a block, K threads a dense row, C blocks a
             state) held against the plain version and swept over batch
             sizes (`k5_sweep`, the fastest layout at each size in
             `k5_fastest_by_B`: where `PACK_MIN_B` comes from; threads,
             dynamic shared memory and registers of each layout in
             `k5_layouts`), its rows at the batches the wide presets give
             it (the wide paths' lines count K5's launches by batch, and
             each row's `launches_at_shape` must not be 0), and its dense
             products timed apart from its partial rounds
             (`k5_phase_split`).  The chain kernel is also held against the host engine
             at its real length (4 chains of 4,096 rate blocks) and timed
             per block beside it; its row also gives its
             time per block over the host engine's (medians of several
             runs each, the host engine's samples beside them), the SASS
             instructions of each of its instances (`cuobjdump`), and its
             registers and spills from the compiler's report.  The fold K3
             is compared at m = 8, 16, 32, 64, 128 (random values with a
             ragged last block, all P-1, zeros), 3 and 1,024, and timed at
             n = 65,536 for m = 16 (`ms`) and 32, 64, 128 (`ms_by_m`).  The
             NTT tile kernel is compared at every length from 2 to 4,096,
             forward and inverse, with no, a full and a periodic epilogue,
             on contiguous and strided views, ragged batches and edge
             values, and timed at the two launches that n = 2^22 gives it
             (2,048 transforms of length 2,048: the columns with the step
             twiddles, then the rows; medians of 7, samples printed).  The
             batch
             inversion `fr_batch_inv` (the f0 quotient of every prove path,
             three launches) is held at the prover's n = 65,536, at edge
             values, at n = 1, 2, 3, 1,001 and 2^17 + 3 (runs of two
             elements), and with a zero in the input; timed whole (samples
             printed) and its total launch alone on one element
             (`serial_floor_ms`: the one Fermat inversion)
  golden     proofs made on the card whose sha256 of `serialize_proof` must
             equal the JAX package's, recorded in
             tests/data/torch_golden.json, and which the pure-int spec
             verifier must accept: the paper schedule [16,16,8], r=32, at
             k=12 (satisfying witness) and k=11 (four random columns, so
             the folded values are not all zero); schedules [32], [64],
             [128], [64,8] and [32,32] (Poseidon widths 33, 65, 129); and the paper
             schedule with the witness handed over as tensors on the card
             (the device branch), which must also equal the host branch's
             proof of the same witness
  main_path  k=16, each path with the launch counts set to 0 just before
             it and read just after: (a) `MlweWitness.random(k=16,
             seed=1234)` at the paper schedule from host columns; (b) the
             same witness as CUDA tensors, whose proof must be byte-equal
             to (a)'s and whose column chains must run in the chain kernel
             and not in the host engine; (c) four random columns at the
             presets `hi128_64_8` [128,64,8] and `uni32x3` [32,32,32].
             Every path: prove, verify, two tampered proofs refused, phase
             times; one f0 quotient (three `fr_batch_inv` launches) and, on
             the host-witness paths, no `fr_sub`
  ntt_path   the NTT entry points at full size, counts set to 0 before and
             read after: `ntt` of 2^22 elements equal to the flat plain
             transform, `intt(ntt(x)) == x`, `lde` of 2^20 values at blowup
             4 with `out[::4] == values`, `lde` with a coset shift and
             `ntt_four_step(256, 256)` against the flat transform, the JAX
             package's recorded digests (`ntt_entries` of
             tests/data/torch_golden.json), the O(n^2) sum at n = 256 in
             Python ints, `Poly.mul` against the schoolbook product; host
             clock times of one warmed call each
  nizk_path  the sum-check NIZKs (`channel.prove_plain` / `prove_mf`) at
             benchmarkdata_nizk.csv's settings (plain: witness seed 42,
             ds_tag 0xA11CE; MF: seed 43, ds_tag 0xB0B, 3 queries a round)
             at k = 12, 14, 16, counts set to 0 before one prove and read
             after it: `size_bytes()` equal to the CSV's `proof_bytes`, the
             sha256 of `serde.serialize_nizk_proof` equal to the JAX
             package's (`nizk_entries` of tests/data/torch_golden.json),
             the port's and the copied spec verifier accept, two tampered
             copies refused (a byte of final_eval and of a c0; of a
             next_root and of a sibling), and the device chain alone, run
             under `torch.cuda.set_sync_debug_mode("error")`, gives the
             proof's roots and coefficients.  Per proof: prove seconds and
             verify ms (medians of 5, samples printed), phases, launches,
             the MF read-back branch.  At k = 16 K1's device time by layout
             and batch (CUDA events around each launch) and a
             `torch.profiler` trace of one prove: device time by kernel and
             the idle share
  bench_path the bench harness (`stark_mlwe_tpu_torch.bench`) as the
             drivers run it, on `gen_witness(k, witness_seed_for(label,
             k))`: the paper schedule at k = 11-16 and the twelve other
             presets at k=16, counts set to 0 before each of the two paths
             and read after; each `proof_bytes` equal to benchmarkdata.csv's
             row, each proof accepted by the port's verifier, and those of
             `BENCH_SPEC_VERIFY` by the spec verifier too;
             the paper k=16 proof's sha256 equal to the JAX spec prover's
             (`bench_paper_k16` of tests/data/torch_golden.json), its 5
             prove and verify samples, medians, its wire length apart from
             `proof_bytes`; `run_plain_nizk(12)` / `run_mf_nizk(12)` sizes
             equal to benchmarkdata_nizk.csv's; the peak allocated device
             memory, `utils.profiling.phase_report()`, and a
             `utils.profiling.trace` of one paper k=16 prove in `--log-dir`
             (its idle share beside it)
  parallel_path  the sharded prover (`distributed`, `parallel`,
             `parallel.prover`) on a one-rank group set up by
             `initialize_distributed()`: NCCL on cuda:0 (the line prints
             the backend and the world size).  (a) `prove_sharded` of
             main_path (a)'s witness and schedule, byte-equal to its
             proof, verified, two tampered copies refused, host-clock
             seconds of `PARALLEL_REPS` proves (median and samples) beside
             main_path (a)'s; (b) `sharded_deep_fri_prove` of the bench
             witness at paper k=16, its sha256 the `bench_paper_k16`
             golden; (c) `build_sharded_prove_step` at n = 2^16, m = arity
             = 16, on random columns: root, phi_z and f1 equal to
             `build_tree`, `merge_evals_device` and `fold_layer_dev`, phi_z
             to `DeviceDomainH.eval_lagrange`; (d) `build_ntt_sharded` at
             2^11 x 2^11 equal to `ntt` and `ntt_four_step`.  Each with the
             launch counts and the mesh's collectives set to 0 before it
             and read after it: K1, K3 and `fr_batch_inv` must have run in
             (a), (b) and (c), K6 in (d).  More than one rank needs a
             machine with more than one card

The line before the last lists every kernel with its launches on the main
paths, its error against the plain version, its time, the plain version's
time and the least time the card could take (`bound_ms`).  Every time on it
was measured in the run; where the plain version was timed at a smaller
shape than the kernel (the chain), the row says so in `plain_shape` and
gives the kernel's time at that shape too.  The last line is
`{"ok": true, "device": {...}}`.  Without a CUDA device the script prints
no result and exits with code 2.

The compiler's report (registers, stack and spills of every kernel) is
written to `ptxas.log` in `build/`, or in `--log-dir`, and every JSON line
of the run to `chip_smoke.jsonl` beside it.

`--rehearse-cpu` walks the same control flow on the CPU at a small size
(plain versions only, no kernel is built or compared; the sharded prover
on a one-rank gloo group); it is for checking the script itself and prints
no `ok` line.
"""

from __future__ import annotations

import argparse
import copy
import csv
import ctypes
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SEED = 1234
HOST_REPS = 5                  # host-engine runs of the full chain
GOLDEN_ENTRIES = ["paper_k12", "paper_k11_unstructured", "wide32_k6",
                  "wide64_k7", "wide128_k8", "wide64_8_k10", "wide32_32_k11",
                  "paper_k11_device_witness"]
WIDE_PRESETS = [("hi128_64_8", [128, 64, 8]), ("uni32x3", [32, 32, 32])]
NTT_PATH = "ntt 2^22 + lde 2^20x4"
NTT_GOLDEN = ["ntt_2e16", "intt_2e16", "lde_2e14_b4", "lde_2e12_b2_coset5",
              "four_step_256x256"]
# The sum-check NIZKs as `bench.run_plain_nizk` / `run_mf_nizk` of the JAX
# package run them (benchmarkdata_nizk.csv): witness seed, ds_tag, queries.
NIZK = {"plain": (42, 0xA11CE, 0), "mf": (43, 0xB0B, 3)}
NIZK_KS = (12, 14, 16)
NIZK_REPS = 5
# The bench harness's path (`bench_path`): paper rows and the preset rows'
# k of benchmarkdata.csv, the samples of the paper k=16 row, its golden.
BENCH_PAPER_KS = (11, 12, 13, 14, 15, 16)
BENCH_K = 16
BENCH_REPS = 5
BENCH_GOLDEN = "bench_paper_k16"
# Presets whose bench proofs the pure-int spec verifier also checks: at
# widths 65 and 129 it takes 28-42 s a proof on the GPU machine's host.
BENCH_SPEC_VERIFY = ("paper", "mod16", "uni32x3")
# Samples of the sharded prove (`parallel_path` (a)).
PARALLEL_REPS = 3
CHAIN_REPLACES = ("stark_mlwe_tpu/ops/poseidon_chain.py:429",
                  "stark_mlwe_tpu/ops/poseidon_pallas.py:584")


LINES = []                     # every JSON line, for chip_smoke.jsonl


def emit(obj) -> None:
    LINES.append(json.dumps(obj))
    print(LINES[-1], flush=True)


def kernel_key(mangled: str) -> str:
    """`poseidon_permute_warp_kernel<17>` or
    `poseidon_permute_group_kernel<33,1,4>` for the mangled name of that
    template instance; other names as they are."""
    m = re.match(r"_Z\d+(\w+?)I((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    args = re.findall(r"Li(\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_registers(log: str) -> dict:
    """Registers and spill bytes of each kernel instance in an
    `nvcc -Xptxas -v` log, keyed by `kernel_key`."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([^' ]+)", line)
        if m:
            key = kernel_key(m.group(1))
            out.setdefault(key, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key:
            out[key]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            out[key]["registers"] = int(m.group(1))
    return out


def sass_counts(so: str):
    """SASS instructions of each kernel instance in a built library, keyed
    as in `ptxas_registers`; None where `cuobjdump` is missing."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", so], check=True, capture_output=True,
                         text=True).stdout
    counts, key = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = kernel_key(m.group(1))
            counts[key] = 0
        elif key and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[key] += 1
    return counts


def csv_sizes(name: str, kind: str) -> dict:
    """(row[kind], k) -> proof_bytes of one of the JAX package's bench
    CSVs; a key recorded with two sizes raises."""
    out = {}
    with open(os.path.join(ROOT, name)) as fh:
        for row in csv.DictReader(fh):
            key, size = (row[kind], int(row["k"])), int(row["proof_bytes"])
            if out.setdefault(key, size) != size:
                raise AssertionError(f"{name}: two sizes for {key}")
    return out


def check_wire_and_tamper(path: str, params, buf: bytes, dev) -> None:
    """The wire format round-trips, and two copies with a flipped byte the
    verifier reads (a root, an opened value of the last query) are
    refused."""
    from stark_mlwe_tpu_torch.stark import (deserialize_proof,
                                            serialize_proof, verify)

    if serialize_proof(deserialize_proof(buf)) != buf:
        raise AssertionError(f"{path}: wire format does not round-trip")
    L = len(params.schedule)
    per_query = 8 + 32 * L + 8 + 128 * L + 8 + 64   # the format's tail
    for what, off in (("root", 8 + 32 + 8 + 3),
                      ("opened value",
                       len(buf) - per_query + 8 + 32 * L + 8 + 1)):
        bad = bytearray(buf)
        bad[off] ^= 1
        if verify(params, deserialize_proof(bytes(bad)), device=dev):
            raise AssertionError(f"{path}: a proof with a flipped byte "
                                 f"in a {what} was accepted")


def nizk_path(dev, rehearse: bool, card: str, by_path: dict) -> None:
    """The sum-check NIZKs at benchmarkdata_nizk.csv's settings (see the
    module doc); adds each proof's launch counts to `by_path`."""
    import torch

    from stark_mlwe_tpu_torch import channel as tch
    from stark_mlwe_tpu_torch import kernels
    from stark_mlwe_tpu_torch import merkle as dmk
    from stark_mlwe_tpu_torch.mle import DeviceMLE
    from stark_mlwe_tpu_torch.ops import fr
    from stark_mlwe_tpu_torch.ops import poseidon as dpos
    from stark_mlwe_tpu_torch.serde import serialize_nizk_proof
    from stark_mlwe_tpu_torch.spec import channel as spec_channel
    from stark_mlwe_tpu_torch.spec.field import fr_to_bytes
    from stark_mlwe_tpu_torch.spec.rng import StdRng

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    csv_bytes = csv_sizes("benchmarkdata_nizk.csv", "variant")
    with open(os.path.join(ROOT, "tests", "data", "torch_golden.json")) as fh:
        nizk_golden = {e["name"]: e for e in json.load(fh)["nizk_entries"]}
    k1_by_batch = {}
    permute_k1 = dpos.permute_k1

    def timed_permute_k1(state, dp, layout):
        """K1 with CUDA events around the launch, summed by layout, width
        and batch (read after a synchronise)."""
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = permute_k1(state, dp, layout)
        e1.record()
        key = f"{layout} t={dp.t} B={int(state.shape[0])}"
        k1_by_batch.setdefault(key, []).append((e0, e1))
        return out

    class no_host_sync:
        """CUDA's sync debug mode at "error" (any operation that makes the
        host wait for the card raises); nothing on the CPU."""

        def __enter__(self):
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")

        def __exit__(self, *exc):
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
            return False

    def flip_byte(b: bytes) -> bytes:
        return b[:3] + bytes([b[3] ^ 1]) + b[4:]

    def chain_outputs(variant, vk, values):
        """The device chain alone (tree + rounds), run with host syncs
        forbidden; returns (roots, coefficient pairs, final) as ints."""
        tree_cfg = tch.DeviceMerkleCommitment(vk.tree_label)._tree_cfg()
        with no_host_sync():
            if variant == "plain":
                root = dmk.build_tree(values, tree_cfg).levels_dev[-1][0]
                _, cps, final = tch._plain_chain(values, root, vk.k)
                roots, cps = [root], [cps[i] for i in range(vk.k)]
            else:
                layers, trees, pairs = tch._mf_chain_device(
                    DeviceMLE(values), tree_cfg, vk.k)
                roots = [t.levels_dev[-1][0] for t in trees]
                cps = [torch.stack(p) for p in pairs]
                final = layers[-1].values_dev[0]
        sync()
        out = fr.unpack_ints(fr.from_mont(torch.cat(
            [torch.stack(roots), torch.cat(cps), final[None]])))
        n_roots = len(roots)
        return (out[:n_roots], list(zip(out[n_roots:-1:2],
                                        out[n_roots + 1:-1:2])), out[-1])

    nizk_ks = (4,) if rehearse else NIZK_KS
    reps = 1 if rehearse else NIZK_REPS
    nizk_lines = []
    for variant, (seed, ds_tag, queries) in NIZK.items():
        prove_fn, verify_fn, spec_verify = (
            (tch.prove_plain, tch.verify_plain, spec_channel.verify_plain)
            if variant == "plain" else
            (tch.prove_mf, tch.verify_mf, spec_channel.verify_mf))
        for kk in nizk_ks:
            t0 = time.perf_counter()
            w = StdRng.seed_from_u64(seed).ark_fr_rand_batch(1 << kk)
            vk = (spec_channel.build_vk_plain(kk, ds_tag) if variant == "plain"
                  else spec_channel.build_vk_mf(kk, ds_tag, queries))
            path = f"nizk {variant} k={kk}"
            prove_fn(vk, w, device=dev)            # warm-up: constants
            sync()
            samples, phases = [], []
            for rep in range(reps):
                kernels.reset_launches()
                sync()
                t1 = time.perf_counter()
                proof = prove_fn(vk, w, device=dev)
                sync()
                samples.append(time.perf_counter() - t1)
                phases.append(dict(tch.phase_seconds))
                if rep == 0:
                    counts = dict(kernels.launches)
            by_path[path] = counts
            buf = serialize_nizk_proof(proof)
            vsamples = []
            for _ in range(reps):
                t1 = time.perf_counter()
                ok = verify_fn(vk, proof, device=dev)
                vsamples.append((time.perf_counter() - t1) * 1e3)
                if not ok:
                    raise AssertionError(f"{path}: verify refused the proof")
            t1 = time.perf_counter()
            if not spec_verify(vk, proof):
                raise AssertionError(f"{path}: the spec verifier refused "
                                     f"the proof")
            spec_s = time.perf_counter() - t1
            want_bytes = csv_bytes.get((variant, kk))
            if want_bytes is not None and proof.size_bytes() != want_bytes:
                raise AssertionError(f"{path}: {proof.size_bytes()} bytes, "
                                     f"benchmarkdata_nizk.csv says "
                                     f"{want_bytes}")
            if not rehearse and want_bytes is None:
                raise AssertionError(f"{path}: not in benchmarkdata_nizk.csv")
            ent = nizk_golden.get(f"{variant}_k{kk}")
            sha = hashlib.sha256(buf).hexdigest()
            if ent is not None and (sha != ent["sha256"]
                                    or proof.size_bytes() != ent["size_bytes"]):
                raise AssertionError(f"{path}: sha256 {sha} differs from the "
                                     f"JAX package's {ent['sha256']}")
            if not rehearse and kk < 16 and ent is None:
                raise AssertionError(f"{path}: no golden entry")
            # tampered copies: bytes the verifier reads
            if variant == "plain":
                c0, c1 = proof.rounds[2]
                bad = [spec_channel.ProofPlain(proof.root, proof.rounds,
                                               flip_byte(proof.final_eval)),
                       spec_channel.ProofPlain(
                           proof.root, proof.rounds[:2] + [(flip_byte(c0), c1)]
                           + proof.rounds[3:], proof.final_eval)]
            else:
                bad = [copy.deepcopy(proof), copy.deepcopy(proof)]
                bad[0].rounds[1].next_root = flip_byte(
                    bad[0].rounds[1].next_root)
                lvl = next(lv for lv in bad[1].rounds[0].cur_proof.siblings
                           if lv)
                lvl[0] = flip_byte(lvl[0])
            for b in bad:
                if verify_fn(vk, b, device=dev):
                    raise AssertionError(f"{path}: a tampered proof was "
                                         f"accepted")
            if spec_verify(vk, bad[0]):
                raise AssertionError(f"{path}: the spec verifier accepted a "
                                     f"tampered proof")
            # the chain alone, with host syncs forbidden, gives the proof's
            # roots and coefficients
            values = DeviceMLE.from_ints(w, dev).values_dev
            roots, cints, final = chain_outputs(variant, vk, values)
            want_roots = ([proof.root] if variant == "plain" else
                          [proof.initial_root] + [r.next_root
                                                  for r in proof.rounds])
            want_c = (proof.rounds if variant == "plain" else
                      [(r.c0, r.c1) for r in proof.rounds])
            if ([fr_to_bytes(x) for x in roots] != want_roots
                    or [(fr_to_bytes(a), fr_to_bytes(b)) for a, b in cints]
                    != list(want_c)
                    or fr_to_bytes(final) != proof.final_eval):
                raise AssertionError(f"{path}: the chain run without host "
                                     f"syncs differs from the proof")
            if not rehearse:
                missing = [n for n in ("poseidon_permute_warp_t17", "fr_add",
                                       "fr_sub", "fr_mont_mul")
                           if counts[n] == 0]
                if missing:
                    raise AssertionError(f"{path} launched no {missing}")
            branch = ("bundle" if variant == "plain" else
                      "gather" if (1 << kk) >= tch.MF_GATHER_MIN_N
                      else "download")
            line = {"phase": "nizk_path", "path": path, "k": kk,
                    "branch": branch, "proof_bytes": proof.size_bytes(),
                    "csv_proof_bytes": want_bytes,
                    "encoded_bytes": len(buf), "sha256": sha,
                    "matches_jax": ent is not None, "verify": True,
                    "spec_verify": True, "tamper_refused": True,
                    "chain_without_host_sync": dev.type == "cuda",
                    "prove_seconds": statistics.median(samples),
                    "prove_seconds_samples": samples,
                    "verify_ms": statistics.median(vsamples),
                    "verify_ms_samples": vsamples,
                    "spec_verify_seconds": spec_s,
                    "phase_seconds": {n: statistics.median(
                        p[n] for p in phases) for n in phases[0]},
                    "launches": {n: c for n, c in counts.items() if c},
                    "seconds": time.perf_counter() - t0, "card": card}
            nizk_lines.append(line)
            emit(line)

    # k = 16 (k = 4 in the rehearsal): K1's device time by layout and batch
    # (CUDA events around each launch of one prove), then one more prove
    # under torch.profiler: device time by kernel, copies included, and the
    # idle share of the traced wall.
    profile = {}
    if not rehearse:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        kk = nizk_ks[-1]
        for variant, (seed, ds_tag, queries) in NIZK.items():
            w = StdRng.seed_from_u64(seed).ark_fr_rand_batch(1 << kk)
            vk = (spec_channel.build_vk_plain(kk, ds_tag) if variant == "plain"
                  else spec_channel.build_vk_mf(kk, ds_tag, queries))
            prove_fn = tch.prove_plain if variant == "plain" else tch.prove_mf
            k1_by_batch.clear()
            dpos.permute_k1 = timed_permute_k1
            try:
                prove_fn(vk, w, device=dev)
                sync()
            finally:
                dpos.permute_k1 = permute_k1
            k1 = {key: {"launches": len(ev), "device_ms": sum(
                a.elapsed_time(b) for a, b in ev)}
                for key, ev in sorted(k1_by_batch.items())}
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                prove_fn(vk, w, device=dev)
                sync()
                traced = time.perf_counter() - t1
            by_name = {}
            for ev in prof.key_averages():
                self_us = getattr(ev, "self_device_time_total", None)
                if self_us is None:
                    self_us = getattr(ev, "self_cuda_time_total", 0.0)
                if self_us > 0:
                    by_name[ev.key] = {"calls": ev.count,
                                       "device_ms": self_us / 1e3}
            busy = sum(v["device_ms"] for v in by_name.values()) / 1e3
            profile[variant] = {
                "k": kk, "k1_device_ms_by_layout_and_batch": k1,
                "traced_prove_seconds": traced, "device_busy_seconds": busy,
                "device_idle_share": 1.0 - busy / traced,
                "device_ms_by_kernel": dict(sorted(
                    by_name.items(), key=lambda kv: -kv[1]["device_ms"]))}
    emit({"phase": "nizk_path", "profile": profile,
          "paths": len(nizk_lines), "gather_min_n": tch.MF_GATHER_MIN_N,
          "seconds": time.perf_counter() - t_phase, "card": card})


def bench_path(dev, rehearse: bool, card: str, by_path: dict,
               logdir: str) -> None:
    """The bench harness (`stark_mlwe_tpu_torch.bench`) as the drivers run
    it: the paper schedule at k = 11-16 and the other twelve presets at
    k=16 on `gen_witness(k, witness_seed_for(label, k))`, each proof's
    `proof_bytes` held to benchmarkdata.csv and accepted by the port's
    verifier (and `BENCH_SPEC_VERIFY`'s by the spec one); the paper k=16
    proof's sha256 held to the JAX spec
    prover's (`bench_paper_k16` of tests/data/torch_golden.json); the NIZK
    sizes at k=12.  Counts set to 0 before each path and read after it."""
    import torch

    from stark_mlwe_tpu_torch import bench, kernels
    from stark_mlwe_tpu_torch.spec import fri as spec_fri
    from stark_mlwe_tpu_torch.stark import serialize_proof
    from stark_mlwe_tpu_torch.utils import profiling

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    csv_bytes = csv_sizes("benchmarkdata.csv", "label")
    nizk_bytes = csv_sizes("benchmarkdata_nizk.csv", "variant")
    with open(os.path.join(ROOT, "tests", "data", "torch_golden.json")) as fh:
        golden = {e["name"]: e for e in json.load(fh)["entries"]}[
            BENCH_GOLDEN]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    profiling.reset_phases()

    paper_ks = (11,) if rehearse else BENCH_PAPER_KS
    presets = ([("uni128", 8)] if rehearse else
               [(label, BENCH_K) for label, _ in bench.PRESETS
                if label != "paper"])
    expected = ["poseidon_permute_t17", "poseidon_permute_warp_t17",
                "poseidon_permute_warp_t9", "fr_fold", "fr_mont_mul",
                "fr_batch_inv"]
    for path, runs, extra in (
            ("bench paper", [("paper", k) for k in paper_ks], []),
            ("bench presets", presets, ["poseidon_permute_group_t33",
                                        "poseidon_permute_group_t65",
                                        "poseidon_permute_group_t129"])):
        kernels.reset_launches()
        sync()
        for label, k in runs:
            t0 = time.perf_counter()
            reps = BENCH_REPS if (label, k) == ("paper", BENCH_K) else 1
            res = bench.run_mf_fri(label, k, reps=reps, device=dev)
            proof = res["proof"]
            params = spec_fri.DeepFriParams(schedule=list(res["schedule"]),
                                            r=bench.R_QUERIES,
                                            seed_z=bench.SEED_Z)
            spec_s = None
            if label in BENCH_SPEC_VERIFY:
                t1 = time.perf_counter()
                if not spec_fri.deep_fri_verify(params, proof):
                    raise AssertionError(f"{path} {label} k={k}: the spec "
                                         f"verifier refused the proof")
                spec_s = time.perf_counter() - t1
            want = csv_bytes.get((label, k))
            if want is None and not rehearse:
                raise AssertionError(f"{label} k={k}: not in "
                                     f"benchmarkdata.csv")
            if want is not None and res["proof_bytes"] != want:
                raise AssertionError(f"{path} {label} k={k}: proof_bytes "
                                     f"{res['proof_bytes']}, "
                                     f"benchmarkdata.csv says {want}")
            if label == "paper":
                last_paper = proof
            buf = serialize_proof(proof)
            sha = hashlib.sha256(buf).hexdigest()
            line = {"phase": "bench_path", "path": path, "label": label,
                    "k": k, "schedule": res["schedule"],
                    "proof_bytes": res["proof_bytes"],
                    "csv_proof_bytes": want, "wire_bytes": len(buf),
                    "sha256": sha, "verify": True,
                    "spec_verify": spec_s is not None,
                    "spec_verify_seconds": spec_s,
                    "prove_s": res["prove_s"],
                    "prove_median_s": res["prove_median_s"],
                    "prove_samples": res["prove_samples"],
                    "verify_median_ms": res["verify_median_ms"],
                    "verify_samples": res["verify_samples"],
                    "seconds": time.perf_counter() - t0, "card": card}
            if (label, k) == ("paper", BENCH_K):
                if (sha, len(buf)) != (golden["sha256"],
                                       golden["proof_bytes"]):
                    raise AssertionError(
                        f"bench paper k={k}: sha256 {sha} ({len(buf)} "
                        f"bytes) differs from the JAX spec prover's "
                        f"{golden['sha256']} ({golden['proof_bytes']})")
                line["matches_jax"] = True
            emit(line)
        counts = dict(kernels.launches)
        by_path[path] = counts
        if not rehearse:
            missing = [n for n in expected + extra if counts[n] == 0]
            if missing:
                raise AssertionError(f"{path} launched no {missing}")

    nizk = {}
    for variant, run in (("plain", bench.run_plain_nizk),
                         ("mf", bench.run_mf_nizk)):
        kk = 4 if rehearse else 12
        got = run(kk, device=dev)["proof_bytes"]
        want = nizk_bytes.get((variant, kk))
        if not rehearse and got != want:
            raise AssertionError(f"bench {variant} NIZK k={kk}: {got} "
                                 f"bytes, benchmarkdata_nizk.csv says "
                                 f"{want}")
        nizk[variant] = {"k": kk, "proof_bytes": got, "csv_proof_bytes": want}

    # one paper prove at the last k under torch.profiler, into --log-dir
    # (the rehearsal traces its verify: the plain versions' millions of
    # small operations would make a trace of the prove gigabytes long)
    from stark_mlwe_tpu_torch.fri import (DeviceDeepAliRealBuilder,
                                          deep_fri_prove, deep_fri_verify)
    k = paper_ks[-1]
    cols = bench.packed_witness("paper", k, bench.witness_seed_for("paper", k))
    params = spec_fri.DeepFriParams(schedule=dict(bench.PRESETS)["paper"],
                                    r=bench.R_QUERIES, seed_z=bench.SEED_Z)
    trace_dir = os.path.join(logdir, "trace_bench_paper")
    with profiling.trace(trace_dir, device=dev) as prof:
        t0 = time.perf_counter()
        if rehearse:
            if not deep_fri_verify(params, last_paper, device=dev):
                raise AssertionError("bench paper: verify refused the proof")
        else:
            deep_fri_prove(DeviceDeepAliRealBuilder(), *cols, 1 << k, params,
                           device=dev)
        sync()
        traced = time.perf_counter() - t0
    busy = sum(getattr(ev, "self_device_time_total", 0.0)
               for ev in prof.key_averages()) / 1e6
    peak = (profiling.device_memory_stats(dev)["max_memory_allocated"]
            if dev.type == "cuda" else None)
    emit({"phase": "bench_path", "nizk": nizk,
          "peak_allocated_bytes": peak,
          "trace": os.path.join(trace_dir, "trace.json"),
          "trace_bytes": os.path.getsize(os.path.join(trace_dir,
                                                      "trace.json")),
          "traced_seconds": traced, "device_busy_seconds": busy,
          "device_idle_share": 1.0 - busy / traced,
          "phase_report": profiling.phase_report(),
          "seconds": time.perf_counter() - t_phase, "card": card})


def parallel_path(dev, rehearse: bool, card: str, by_path: dict, witness,
                  params, main_buf: bytes, main_prove_s: float) -> None:
    """The sharded prover (`parallel`, `parallel.prover`) over a one-rank
    group, NCCL on the card (gloo in the rehearsal): (a) `prove_sharded` of
    the main path's witness, byte-equal to its proof, verified, tampered
    copies refused, timed (`PARALLEL_REPS` samples); (b) the bench witness
    at paper k=16 through `sharded_deep_fri_prove`, its sha256 the JAX
    spec prover's; (c) `build_sharded_prove_step` at n = 2^16, m = arity =
    16, on random columns, against the single-device merge, fold and tree
    and `DeviceDomainH.eval_lagrange`; (d) `build_ntt_sharded` at 2^11 x
    2^11 against `ntt` and `ntt_four_step`.  Launch counts and collectives
    set to 0 before each path and read after it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from stark_mlwe_tpu_torch import bench, kernels
    from stark_mlwe_tpu_torch import parallel as par
    from stark_mlwe_tpu_torch.distributed import initialize_distributed
    from stark_mlwe_tpu_torch.fri import (DeviceDeepAliRealBuilder,
                                          deep_fri_prove, fold_layer_dev, fs,
                                          s_layer_dev)
    from stark_mlwe_tpu_torch.fri import deep_ali as dali
    from stark_mlwe_tpu_torch.merkle import build_tree
    from stark_mlwe_tpu_torch.ops import fr
    from stark_mlwe_tpu_torch.ops import ntt as dntt
    from stark_mlwe_tpu_torch.parallel import prover as spv
    from stark_mlwe_tpu_torch.spec import fri as spec_fri
    from stark_mlwe_tpu_torch.spec.field import P, get_root_of_unity
    from stark_mlwe_tpu_torch.spec.merkle import MerkleChannelCfg
    from stark_mlwe_tpu_torch.stark import serialize_proof, verify

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    initialize_distributed(device="cpu" if rehearse else None)
    mesh = par.make_mesh(device=dev)
    backend = dist.get_backend()
    # the communicator comes up at its first collective: not in a timing
    mesh.all_reduce_sum(torch.zeros(1, dtype=torch.int32, device=dev))
    sync()
    collectives = {}

    def counted(path, fn):
        kernels.reset_launches()
        mesh.reset_collectives()
        sync()
        out = fn()
        sync()
        by_path[path] = dict(kernels.launches)
        collectives[path] = dict(mesh.collectives)
        return out

    def require(path, names):
        missing = [n for n in names if by_path[path][n] == 0]
        if missing and not rehearse:
            raise AssertionError(f"{path} launched no {missing}")

    k1 = ["poseidon_permute_t17", "poseidon_permute_warp_t17",
          "poseidon_permute_warp_t9"]

    # (a) the main path's witness and schedule
    k = len(witness.a).bit_length() - 1
    path_a = f"parallel (a) prove_sharded, paper k={k}"
    t0 = time.perf_counter()
    proof = counted(path_a, lambda: spv.prove_sharded(witness, params,
                                                      mesh=mesh))
    samples = [time.perf_counter() - t0]
    phases = dict(spv.phase_seconds)
    for _ in range(PARALLEL_REPS - 1):
        t0 = time.perf_counter()
        spv.prove_sharded(witness, params, mesh=mesh)
        sync()
        samples.append(time.perf_counter() - t0)
    buf = serialize_proof(proof)
    if buf != main_buf:
        raise AssertionError(f"{path_a}: the proof differs from main_path's "
                             f"single-device proof")
    if not verify(params, proof, device=dev):
        raise AssertionError(f"{path_a}: verify refused the proof")
    check_wire_and_tamper(path_a, params, buf, dev)
    require(path_a, k1 + ["fr_fold", "fr_batch_inv"])

    # (b) the bench witness at paper k=16
    kb = 11 if rehearse else BENCH_K
    path_b = f"parallel (b) bench paper k={kb}"
    cols = bench.packed_witness("paper", kb, bench.witness_seed_for("paper",
                                                                     kb))
    bparams = spec_fri.DeepFriParams(schedule=dict(bench.PRESETS)["paper"],
                                     r=bench.R_QUERIES, seed_z=bench.SEED_Z)
    sha = hashlib.sha256(serialize_proof(counted(
        path_b, lambda: spv.sharded_deep_fri_prove(
            mesh, *cols, 1 << kb, bparams)))).hexdigest()
    if rehearse:
        want = hashlib.sha256(serialize_proof(deep_fri_prove(
            DeviceDeepAliRealBuilder(), *cols, 1 << kb, bparams,
            device=dev))).hexdigest()
    else:
        with open(os.path.join(ROOT, "tests", "data",
                               "torch_golden.json")) as fh:
            want = {e["name"]: e for e in json.load(fh)["entries"]}[
                BENCH_GOLDEN]["sha256"]
    if sha != want:
        raise AssertionError(f"{path_b}: sha256 {sha}, expected {want}")
    require(path_b, k1 + ["fr_fold", "fr_batch_inv"])

    # (c) the sharded step on random columns
    rng = np.random.default_rng(SEED + 8)

    def rand_elems(n):
        raw = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        raw[:, 7] &= 0x3FFFFFFF          # < 2^254 < P
        return fr.to_device(raw.astype(np.uint32).view(np.int32), dev)

    log_n, m_s = (8 if rehearse else 16), 16
    n_s = 1 << log_n
    path_c = f"parallel (c) build_sharded_prove_step n=2^{log_n}"
    local = n_s // mesh.size
    mine = slice(mesh.rank * local, (mesh.rank + 1) * local)
    a, s, e, t = (rand_elems(n_s) for _ in range(4))
    omega = get_root_of_unity(n_s)
    z, z_fold = 0x1234567, 0xABCDEF
    zh = (pow(z, n_s, P) - 1) % P
    scale = zh * pow(n_s % P, P - 2, P) % P
    step, ds_locals, _ = par.build_sharded_prove_step(mesh, n_s, m_s, m_s)
    w = dali.omega_powers(omega, n_s, dev)
    zpow = fr.to_device(fr.pack_ints([pow(z_fold, j, P) for j in range(m_s)],
                                     mont=True), dev)
    root, phi_z, f1 = counted(path_c, lambda: step(
        a[mine], s[mine], e[mine], t[mine], w[mine],
        fr.const(z, dev, mont=True), fr.const(scale, dev, mont=True), zpow,
        *ds_locals))
    f0_ref, _, c_star = dali.merge_evals_device(a, s, e, t, omega, z)
    f1_ref = fold_layer_dev(f0_ref, z_fold, m_s)
    root_ref = build_tree(fs.hash_leaf_pairs_dev(
        f0_ref, s_layer_dev(f0_ref, f1_ref, m_s)),
        MerkleChannelCfg.new(m_s, tree_label=0)).root()
    phi_z = fr.unpack_ints(phi_z[None], mont=True)[0]
    lagrange = dali.DeviceDomainH(n_s, device=dev).eval_lagrange(
        dali.phi_kernel(a, s, e, t), z)
    rows = slice(mesh.rank * local // m_s, (mesh.rank + 1) * local // m_s)
    if fr.unpack_ints(root[None], mont=True)[0] != root_ref:
        raise AssertionError(f"{path_c}: root differs from build_tree's")
    if not phi_z == lagrange == c_star * zh % P:
        raise AssertionError(f"{path_c}: phi_z differs from eval_lagrange")
    if not torch.equal(f1, f1_ref[rows]):
        raise AssertionError(f"{path_c}: f1 differs from fold_layer_dev")
    require(path_c, ["poseidon_permute_t17", "fr_fold", "fr_batch_inv"])
    del a, s, e, t, w, f0_ref, f1_ref

    # (d) the sharded four-step NTT
    n1 = n2 = 1 << (4 if rehearse else 11)
    path_d = f"parallel (d) build_ntt_sharded 2^{(n1 * n2).bit_length() - 1}"
    x = rand_elems(n1 * n2)
    fn, tw_local = par.build_ntt_sharded(mesh, n1, n2)
    rows = n1 * n2 // mesh.size
    mine = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    y = counted(path_d, lambda: fn(x[mine], tw_local))
    t0 = time.perf_counter()
    fn(x[mine], tw_local)
    sync()
    ntt_s = time.perf_counter() - t0
    if not torch.equal(y, dntt.ntt(x)[mine]):
        raise AssertionError(f"{path_d}: differs from ntt")
    if not torch.equal(y, dntt.ntt_four_step(x, n1, n2)[mine]):
        raise AssertionError(f"{path_d}: differs from ntt_four_step")
    require(path_d, ["fr_ntt_tiles", "fr_mont_mul"])
    del x, y
    dntt.clear_tables()

    emit({"phase": "parallel_path", "backend": backend,
          "world_size": mesh.size, "rank": mesh.rank, "device": str(dev),
          "k": k, "schedule": params.schedule, "r": params.r,
          "proof_bytes": len(buf), "equals_main_path": True, "verify": True,
          "tamper_refused": True,
          "prove_seconds_median": statistics.median(samples),
          "prove_samples": samples, "main_path_prove_seconds": main_prove_s,
          "phase_seconds": phases,
          "bench": {"k": kb, "sha256": sha, "matches": True},
          "step": {"n": n_s, "m": m_s, "arity": m_s, "exact": True},
          "ntt": {"n1": n1, "n2": n2, "exact": True, "seconds": ntt_s},
          "launches": {p: {n: c for n, c in by_path[p].items() if c}
                       for p in (path_a, path_b, path_c, path_d)},
          "collectives": collectives,
          "seconds": time.perf_counter() - t_phase, "card": card})
    dist.destroy_process_group()


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
    from stark_mlwe_tpu_torch.utils.roofline import (MAC_ACC_MUL,
                                                     MAC_MONT_MUL,
                                                     MAC_REDC320, bound,
                                                     ntt_tile_macs,
                                                     permute_macs)
    from stark_mlwe_tpu_torch.utils.profiling import card_line, host_facts
    from stark_mlwe_tpu_torch.fri import fs
    from stark_mlwe_tpu_torch.ops import fr
    from stark_mlwe_tpu_torch.ops import ntt as dntt
    from stark_mlwe_tpu_torch.ops import poseidon as dpos
    from stark_mlwe_tpu_torch.poly import Poly
    from stark_mlwe_tpu_torch.spec import fri as spec_fri
    from stark_mlwe_tpu_torch.spec.field import P, get_root_of_unity
    from stark_mlwe_tpu_torch.spec import poseidon as spos
    from stark_mlwe_tpu_torch.spec.merkle import MerkleChannelCfg
    from stark_mlwe_tpu_torch.spec.transcript import default_params
    from stark_mlwe_tpu_torch.stark import (DeepFriParams, MlweWitness,
                                            prove, serialize_proof, verify)

    dev = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---- phase 1: device ------------------------------------------------
    card = "cpu rehearsal" if rehearse else card_line()
    native.available()
    logdir = args.log_dir or os.path.join(ROOT, "build")
    os.makedirs(logdir, exist_ok=True)
    if not rehearse:
        kernels.build_all()
        with open(os.path.join(logdir, "ptxas.log"), "w") as f:
            for name, log in kernels.build_log.items():
                f.write(f"==== {name}\n{log}\n")
    print(card, flush=True)
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kind": None if rehearse else torch.cuda.get_device_name(0),
          "host": host_facts(),
          "kernel_build_seconds": kernels.build_seconds,
          "setup_seconds": time.perf_counter() - t_start})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def time_ms(fn, reps: int, inner: int = 1) -> float:
        return statistics.median(time_samples(fn, reps, inner))

    def time_samples(fn, reps: int, inner: int = 1) -> list:
        """`reps` samples of the device time of one call: each sample is
        `inner` back-to-back calls between two CUDA events, after one
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
        return samples

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

    # K3 fr_fold: exact at every arity the prove paths fold by (8, 16, 32,
    # 64, 128) on random values with a ragged last block, on all P-1 and on
    # zeros, and at m = 3 and 1,024; timed at n = 65,536 for m = 16 (the
    # paper schedule's first fold: the row's `ms`) and m = 32, 64, 128 (the
    # wide presets' folds: `ms_by_m`).
    err = 0
    worst = fr.to_device(fr.pack_ints([P - 1] * (128 * 7)), dev)
    for mw in (8, 16, 32, 64, 128, 3, 1024):
        per_block = 128 // min(32, 1 << (mw.bit_length() - 1))
        nw = per_block + 3
        fw, zw = rand_elems(mw * nw), rand_elems(mw)
        err = max(err, check_exact(f"fr_fold (m={mw}, {nw} outputs)",
                                   fr.fold(fw, zw), fr.fold_plain(fw, zw)))
        if mw <= 128:
            err = max(err, check_exact(
                f"fr_fold (m={mw}, all P-1)", fr.fold(worst[:mw * 7],
                                                      worst[:mw]),
                fr.fold_plain(worst[:mw * 7], worst[:mw])))
            zero = torch.zeros_like(fw)
            err = max(err, check_exact(f"fr_fold (m={mw}, zeros)",
                                       fr.fold(zero, zw),
                                       fr.fold_plain(zero, zw)))
    fold_ms, fold_bound = {}, {}
    n_fold = max(full_n, 1024)
    f = rand_elems(n_fold)
    for mw in (16, 32, 64, 128):
        zw = rand_elems(mw)
        err = max(err, check_exact(f"fr_fold (n={n_fold}, m={mw})",
                                   fr.fold(f, zw), fr.fold_plain(f, zw)))
        fold_ms[str(mw)] = time_ms(lambda: fr.fold(f, zw), 7, inner=20)
        nout = n_fold // mw
        fold_bound[str(mw)] = bound(32 * (n_fold + mw + nout),
                                    nout * (mw * MAC_ACC_MUL
                                            + MAC_REDC320))[0]
    m = 16
    zp = rand_elems(m)
    pms = time_ms(lambda: fr.fold_plain(f, zp), 3)
    nout = n_fold // m
    bms, by = bound(32 * (n_fold + m + nout),
                    nout * (m * MAC_ACC_MUL + MAC_REDC320))
    rows.append({"name": "fr_fold", "route": "cuda",
                 "source": "stark_mlwe_tpu_torch/csrc/fr_fold.cu",
                 "replaces": "stark_mlwe_tpu/fri/__init__.py:198",
                 "shape": f"n={n_fold}, m={m}", "max_abs_err": err,
                 "tolerance": 0, "ms": fold_ms["16"], "plain_ms": pms,
                 "bound_ms": bms, "bound_by": by, "library_ms": None,
                 "ms_by_m": fold_ms, "bound_ms_by_m": fold_bound,
                 "registers": ptxas_registers(kernels.build_log.get(
                     "fr_fold", ""))})

    # fr_batch_inv: the f0 quotient phi / (w - z) of every prove path (one
    # call, three launches) and `fr.batch_inv`, held exactly against the
    # plain versions at the prover's n, at edge values, at ragged n, at an n
    # whose layout takes runs of two elements, and with a zero in the input
    # (all outputs 0).  Timed whole (median of 7, samples printed) and the
    # total launch alone on one element: the Fermat chain of the one
    # inversion, the design's serial floor.  The launches apart come from
    # scripts/profile_torch_prove.py, the layouts side by side from
    # scripts/batch_inv_sweep.py.
    phi_q, w_q, z_q = rand_elems(full_n), rand_elems(full_n), rand_elems(1)[0]
    want_q = fr.f0_quotient_plain(phi_q, w_q, z_q)
    err = check_exact("f0_quotient", fr.f0_quotient(phi_q, w_q, z_q), want_q)
    err = max(err, check_exact("batch_inv", fr.batch_inv(w_q),
                               fr.batch_inv_plain(w_q)))
    nz = fr.to_device(fr.pack_ints([x for x in edge_ints if x] * 3), dev)
    for zc in (z_q, fr.const(0, dev), nz[4]):
        err = max(err, check_exact("f0_quotient (edge values)",
                                   fr.f0_quotient(nz.flip(0), nz, zc),
                                   fr.f0_quotient_plain(nz.flip(0), nz, zc)))
    err = max(err, check_exact("batch_inv (edge values)", fr.batch_inv(nz),
                               fr.batch_inv_plain(nz)))
    for k in (1, 2, 3, 1001):
        err = max(err, check_exact(
            f"f0_quotient (n={k})", fr.f0_quotient(phi_q[:k], w_q[:k], z_q),
            fr.f0_quotient_plain(phi_q[:k], w_q[:k], z_q)))
        err = max(err, check_exact(f"batch_inv (n={k})",
                                   fr.batch_inv(w_q[:k]),
                                   fr.batch_inv_plain(w_q[:k])))
    n_runs = (1 if rehearse else 1 << 17) + 3      # runs of two elements
    w_big = rand_elems(n_runs)
    err = max(err, check_exact(
        f"f0_quotient (n={n_runs}, layout {fr.batch_inv_layout(n_runs)})",
        fr.f0_quotient(w_big.flip(0), w_big, z_q),
        fr.f0_quotient_plain(w_big.flip(0), w_big, z_q)))
    del w_big
    w_zero = w_q[:1001].clone()
    w_zero[len(w_zero) * 3 // 4] = 0
    z_in = w_q[len(w_zero) // 2]          # w - z = 0 there
    for got, want in ((fr.batch_inv(w_zero), fr.batch_inv_plain(w_zero)),
                      (fr.f0_quotient(phi_q[:1001], w_q[:1001], z_in),
                       fr.f0_quotient_plain(phi_q[:1001], w_q[:1001],
                                            z_in))):
        err = max(err, check_exact("a zero in the input", got, want))
        if got.any():
            raise AssertionError("fr_batch_inv: a zero in the input did not "
                                 "make every output 0")
    bi_samples = time_samples(lambda: fr.f0_quotient(phi_q, w_q, z_q), 7)
    pms = time_ms(lambda: fr.f0_quotient_plain(phi_q, w_q, z_q), 1)
    bi_layout = fr.batch_inv_layout(full_n)
    bi_scratch = fr.batch_inv_scratch(full_n, bi_layout)
    # Fermat's inverse in fr32_inv: 14 table products, 4 squarings for each
    # of the 63 lower 4-bit digits of P - 2, one product per nonzero digit.
    inv_products = 14 + 4 * 63 + sum(1 for k in range(63)
                                     if (P - 2) >> (4 * k) & 15)
    # bytes of the function: w, phi, out and z once (the scratch the
    # three launches pass between them is this design's cost, reported as
    # `scratch_bytes`, not the function's); products: Montgomery's trick
    # (3 per element), phi (1 per element) and the one inversion
    bms, by = bound(32 * (3 * full_n + 1),
                    MAC_MONT_MUL * (4 * full_n + inv_products))
    floor_ms = None
    if not rehearse:
        # the total launch alone (stages mask 2) on one element: the Fermat
        # chain of the one inversion, after one call of all three launches
        one, out1 = w_q[:1], torch.empty_like(w_q[:1])
        lay1 = fr.batch_inv_layout(1)
        scr1 = torch.empty((fr.batch_inv_scratch(1, lay1), 8),
                           dtype=torch.int32, device=dev)
        blib = kernels.lib("fr_batch_inv")

        def bi_one(stages):
            kernels.check(blib.fr_batch_inv(
                one.data_ptr(), None, None, out1.data_ptr(),
                scr1.data_ptr(), int(scr1.shape[0]), 1, *lay1, stages,
                kernels.stream_ptr()), "fr_batch_inv total")
        bi_one(7)
        floor_ms = time_ms(lambda: bi_one(2), 7)
    rows.append({"name": "fr_batch_inv", "route": "cuda",
                 "source": "stark_mlwe_tpu_torch/csrc/fr_batch_inv.cu",
                 "replaces": "stark_mlwe_tpu/ops/fr.py:479",
                 "also_replaces": "stark_mlwe_tpu/fri/deep_ali.py:67",
                 "shape": f"n={full_n}: f0_quotient(phi, w, z)",
                 "layout": dict(zip(("threads", "per_thread", "b_threads"),
                                    bi_layout)),
                 "max_abs_err": err, "tolerance": 0,
                 "ms": statistics.median(bi_samples),
                 "ms_samples": bi_samples, "plain_ms": pms,
                 "bound_ms": bms, "bound_by": by, "library_ms": None,
                 "scratch_bytes_moved": 32 * bi_scratch * 2,
                 "serial_floor_ms": floor_ms,
                 "serial_floor_shape": "the total launch alone, n=1",
                 "inv_products": inv_products,
                 "registers": ptxas_registers(kernels.build_log.get(
                     "fr_batch_inv", ""))})
    del phi_q, w_q, want_q

    def edge_states(t):
        return fr.to_device(fr.pack_ints(
            [v for x in edge_ints for v in [x] * t]), dev).reshape(-1, t, 8)

    # K1, t = 17 (transcript parameters: the leaf hash of layer 0 is one
    # permutation per leaf, and the tree levels of arity 16) and t = 9 (the
    # arity-8 and arity-2 trees).  Both layouts are called directly, so each
    # is held whatever `permute_layout` picks: random states, edge values,
    # the spec on a few states.  Rows at the batches the prove paths give
    # each layout: the thread layout at the layer-0 leaf hash (65,536 states
    # of t=17), the warp layout at the tree levels (256 and 4,096 states of
    # t=17, 32 and 2,048 of t=9).  No prove path gives t=9 a batch above
    # WARP_MAX_B[9], so no main path launches the t=9 thread layout: it is
    # held and timed at 65,536 states, and its row says so.
    k1_rows = ((17, "thread", full_n), (17, "warp", 256), (17, "warp", 4096),
               (9, "thread", full_n), (9, "warp", 32), (9, "warp", 2048))
    k1_off_path = {(9, "thread")}
    k1_params = {17: default_params(), 9: MerkleChannelCfg.new(8).params}
    k1_errs = {}
    for t, params in k1_params.items():
        dp = dpos.device_params(params)
        st = rand_elems(5 if rehearse else 1001, t)
        edge = edge_states(t)
        want, want_edge = dpos.permute_plain(st, dp), dpos.permute_plain(
            edge, dp)
        few = fr.unpack_ints(st[:3], mont=True)
        spec = [v for i in range(3)
                for v in spos.permute(few[i * t:(i + 1) * t], params)]
        for layout in dpos.K1_LAYOUTS:
            name = dpos.k1_counter(t, layout)
            got = dpos.permute_k1(st, dp, layout)
            sync()
            err = check_exact(name, got, want)
            err = max(err, check_exact(f"{name} (edge values)",
                                       dpos.permute_k1(edge, dp, layout),
                                       want_edge))
            if fr.unpack_ints(got[:3], mont=True) != spec:
                raise AssertionError(f"{name}: disagrees with the spec")
            k1_errs[name] = err
    k1_states = {}
    for t, layout, B in k1_rows:
        if rehearse:
            B = min(B, 7)
        dp = dpos.device_params(k1_params[t])
        name = dpos.k1_counter(t, layout)
        if (t, B) not in k1_states:
            st = rand_elems(B, t)
            k1_states[t, B] = (st, dpos.permute_plain(st, dp),
                               time_ms(lambda: dpos.permute_plain(st, dp), 1))
        st, want, pms = k1_states[t, B]
        err = max(k1_errs[name], check_exact(
            f"{name} (B={B})", dpos.permute_k1(st, dp, layout), want))
        ms = time_ms(lambda: dpos.permute_k1(st, dp, layout), 5)
        bms, by = bound(2 * 32 * t * B,
                        B * permute_macs(t, k1_params[t].rf, k1_params[t].rp))
        rows.append({"name": name, "route": "cuda",
                     "source": "stark_mlwe_tpu_torch/csrc/poseidon_permute.cu",
                     "replaces": "stark_mlwe_tpu/ops/poseidon_pallas.py:486",
                     "layout": layout, "shape": f"B={B}, t={t}",
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "tolerance": 0, "bound_ms": bms, "bound_by": by,
                     "library_ms": None,
                     "registers": {k: v for k, v in ptxas_registers(
                         kernels.build_log.get("poseidon_permute", "")
                     ).items() if k.startswith(
                         "poseidon_permute_warp_kernel" if layout == "warp"
                         else "poseidon_permute_kernel")}})
        if (t, layout) in k1_off_path:
            rows[-1] |= {"main_path": False, "note":
                         f"no prove path gives t={t} a batch above "
                         f"WARP_MAX_B[{t}] = {dpos.WARP_MAX_B[t]}"}
    del k1_states
    # The two layouts side by side over batch sizes: the crossover.
    k1_sweep = {}
    for t, sizes in ((17, (1, 16, 32, 256, 528, 1024, 2048, 4096, 8192,
                           16384, 65536)),
                     (9, (1, 32, 256, 512, 1024, 2048, 4096, 8192, 16384,
                          65536))):
        dp = dpos.device_params(k1_params[t])
        for B in (sizes[:3] if rehearse else sizes):
            st = rand_elems(B, t)
            check_exact(f"K1 t={t} B={B}: the warp layout against the "
                        f"thread layout", dpos.permute_k1(st, dp, "warp"),
                        dpos.permute_k1(st, dp, "thread"))
            k1_sweep[f"t={t}, B={B}"] = {
                layout + "_ms": time_ms(
                    lambda: dpos.permute_k1(st, dp, layout), 5)
                for layout in dpos.K1_LAYOUTS} | {
                "layouts_equal": True,
                "dispatch": dpos.permute_layout(B, t)}

    # K5 poseidon_permute_group, t = 33, 65, 129: the tree levels of arity
    # 32, 64 and 128.  Rows at the batches the k=16 presets give each width
    # (2,048, 64 and 1 parents of arity 32 under uni32x3; 8 and 1 of arity
    # 64 and 512, 4 and 1 of arity 128 under hi128_64_8), each in the layout
    # `group_layout` picks.  Every row and every size of
    # the sweep is held against the plain version on the same states; the
    # edge values and the spec on one state of each width besides.
    def k5_label(layout):
        return "S={},K={},C={}".format(*layout)

    def k5_kernel(t, layout):
        return "poseidon_permute_group_kernel<{},{},{},{}>".format(t, *layout)

    k5_shape = {}
    if not rehearse:
        glib = kernels.lib("poseidon_permute_group")
        for t in dpos.GROUP_WIDTHS:
            for layout in dpos.GROUP_LAYOUTS[t]:
                th, nb = ctypes.c_int(), ctypes.c_int()
                if glib.poseidon_permute_group_shape(
                        t, *layout, ctypes.byref(th), ctypes.byref(nb)):
                    raise AssertionError(f"K5 layout {t, layout} not built")
                k5_shape[t, layout] = {"threads": th.value,
                                       "dynamic_smem_bytes": nb.value}
    k5_regs = ptxas_registers(kernels.build_log.get("poseidon_permute_group",
                                                     ""))
    k5_rows = []
    for t, sizes, replaces in (
            (33, (2048, 64, 1), "stark_mlwe_tpu/ops/poseidon_pallas.py:486"),
            (65, (8, 1), "stark_mlwe_tpu/ops/poseidon_pallas.py:486"),
            (129, (512, 4, 1), "stark_mlwe_tpu/ops/poseidon_wide.py:198")):
        params = spos.params_for_width(t)
        dp = dpos.device_params(params)
        name = f"poseidon_permute_group_t{t}"
        edge = edge_states(t)
        err = check_exact(f"{name} (edge values)", dpos.permute(edge, dp),
                          dpos.permute_plain(edge, dp))
        for B in (sizes[1:] if rehearse else sizes):
            st = rand_elems(B, t)
            out_k = dpos.permute(st, dp)
            sync()
            err = max(err, check_exact(f"{name} (B={B})", out_k,
                                       dpos.permute_plain(st, dp)))
            one = fr.unpack_ints(st[:1], mont=True)
            if fr.unpack_ints(out_k[:1], mont=True) != spos.permute(one,
                                                                   params):
                raise AssertionError(f"{name}: disagrees with the spec")
            ms = time_ms(lambda: dpos.permute(st, dp), 5)
            pms = time_ms(lambda: dpos.permute_plain(st, dp), 1)
            bms, by = bound(2 * 32 * t * B,
                            B * permute_macs(t, params.rf, params.rp))
            layout = dpos.group_layout(B, t)
            rows.append({"name": name, "route": "cuda", "source":
                         "stark_mlwe_tpu_torch/csrc/poseidon_permute_group.cu",
                         "replaces": replaces, "shape": f"B={B}, t={t}",
                         "layout": dict(zip("SKC", layout)) | k5_shape.get(
                             (t, layout), {}),
                         "max_abs_err": err, "ms": ms, "plain_ms": pms,
                         "tolerance": 0, "bound_ms": bms, "bound_by": by,
                         "library_ms": None,
                         "registers": k5_regs.get(k5_kernel(t, layout))})
            k5_rows.append((rows[-1], f"t={t}, B={B}"))
    # Every layout side by side over batch sizes, each held against the plain
    # version: where `PACK_MIN_B` comes from.
    k5_sweep, k5_best = {}, {}
    for t in dpos.GROUP_WIDTHS:
        dp = dpos.device_params(spos.params_for_width(t))
        sizes = (1, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
        for B in (sizes[:1] if rehearse else sizes):
            st = rand_elems(B, t)
            want = dpos.permute_plain(st, dp)
            cell = {}
            for layout in dpos.GROUP_LAYOUTS[t]:
                check_exact(f"K5 t={t} B={B} layout={layout}",
                            dpos.permute_group(st, dp, layout), want)
                cell[k5_label(layout) + "_ms"] = time_ms(
                    lambda: dpos.permute_group(st, dp, layout), 5)
            best = min(cell, key=cell.get)[:-3]
            k5_best.setdefault(f"t={t}", {})[str(B)] = best
            k5_sweep[f"t={t}, B={B}"] = cell | {
                "equal_to_plain": True, "fastest": best,
                "dispatch": k5_label(dpos.group_layout(B, t))}
    k5_layouts = {f"t={t},{k5_label(layout)}": v | {
        "registers": k5_regs.get(k5_kernel(t, layout))}
        for (t, layout), v in k5_shape.items()}
    # Where K5's time goes: the entry point handed changed round counts,
    # (rf, rp) as the parameters have them, (rf, 1) for the rf + 1 dense
    # products and their full rounds, (0, rp) less (0, 1) for the rp - 1
    # exchanging partial rounds; at one state and at a full card in the
    # packing layout.  Those outputs are not permutations and are not read.
    k5_phases = {}
    for t in (() if rehearse else dpos.GROUP_WIDTHS):
        dp = dpos.device_params(spos.params_for_width(t))
        consts = [c.data_ptr() for c in dp.group_consts(dev)]
        for B in (1, {33: 2048, 65: 512, 129: 512}[t]):
            layout = dpos.group_layout(B, t)
            st = rand_elems(B, t)
            res = torch.empty_like(st)
            cell = {}
            for rf, rp in ((dp.rf, dp.rp), (dp.rf, 1), (0, dp.rp), (0, 1)):
                cell[f"rf={rf},rp={rp}_ms"] = time_ms(
                    lambda: kernels.check(glib.poseidon_permute_group(
                        st.data_ptr(), res.data_ptr(), B, t, *layout, rf, rp,
                        *consts, kernels.stream_ptr()), "K5 phase split"), 5)
            part = cell[f"rf=0,rp={dp.rp}_ms"] - cell["rf=0,rp=1_ms"]
            k5_phases["t={}, B={}, S={}, K={}, C={}".format(t, B, *layout)] = (
                cell | {"dense_and_full_rounds_ms": cell[f"rf={dp.rf},rp=1_ms"],
                        "partial_rounds_ms": part,
                        "partial_round_us": part * 1e3 / (dp.rp - 1)})

    dp17 = dpos.device_params(default_params())
    # K4 poseidon_absorb_chain: against its plain version on short chains
    # (the plain version takes about a second per block on the card), a
    # ragged column through `tagged_hash_vecs` against the host engine, and
    # the real length - 4 columns of 65,536 rows, 4,096 rate blocks each -
    # against the host engine, timed per block beside it.
    C, rate = 4, dp17.rate
    nb_short = 2 if rehearse else 8
    cols = rand_elems(C, 5 + nb_short * rate)
    st0 = rand_elems(C, 17)
    err = check_exact("poseidon_absorb_chain",
                      dpos.absorb_chain(st0, cols, 5, nb_short, dp17),
                      dpos.absorb_chain_plain(st0, cols, 5, nb_short, dp17))
    edge = edge_states(17)[:C]
    err = max(err, check_exact(
        "poseidon_absorb_chain (edge values)",
        dpos.absorb_chain(edge, edge.repeat(1, 2, 1), 1, 2, dp17),
        dpos.absorb_chain_plain(edge, edge.repeat(1, 2, 1), 1, 2, dp17)))
    dp9 = dpos.device_params(MerkleChannelCfg.new(8).params)
    cols9, st9 = rand_elems(3, 2 + 2 * dp9.rate), rand_elems(3, 9)
    err = max(err, check_exact(
        "poseidon_absorb_chain (t=9)",
        dpos.absorb_chain(st9, cols9, 2, 2, dp9),
        dpos.absorb_chain_plain(st9, cols9, 2, 2, dp9)))
    tags = [b"ALI/A", b"ALI/S", b"ALI/E", b"ALI/T"]

    def host_cols(x):
        return [fr.to_u64(c) for c in x.cpu()]

    ragged = rand_elems(C, 12 + 3 * rate + 5)    # head, 3 blocks, tail
    if fs.tagged_hash_vecs(tags, ragged) != fs.tagged_hash_cols_native(
            tags, host_cols(ragged)):
        raise AssertionError("tagged_hash_vecs (head + blocks + tail) "
                             "disagrees with the host engine")
    nb_full = full_n // rate
    long_cols = rand_elems(C, full_n)
    long_host = host_cols(long_cols)
    # The host clock on shared cores spreads by tens of percent between
    # runs: the host engine is timed HOST_REPS times and its median kept.
    host_samples = []
    for _ in range(HOST_REPS):
        t0 = time.perf_counter()
        want = fs.tagged_hash_cols_native(tags, long_host)
        host_samples.append(time.perf_counter() - t0)
    host_chain_s = statistics.median(host_samples)
    sync()
    t0 = time.perf_counter()
    got = fs.tagged_hash_vecs(tags, long_cols)
    device_chain_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"tagged_hash_vecs over {full_n} rows disagrees "
                             f"with the host engine")
    ms = time_ms(lambda: dpos.absorb_chain(st0, long_cols, 0, nb_full, dp17),
                 3)
    # The plain version is timed where it was compared (nb_short blocks: at
    # the full length it would run for the better part of an hour), and the
    # kernel is timed again at that shape so the two can be set side by side.
    ms_short = time_ms(
        lambda: dpos.absorb_chain(st0, cols, 5, nb_short, dp17), 5)
    pms_short = time_ms(
        lambda: dpos.absorb_chain_plain(st0, cols, 5, nb_short, dp17), 1)
    bms, by = bound(32 * C * (2 * 17 + nb_full * rate),
                    C * nb_full * permute_macs(17, dp17.rf, dp17.rp))
    rows.append({"name": "poseidon_absorb_chain", "route": "cuda", "source":
                 "stark_mlwe_tpu_torch/csrc/poseidon_absorb_chain.cu",
                 "replaces": CHAIN_REPLACES[0],
                 "also_replaces": CHAIN_REPLACES[1],
                 "shape": f"C={C}, t=17, nb={nb_full}", "max_abs_err": err,
                 "tolerance": 0, "ms": ms,
                 "plain_ms": pms_short,
                 "plain_shape": f"C={C}, t=17, nb={nb_short}",
                 "ms_at_plain_shape": ms_short,
                 "compared_with": f"the plain version at nb={nb_short} "
                                  f"(t=17) and at two blocks (edge values; "
                                  f"t=9); the host engine at nb={nb_full}",
                 "bound_ms": bms, "bound_by": by, "library_ms": None,
                 "ms_per_block": ms / nb_full,
                 "host_engine_ms_per_block": host_chain_s * 1e3 / nb_full,
                 "ms_per_block_over_host_engine":
                     ms / (host_chain_s * 1e3),
                 "sass_instructions": None if rehearse else sass_counts(
                     kernels.library_path("poseidon_absorb_chain")),
                 "registers": ptxas_registers(kernels.build_log.get(
                     "poseidon_absorb_chain", "")),
                 "host_engine_chain_seconds": host_chain_s,
                 "host_engine_chain_seconds_samples": host_samples,
                 "tagged_hash_vecs_seconds": device_chain_s})
    # K6 fr_ntt_tiles: every tile length, forward and inverse, without and
    # with a full epilogue; then the kinds of view the recursion and the
    # batched entry points hand it; then the two launches of n = 2^22.
    # Every length splits its stages into passes of two with one stage
    # first where log2 L is odd, so both splits are held.
    def tiles_case(label, x, wt, ep=None, out=None):
        got = dntt.ntt_tiles(x, wt, ep, out=out)
        sync()
        return check_exact(f"fr_ntt_tiles ({label})", got,
                           dntt.ntt_tiles_plain(x, wt, ep))

    err = 0
    L = 2
    while L <= (64 if rehearse else dntt.TILE_CAP):
        B = 3 if L >= 512 else 37
        for inverse in (False, True):
            wt = dntt.stage_twiddles(L, inverse, dev)
            x = rand_elems(B, L)
            err = max(err, tiles_case(f"L={L}, B={B}, inverse={inverse}",
                                      x, wt))
            err = max(err, tiles_case(f"L={L}, B={B}, inverse={inverse}, "
                                      f"full epilogue", x, wt,
                                      rand_elems(B, L)))
        L *= 2
    for L in (64,) if rehearse else (64, 2048):
        wt = dntt.stage_twiddles(L, False, dev)
        err = max(err, tiles_case(f"L={L}, B=1", rand_elems(1, L), wt,
                                  rand_elems(1, L)))
        err = max(err, tiles_case(f"L={L}, batch 5x8, periodic epilogue",
                                  rand_elems(5, 8, L), wt, rand_elems(8, L)))
        err = max(err, tiles_case(f"L={L}, batch 5x8, one epilogue row",
                                  rand_elems(5, 8, L), wt, rand_elems(1, L)))
        # transforms down the columns of a matrix, written to another layout
        cols = rand_elems(L, 3, 8).permute(1, 2, 0, 3)
        out = torch.zeros((3, L, 8, 8), dtype=torch.int32,
                          device=dev).permute(0, 2, 1, 3)
        err = max(err, tiles_case(f"L={L}, strided in and out", cols, wt,
                                  rand_elems(8, L), out))
        err = max(err, tiles_case(f"L={L}, sliced batch",
                                  rand_elems(9, L)[2:7], wt))
        edge_rows = [[x] * L for x in (P - 1, 0, R % P)] + [
            [edge_ints[(i + r) % len(edge_ints)] for i in range(L)]
            for r in range(4)]
        edge = fr.to_device(fr.pack_ints([v for row in edge_rows
                                          for v in row]), dev
                            ).reshape(len(edge_rows), L, 8)
        err = max(err, tiles_case(f"L={L}, edge values", edge, wt,
                                  edge.flip(0).contiguous()))
    # The launches of the full-size transform: n = m1 * m2, the m2 columns
    # (length m1, element stride m2) with the step twiddles into tmp[j1, i2];
    # then the m1 rows (length m2) into out[j1 + m1*j2].
    n_ntt = 1 << (8 if rehearse else 22)
    ntt_tile = 16 if rehearse else dntt.TILE_MAX
    m1, m2 = dntt._split(n_ntt, ntt_tile)
    x22 = rand_elems(n_ntt)
    wt1 = dntt.stage_twiddles(m1, False, dev)
    wt2 = dntt.stage_twiddles(m2, False, dev)
    ep22 = dntt.step_twiddles(n_ntt, m1, m2, False, False, dev)
    cols = x22.reshape(m1, m2, 8).transpose(0, 1)
    tmp = torch.empty((m1, m2, 8), dtype=torch.int32, device=dev)
    out22 = torch.empty((m2, m1, 8), dtype=torch.int32, device=dev)
    err = max(err, tiles_case("columns of n", cols, wt1, ep22,
                              tmp.transpose(0, 1)))
    err = max(err, tiles_case("rows of n", tmp, wt2, None,
                              out22.transpose(0, 1)))
    ms_samples = time_samples(lambda: dntt.ntt_tiles(
        cols, wt1, ep22, out=tmp.transpose(0, 1)), 7)
    ms = statistics.median(ms_samples)
    rows_samples = time_samples(lambda: dntt.ntt_tiles(
        tmp, wt2, None, out=out22.transpose(0, 1)), 7)
    ms_rows = statistics.median(rows_samples)
    pms = time_ms(lambda: dntt.ntt_tiles_plain(cols, wt1, ep22), 1)
    bms, by = bound(32 * (3 * n_ntt + m1 // 2),
                    m2 * ntt_tile_macs(m1, True))
    bms_rows, by_rows = bound(32 * (2 * n_ntt + m2 // 2),
                              m1 * ntt_tile_macs(m2, False))
    rows.append({"name": "fr_ntt_tiles", "route": "cuda",
                 "source": "stark_mlwe_tpu_torch/csrc/fr_ntt.cu",
                 "replaces": "stark_mlwe_tpu/ops/ntt_pallas.py:197",
                 "shape": f"L={m1}, B={m2}: the columns of n={n_ntt} as a "
                          f"{m1}x{m2} matrix, with the step twiddles",
                 "max_abs_err": err, "tolerance": 0, "ms": ms,
                 "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                 "library_ms": None, "ms_samples": ms_samples,
                 "registers": ptxas_registers(kernels.build_log.get(
                     "fr_ntt", "")),
                 "rows_launch": {"shape": f"L={m2}, B={m1}: its rows, no "
                                          f"epilogue, strided store",
                                 "ms": ms_rows, "ms_samples": rows_samples,
                                 "bound_ms": bms_rows,
                                 "bound_by": by_rows}})
    del x22, cols, tmp, out22, ep22
    emit({"phase": "kernels", "card": card, "exact": True,
          "k1_sweep": k1_sweep,
          "k5_sweep": k5_sweep, "k5_fastest_by_B": k5_best,
          "k5_layouts": k5_layouts, "k5_phase_split": k5_phases,
          "chain": {k: rows[-2][k] for k in (
              "shape", "ms", "ms_per_block", "host_engine_ms_per_block",
              "ms_per_block_over_host_engine", "sass_instructions",
              "registers", "host_engine_chain_seconds",
              "host_engine_chain_seconds_samples",
              "tagged_hash_vecs_seconds")},
          "kernels": [{k: r[k] for k in ("name", "shape", "ms", "plain_ms",
                                         "max_abs_err")} for r in rows],
          "seconds": time.perf_counter() - t_start})

    # ---- phase 3: golden --------------------------------------------------
    with open(os.path.join(ROOT, "tests", "data", "torch_golden.json")) as fh:
        golden = {e["name"]: e for e in json.load(fh)["entries"]}
    def prove_device_witness(w, wparams):
        """The device branch: the columns are tensors on the card (in the
        rehearsal, CPU tensors sent down the same branch)."""
        ali = fri.DeviceDeepAliRealBuilder(device_columns=rehearse)
        return fri.deep_fri_prove(ali, *w.to_device(dev), len(w.a), wparams,
                                  device=dev)

    names = ["small_k6"] if rehearse else GOLDEN_ENTRIES
    for name in names:
        ent = golden[name]
        gparams = DeepFriParams(schedule=list(ent["schedule"]), r=ent["r"],
                                seed_z=ent["seed_z"])
        make = (MlweWitness.random_unstructured if ent.get("unstructured")
                else MlweWitness.random)
        t0 = time.perf_counter()
        gw = make(k=ent["k"], seed=ent["seed"])
        on_device = ent.get("witness") == "device" or rehearse
        if on_device:
            gproof = prove_device_witness(gw, gparams)
            if serialize_proof(gproof) != serialize_proof(
                    prove(gw, gparams, device=dev)):
                raise AssertionError(f"golden {name}: the device branch and "
                                     f"the host branch give different proofs")
        else:
            gproof = prove(gw, gparams, device=dev)
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
              "schedule": ent["schedule"], "device_witness": on_device,
              "proof_bytes": len(gbuf), "sha256": gsha, "matches_jax": True,
              "verify": True, "spec_verify": True,
              "spec_verify_seconds": spec_s,
              "seconds": time.perf_counter() - t0})

    # ---- phase 4: main paths ---------------------------------------------
    k = 7 if rehearse else 16
    paper = (DeepFriParams(schedule=[8, 4], r=6, seed_z=0xDEEFBAAD)
             if rehearse else
             DeepFriParams(schedule=[16, 16, 8], r=32, seed_z=0xDEEFBAAD))
    t0 = time.perf_counter()
    witness = MlweWitness.random(k=k, seed=SEED)
    witness_s = time.perf_counter() - t0
    random_cols = MlweWitness.random_unstructured(k=k, seed=SEED)
    # K2 and the quotient on every prove path; `fr_sub` only where phi is
    # formed on the card (the device witness): the quotient's w - z is part
    # of `fr_batch_inv`.
    F0 = ["fr_mont_mul", "fr_add", "fr_batch_inv"]
    by_path = {}
    prove_seconds = {}

    def drive(path, params, run, expected, absent_phase=None, counts_are=()):
        """One path: counts to 0, prove + verify, counts read; then the
        proof's shape, the wire format and two tampered copies.
        `counts_are`: (counter, launches) pairs the path must show."""
        kernels.reset_launches()
        sync()
        t0 = time.perf_counter()
        proof = run()
        sync()
        prove_s = time.perf_counter() - t0
        phases = dict(fri.phase_seconds)
        prove_seconds[path] = prove_s
        t0 = time.perf_counter()
        accepted = verify(params, proof, device=dev)
        verify_s = time.perf_counter() - t0
        counts = dict(kernels.launches)
        by_path[path] = counts

        if not accepted:
            raise AssertionError(f"{path}: verify refused the proof")
        buf = serialize_proof(proof)
        check_wire_and_tamper(path, params, buf, dev)
        L = len(params.schedule)
        if len(proof.roots) != L + 1 or len(proof.queries) != params.r \
                or proof.n0 != 1 << k:
            raise AssertionError(f"{path}: proof of unexpected shape")
        if absent_phase is not None and absent_phase in phases:
            raise AssertionError(f"{path}: phase {absent_phase} ran")
        if not rehearse:
            missing = [n for n in expected if counts[n] == 0]
            if missing:
                raise AssertionError(f"{path} launched no {missing}")
            wrong = {n: counts[n] for n, c in counts_are if counts[n] != c}
            if wrong:
                raise AssertionError(f"{path}: launches {wrong}, expected "
                                     f"{dict(counts_are)}")
        emit({"phase": "main_path", "path": path, "k": k,
              "schedule": params.schedule, "r": params.r, "verify": True,
              "tamper_refused": True, "proof_bytes": len(buf),
              "spec_proof_bytes": spec_fri.deep_fri_proof_size_bytes(proof),
              "prove_seconds": prove_s, "verify_seconds": verify_s,
              "phase_seconds": phases,
              "launches": {n: c for n, c in counts.items() if c},
              "card": card})
        return buf

    # K1 by layout (`permute_layout`): the layer-0 leaf hash (65,536 states
    # of t=17) takes the thread layout, every tree level the warp layout.
    paper_kernels = ["poseidon_permute_t17", "poseidon_permute_warp_t17",
                     "poseidon_permute_warp_t9", "fr_fold"] + F0
    one_quotient = (("fr_batch_inv", 3),)
    buf_host = drive("paper, host witness", paper,
                     lambda: prove(witness, paper, device=dev),
                     paper_kernels, counts_are=one_quotient + (("fr_sub", 0),))
    buf_dev = drive("paper, device witness", paper,
                    lambda: prove_device_witness(witness, paper),
                    paper_kernels + ["poseidon_absorb_chain", "fr_sub"],
                    absent_phase="ali/host_absorb", counts_are=one_quotient)
    if buf_dev != buf_host:
        raise AssertionError("main path: the device-witness proof differs "
                             "from the host-witness proof")
    wide = ([("wide64", [64], ["poseidon_permute_group_t65"]),
             ("wide32", [32], ["poseidon_permute_group_t33"])]
            if rehearse else
            [(WIDE_PRESETS[0][0], WIDE_PRESETS[0][1],
              ["poseidon_permute_group_t129", "poseidon_permute_group_t65",
               "poseidon_permute_warp_t9"]),
             (WIDE_PRESETS[1][0], WIDE_PRESETS[1][1],
              ["poseidon_permute_group_t33", "poseidon_permute_warp_t9"])])
    # The batch of every K5 launch of the wide paths, counted by width and
    # size (the shapes behind the K5 rows).
    k5_batches, k5_batches_by_path = {}, {}
    permute_group = dpos.permute_group

    def counted_permute_group(state, dp, layout=None):
        key = f"t={dp.t}, B={int(state.shape[0])}"
        k5_batches[key] = k5_batches.get(key, 0) + 1
        return permute_group(state, dp, layout)

    dpos.permute_group = counted_permute_group
    for preset, schedule, group_kernels in wide:
        wparams = DeepFriParams(schedule=schedule, r=paper.r,
                                seed_z=0xDEEFBAAD)
        k5_batches.clear()
        drive(f"{preset}, host witness", wparams,
              lambda: prove(random_cols, wparams, device=dev),
              group_kernels + ["poseidon_permute_t17", "fr_fold"] + F0,
              counts_are=one_quotient + (("fr_sub", 0),))
        k5_batches_by_path[f"{preset}, host witness"] = dict(k5_batches)
        emit({"phase": "main_path", "path": f"{preset}, host witness",
              "k5_launches_by_batch": dict(k5_batches)})
    dpos.permute_group = permute_group
    emit({"phase": "main_path", "witness_seconds": witness_s,
          "device_witness_equals_host_witness": True})

    # ---- phase 5: the NTT path ---------------------------------------------
    def clock(fn):
        """Host-clock seconds of one call that ends in a synchronise, after
        one warm-up call; also the result and the K6 launches of the call."""
        fn()
        sync()
        before = kernels.launches["fr_ntt_tiles"]
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0, out,
                kernels.launches["fr_ntt_tiles"] - before)

    def same_tensor(what, a, b):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"ntt_path: {what} differ")

    kernels.reset_launches()
    dntt.clear_tables()
    sync()
    t_phase = time.perf_counter()
    for inverse in (False, True):
        dntt.step_twiddles(n_ntt, m1, m2, inverse, inverse, dev)
        dntt.stage_twiddles(m1, inverse, dev)
        dntt.stage_twiddles(m2, inverse, dev)
    sync()
    table_s = time.perf_counter() - t_phase
    x = rand_elems(n_ntt)
    ntt_s, y, ntt_launches = clock(lambda: dntt.ntt(x, tile_max=ntt_tile))
    same_tensor(f"ntt and ntt_plain at n={n_ntt}", y, dntt.ntt_plain(x))
    intt_s, back, _ = clock(lambda: dntt.intt(y, tile_max=ntt_tile))
    same_tensor(f"intt(ntt(x)) and x at n={n_ntt}", back, x)
    del back, y
    # other tile lengths on the same input, a single sample each
    tile_seconds = {}
    if not rehearse:
        for tile in (512, 1024, 2048):
            tile_seconds[str(tile)], _, _ = clock(
                lambda: dntt.ntt(x, tile_max=tile))
    del x
    dntt.clear_tables()

    n_lde = n_ntt // 4
    vals = rand_elems(n_lde)
    lde_s, big, _ = clock(lambda: dntt.lde(vals, 4))
    same_tensor("lde(values, 4)[::4] and values", big[::4], vals)
    del big, vals

    n_small = 1 << (6 if rehearse else 12)
    vs = rand_elems(n_small)
    shifted = fr.mont_mul(dntt.ntt_plain(vs, True), fr.powers(
        fr.const(5, dev, mont=True), n_small))
    same_tensor("lde with coset shift 5 and the plain transforms",
                dntt.lde(vs, 2, coset_shift=5),
                dntt.ntt_plain(torch.cat([shifted, torch.zeros_like(shifted)]
                                         )))
    side = 16 if rehearse else 256
    xf = rand_elems(side * side)
    flat = dntt.ntt(xf)
    same_tensor(f"ntt_four_step({side}, {side}) and ntt",
                dntt.ntt_four_step(xf, side, side), flat)
    same_tensor(f"ntt and ntt_plain at n={side * side}", flat,
                dntt.ntt_plain(xf))

    def digest(t):
        return hashlib.sha256(
            fr.from_mont(t).contiguous().cpu().numpy().tobytes()).hexdigest()

    ntt_golden = {e["name"]: e for e in json.load(open(os.path.join(
        ROOT, "tests", "data", "torch_golden.json")))["ntt_entries"]}
    for name in ["lde_2e12_b2_coset5"] if rehearse else NTT_GOLDEN:
        ent = ntt_golden[name]
        xg = fr.to_device(fr.seeded_limbs(ent["seed"], ent["n"]), dev)
        if ent["op"] == "ntt":
            yg = dntt.ntt(xg)
        elif ent["op"] == "intt":
            yg = dntt.intt(xg)
        elif ent["op"] == "lde":
            yg = dntt.lde(xg, ent["blowup"], ent.get("coset_shift"))
        else:
            yg = dntt.ntt_four_step(xg, ent["n1"], ent["n2"])
        if digest(yg) != ent["sha256"]:
            raise AssertionError(f"ntt_path: golden {name}: the port's "
                                 f"digest differs from the JAX package's")

    n_naive = 256
    cs = [int(v) for v in rng.integers(0, 1 << 62, size=n_naive)]
    cs[:len(edge_ints)] = edge_ints
    w = get_root_of_unity(n_naive)
    want = [sum(c * pow(w, i * j, P) for i, c in enumerate(cs)) % P
            for j in range(n_naive)]
    got = fr.unpack_ints(dntt.ntt(fr.to_device(
        fr.pack_ints(cs, mont=True), dev)), mont=True)
    if got != want:
        raise AssertionError("ntt_path: ntt at n=256 differs from the "
                             "O(n^2) sum in Python ints")

    na, nb = (70, 90) if rehearse else (2000, 1500)
    pa = [int(v) << 190 | int(u) for v, u in zip(
        rng.integers(0, 1 << 62, size=na), rng.integers(0, 1 << 62, size=na))]
    pb = [int(v) << 190 | int(u) for v, u in zip(
        rng.integers(0, 1 << 62, size=nb), rng.integers(0, 1 << 62, size=nb))]
    t0 = time.perf_counter()
    prod = Poly(pa).mul(Poly(pb), device=dev)
    poly_s = time.perf_counter() - t0
    school = [0] * (na + nb - 1)
    for i, a in enumerate(pa):
        for j, b in enumerate(pb):
            school[i + j] += a * b
    if prod.coeffs != Poly(school).coeffs:
        raise AssertionError("ntt_path: Poly.mul differs from the "
                             "schoolbook product")

    counts = dict(kernels.launches)
    by_path[NTT_PATH] = counts
    if not rehearse:
        missing = [n for n in ["fr_ntt_tiles", "fr_mont_mul"]
                   if counts[n] == 0]
        if missing:
            raise AssertionError(f"{NTT_PATH} launched no {missing}")
    emit({"phase": "ntt_path", "path": NTT_PATH, "n": n_ntt,
          "tile_max": ntt_tile, "split": [m1, m2],
          "ntt_2e22_seconds": ntt_s, "ntt_2e22_elems_per_s": n_ntt / ntt_s,
          "intt_2e22_seconds": intt_s, "lde_2e20_blowup4_seconds": lde_s,
          "table_build_seconds": table_s,
          "k6_launches_per_transform": ntt_launches,
          "ntt_2e22_seconds_by_tile_max": tile_seconds,
          "poly_mul_seconds": poly_s, "poly_coefficients": [na, nb],
          "equals_plain": True, "roundtrip": True, "lde_stride_4": True,
          "coset_and_four_step": True, "golden_matches_jax": True,
          "naive_n256": True, "poly_mul": True,
          "launches": {n: c for n, c in counts.items() if c},
          "seconds": time.perf_counter() - t_phase, "card": card})

    # ---- phase 6: the sum-check NIZK path ------------------------------------
    nizk_path(dev, rehearse, card, by_path)

    # ---- phase 7: the bench harness ------------------------------------------
    bench_path(dev, rehearse, card, by_path, logdir)

    # ---- phase 8: the sharded prover -------------------------------------------
    parallel_path(dev, rehearse, card, by_path, witness, paper, buf_host,
                  prove_seconds["paper, host witness"])

    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if not rehearse and r["launches"] == 0 and r.get("main_path", True):
            raise AssertionError(f"no main path launched {r['name']}")
    # A K5 row's own shape: the launches at its batch, which a main path
    # must have made.
    for r, key in k5_rows:
        r["launches_at_shape"] = sum(c.get(key, 0)
                                     for c in k5_batches_by_path.values())
        if not rehearse and r["launches_at_shape"] == 0:
            raise AssertionError(f"no main path launched {r['name']} at "
                                 f"{r['shape']}")
    if not rehearse:
        # the whole output, which can outgrow what a job runner shows
        with open(os.path.join(logdir, "chip_smoke.jsonl"), "w") as f:
            f.write("\n".join(LINES + [json.dumps({"kernels": rows})]) + "\n")
    if rehearse:
        emit({"kernels": rows})
        print("rehearsal on the CPU finished: no kernel was built or run",
              file=sys.stderr)
        return 0

    print(card_line(), flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
