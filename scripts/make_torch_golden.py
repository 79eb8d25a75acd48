"""Write tests/data/torch_golden.json: reference proofs of the JAX package.

For each entry the JAX package proves `MlweWitness.random(k, seed)` (or
`random_unstructured`) under the given schedule on the CPU and the sha256 and length of
`serialize_proof` are recorded.  The PyTorch port must reproduce them
byte for byte: CPU tests check the small entries, `chip_smoke.py` checks
all but the smallest on the GPU.

An entry with `"witness": "device"` hands the four columns over as JAX
device arrays, so the column digests come through `fs.tagged_hash_vecs`
(the device branch of `build_f0`) instead of the host engine.

An entry with `"witness": "bench"` proves the bench harness's witness,
`bench.gen_witness(k, bench.witness_seed_for(label, k))` (four random
columns), at the preset's schedule, r = 32 and seed_z = 0xDEEF_BAAD, with
the JAX package's pure-int spec prover (`spec.fri.deep_fri_prove` with
`DeepAliRealBuilder`, `"prover": "spec"`), to which its device prover is
held by its own tests; `spec_proof_bytes` is
`deep_fri_proof_size_bytes`, the `proof_bytes` of `benchmarkdata.csv`.
That prover took 57.4 s at paper k = 12 (53,944 bytes, the CSV's) on one
core of an 8-core x86 host; `bench_paper_k16` took 911 s there.

`nizk_entries` are digests of the JAX package's sum-check NIZK proofs at
the settings of `benchmarkdata_nizk.csv` (`bench.run_plain_nizk` /
`run_mf_nizk`: witness `StdRng.seed_from_u64(seed)` drawn with
`ark_fr_rand`, the VK's ds_tag and queries per round): the sha256 and
length of the port's canonical encoding
`stark_mlwe_tpu_torch.serde.serialize_nizk_proof`, beside
`proof.size_bytes()`.  Up to k = 12 the proof comes from the JAX package's
device prover (`channel.prove_plain` / `prove_mf`, `"prover": "device"`);
its one-program compile on the CPU takes minutes and about 18 GB there
(k = 12), and grows with k, so from k = 14 on it comes from the JAX
package's pure-int spec prover (`spec.channel`, `"prover": "spec"`), to
which the device prover is held byte for byte by the JAX package's tests
(and its gather branch by tests/test_torch_nizk.py).  The JAX package's
pure-int verifier (and, for device proofs, its device verifier) must
accept each proof.

`ntt_entries` are digests of the JAX package's NTT entry points
(`ops.ntt.ntt`, `intt`, `lde`, `ntt_four_step`) on the inputs
`fr.seeded_limbs(seed, n)` of the port, read as Montgomery form: the sha256
of the outputs' canonical little-endian 32-byte encodings in order.

Entries already in the file are kept as they are; only missing ones are
computed.  Run from the repository root (takes minutes: XLA compiles on
the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ENTRIES = [
    {"name": "small_k6", "k": 6, "seed": 2024, "schedule": [8, 4], "r": 6,
     "seed_z": 0xDEEFBAAD},
    {"name": "paper_k12", "k": 12, "seed": 1234, "schedule": [16, 16, 8],
     "r": 32, "seed_z": 0xDEEFBAAD},
    # A satisfying witness has phi = a*s + e - t = 0 everywhere, so f0 and
    # every fold of it are zero; four independent random columns make the
    # folded values and the opened payloads non-trivial.
    {"name": "paper_k11_unstructured", "k": 11, "seed": 1234,
     "schedule": [16, 16, 8], "r": 32, "seed_z": 0xDEEFBAAD,
     "unstructured": True},
    # Wide arities: trees of arity 128, 64 and 32 hash at Poseidon widths
    # 129, 65 and 33 (the last layers at width 9).
    {"name": "wide32_k6", "k": 6, "seed": 1234, "schedule": [32],
     "r": 4, "seed_z": 0xDEEFBAAD, "unstructured": True},
    {"name": "wide64_k7", "k": 7, "seed": 1234, "schedule": [64],
     "r": 4, "seed_z": 0xDEEFBAAD, "unstructured": True},
    {"name": "wide128_k8", "k": 8, "seed": 1234, "schedule": [128],
     "r": 8, "seed_z": 0xDEEFBAAD, "unstructured": True},
    {"name": "wide64_8_k10", "k": 10, "seed": 1234, "schedule": [64, 8],
     "r": 8, "seed_z": 0xDEEFBAAD, "unstructured": True},
    {"name": "wide32_32_k11", "k": 11, "seed": 1234, "schedule": [32, 32],
     "r": 8, "seed_z": 0xDEEFBAAD, "unstructured": True},
    # The device-resident witness: same prover, columns as device arrays.
    {"name": "paper_k11_device_witness", "k": 11, "seed": 4321,
     "schedule": [16, 16, 8], "r": 32, "seed_z": 0xDEEFBAAD,
     "unstructured": True, "witness": "device"},
    # The bench's paper row at k = 16 (benchmarkdata.csv: 101,600 bytes).
    {"name": "bench_paper_k16", "k": 16, "label": "paper",
     "schedule": [16, 16, 8], "r": 32, "seed_z": 0xDEEFBAAD,
     "witness": "bench", "prover": "spec"},
]

NIZK_ENTRIES = [
    {"name": f"{variant}_k{k}", "variant": variant, "k": k,
     "seed": 42 if variant == "plain" else 43,
     "ds_tag": 0xA11CE if variant == "plain" else 0xB0B,
     "queries_per_round": 0 if variant == "plain" else 3}
    for k in (5, 12, 14, 16) for variant in ("plain", "mf")
]
NIZK_DEVICE_MAX_K = 12

NTT_ENTRIES = [
    {"name": "ntt_2e16", "op": "ntt", "n": 1 << 16, "seed": 2201},
    {"name": "intt_2e16", "op": "intt", "n": 1 << 16, "seed": 2202},
    {"name": "lde_2e14_b4", "op": "lde", "n": 1 << 14, "seed": 2203,
     "blowup": 4},
    {"name": "lde_2e12_b2_coset5", "op": "lde", "n": 1 << 12, "seed": 2204,
     "blowup": 2, "coset_shift": 5},
    {"name": "four_step_256x256", "op": "four_step", "n": 1 << 16,
     "seed": 2205, "n1": 256, "n2": 256},
]


def ntt_digest(ent) -> str:
    """One NTT entry through the JAX package on the CPU."""
    import jax.numpy as jnp
    import numpy as np
    from stark_mlwe_tpu.ops import fr as jfr
    from stark_mlwe_tpu.ops import ntt as jntt
    from stark_mlwe_tpu_torch import convert
    from stark_mlwe_tpu_torch.ops import fr as tfr

    x = jnp.asarray(convert.to_jax_limbs(
        tfr.seeded_limbs(ent["seed"], ent["n"])))
    if ent["op"] == "ntt":
        y = jntt.ntt(x)
    elif ent["op"] == "intt":
        y = jntt.intt(x)
    elif ent["op"] == "lde":
        y = jntt.lde(x, ent["blowup"], ent.get("coset_shift"))
    else:
        y = jntt.ntt_four_step(x, ent["n1"], ent["n2"])
    canon = np.asarray(jfr.from_mont(y)).astype("<u2")
    return hashlib.sha256(canon.tobytes()).hexdigest()


def nizk_record(ent) -> dict:
    """One NIZK entry through the JAX package on the CPU."""
    from stark_mlwe_tpu import channel as jch
    from stark_mlwe_tpu.spec import channel as jsch
    from stark_mlwe_tpu.spec.rng import StdRng
    from stark_mlwe_tpu_torch.serde import serialize_nizk_proof

    witness = StdRng.seed_from_u64(ent["seed"]).ark_fr_rand_batch(
        1 << ent["k"])
    on_device = ent["k"] <= NIZK_DEVICE_MAX_K
    if ent["variant"] == "plain":
        vk = jsch.build_vk_plain(ent["k"], ds_tag=ent["ds_tag"])
        proof = (jch if on_device else jsch).prove_plain(vk, witness)
        assert jsch.verify_plain(vk, proof)
        assert not on_device or jch.verify_plain(vk, proof)
    else:
        vk = jsch.build_vk_mf(ent["k"], ds_tag=ent["ds_tag"],
                              queries_per_round=ent["queries_per_round"])
        proof = (jch if on_device else jsch).prove_mf(vk, witness)
        assert jsch.verify_mf(vk, proof)
        assert not on_device or jch.verify_mf(vk, proof)
    buf = serialize_nizk_proof(proof)
    rec = dict(ent, prover="device" if on_device else "spec")
    rec["size_bytes"] = proof.size_bytes()
    rec["encoded_bytes"] = len(buf)
    rec["sha256"] = hashlib.sha256(buf).hexdigest()
    return rec


def bench_proof(ent):
    """The bench witness of `ent` through the JAX package's spec prover;
    returns (proof, seed)."""
    from stark_mlwe_tpu.bench import gen_witness, witness_seed_for
    from stark_mlwe_tpu.spec import fri as jsfri

    seed = witness_seed_for(ent["label"], ent["k"])
    params = jsfri.DeepFriParams(schedule=list(ent["schedule"]), r=ent["r"],
                                 seed_z=ent["seed_z"])
    proof = jsfri.deep_fri_prove(jsfri.DeepAliRealBuilder(),
                                 *gen_witness(ent["k"], seed),
                                 1 << ent["k"], params)
    assert jsfri.deep_fri_verify(params, proof)
    return proof, seed


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from stark_mlwe_tpu.fri import DeviceDeepAliRealBuilder, deep_fri_prove
    from stark_mlwe_tpu.spec.fri import deep_fri_proof_size_bytes
    from stark_mlwe_tpu.stark import (DeepFriParams, MlweWitness, prove,
                                      serialize_proof, verify)

    path = os.path.join(ROOT, "tests", "data", "torch_golden.json")
    with open(path) as f:
        old = json.load(f)
    have = {e["name"]: e for e in old["entries"]}
    have_ntt = {e["name"]: e for e in old.get("ntt_entries", [])}
    have_nizk = {e["name"]: e for e in old.get("nizk_entries", [])}
    out = {"source": "stark_mlwe_tpu.stark.prove on the CPU backend "
                     "(prover: spec: stark_mlwe_tpu.spec.fri.deep_fri_prove)",
           "entries": [],
           "ntt_source": "stark_mlwe_tpu.ops.ntt on the CPU backend",
           "ntt_entries": [],
           "nizk_source": "stark_mlwe_tpu.channel.prove_plain / prove_mf "
                          "on the CPU backend (prover: device) or "
                          "stark_mlwe_tpu.spec.channel (prover: spec), "
                          "encoded by stark_mlwe_tpu_torch.serde."
                          "serialize_nizk_proof",
           "nizk_entries": []}
    for ent in ENTRIES:
        if ent["name"] in have:
            out["entries"].append(have[ent["name"]])
            continue
        t0 = time.perf_counter()
        rec = dict(ent)
        params = DeepFriParams(schedule=list(ent["schedule"]), r=ent["r"],
                               seed_z=ent["seed_z"])
        if ent.get("witness") == "bench":
            proof, rec["seed"] = bench_proof(ent)
            rec["spec_proof_bytes"] = deep_fri_proof_size_bytes(proof)
        else:
            make = (MlweWitness.random_unstructured
                    if ent.get("unstructured") else MlweWitness.random)
            w = make(k=ent["k"], seed=ent["seed"])
            if ent.get("witness") == "device":
                proof = deep_fri_prove(DeviceDeepAliRealBuilder(),
                                       *w.to_device(), 1 << ent["k"], params)
            else:
                proof = prove(w, params)
            assert verify(params, proof)
        buf = serialize_proof(proof)
        rec["proof_bytes"] = len(buf)
        rec["sha256"] = hashlib.sha256(buf).hexdigest()
        out["entries"].append(rec)
        print(rec["name"], rec["proof_bytes"], rec["sha256"],
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    for ent in NTT_ENTRIES:
        if ent["name"] in have_ntt:
            out["ntt_entries"].append(have_ntt[ent["name"]])
            continue
        t0 = time.perf_counter()
        rec = dict(ent)
        rec["sha256"] = ntt_digest(ent)
        out["ntt_entries"].append(rec)
        print(rec["name"], rec["sha256"],
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    for ent in NIZK_ENTRIES:
        if ent["name"] in have_nizk:
            out["nizk_entries"].append(have_nizk[ent["name"]])
            continue
        t0 = time.perf_counter()
        rec = nizk_record(ent)
        out["nizk_entries"].append(rec)
        print(rec["name"], rec["size_bytes"], rec["sha256"],
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
