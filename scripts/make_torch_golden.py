"""Write tests/data/torch_golden.json: reference proofs of the JAX package.

For each entry the JAX package proves `MlweWitness.random(k, seed)` (or
`random_unstructured`) under the given schedule on the CPU and the sha256 and length of
`serialize_proof` are recorded.  The PyTorch port must reproduce them
byte for byte: CPU tests check the small entries, `chip_smoke.py` checks
all but the smallest on the GPU.

An entry with `"witness": "device"` hands the four columns over as JAX
device arrays, so the column digests come through `fs.tagged_hash_vecs`
(the device branch of `build_f0`) instead of the host engine.

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
]

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


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from stark_mlwe_tpu.fri import DeviceDeepAliRealBuilder, deep_fri_prove
    from stark_mlwe_tpu.stark import (DeepFriParams, MlweWitness, prove,
                                      serialize_proof, verify)

    path = os.path.join(ROOT, "tests", "data", "torch_golden.json")
    with open(path) as f:
        old = json.load(f)
    have = {e["name"]: e for e in old["entries"]}
    have_ntt = {e["name"]: e for e in old.get("ntt_entries", [])}
    out = {"source": "stark_mlwe_tpu.stark.prove on the CPU backend",
           "entries": [],
           "ntt_source": "stark_mlwe_tpu.ops.ntt on the CPU backend",
           "ntt_entries": []}
    for ent in ENTRIES:
        if ent["name"] in have:
            out["entries"].append(have[ent["name"]])
            continue
        t0 = time.perf_counter()
        make = (MlweWitness.random_unstructured if ent.get("unstructured")
                else MlweWitness.random)
        w = make(k=ent["k"], seed=ent["seed"])
        params = DeepFriParams(schedule=list(ent["schedule"]), r=ent["r"],
                               seed_z=ent["seed_z"])
        if ent.get("witness") == "device":
            proof = deep_fri_prove(DeviceDeepAliRealBuilder(), *w.to_device(),
                                   1 << ent["k"], params)
        else:
            proof = prove(w, params)
        assert verify(params, proof)
        buf = serialize_proof(proof)
        rec = dict(ent)
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
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
