"""Write tests/data/torch_golden.json: reference proofs of the JAX package.

For each entry the JAX package proves `MlweWitness.random(k, seed)` (or
`random_unstructured`) under the given schedule on the CPU and the sha256 and length of
`serialize_proof` are recorded.  The PyTorch port must reproduce them
byte for byte: a CPU test checks the small entry, `chip_smoke.py` checks
the paper-schedule entry on the GPU.

Run from the repository root (takes minutes: XLA compiles on the CPU):

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
]


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from stark_mlwe_tpu.stark import (DeepFriParams, MlweWitness, prove,
                                      serialize_proof, verify)

    out = {"source": "stark_mlwe_tpu.stark.prove on the CPU backend",
           "entries": []}
    for ent in ENTRIES:
        t0 = time.perf_counter()
        make = (MlweWitness.random_unstructured if ent.get("unstructured")
                else MlweWitness.random)
        w = make(k=ent["k"], seed=ent["seed"])
        params = DeepFriParams(schedule=list(ent["schedule"]), r=ent["r"],
                               seed_z=ent["seed_z"])
        proof = prove(w, params)
        assert verify(params, proof)
        buf = serialize_proof(proof)
        rec = dict(ent)
        rec["proof_bytes"] = len(buf)
        rec["sha256"] = hashlib.sha256(buf).hexdigest()
        out["entries"].append(rec)
        print(rec["name"], rec["proof_bytes"], rec["sha256"],
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    path = os.path.join(ROOT, "tests", "data", "torch_golden.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
