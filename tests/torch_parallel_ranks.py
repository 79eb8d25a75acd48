"""Rank processes of the sharded-port tests (not a test module).

The tests of `stark_mlwe_tpu_torch.parallel` start every rank of a world
as its own process running this file:

    python tests/torch_parallel_ranks.py SUITE RANK WORLD STORE OUT

Each rank joins a gloo group through a file store (`STORE`, no port to
clash with another test worker), runs every case of SUITE, and writes
what it got to `OUT/rank{RANK}.json`.  This file imports torch and the
port only; the test files, which also import the JAX package, read the
results.  `World` is the parent's side.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A rank still running this long after its start is killed and its tests
# fail (a hung collective raises sooner: the group's timeout is 120 s).
RANK_TIMEOUT_S = 240

# The prover cases: (k, witness seed, unstructured, schedule, r, seed_z,
# world sizes).  small_k6 and wide32_k6 are entries of
# tests/data/torch_golden.json; k7_16 is the JAX package's own case of
# tests/test_parallel_prover.py; final1_k6 ends in a one-element layer.
PROVER_CASES = {
    "small_k6": (6, 2024, False, [8, 4], 6, 0xDEEFBAAD, (1, 2, 4)),
    "wide32_k6": (6, 1234, True, [32], 4, 0xDEEFBAAD, (2,)),
    "k7_16": (7, 0xBEEF + 7, False, [16], 4, 0xD00D, (1, 2, 4)),
    "final1_k6": (6, 99, True, [8, 8], 4, 0xD00D, (1,)),
}

# The sharded step: n = STEP_N_PER_RANK * D, m = arity = STEP_M.
STEP_N_PER_RANK = 64
STEP_M = 4
STEP_SEED = 0x5A5A
STEP_Z = 0x1234567
STEP_Z_FOLD = 0xABCDEF

# The sharded NTT: (n1, n2) by world size.
NTT_CASES = {1: [(16, 16)], 2: [(16, 16)], 4: [(16, 16), (64, 64)]}
NTT_SEED = 0x77


def step_inputs(D: int):
    """The step's four columns as canonical ints (numpy seed)."""
    import numpy as np

    from stark_mlwe_tpu_torch.spec.field import P

    n = STEP_N_PER_RANK * D
    words = np.random.default_rng(STEP_SEED + D).integers(
        0, 1 << 32, size=(4, n, 8), dtype=np.uint64)
    return [[sum(int(w) << (32 * i) for i, w in enumerate(row)) % P
             for row in col] for col in words]


def ntt_input(n1: int, n2: int):
    """The NTT's input: seeded Montgomery limbs [n1*n2, 8] (numpy)."""
    from stark_mlwe_tpu_torch.ops import fr

    return fr.seeded_limbs(NTT_SEED + n1 * n2, n1 * n2)


def _prover_suite(mesh, D: int) -> dict:
    from stark_mlwe_tpu_torch.parallel.prover import prove_sharded
    from stark_mlwe_tpu_torch.stark import (DeepFriParams, MlweWitness,
                                            serialize_proof)

    out = {}
    for name, (k, seed, unstructured, schedule, r, seed_z,
               worlds) in PROVER_CASES.items():
        if D not in worlds:
            continue
        make = (MlweWitness.random_unstructured if unstructured
                else MlweWitness.random)
        w = make(k=k, seed=seed)
        params = DeepFriParams(schedule=schedule, r=r, seed_z=seed_z)
        mesh.reset_collectives()
        t0 = time.perf_counter()
        proof = prove_sharded(w, params, mesh=mesh)
        out[name] = {"proof": serialize_proof(proof).hex(),
                     "collectives": dict(mesh.collectives),
                     "seconds": time.perf_counter() - t0}
    return out


def _parallel_suite(mesh, D: int) -> dict:
    import torch

    from stark_mlwe_tpu_torch import parallel as par
    from stark_mlwe_tpu_torch.fri import deep_ali as dali
    from stark_mlwe_tpu_torch.ops import fr
    from stark_mlwe_tpu_torch.spec.field import P, get_root_of_unity
    from stark_mlwe_tpu_torch.spec.transcript import Transcript

    r = mesh.rank
    out = {}

    # --- the sharded step ---------------------------------------------
    n, m = STEP_N_PER_RANK * D, STEP_M
    local = n // D
    step, ds_locals, _ = par.build_sharded_prove_step(mesh, n, m, m)
    cols = [fr.to_device(fr.pack_ints(c[r * local:(r + 1) * local],
                                      mont=True), "cpu")
            for c in step_inputs(D)]
    omega = get_root_of_unity(n)
    w = dali.omega_powers(omega, n, "cpu")[r * local:(r + 1) * local]
    zh = (pow(STEP_Z, n, P) - 1) % P
    scale = zh * pow(n % P, P - 2, P) % P
    zpow = fr.to_device(fr.pack_ints([pow(STEP_Z_FOLD, j, P)
                                      for j in range(m)], mont=True), "cpu")
    mesh.reset_collectives()
    root, phi_z, f1 = step(*cols, w, fr.const(STEP_Z, "cpu", mont=True),
                           fr.const(scale, "cpu", mont=True), zpow,
                           *ds_locals)
    out["step"] = {"root": fr.unpack_ints(root[None], mont=True)[0],
                   "phi_z": fr.unpack_ints(phi_z[None], mont=True)[0],
                   "f1": fr.unpack_ints(f1, mont=True),
                   "collectives": dict(mesh.collectives)}

    # --- the sharded NTT ----------------------------------------------
    for n1, n2 in NTT_CASES[D]:
        fn, tw_local = par.build_ntt_sharded(mesh, n1, n2)
        x = fr.to_device(ntt_input(n1, n2), "cpu")
        rows = n1 * n2 // D
        mesh.reset_collectives()
        y = fn(x[r * rows:(r + 1) * rows], tw_local)
        out[f"ntt_{n1}x{n2}"] = {
            "limbs": [int(v) for v in y.reshape(-1).tolist()],
            "collectives": dict(mesh.collectives)}

    # --- scripts/distributed_smoke.py: replicated FS + a collective -----
    tr = Transcript(b"DIST/SMOKE")
    tr.absorb_bytes(b"witness-bytes")
    ch = tr.challenge(b"c") % (1 << 31)
    got = mesh.all_gather(torch.tensor([[ch]], dtype=torch.int64))
    total = mesh.all_reduce_sum(torch.ones(1, dtype=torch.int64))
    out["smoke"] = {"challenge": ch,
                    "gathered": [int(v) for v in got.reshape(-1)],
                    "sum": int(total[0])}
    return out


SUITES = {"prover": _prover_suite, "parallel": _parallel_suite}


def rank_main(suite: str, rank: int, world: int, store: str,
              out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from stark_mlwe_tpu_torch.distributed import initialize_distributed
    from stark_mlwe_tpu_torch.parallel import make_mesh

    initialize_distributed("file://" + store, world, rank, device="cpu")
    try:
        mesh = make_mesh(world, device="cpu")
        result = SUITES[suite](mesh, world)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(result, fh)
    finally:
        dist.destroy_process_group()


class World:
    """The rank processes of one world, started at construction."""

    def __init__(self, suite: str, world: int, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.world, self.out_dir = world, out_dir
        store = os.path.join(out_dir, "store")
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        self.logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
                     for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(r),
             str(world), store, out_dir],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(self.logs)]
        self.t0 = time.perf_counter()
        self._results = None

    def close(self) -> None:
        """Kill the ranks still running and close their logs."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()

    def results(self) -> list:
        """Every rank's results, in rank order; waits for the ranks (up to
        `RANK_TIMEOUT_S` from their start, then kills them) and raises if
        one failed."""
        if self._results is None:
            try:
                for p in self.procs:
                    left = RANK_TIMEOUT_S - (time.perf_counter() - self.t0)
                    p.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                pass
            finally:
                self.close()
            bad = [(r, p.returncode) for r, p in enumerate(self.procs)
                   if p.returncode != 0]
            if bad:
                tails = [open(os.path.join(self.out_dir, f"rank{r}.log")
                              ).read()[-3000:] for r, _ in bad]
                raise RuntimeError(f"world of {self.world}: ranks {bad} "
                                   f"failed\n" + "\n".join(tails))
            self._results = []
            for r in range(self.world):
                with open(os.path.join(self.out_dir, f"rank{r}.json")) as fh:
                    self._results.append(json.load(fh))
            self.seconds = time.perf_counter() - self.t0
        return self._results

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
              sys.argv[5])
