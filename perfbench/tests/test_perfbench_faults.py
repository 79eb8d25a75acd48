"""`correct` is decided by the comparison with the reference, and that
comparison fails where it should: a whole run on the CPU at a tiny size
(the look for a card skipped), with the timed path sound, broken
underneath, or replaced by the control.

The faults a prover cell can have: a step that returns its state
unchanged (every request after the first gets the first proof), half
of the batch left out (the second half of the witness rows zeroed), an
answer altered where it is produced (one opened value or coefficient).
The control is the reference in the program's place, one Poseidon
partial round short of the configuration's rounds."""

import copy
import json
import os
import shutil

import numpy as np
import pytest

from perfbench.harness import bench, registry
from perfbench.reference.field import P
from perfbench.reference.poseidon import Suite
from perfbench.reference.workers import Workers

CELLS = {"tiny_stark.k5": ("tiny_stark", {"system": "stark",
                                          "schedule": [8], "r": 4,
                                          "seed_z": 3740252845,
                                          "check_proofs": 2}, 5),
         "tiny_mf.k3": ("tiny_mf", {"system": "nizk_mf", "ds_tag": 2827,
                                    "queries_per_round": 3,
                                    "check_proofs": 2}, 3)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    shutil.copytree(os.path.join(registry.REPO_ROOT, "perfbench"),
                    os.path.join(root, "perfbench"))
    b = registry.load_benchmark()
    for cell, (name, cfg, k) in CELLS.items():
        path = f"perfbench/configs/{name}.json"
        with open(os.path.join(root, path), "w") as fh:
            json.dump(cfg, fh)
        with open(os.path.join(root, f"perfbench/traffic/k{k}.json"),
                  "w") as fh:
            json.dump({"k": k, "witness": "host", "loop": "closed",
                       "clients": 1, "pool": 2, "min_proofs": 2,
                       "trace_seconds": 0}, fh)
        b["configs"].append({"name": name, "source": "x", "file": path,
                             "reduced": [], "why": "x"})
        b["workloads"].append({"name": cell, "config": name,
                               "traffic": f"k{k}", "chips": 1, "why": "x"})
        for m in b["end_to_end"]:
            if m["name"] in ("proofs_per_s", "prove_p95_ms"):
                m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(b, fh)
    return root


def _run(root, cell, override=None):
    return bench.run_cell(cell, 2**31 + 77, 0.0, False, device="cpu",
                          root=root, prove_override=override, workers=1)


def _stale():
    first = []

    def prove(system, j):
        if not first:
            first.append(system.prove(j))
        return first[0]
    return prove


def _half(system, j):
    s = copy.copy(system)
    if hasattr(system, "cols"):
        cols = []
        for c in system.cols[j]:
            c = np.array(c)
            c[c.shape[0] // 2:] = 0
            cols.append(c)
        s.cols = {j: cols}
    else:
        v = list(system.values[j])
        s.values = {j: v[:len(v) // 2] + [0] * (len(v) - len(v) // 2)}
    return s.prove(j)


def _altered(system, j):
    proof = system.prove(j)
    if hasattr(proof, "queries"):
        pay = proof.queries[0].per_layer_payloads[0]
        pay.f_i = (pay.f_i + 1) % P
    else:
        c0 = proof.rounds[0].c0
        proof.rounds[0].c0 = bytes([c0[0] ^ 1]) + c0[1:]
    return proof


def _control(system, j):
    with Workers(1) as w:
        return system.reference(j, Suite(rp_cut=1), w)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"proofs_per_s", "prove_p95_ms",
                                   "setup_s"}


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "control"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_faults_and_control_are_not_correct(root, cell, fault):
    override = {"stale": _stale(), "half": _half, "altered": _altered,
                "control": _control}[fault]
    out = _run(root, cell, override)
    assert not out["correct"]
    assert out["checks"]["ref_mismatch"]["value"] > 0
