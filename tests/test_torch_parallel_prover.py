"""The port's sharded prover (`parallel.prover`) at 1, 2 and 4 gloo ranks.

Every rank is its own process (tests/torch_parallel_ranks.py, which
imports torch and the port only); the three worlds are started once for
this file and run beside the JAX side.  Each rank proves every case and
returns its proof's bytes, which must be the same on every rank and equal
to the JAX package's:

  - small_k6 ([8, 4]: pair leaves at layer 1, a final layer of one row a
    rank at 2 ranks, the tail gathered early at 4) and wide32_k6 ([32],
    t=33, 2 ranks) through their sha256 in tests/data/torch_golden.json,
  - the JAX package's own case (k=7, [16], tests/test_parallel_prover.py)
    against the port's single-device prove at every world size and the
    JAX package's `prove_sharded` on 2 of the 8 virtual CPU devices,
  - final1_k6 ([8, 8], random columns, one rank: a last layer of one
    element) against the port's single-device prove.

The JAX package's spec verifier accepts every proof.
"""

import hashlib
import json
import os

import pytest
import torch

import stark_mlwe_tpu.stark as jstark
from stark_mlwe_tpu import parallel as jpar
from stark_mlwe_tpu.parallel import prover as jspv
from stark_mlwe_tpu.spec import fri as jspec_fri

import stark_mlwe_tpu_torch.stark as tstark
from stark_mlwe_tpu_torch import parallel as tpar
from stark_mlwe_tpu_torch.distributed import initialize_distributed
from stark_mlwe_tpu_torch.parallel import prover as tspv

import torch_parallel_ranks as tpr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)
GOLDEN_CASES = [(name, D) for name in ("small_k6", "wide32_k6")
                for D in tpr.PROVER_CASES[name][-1]]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("prover_ranks")
    started = {D: tpr.World("prover", D, str(base / f"world{D}"))
               for D in WORLDS}
    yield started
    for w in started.values():
        w.close()


def case_params(name):
    k, seed, unstructured, schedule, r, seed_z, _ = tpr.PROVER_CASES[name]
    return k, seed, unstructured, tstark.DeepFriParams(
        schedule=schedule, r=r, seed_z=seed_z)


def rank_proofs(worlds, name, D) -> bytes:
    """The case's proof, which every rank of the world must have made."""
    bufs = {bytes.fromhex(res[name]["proof"])
            for res in worlds[D].results()}
    assert len(bufs) == 1, f"{name} at {D} ranks: ranks disagree"
    return bufs.pop()


def spec_verifies(name, buf) -> bool:
    _, _, _, params = case_params(name)
    jparams = jspec_fri.DeepFriParams(schedule=params.schedule, r=params.r,
                                      seed_z=params.seed_z)
    return jspec_fri.deep_fri_verify(jparams, jstark.deserialize_proof(buf))


@pytest.fixture(scope="module")
def single_device():
    """The port's single-device proof of a case (made once)."""
    made = {}

    def proof(name):
        if name not in made:
            k, seed, unstructured, params = case_params(name)
            make = (tstark.MlweWitness.random_unstructured if unstructured
                    else tstark.MlweWitness.random)
            made[name] = tstark.serialize_proof(
                tstark.prove(make(k=k, seed=seed), params, device="cpu"))
        return made[name]

    return proof


def test_k7_equals_jax_sharded_prove_on_two_devices(worlds):
    """Started first, so the ranks run while the JAX side compiles."""
    k, seed, _, params = case_params("k7_16")
    w = jstark.MlweWitness.random(k=k, seed=seed)
    jparams = jstark.DeepFriParams(schedule=params.schedule, r=params.r,
                                   seed_z=params.seed_z)
    jbuf = jstark.serialize_proof(
        jspv.prove_sharded(w, jparams, mesh=jpar.make_mesh(2)))
    assert rank_proofs(worlds, "k7_16", 2) == jbuf


@pytest.mark.parametrize("name,D", GOLDEN_CASES)
def test_sharded_proof_equals_golden(worlds, name, D):
    golden = {e["name"]: e for e in json.load(open(os.path.join(
        ROOT, "tests", "data", "torch_golden.json")))["entries"]}[name]
    buf = rank_proofs(worlds, name, D)
    assert hashlib.sha256(buf).hexdigest() == golden["sha256"]
    assert len(buf) == golden["proof_bytes"]
    assert spec_verifies(name, buf)


@pytest.mark.parametrize("name,D", [("k7_16", D) for D in WORLDS]
                         + [("final1_k6", 1)])
def test_sharded_proof_equals_single_device_prove(worlds, single_device,
                                                  name, D):
    """final1_k6 ([8, 8] at k=6, random columns) ends in a one-element
    layer, which stays replicated."""
    buf = rank_proofs(worlds, name, D)
    assert buf == single_device(name)
    _, _, _, params = case_params(name)
    assert tstark.verify(params, tstark.deserialize_proof(buf), device="cpu")
    assert spec_verifies(name, buf)


@pytest.mark.parametrize("D", WORLDS)
def test_collectives_per_prove(worlds, D):
    """Every rank issues the same collectives; each prove assembles its
    openings with exactly one all-reduce; and (k=7, [16]), whose layers
    all split at 1, 2 and 4 ranks, issues the same collectives at every
    world size: nothing is skipped at one rank."""
    res = worlds[D].results()
    for name in res[0]:
        counts = [r[name]["collectives"] for r in res]
        assert all(c == counts[0] for c in counts), name
        assert counts[0]["all_reduce"] == 1, name
        assert counts[0]["all_to_all"] == 0, name
    # one all-gather of the frontier per sharded layer, none gathering f
    assert res[0]["k7_16"]["collectives"] == {
        "all_gather": 2, "all_to_all": 0, "all_reduce": 1}


def test_unprimed_row_of_a_sharded_layer_raises():
    """A sharded layer's view reads only the rows the gather primed, by
    global index; no row is read back from a shard."""
    local = torch.zeros((4, 8), dtype=torch.int32)
    view = tspv.ShardedFieldView(tspv.RowShard(local, 8, 16))
    assert len(view) == 16
    view.prime({9: 5})
    assert view[9] == 5
    with pytest.raises(KeyError, match="not gathered"):
        view[8]
    with pytest.raises(TypeError):
        list(view)


def test_sharded_gather_batch_at_one_rank():
    """The openings' gather over a one-rank gloo group: rows of a shard
    (global indices) and of a replicated tensor, one all-reduce."""
    import torch.distributed as dist

    from stark_mlwe_tpu_torch.ops import fr

    initialize_distributed(device="cpu")
    try:
        mesh = tpar.make_mesh(1, device="cpu")
        vals = list(range(100, 116))
        full = fr.to_device(fr.pack_ints(vals, mont=True), "cpu")
        batch = tspv.ShardedGatherBatch(mesh)
        h0 = batch.add(tspv.RowShard(full, 0, 16), [3, 0, 15])
        h1 = batch.add(full, [7])
        out = batch.run()
        assert out[h0] == [103, 100, 115] and out[h1] == [107]
        assert mesh.collectives == {"all_gather": 0, "all_to_all": 0,
                                    "all_reduce": 1}
    finally:
        dist.destroy_process_group()
