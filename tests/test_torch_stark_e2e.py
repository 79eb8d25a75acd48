"""The first slice of the port as a whole: stark.prove / stark.verify.

The same witness and parameters go through the JAX package's prover and
the port's (`device="cpu"`): the serialized proofs must be byte-equal, each
verifier must accept the other's proof, and a flipped byte is refused.
"""

import hashlib
import json
import os

import pytest

import stark_mlwe_tpu.stark as jstark
import stark_mlwe_tpu_torch.stark as tstark
from stark_mlwe_tpu_torch import fri as tfri
from stark_mlwe_tpu_torch.spec import fri as sfri
from stark_mlwe_tpu_torch.spec.field import P

from torch_port_util import rand_ints

K, SEED = 6, 2024
SCHEDULE, R, SEED_Z = [8, 4], 6, 0xDEEF_BAAD


@pytest.fixture(scope="module")
def port_proof():
    w = tstark.MlweWitness.random(k=K, seed=SEED)
    params = tstark.DeepFriParams(schedule=SCHEDULE, r=R, seed_z=SEED_Z)
    return params, tstark.prove(w, params, device="cpu")


@pytest.fixture(scope="module")
def jax_proof():
    w = jstark.MlweWitness.random(k=K, seed=SEED)
    params = jstark.DeepFriParams(schedule=SCHEDULE, r=R, seed_z=SEED_Z)
    return params, jstark.prove(w, params)


def test_witness_is_the_same_satisfying_instance():
    w = tstark.MlweWitness.random(k=K, seed=SEED)
    jw = jstark.MlweWitness.random(k=K, seed=SEED)
    assert (w.a, w.s, w.e, w.t) == (jw.a, jw.s, jw.e, jw.t)
    assert all((w.a[i] * w.s[i] + w.e[i]) % P == w.t[i]
               for i in range(1 << K))
    u = tstark.MlweWitness.random_unstructured(k=4, seed=3)
    ju = jstark.MlweWitness.random_unstructured(k=4, seed=3)
    assert (u.a, u.t) == (ju.a, ju.t)


def test_proof_bytes_equal_jax(port_proof, jax_proof):
    assert tstark.serialize_proof(port_proof[1]) == \
        jstark.serialize_proof(jax_proof[1])


def test_each_verifier_accepts_the_others_proof(port_proof, jax_proof):
    params, proof = port_proof
    jparams, jproof = jax_proof
    assert tstark.verify(params, proof, device="cpu")
    buf = tstark.serialize_proof(proof)
    jbuf = jstark.serialize_proof(jproof)
    assert jstark.verify(jparams, jstark.deserialize_proof(buf))
    assert tstark.verify(params, tstark.deserialize_proof(jbuf),
                         device="cpu")
    # the pure-int spec verifier is the third judge
    assert sfri.deep_fri_verify(params, proof)


def test_wire_format_round_trip(port_proof):
    _, proof = port_proof
    buf = tstark.serialize_proof(proof)
    assert tstark.serialize_proof(tstark.deserialize_proof(buf)) == buf


def _tamper_offsets(proof, buf):
    """Byte offsets the verifier must notice: inside the first root, inside
    a Merkle sibling of layer 0, inside an opened value of the last query.
    (Bytes of fields the verifier never reads - the positions of a query
    inside its batch - are not in this list.)"""
    sib = proof.layer_batches.layers[0].child_proof.siblings[0][0]
    L = len(SCHEDULE)
    per_query = 8 + 32 * L + 8 + 128 * L + 8 + 64     # the tail of the format
    return {"root": 8 + 32 + 8 + 3,
            "sibling": buf.index(tstark.fr_to_bytes(sib)) + 7,
            "payload": len(buf) - per_query + 8 + 32 * L + 8 + 1}


@pytest.mark.parametrize("which", ["root", "sibling", "payload"])
def test_flipped_byte_is_refused(port_proof, which):
    params, proof = port_proof
    buf = bytearray(tstark.serialize_proof(proof))
    buf[_tamper_offsets(proof, bytes(buf))[which]] ^= 1
    bad = tstark.deserialize_proof(bytes(buf))
    assert not tstark.verify(params, bad, device="cpu")
    assert not sfri.deep_fri_verify(params, bad)


def test_golden_small_entry(port_proof):
    """The JAX package's recorded proof (tests/data/torch_golden.json,
    written by scripts/make_torch_golden.py) for this configuration."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "torch_golden.json")
    with open(path) as f:
        ent = {e["name"]: e for e in json.load(f)["entries"]}["small_k6"]
    assert (ent["k"], ent["seed"], ent["schedule"], ent["r"],
            ent["seed_z"]) == (K, SEED, SCHEDULE, R, SEED_Z)
    buf = tstark.serialize_proof(port_proof[1])
    assert len(buf) == ent["proof_bytes"]
    assert hashlib.sha256(buf).hexdigest() == ent["sha256"]


def test_blinded_prove_verifies():
    w = tstark.MlweWitness.random(k=4, seed=7)
    r_col = rand_ints(5, 1 << 4)
    params = tstark.DeepFriParams(schedule=[4, 4], r=3, seed_z=99)
    proof = tstark.prove(w, params, blinding_r=r_col, device="cpu")
    assert tstark.verify(params, proof, device="cpu")
    # bit-identical to the pure-int spec prover with the same blinding
    builder = sfri.DeepAliRealBuilder(r_eval_opt=r_col, use_blinding=True)
    want = sfri.deep_fri_prove(builder, w.a, w.s, w.e, w.t, 1 << 4, params)
    assert proof.roots == want.roots
    unblinded = tstark.prove(w, params, device="cpu")
    assert unblinded.roots != proof.roots


def test_phase_times_are_recorded(port_proof):
    for name in ("fri/build_f0", "fri/fold+commit", "fri/queries",
                 "ali/host_absorb"):
        assert tfri.phase_seconds[name] >= 0.0
