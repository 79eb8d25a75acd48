"""The port's sum-check NIZK track against the JAX package, on the CPU.

`stark_mlwe_tpu_torch.channel` (`prove_plain` / `prove_mf`, both MF
read-back branches, the verifiers), `transcript_dev.DeviceTranscript` and
`mle.DeviceMLE` are held exactly (field elements and bytes, tolerance 0)
against the JAX package's device modules and the pure-int spec, on inputs
made from a seed.  The port runs its plain versions of K1 and K2 here
(`device="cpu"`).  Proofs are made once per module and shared by the
tests, at k = 5: a plain t=17 permutation costs about half a second a call
on the CPU, and the JAX package's `prove_mf` compiles for about a minute
(its `prove_plain` for over 1.5 minutes, so the plain proof is held to the
JAX package's recorded bytes, `nizk_entries` of tests/data/
torch_golden.json, written by scripts/make_torch_golden.py).  The JAX
package's own MF gather branch, which no JAX test reaches, is held to its
spec here as well.
"""

import hashlib
import json
import os
import random

import jax.numpy as jnp
import pytest
import torch

from stark_mlwe_tpu import channel as jch
from stark_mlwe_tpu.mle import DeviceMLE as JaxMLE
from stark_mlwe_tpu.ops import fr as jfr
from stark_mlwe_tpu.spec import channel as jsch
from stark_mlwe_tpu.transcript_dev import DeviceTranscript as JaxTranscript
from stark_mlwe_tpu_torch import channel as tch
from stark_mlwe_tpu_torch.mle import DeviceMLE
from stark_mlwe_tpu_torch.ops import fr
from stark_mlwe_tpu_torch.serde import serialize_nizk_proof
from stark_mlwe_tpu_torch.spec import channel as tsch
from stark_mlwe_tpu_torch.spec import mle as tsmle
from stark_mlwe_tpu_torch.spec.field import P
from stark_mlwe_tpu_torch.spec.rng import StdRng
from stark_mlwe_tpu_torch.spec.transcript import Transcript
from stark_mlwe_tpu_torch.transcript_dev import DeviceTranscript
import torch_port_util  # noqa: F401  (one torch thread per test worker)

CPU = "cpu"
K = 5
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden.json")


def golden_nizk() -> dict:
    with open(GOLDEN) as f:
        return {e["name"]: e for e in json.load(f).get("nizk_entries", [])}


def bench_witness(seed: int, k: int) -> list:
    """`bench.run_plain_nizk` / `run_mf_nizk`'s witness."""
    return StdRng.seed_from_u64(seed).ark_fr_rand_batch(1 << k)


def flip(b: bytes, at: int = 3) -> bytes:
    return b[:at] + bytes([b[at] ^ 1]) + b[at + 1:]


# ---------------------------------------------------------------------------
# Proofs, made once per module.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plain():
    """(vk, witness, port proof): the plain settings of
    benchmarkdata_nizk.csv at k = 5."""
    w = bench_witness(42, K)
    vk = tsch.build_vk_plain(K, ds_tag=0xA11CE)
    proof = tch.prove_plain(vk, w, device=CPU)
    assert set(tch.phase_seconds) == {"plain/pack", "plain/chain",
                                      "plain/bundle"}
    return vk, w, proof


def jax_vk_mf():
    return jsch.build_vk_mf(K, ds_tag=0xB0B, queries_per_round=3)


@pytest.fixture(scope="module")
def mf():
    """(vk, witness, port proof by download, port proof by gathers, JAX
    proof, phases of the download and of the gather run): the MF settings
    of benchmarkdata_nizk.csv at k = 5."""
    w = bench_witness(43, K)
    vk = tsch.build_vk_mf(K, ds_tag=0xB0B, queries_per_round=3)
    assert (1 << K) < tch.MF_GATHER_MIN_N
    down = tch.prove_mf(vk, w, device=CPU)
    down_phases = dict(tch.phase_seconds)
    saved = tch.MF_GATHER_MIN_N
    tch.MF_GATHER_MIN_N = 1
    try:
        gather = tch.prove_mf(vk, w, device=CPU)
        gather_phases = dict(tch.phase_seconds)
    finally:
        tch.MF_GATHER_MIN_N = saved
    return (vk, w, down, gather, jch.prove_mf(jax_vk_mf(), w), down_phases,
            gather_phases)


def assert_mf_equal(a, b):
    """Every field of two MF proofs."""
    assert (a.initial_root, a.final_eval) == (b.initial_root, b.final_eval)
    assert len(a.rounds) == len(b.rounds) == K
    for r1, r2 in zip(a.rounds, b.rounds):
        assert (r1.c0, r1.c1, r1.next_root) == (r2.c0, r2.c1, r2.next_root)
        assert (r1.cur_indices, r1.cur_values) == (r2.cur_indices,
                                                    r2.cur_values)
        assert (r1.next_indices, r1.next_values) == (r2.next_indices,
                                                      r2.next_values)
        for p1, p2 in ((r1.cur_proof, r2.cur_proof),
                       (r1.next_proof, r2.next_proof)):
            assert (p1.arity, p1.group_sizes, p1.indices, p1.siblings) == \
                (p2.arity, p2.group_sizes, p2.indices, p2.siblings)
    assert a.size_bytes() == b.size_bytes()
    assert serialize_nizk_proof(a) == serialize_nizk_proof(b)


# ---------------------------------------------------------------------------
# prove_plain / verify_plain.
# ---------------------------------------------------------------------------

def test_prove_plain_equals_jax(plain):
    """Every byte of the canonical encoding (every field, in order)
    against the JAX package's proof of the same witness."""
    ent = golden_nizk()["plain_k5"]
    _, _, tp = plain
    assert (ent["variant"], ent["k"], ent["seed"], ent["ds_tag"]) == \
        ("plain", K, 42, 0xA11CE)
    buf = serialize_nizk_proof(tp)
    assert hashlib.sha256(buf).hexdigest() == ent["sha256"]
    assert len(buf) == ent["encoded_bytes"]
    assert tp.size_bytes() == ent["size_bytes"] == 32 + 64 * K + 32


def test_prove_plain_equals_spec_and_verifies(plain):
    vk, w, tp = plain
    sp = tsch.prove_plain(vk, w)
    assert (tp.root, tp.rounds, tp.final_eval) == (sp.root, sp.rounds,
                                                   sp.final_eval)
    assert tch.verify_plain(vk, tp, device=CPU)
    assert tsch.verify_plain(vk, tp)


@pytest.mark.parametrize("where", ["final_eval", "c0", "c1", "root"])
def test_plain_tamper_refused(plain, where):
    vk, _, tp = plain
    rounds = list(tp.rounds)
    root, final = tp.root, tp.final_eval
    if where == "final_eval":
        final = flip(final)
    elif where == "root":
        root = flip(root)
    else:
        c0, c1 = rounds[2]
        rounds[2] = (flip(c0), c1) if where == "c0" else (c0, flip(c1))
    bad = tsch.ProofPlain(root, rounds, final)
    assert not tch.verify_plain(vk, bad, device=CPU)
    assert not tsch.verify_plain(vk, bad)


# ---------------------------------------------------------------------------
# prove_mf / verify_mf: both read-back branches.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["download", "gather"])
def test_prove_mf_equals_jax(mf, branch):
    vk, _, down, gather, jp, down_phases, gather_phases = mf
    proof = down if branch == "download" else gather
    phases = down_phases if branch == "download" else gather_phases
    assert_mf_equal(proof, jp)
    readback = "mf/download" if branch == "download" else "mf/gather_ctx"
    assert set(phases) == {"mf/pack", "mf/chain_device", readback,
                           "mf/host_assembly"}


def test_prove_mf_equals_spec_and_verifies(mf):
    vk, w, down, _, _, _, _ = mf
    assert_mf_equal(down, tsch.prove_mf(vk, w))
    assert tch.verify_mf(vk, down, device=CPU)
    assert tsch.verify_mf(vk, down)


@pytest.mark.parametrize("where", ["final_eval", "c0", "next_root",
                                   "sibling", "cur_value"])
def test_mf_tamper_refused(mf, where):
    import copy
    vk, _, down, _, _, _, _ = mf
    bad = copy.deepcopy(down)
    r = bad.rounds[1]
    if where == "final_eval":
        bad.final_eval = flip(bad.final_eval)
    elif where == "c0":
        r.c0 = flip(r.c0)
    elif where == "next_root":
        r.next_root = flip(r.next_root)
    elif where == "sibling":
        lvl = next(lv for lv in r.cur_proof.siblings if lv)
        lvl[0] = flip(lvl[0])
    else:
        r.cur_values[0] = flip(r.cur_values[0])
    assert not tch.verify_mf(vk, bad, device=CPU)
    assert not tsch.verify_mf(vk, bad)


def test_mf_golden(mf):
    ent = golden_nizk()["mf_k5"]
    vk, _, down, _, _, _, _ = mf
    buf = serialize_nizk_proof(down)
    assert (ent["seed"], ent["ds_tag"], ent["queries_per_round"]) == \
        (43, 0xB0B, 3)
    assert hashlib.sha256(buf).hexdigest() == ent["sha256"]
    assert down.size_bytes() == ent["size_bytes"]


def test_jax_mf_gather_branch_matches_its_spec(mf, monkeypatch):
    """The JAX package's `_MFGatherCtx` runs only from
    STARK_MF_GATHER_MIN_N values on (2^14 by default); forced at k = 5 it
    must give the JAX spec's proof (and the port's)."""
    vk, w, down, _, _, _, _ = mf
    monkeypatch.setenv("STARK_MF_GATHER_MIN_N", "1")
    seen = []
    ctx_cls = jch._MFGatherCtx

    class Spy(ctx_cls):
        def __init__(self, *a):
            seen.append(True)
            super().__init__(*a)

    monkeypatch.setattr(jch, "_MFGatherCtx", Spy)
    jp = jch.prove_mf(jax_vk_mf(), w)
    assert seen, "the JAX gather branch did not run"
    assert_mf_equal(jp, jsch.prove_mf(jax_vk_mf(), w))
    assert_mf_equal(jp, down)
    assert jsch.verify_mf(jax_vk_mf(), jp)


def test_mf_round_by_round_prover_equals_spec():
    """`SumCheckMFProver` (round by round on the device) and
    `SumCheckMFVerifier` against the spec's, at k = 3."""
    k = 3
    rng = random.Random(0x3F3)
    w = [rng.randrange(P) for _ in range(1 << k)]
    mcfg = tsch.MerkleChannelCfg.new(91)
    qcfg = tsch.SumCheckMFConfig(2)
    tp = tch.SumCheckMFProver(qcfg, mcfg, tsch.ProverChannel(
        tch.FastTranscript(b"MF/RBR")), DeviceMLE.from_ints(w, CPU))
    sp = tsch.SumCheckMFProver(qcfg, mcfg, tsch.ProverChannel(
        Transcript(b"MF/RBR")), tsmle.MLE(w))
    assert tp.current_root() == sp.current_root()
    assert tp.send_claim() == sp.send_claim()
    sv = tch.SumCheckMFVerifier(qcfg, mcfg, tsch.VerifierChannel(
        tch.FastTranscript(b"MF/RBR")), tp.current_root(), k, device=CPU)
    sv.receive_initial_root(tp.current_root())
    sv.recv_claim(sum(w) % P)
    running = sum(w) % P
    for i in range(k):
        got, want = tp.round(i), sp.round(i)
        assert got[:4] == want[:4]
        assert got[4] == want[4]
        c0, c1, r_i, next_root, op = got
        sv.start_round(i, running, c0, c1)
        assert sv.derive_round_challenge(i) == r_i
        prev = sv.cur_root
        sv.recv_next_root(next_root)
        assert sv.verify_fold_openings(
            op.cur_indices, op.cur_values, op.cur_proof, op.next_indices,
            op.next_values, op.next_proof, r_i, prev, next_root)
        running = sv.compute_s_next(c0, c1, r_i)
    assert tp.finalize_eval() == sp.finalize_eval()
    sv.finalize_and_check(tp.layer.values()[0], running)


# ---------------------------------------------------------------------------
# DeviceTranscript, DeviceMLE, the channel layers.
# ---------------------------------------------------------------------------

def test_device_transcript_equals_jax_and_spec_randomized():
    """Randomized interleavings of byte absorbs, constant and device field
    absorbs and challenges (many rate offsets), as in the JAX package's
    test of its DeviceTranscript."""
    r = random.Random(0xDE57)
    for trial in range(3):
        label = b"DT/TRIAL" + bytes([trial])
        host = Transcript(label)
        port = DeviceTranscript(label, device=CPU)
        jax_t = JaxTranscript(label)
        for _ in range(25):
            op = r.randrange(3)
            if op == 0:
                data = bytes(r.randrange(256) for _ in range(r.randrange(40)))
                for t in (host, port, jax_t):
                    t.absorb_bytes(data)
            elif op == 1:
                x = r.randrange(P)
                host.absorb_field(x)
                port.absorb_field_const(x)
                jax_t.absorb_field_const(x)
            else:
                x = r.randrange(P)
                host.absorb_field(x)
                port.absorb_field_dev(fr.to_device(fr.pack_int(x, mont=True),
                                                   CPU))
                jax_t.absorb_field_dev(jnp.asarray(jfr.pack_int(x,
                                                                mont=True)))
        lab = bytes([trial]) + b"/final"
        want = host.challenge(lab)
        got = port.challenge_dev(lab)
        assert got.shape == (fr.N,) and got.dtype == torch.int32
        assert fr.unpack_ints(got, mont=True) == [want]
        assert jfr.unpack_ints(jax_t.challenge_dev(lab)[None, :],
                               mont=True) == [want]


@pytest.fixture(scope="module")
def mle_case():
    rng = random.Random(0x31E)
    k = 4
    vals = [rng.randrange(P) for _ in range(1 << k)]
    r = [rng.randrange(P) for _ in range(k)]
    return vals, r, DeviceMLE.from_ints(vals, device=CPU), \
        JaxMLE.from_ints(vals), tsmle.MLE(vals)


def test_device_mle_eval_sum_fold_last(mle_case):
    vals, r, t, j, s = mle_case
    assert t.n == j.n == 4
    assert t.eval(r) == j.eval(r) == s.eval(r)
    assert t.sum() == j.sum() == sum(vals) % P
    assert t.fold_last(r[0]).values() == j.fold_last(r[0]).values() \
        == s.fold_last(r[0]).values
    assert t.values() == vals
    assert t.value_at([0, 5, 15]) == [vals[0], vals[5], vals[15]]


@pytest.mark.parametrize("var", [0, 2, 3])
def test_device_mle_fold_and_fix(mle_case, var):
    vals, r, t, j, s = mle_case
    assert t.fold(var, r[1]).values() == j.fold(var, r[1]).values() \
        == s.fold(var, r[1]).values
    for bit in (False, True):
        assert t.fix(var, bit).values() == j.fix(var, bit).values() \
            == s.fix(var, bit).values


def test_mle_channel_roundtrip_equals_jax():
    """MLE commit / point / eval / open through the channel layers in
    lockstep, port prover and verifier beside the JAX package's."""
    k = 5
    rng = random.Random(0xC4A)
    vals = [rng.randrange(P) for _ in range(1 << k)]
    cfg = tsch.MerkleChannelCfg.new(99)
    pc = tsch.ProverChannel(tch.FastTranscript(b"MLE/E2E"))
    vc = tsch.VerifierChannel(tch.FastTranscript(b"MLE/E2E"))
    mp = tch.MleProver(tch.ChanMerkleProver(pc, cfg),
                       DeviceMLE.from_ints(vals, device=CPU))
    mv = tch.MleVerifier(tch.ChanMerkleVerifier(vc, cfg, device=CPU), k)
    jp = jch.MleProver(jch.ChanMerkleProver(jch.ProverChannel(
        jch.FastTranscript(b"MLE/E2E")), jsch.MerkleChannelCfg.new(99)),
        JaxMLE.from_ints(vals))
    root = mp.commit()
    assert root == jp.commit()
    mv.receive_root(root)
    r_p = mp.draw_point(b"mle/r")
    assert r_p == mv.draw_point(b"mle/r") == jp.draw_point(b"mle/r")
    val = mp.evaluate_and_bind(r_p)
    assert val == jp.evaluate_and_bind(r_p) == tsmle.MLE(vals).eval(r_p)
    mv.bind_claimed_eval(val)
    vals_open, proof = mp.open_indices([1, 7, 20])
    jvals, jproof = jp.open_indices([1, 7, 20])
    assert vals_open == jvals and proof.siblings == jproof.siblings
    assert mv.verify_openings([1, 7, 20], vals_open, proof)
    assert not mv.verify_openings([1, 7, 20],
                                  [vals_open[0] + 1] + vals_open[1:], proof)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(plain, mf):
    """`device=None` means the card: without one every entry point of the
    track raises, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    vk, w, tp = plain
    vk_mf, _, down, _, _, _, _ = mf
    for call in (lambda: tch.prove_plain(vk, w),
                 lambda: tch.verify_plain(vk, tp),
                 lambda: tch.prove_mf(vk_mf, w),
                 lambda: tch.verify_mf(vk_mf, down),
                 lambda: DeviceMLE.from_ints(w),
                 lambda: DeviceTranscript(b"X")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
