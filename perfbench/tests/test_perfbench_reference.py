"""The reference against the port's CPU path at tiny sizes, the
Poseidon permutation against its definition, and the frozen work
counts against the permutations the reference computes."""

import random
from collections import Counter

import numpy as np
import pytest

from perfbench import roofline
from perfbench.harness import canon, witness
from perfbench.reference import merkle as rmerkle
from perfbench.reference import nizk_mf as rmf
from perfbench.reference import poseidon as rpos
from perfbench.reference import stark as rstark
from perfbench.reference.field import P, mont_rows_to_ints
from perfbench.reference.workers import Workers


@pytest.mark.parametrize("t", [9, 17])
def test_sparse_permutation_is_the_dense_one(t):
    p = rpos.Suite().width(t)
    rng = random.Random(t)
    for _ in range(3):
        s = [rng.randrange(P) for _ in range(t)]
        assert p.permute(s) == rpos.permute_dense(s, p)


def test_transcript_constants_match_the_ports_spec():
    from stark_mlwe_tpu_torch.spec.poseidon import generate_params_t17
    from stark_mlwe_tpu_torch.spec.transcript import default_params

    mine = rpos.Suite().transcript()
    theirs = default_params()
    assert mine.mds == theirs.mds and mine.rc_partial == theirs.rc_partial
    assert rpos.Suite().merkle_default().rc_full == \
        generate_params_t17(b"POSEIDON-T17-X5-SEED").rc_full


def _cols(seed, k):
    rng = witness.generator(seed, "stark-columns")
    return [witness.field_rows(rng, 1 << k) for _ in range(4)]


@pytest.mark.parametrize("k,schedule,workers", [
    (5, [8], 1), (7, [16, 4], 2), (11, [16, 16, 8], 1)])
def test_stark_reference_is_the_ports_proof(k, schedule, workers):
    from stark_mlwe_tpu_torch.fri import (DeviceDeepAliRealBuilder,
                                          deep_fri_prove)
    from stark_mlwe_tpu_torch.stark import DeepFriParams

    rows = _cols(k, k)
    r = 8 if k < 11 else 32
    port = deep_fri_prove(
        DeviceDeepAliRealBuilder(), *[witness.as_limbs_int32(c) for c in rows],
        1 << k, DeepFriParams(schedule=schedule, r=r, seed_z=0xDEEFBAAD),
        device="cpu")
    with Workers(workers) as w:
        ref = rstark.prove([mont_rows_to_ints(c) for c in rows], schedule, r,
                           0xDEEFBAAD, rpos.Suite(), w)
    a, b = canon.leaves(port), canon.leaves(ref)
    assert len(a) > 100 and canon.mismatches(a, b) == 0


@pytest.mark.parametrize("k", [3, 5])
def test_nizk_mf_reference_is_the_ports_proof(k):
    from stark_mlwe_tpu_torch.channel import prove_mf
    from stark_mlwe_tpu_torch.spec.channel import build_vk_mf

    vals = witness.as_ints(witness.field_rows(
        witness.generator(k, "nizk-values"), 1 << k))
    port = prove_mf(build_vk_mf(k, ds_tag=0xB0B, queries_per_round=3), vals,
                    device="cpu")
    with Workers(1) as w:
        ref = rmf.prove(vals, k, 0xB0B, 3, rpos.Suite(), w)
    a, b = canon.leaves(port), canon.leaves(ref)
    assert len(a) > 50 and canon.mismatches(a, b) == 0


class _Counting:
    """Counts the reference's permutations by width."""

    def __init__(self, monkeypatch):
        self.by_t = Counter()
        orig = rpos.Params.permute

        def permute(p, state):
            self.by_t[p.t] += 1
            return orig(p, state)

        monkeypatch.setattr(rpos.Params, "permute", permute)


@pytest.mark.parametrize("k,schedule", [(9, [16, 16]), (11, [16, 16, 8]),
                                        (9, [8, 4, 2])])
def test_frozen_stark_counts_are_the_commits(monkeypatch, k, schedule):
    c = _Counting(monkeypatch)
    rows = _cols(1, k)
    cols = [mont_rows_to_ints(x) for x in rows]
    with Workers(1) as w:
        f0 = rstark.f0_values(*cols, rstark.get_root_of_unity(1 << k), 12345)
        sizes, f = [1 << k], [f0]
        for m in schedule:
            f.append(rstark.fold(f[-1], 7, m))
        s_layers = [[f[i + 1][j // m] for j in range(len(f[i]))]
                    for i, m in enumerate(schedule)] + [[0] * len(f[-1])]
        for ell in range(len(schedule) + 1):
            rstark.commit_layer(ell, schedule[ell] if ell < len(schedule)
                                else 1, f[ell], s_layers[ell], rpos.Suite(),
                                w)
    work = roofline.work({"system": "stark", "schedule": schedule},
                         {"k": k, "witness": "host"})
    assert dict(c.by_t) == work["k1"]


def test_frozen_device_chain_counts():
    host = roofline.work({"system": "stark", "schedule": [16, 16, 8]},
                         {"k": 16, "witness": "host"})
    dev = roofline.work({"system": "stark", "schedule": [16, 16, 8]},
                        {"k": 16, "witness": "device"})
    assert dev["k1"][17] == host["k1"][17] + 4
    # 2^16 fields after a 4-field prefix: 12 fill the first block, 4095
    # whole blocks follow, 4 are left for the challenge
    assert dev["k4"] == {17: 4 * 4095}


@pytest.mark.parametrize("k", [4, 6])
def test_frozen_nizk_counts_are_the_trees(monkeypatch, k):
    c = _Counting(monkeypatch)
    vals = list(range(1, (1 << k) + 1))
    with Workers(1) as w:
        for j in range(k + 1):
            rmerkle.MerkleTree(vals[:1 << j], 16,
                               rpos.Suite().merkle_default(), 5, w)
    work = roofline.work({"system": "nizk_mf"}, {"k": k})
    assert work["k1"][17] == c.by_t[17] + k      # + the k round challenges


def test_bound_is_set_by_operations():
    sec, by = roofline.bound_seconds({17: 79172, 9: 137})
    assert by == "operations"
    macs = 79172 * 122040 + 137 * roofline.permute_macs(9)
    assert sec == pytest.approx(macs * 8 / 67e12)
