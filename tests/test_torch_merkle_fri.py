"""Port Merkle engine and FRI building blocks vs the JAX package.

Tree levels, leaf hashes and the DEEP-ALI merge go through both packages
on the same numpy-seeded inputs; tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_mlwe_tpu import merkle as jmk
from stark_mlwe_tpu.fri import deep_ali as jdali
from stark_mlwe_tpu.fri import fs as jfs
from stark_mlwe_tpu.spec import merkle as jsmk
from stark_mlwe_tpu_torch import merkle as tmk
from stark_mlwe_tpu_torch.fri import deep_ali as tdali
from stark_mlwe_tpu_torch.fri import fold_layer_dev, s_layer_dev
from stark_mlwe_tpu_torch.fri import fs as tfs
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.spec import deep_ali as sdali
from stark_mlwe_tpu_torch.spec import fri as sfri
from stark_mlwe_tpu_torch.spec import merkle as smk
from stark_mlwe_tpu_torch.spec.field import P, get_root_of_unity

from torch_port_util import jax_limbs, port_tensor, rand_ints, same


@pytest.mark.parametrize("n,arity", [(18, 16), (10, 8)])
def test_build_tree_levels_match_jax(n, arity):
    """Arity 16 and 8 with a ragged last group (18 = 16 + 2, 10 = 8 + 2):
    every level equals the JAX package's.  The ragged group and the top
    level both hash two children, so the JAX side compiles two sponge
    shapes per tree, not three."""
    leaves = rand_ints(70 + arity, n)
    tree = tmk.build_tree(port_tensor(leaves, mont=True),
                          smk.MerkleChannelCfg.new(arity, tree_label=7))
    jtree = jmk.build_tree(jnp.asarray(jax_limbs(leaves, mont=True)),
                           jsmk.MerkleChannelCfg.new(arity, tree_label=7))
    assert len(tree.levels_dev) == len(jtree.levels_dev)
    for lvl, jlvl in zip(tree.levels_dev, jtree.levels_dev):
        assert same(lvl, jlvl)
    assert tree.root() == jtree.root()


def test_build_tree_pairs_arity2_matches_jax_and_spec():
    """The final FRI layer's tree: pair leaves under LEAF_LEVEL_DS, arity 2,
    with a ragged last group on the way up (3 -> 2 -> 1)."""
    f, cp = rand_ints(81, 3), rand_ints(82, 3)
    cfg = smk.MerkleChannelCfg.new(2, tree_label=3)
    tree = tmk.build_tree_pairs(port_tensor(f, mont=True),
                                port_tensor(cp, mont=True), cfg)
    jtree = jmk.build_tree_pairs(jnp.asarray(jax_limbs(f, mont=True)),
                                 jnp.asarray(jax_limbs(cp, mont=True)),
                                 jsmk.MerkleChannelCfg.new(2, tree_label=3))
    for lvl, jlvl in zip(tree.levels_dev, jtree.levels_dev):
        assert same(lvl, jlvl)
    want = smk.MerkleTree.new_pairs(f, cp, cfg)
    assert tree.root() == want.root()


def test_ds_rows_device_matches_host_rows():
    got = tmk.ds_rows_device(16, smk.LEAF_LEVEL_DS, 5, 2,
                             torch.device("cpu"), start=3)
    want = tmk.ds_rows_mont(16, smk.LEAF_LEVEL_DS, np.arange(3, 8), 2)
    assert np.array_equal(got.numpy(), want)
    assert same(got, jmk.ds_rows_mont(16, jsmk.LEAF_LEVEL_DS,
                                      np.arange(3, 8), 2))


def test_open_and_verify_many_ds_with_tamper():
    n, arity = 40, 16
    leaves = rand_ints(90, n)
    cfg = smk.MerkleChannelCfg.new(arity, tree_label=5)
    tree = tmk.build_tree(port_tensor(leaves, mont=True), cfg)
    idxs = [3, 17, 18, 39]
    proof = tree.open_many(idxs)
    want = smk.MerkleTree.new(leaves, cfg).open_many(idxs)
    assert (proof.indices, proof.siblings, proof.group_sizes) == (
        want.indices, want.siblings, want.group_sizes)
    # the plan alone (no values) lists the same sibling positions
    plan = tree.open_plan(idxs)
    assert [len(s) for s in plan[1]] == [len(s) for s in want.siblings]
    vals = [leaves[i] for i in idxs]
    root = tree.root()
    assert tmk.verify_many_ds(root, idxs, vals, proof, 5, cfg.params,
                              device="cpu")
    assert smk.verify_many_ds(root, idxs, vals, proof, 5, cfg.params)
    bad = list(vals)
    bad[1] = (bad[1] + 1) % P
    assert not tmk.verify_many_ds(root, idxs, bad, proof, 5, cfg.params,
                                  device="cpu")
    assert not tmk.verify_many_ds(root, idxs, vals, proof, 6, cfg.params,
                                  device="cpu")


def test_verify_pairs_ds():
    f, cp = rand_ints(91, 8), rand_ints(92, 8)
    cfg = smk.MerkleChannelCfg.new(2, tree_label=1)
    tree = tmk.build_tree_pairs(port_tensor(f, mont=True),
                                port_tensor(cp, mont=True), cfg)
    idxs = [0, 5]
    proof = tree.open_many(idxs)
    pairs = [(f[i], cp[i]) for i in idxs]
    assert tmk.verify_pairs_ds(tree.root(), idxs, pairs, proof, 1,
                               cfg.params, device="cpu")
    pairs[0] = (pairs[0][0], (pairs[0][1] + 1) % P)
    assert not tmk.verify_pairs_ds(tree.root(), idxs, pairs, proof, 1,
                                   cfg.params, device="cpu")


def test_large_batches_take_the_device_route(monkeypatch):
    """Above the host cutoff the verifier's hashing batches on the device
    given; both routes give the same digests."""
    cfg = smk.MerkleChannelCfg.new(8, tree_label=2)
    entries = [(i, rand_ints(100 + i, 8)) for i in range(3)]
    host = tmk._hash_groups_ds(entries, 8, 1, 2, cfg.params, device="cpu")
    monkeypatch.setattr(tmk, "_NATIVE_CUTOFF", 0)
    assert tmk._hash_groups_ds(entries, 8, 1, 2, cfg.params,
                               device="cpu") == host
    pairs = [tuple(rand_ints(110 + i, 2)) for i in range(3)]
    host = tfs.hash_leaf_pairs_ints(pairs, device="cpu")
    monkeypatch.setattr(tfs, "NATIVE_BATCH_CUTOFF", 0)
    assert tfs.hash_leaf_pairs_ints(pairs, device="cpu") == host
    rows = [[1, 2, 3], [4, 5, 6]]
    want = [sfri.tr_hash_fields_tagged(b"FRI/index", r) for r in rows]
    assert tfs.one_block_tagged_hash_batch(b"FRI/index", rows,
                                           device="cpu") == want


def test_hash_leaf_pairs_dev_matches_jax():
    n = 5
    f, s = rand_ints(120, n), rand_ints(121, n)
    got = tfs.hash_leaf_pairs_dev(port_tensor(f, mont=True),
                                  port_tensor(s, mont=True))
    want = jfs.hash_leaf_pairs_dev(jnp.asarray(jax_limbs(f, mont=True)),
                                   jnp.asarray(jax_limbs(s, mont=True)))
    assert same(got, want)
    assert tfr.unpack_ints(got, mont=True) == [
        sfri.hash_leaf_pair(a, b) for a, b in zip(f, s)]


def test_merge_evals_device_matches_jax():
    n = 8
    omega = get_root_of_unity(n)
    cols = [rand_ints(130 + i, n) for i in range(4)]
    z = rand_ints(136, 1)[0]
    tcols = [port_tensor(c, mont=True) for c in cols]
    f0, _, c_star = tdali.merge_evals_device(*tcols, omega, z)
    jf0, _, jc_star = jdali.merge_evals_device(
        *[jnp.asarray(jax_limbs(c, mont=True)) for c in cols], omega, z)
    assert same(f0, jf0)
    assert c_star == jc_star
    # the prover's split form (host phi, then the quotient) is the same f0
    f0b = tdali.f0_from_phi(tdali.phi_kernel(*tcols),
                            tdali.omega_powers(omega, n, "cpu"), z)
    assert torch.equal(f0, f0b)
    f0c, _, _ = tdali.merge_evals_device(*tcols, omega, z, with_c_star=False)
    assert torch.equal(f0, f0c)


def test_merge_evals_device_blinded_matches_spec():
    n = 16
    omega = get_root_of_unity(n)
    cols = [rand_ints(130 + i, n) for i in range(4)]
    r_col = rand_ints(135, n)
    z, beta = rand_ints(136, 2)
    tcols = [port_tensor(c, mont=True) for c in cols]
    r_t = port_tensor(r_col, mont=True)
    f0, _, c_star = tdali.merge_evals_device(*tcols, omega, z, r_eval=r_t,
                                             beta=beta)
    want_f0, _, want_c = sdali.deep_ali_merge_evals_blinded(
        *cols, r_col, beta, omega, z)
    assert tfr.unpack_ints(f0, mont=True) == want_f0
    assert c_star == want_c
    f0b = tdali.f0_from_phi(tdali.phi_kernel(*tcols),
                            tdali.omega_powers(omega, n, "cpu"), z,
                            beta=beta, r_eval=r_t)
    assert torch.equal(f0, f0b)


def test_fold_and_s_layer_match_spec():
    m, n = 8, 32
    f = rand_ints(140, n)
    z = rand_ints(141, 1)[0]
    folded = fold_layer_dev(port_tensor(f, mont=True), z, m)
    assert tfr.unpack_ints(folded, mont=True) == sfri.fri_fold_layer(f, z, m)
    s = s_layer_dev(port_tensor(f, mont=True), folded, m)
    assert tfr.unpack_ints(s, mont=True) == sfri.compute_s_layer(f, z, m)


def test_mock_builder_matches_spec():
    from stark_mlwe_tpu_torch.fri import DeviceDeepAliMock
    n = 16
    cols = [rand_ints(150 + i, n) for i in range(4)]
    dom = sfri.FriDomain.new_radix2(n)
    got = DeviceDeepAliMock().build_f0(*cols, n, dom, device="cpu")
    want = sfri.DeepAliMock().build_f0(*cols, n, dom)
    assert tfr.unpack_ints(got, mont=True) == want
