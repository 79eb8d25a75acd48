"""The port's `serde`, legacy Merkle pieces, Merkle facades and small
commitment trees against the JAX package, on the CPU.

Every comparison is exact (field elements and bytes, tolerance 0).  The
port's trees are built with its plain K1 (`device="cpu"` tensors); its
verifiers hash a proof's few rows in the host engine, and the legacy
verifier is also driven through its device branch.  Inputs come from a
seeded `random.Random`.
"""

import random

import jax.numpy as jnp
import pytest
import torch

from stark_mlwe_tpu import merkle as jmk
from stark_mlwe_tpu import serde as jserde
from stark_mlwe_tpu.ops import fr as jfr
from stark_mlwe_tpu.spec import merkle as jsmk
from stark_mlwe_tpu_torch import merkle as tmk
from stark_mlwe_tpu_torch import serde
from stark_mlwe_tpu_torch.ops import fr
from stark_mlwe_tpu_torch.spec import merkle as smk
from stark_mlwe_tpu_torch.spec.field import P
import torch_port_util  # noqa: F401  (one torch thread per test worker)

CPU = "cpu"
rng = random.Random(0x5EDE)


def rand_elems(n):
    return [rng.randrange(P) for _ in range(n)]


def port_mont(xs):
    return fr.to_device(fr.pack_ints(xs, mont=True), CPU)


def jax_mont(xs):
    return jnp.asarray(jfr.pack_ints(xs, mont=True))


def jax_cfg(cfg):
    return jsmk.MerkleChannelCfg.new(cfg.arity, tree_label=cfg.tree_label)


def jax_levels(tree) -> list:
    """A JAX device tree's levels as canonical ints, converted on the host
    (no XLA compile per level length)."""
    return [jfr.unpack_ints(lv, mont=True) for lv in tree.levels_dev]


def port_levels(tree) -> list:
    return [tree.level_ints(i) for i in range(tree.height() + 1)]


# ---------------------------------------------------------------------------
# serde: the three cases of the JAX package's tests/test_serde.py.
# ---------------------------------------------------------------------------

def test_spec_tree_roundtrip_serves_opens():
    cfg = smk.MerkleChannelCfg.new(16, tree_label=7)
    leaves = rand_elems(55)  # not a power of two on purpose
    tree = smk.MerkleTree.new(leaves, cfg)
    buf = serde.serialize_tree(tree)
    assert buf == jserde.serialize_tree(
        jsmk.MerkleTree.new(leaves, jax_cfg(cfg)))
    tree2 = serde.deserialize_tree(buf, cfg=cfg)
    assert tree2.root() == tree.root()
    assert tree2.levels == tree.levels
    idx = [0, 3, 17, 54]
    proof = tree2.open_many(idx)
    vals = [leaves[i] for i in idx]
    assert smk.verify_many_ds(tree.root(), idx, vals, proof,
                              cfg.tree_label, cfg.params)
    assert tmk.verify_many_ds(tree.root(), idx, vals, proof,
                              cfg.tree_label, cfg.params, device=CPU)
    assert serde.serialize_tree(tree2) == buf
    with pytest.raises(ValueError, match="trailing"):
        serde.deserialize_tree(buf + b"\0", cfg=cfg)


def test_device_tree_roundtrip_equals_jax_device_tree():
    cfg = smk.MerkleChannelCfg.new(4, tree_label=3)
    leaves = rand_elems(64)
    dtree = tmk.build_tree(port_mont(leaves), cfg)
    buf = serde.serialize_tree(dtree)
    jtree = jmk.build_tree(jax_mont(leaves), jax_cfg(cfg))
    assert buf == jserde.serialize_tree(jtree)
    tree2 = serde.deserialize_tree(buf, cfg=cfg)
    assert tree2.root() == dtree.root()
    assert serde.serialize_tree(smk.MerkleTree.new(leaves, cfg)) == buf


def test_merkle_proof_roundtrip():
    cfg = smk.MerkleChannelCfg.new(8, tree_label=0)
    leaves = rand_elems(64)
    tree = smk.MerkleTree.new(leaves, cfg)
    idx = [1, 9, 33]
    proof = tree.open_many(idx)
    buf = serde.serialize_merkle_proof(proof)
    assert buf == jserde.serialize_merkle_proof(
        jsmk.MerkleTree.new(leaves, jax_cfg(cfg)).open_many(idx))
    p2 = serde.deserialize_merkle_proof(buf)
    assert (p2.indices, p2.siblings, p2.group_sizes, p2.arity) == \
        (proof.indices, proof.siblings, proof.group_sizes, proof.arity)
    vals = [leaves[i] for i in idx]
    assert smk.verify_many_ds(tree.root(), idx, vals, p2, cfg.tree_label,
                              cfg.params)


# ---------------------------------------------------------------------------
# Legacy trees (the JAX package's tests/test_merkle_device.py legacy cases).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def legacy():
    n = 55
    leaves = rand_elems(n)
    ds_tag = rng.randrange(1 << 64)  # the tree's serde writes it as a u64
    params = smk.default_params()
    tree = tmk.build_tree_legacy(port_mont(leaves), ds_tag, params)
    jtree = jmk.build_tree_legacy(jax_mont(leaves), ds_tag,
                                  jsmk.default_params())
    return leaves, ds_tag, params, tree, jtree


def test_legacy_tree_equals_jax_and_spec(legacy):
    leaves, ds_tag, params, tree, jtree = legacy
    want = smk.MerkleTree.new_legacy(leaves, ds_tag, params)
    assert tree.root() == jtree.root() == want.root()
    assert (tree.arity, tree.ds_tag, tree.params) == (16, ds_tag, params)
    assert tree.cfg is None
    buf = serde.serialize_tree(tree)
    assert buf == jserde.serialize_tree(jtree) == serde.serialize_tree(want)
    back = serde.deserialize_tree(buf, params=params)
    assert back.ds_tag == ds_tag and back.levels == want.levels


@pytest.mark.parametrize("branch", ["host engine", "device"])
def test_legacy_open_and_verify(legacy, branch, monkeypatch):
    leaves, ds_tag, params, tree, jtree = legacy
    if branch == "device":
        monkeypatch.setattr(tmk, "_NATIVE_CUTOFF", 0)
    idx = [2, 16, 54]
    proof = tree.open_many(idx)
    jproof = jtree.open_many(idx)
    assert (proof.indices, proof.siblings, proof.group_sizes) == \
        (jproof.indices, jproof.siblings, jproof.group_sizes)
    vals = [leaves[i] for i in idx]
    assert smk.verify_many(tree.root(), idx, vals, proof, ds_tag, params)
    assert tmk.verify_many_legacy(tree.root(), idx, vals, proof, ds_tag,
                                  params, device=CPU)
    assert jmk.verify_many_legacy(tree.root(), idx, vals, jproof, ds_tag,
                                  jsmk.default_params())
    bad = [vals[0], (vals[1] + 1) % P, vals[2]]
    assert not tmk.verify_many_legacy(tree.root(), idx, bad, proof, ds_tag,
                                      params, device=CPU)


def test_legacy_pairs_prover_equals_jax():
    n = 20
    f_vals, cp_vals = rand_elems(n), rand_elems(n)
    ds_tag = rng.randrange(P)
    params = smk.default_params()
    want = smk.MerkleTree.new_pairs_legacy(f_vals, cp_vals, ds_tag, params)
    prover = tmk.LegacyMerkleProver(ds_tag, params, device=CPU)
    root, tree = prover.commit_pairs(f_vals, cp_vals)
    jroot, jtree = jmk.LegacyMerkleProver(
        ds_tag, jsmk.default_params()).commit_pairs(f_vals, cp_vals)
    assert root == jroot == want.root()
    assert port_levels(tree) == jax_levels(jtree) == want.levels
    idx = [0, 7, 19]
    pairs, proof = prover.open_pairs(tree, f_vals, cp_vals, idx)
    assert pairs == [(f_vals[i], cp_vals[i]) for i in idx]
    assert prover.verify_pairs(root, idx, pairs, proof)
    assert smk.verify_pairs_legacy(root, idx, pairs, proof, ds_tag, params)
    bad = [pairs[0], (pairs[1][0], (pairs[1][1] + 1) % P), pairs[2]]
    assert not prover.verify_pairs(root, idx, bad, proof)


def test_ds_prover_facade_equals_spec():
    cfg = smk.MerkleChannelCfg.new(8, tree_label=11)
    n = 40
    f_vals, cp_vals = rand_elems(n), rand_elems(n)
    prover = tmk.MerkleProver(cfg, device=CPU)
    root, tree = prover.commit_single(f_vals)
    assert root == smk.MerkleTree.new(f_vals, cfg).root()
    idx = [1, 8, 39]
    proof = prover.open_single(tree, idx)
    assert prover.verify_single(root, idx, [f_vals[i] for i in idx], proof)
    proot, ptree = prover.commit_pairs(f_vals, cp_vals)
    assert proot == smk.MerkleTree.new_pairs(f_vals, cp_vals, cfg).root()
    pairs, pproof = prover.open_pairs(ptree, f_vals, cp_vals, idx)
    assert prover.verify_pairs(proot, idx, pairs, pproof)
    assert not prover.verify_pairs(proot, idx, pairs[::-1], pproof)


# ---------------------------------------------------------------------------
# Small commitment trees (arity 16): the DS padding of `build_levels_from`.
# ---------------------------------------------------------------------------

# Powers of two from 2^0 (the MF chain's last layers), a ragged last group
# of one block (<= 11 children) and of two (12-15), full groups, two
# levels with ragged groups on both.
SMALL_SIZES = [1, 2, 3, 4, 5, 8, 11, 12, 15, 16, 17, 27, 31, 32, 33, 40]


@pytest.mark.parametrize("n", SMALL_SIZES)
def test_small_commitment_tree_equals_jax(n):
    cfg = smk.MerkleChannelCfg.new(16, tree_label=0xB0B)
    leaves = rand_elems(n)
    tree = tmk.build_tree(port_mont(leaves), cfg)
    jtree = jmk.build_tree(jax_mont(leaves), jax_cfg(cfg))
    want = smk.MerkleTree.new(leaves, cfg)
    assert port_levels(tree) == jax_levels(jtree) == want.levels
    assert serde.serialize_tree(tree) == jserde.serialize_tree(want)
    for t in tree.levels_dev:
        assert t.device == torch.device(CPU) and t.dtype == torch.int32
