"""The port's sponge chains and its device-resident-witness prove path.

`ops.poseidon.absorb_chain` (the chain kernel's wrapper; on the CPU its plain
version) against the Pallas kernel `absorb_chain` of the JAX package in
interpret mode; `fri.fs.tagged_hash_vecs`, four chains, against the JAX
package's, which on the CPU runs `absorb_blocks`, the plain reference of
both its Pallas chain kernels, and against the host engine; `absorb_chain`
at the lane-parallel Pallas kernel's test shape (4 chains, one block)
against that kernel's own reference, in and out of its lane layout (the
kernel's interpret run takes three quarters of a minute for one block and
stays with the JAX package's tests); the legacy sponge; and the
prover's device branch as a whole.  Inputs come from numpy seeds;
tolerance: exact (field elements).
"""

import hashlib
import json
import os

import pytest
import torch

import jax.numpy as jnp

from stark_mlwe_tpu.fri import fs as jfs
from stark_mlwe_tpu.ops import poseidon as jpos
from stark_mlwe_tpu.ops import poseidon_chain as pch
from stark_mlwe_tpu.ops import poseidon_pallas as jpp
from stark_mlwe_tpu.spec import poseidon as jspos
import stark_mlwe_tpu_torch.fri as tfri
import stark_mlwe_tpu_torch.stark as tstark
from stark_mlwe_tpu_torch.fri import fs as tfs
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.ops import poseidon as tpos
from stark_mlwe_tpu_torch.spec import poseidon as spos
from stark_mlwe_tpu_torch.spec.field import P

from torch_port_util import jax_limbs, port_tensor, rand_ints, same

T, RATE = 17, 16
TAGS = [b"ALI/A", b"ALI/S", b"ALI/E", b"ALI/T"]


def _chain_inputs(seed, C, nb, off):
    """Initial states [C, T] and columns [C, off + nb*RATE + 1] as ints (one
    spare row on each side of the blocks when off > 0)."""
    init = [rand_ints(seed + c, T) for c in range(C)]
    cols = [rand_ints(seed + 10 + c, off + nb * RATE + 1) for c in range(C)]
    return init, cols


def _port_chain(init, cols, off, nb):
    C = len(init)
    dp = tpos.device_params(spos.params_for_width(T))
    return tpos.absorb_chain(
        port_tensor(sum(init, []), mont=True).reshape(C, T, 8),
        torch.stack([port_tensor(c, mont=True) for c in cols]), off, nb, dp)


def test_absorb_chain_matches_pallas_absorb_chain_interpret():
    """C=2 chains of nb=2 blocks from a non-zero state, read at an offset
    inside the columns; the Pallas kernel takes them batch-last."""
    C, nb, off = 2, 2, 3
    init, cols = _chain_inputs(300, C, nb, off)
    got = _port_chain(init, cols, off, nb)
    jdp = jpos.device_params(jspos.params_for_width(T))
    init_bl = jnp.moveaxis(jnp.asarray(
        jax_limbs(sum(init, []), mont=True)).reshape(C, T, 16), 0, -1)
    blocks = jnp.asarray(jax_limbs(
        sum((c[off:off + nb * RATE] for c in cols), []),
        mont=True)).reshape(C, nb, RATE, 16)
    want = jpp.absorb_chain(init_bl, jnp.moveaxis(blocks, 0, -1), jdp,
                            interpret=True)          # [T, 16, C]
    assert same(got, jnp.moveaxis(want, -1, 0))
    # and the spec, one chain
    st = list(init[0])
    for b in range(nb):
        for i in range(RATE):
            st[i] = (st[i] + cols[0][off + b * RATE + i]) % P
        st = spos.permute(st, spos.params_for_width(T))
    assert tfr.unpack_ints(got[0], mont=True) == st


def test_absorb_chain_matches_lane_kernel_reference():
    """C=4 chains of one block from the zero state: the shape at which the
    JAX package holds `poseidon_chain.absorb_chain_lanes` to the spec.  The
    inputs go through that kernel's lane layout (`pack_lanes`, lane
    32*c + i) before they reach the port, the result goes back into it, and
    the oracle is the kernel's own: add the block, `spec.poseidon.permute`."""
    C, nb = 4, 1
    jparams = jspos.params_for_width(T)
    fields = [rand_ints(320 + c, nb * RATE) for c in range(C)]
    want = []
    for c in range(C):
        st = [0] * T
        for i in range(RATE):
            st[i] = (st[i] + fields[c][i]) % P
        want.append(jspos.permute(st, jparams))
    lanes = pch.pack_lanes(fields)                       # [16, 128] uint32
    cols = pch.unpack_lanes(lanes, RATE, C)
    assert cols == fields
    got = _port_chain([[0] * T] * C, cols, 0, nb)
    got_ints = [tfr.unpack_ints(got[c], mont=True) for c in range(C)]
    assert got_ints == want
    assert same(got, jnp.stack([
        jnp.asarray(pch.pack_lanes(got_ints))[:, c * pch.STRIDE:
                                              c * pch.STRIDE + T].T
        for c in range(C)]))


def test_absorb_chain_rejects_wrong_inputs():
    dp = tpos.device_params(spos.params_for_width(T))
    st = torch.zeros((2, T, 8), dtype=torch.int32)
    cols = torch.zeros((2, 40, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tpos.absorb_chain(st, cols, 10, 2, dp)         # 10 + 32 > 40 rows
    with pytest.raises(TypeError):
        tpos.absorb_chain(st, cols[:1], 0, 1, dp)      # one column short
    with pytest.raises(TypeError):
        tpos.absorb_chain(st[:, :9], cols, 0, 1, dp)   # wrong width
    assert torch.equal(tpos.absorb_chain(st, cols, 0, 0, dp), st)


def test_tagged_hash_vecs_matches_jax_and_host_engine():
    """n = 40 rows behind a 4-field prefix: a head of 12, two full blocks
    through `absorb_chain`, a tail of 4 - and two shorter columns that end
    inside the head and exactly on a block boundary."""
    cols = [rand_ints(340 + i, 40) for i in range(4)]
    stacked = torch.stack([port_tensor(c, mont=True) for c in cols])
    got = tfs.tagged_hash_vecs(TAGS, stacked)
    assert got == jfs.tagged_hash_vecs(
        TAGS, jnp.stack([jnp.asarray(jax_limbs(c, mont=True))
                         for c in cols]))
    for n in (40, 5, 12 + RATE):
        assert tfs.tagged_hash_vecs(TAGS, stacked[:, :n]) == \
            tfs.tagged_hash_cols_native(
                TAGS, [tfr.to_u64(tfr.pack_ints(c[:n], mont=True))
                       for c in cols])


def test_sponge_hash_ds_legacy_matches_jax_and_spec():
    """t = 9, k = 11 inputs: one full rate block and a remainder of 3."""
    B, k, tag = 5, 11, 77
    params, jparams = spos.params_for_width(9), jspos.params_for_width(9)
    inp = [rand_ints(360 + i, k) for i in range(B)]
    got = tpos.sponge_hash_ds_legacy(
        port_tensor(sum(inp, []), mont=True).reshape(B, k, 8),
        port_tensor([tag], mont=True)[0], tpos.device_params(params))
    want = jpos.sponge_hash_ds_legacy(
        jnp.asarray(jax_limbs(sum(inp, []), mont=True)).reshape(B, k, 16),
        jnp.asarray(jax_limbs([tag], mont=True)[0]),
        jpos.device_params(jparams))
    assert same(got, want)
    assert tfr.unpack_ints(got, mont=True) == [
        spos.hash_with_ds(row, tag, params) for row in inp]


def test_device_branch_proof_equals_golden_small_entry():
    """The slice as a whole: k=6, [8,4], the columns handed over as tensors
    and sent down the device branch (`tagged_hash_vecs` -> ALI/seed ->
    `merge_evals_device`).  The proof must be the JAX package's recorded
    one, which `test_torch_stark_e2e.py` also holds the host branch to."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "torch_golden.json")
    with open(path) as f:
        ent = {e["name"]: e for e in json.load(f)["entries"]}["small_k6"]
    w = tstark.MlweWitness.random(k=ent["k"], seed=ent["seed"])
    params = tstark.DeepFriParams(schedule=ent["schedule"], r=ent["r"],
                                  seed_z=ent["seed_z"])
    ali = tfri.DeviceDeepAliRealBuilder(device_columns=True)
    proof = tfri.deep_fri_prove(ali, *w.to_device("cpu"), 1 << ent["k"],
                                params, device="cpu")
    buf = tstark.serialize_proof(proof)
    assert len(buf) == ent["proof_bytes"]
    assert hashlib.sha256(buf).hexdigest() == ent["sha256"]
    assert "ali/column_hashes" in tfri.phase_seconds
    assert "ali/host_absorb" not in tfri.phase_seconds
    assert tstark.verify(params, proof, device="cpu")


def test_mock_f0_device_branch_matches_host_branch():
    from stark_mlwe_tpu_torch.spec import fri as sfri
    n = 16
    cols = [rand_ints(380 + i, n) for i in range(4)]
    dom = sfri.FriDomain.new_radix2(n)
    got = tfri.DeviceDeepAliMock(device_columns=True).build_f0(
        *[port_tensor(c, mont=True) for c in cols], n, dom, device="cpu")
    want = tfri.DeviceDeepAliMock().build_f0(*cols, n, dom, device="cpu")
    assert torch.equal(got, want)
