"""The port at the wide Poseidon widths t = 33, 65, 129 (Merkle arities 32,
64, 128), on the CPU through the plain versions.

`ops.poseidon.permute` against the pure-int spec and against the JAX
package's `lax.scan` route at every wide width (the JAX package's interpret
runs of the wide Pallas kernel take minutes and are not repeated here); the
kernels' own source, compiled with g++, against the spec; and
`stark.prove` / `stark.verify` at one schedule per wide width against the
JAX package's recorded proofs.  Tolerance: exact (field elements).
"""

import hashlib
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from stark_mlwe_tpu.ops import poseidon as jpos
from stark_mlwe_tpu.spec import poseidon as jspos
import stark_mlwe_tpu_torch.stark as tstark
from stark_mlwe_tpu_torch import convert, native
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.ops import poseidon as tpos
from stark_mlwe_tpu_torch.spec import poseidon as spos
from stark_mlwe_tpu_torch.spec.field import P

from torch_port_util import (host_check_lib, jax_limbs, port_tensor,
                             rand_ints, same)

WIDE = [33, 65, 129]
B = 2


def _states(t):
    return rand_ints(400 + t, t) + [P - 1] * t


@pytest.mark.parametrize("t", WIDE)
def test_permute_wide_matches_spec_and_host_engine(t):
    params = spos.params_for_width(t)
    xs = _states(t)
    got = tpos.permute(port_tensor(xs, mont=True).reshape(B, t, 8),
                       tpos.device_params(params))
    want = [spos.permute(xs[b * t:(b + 1) * t], params) for b in range(B)]
    assert tfr.unpack_ints(got, mont=True) == sum(want, [])
    assert native.permute_ints_batch([xs[:t], xs[t:]], params) == want


def _permute_matches_jax(t):
    xs = _states(t)
    got = tpos.permute(port_tensor(xs, mont=True).reshape(B, t, 8),
                       tpos.device_params(spos.params_for_width(t)))
    want = jpos.permute(
        jnp.asarray(jax_limbs(xs, mont=True)).reshape(B, t, 16),
        jpos.device_params(jspos.params_for_width(t)))
    assert same(got, want)


def test_permute_t33_matches_jax():
    _permute_matches_jax(33)


@pytest.mark.parametrize("t", [65, 129])
def test_permute_dense_widths_match_jax(t):
    """t = 65 and 129, where the JAX package's kernels run a dense matrix in
    every round: its `lax.scan` route on the same two states."""
    _permute_matches_jax(t)


@pytest.mark.parametrize("t", WIDE)
def test_group_kernel_source_permutation_on_host(t):
    """K5's routine (csrc/poseidon_group.cuh: states packed into a block, or
    rows split over threads and blocks, the partial rounds' owners in a warp
    of their own), compiled with g++ and replayed in the kernel's order in
    the layout `group_layout` gives B states, against the spec."""
    params = spos.params_for_width(t)
    xs = _states(t)
    consts = [np.ascontiguousarray(c.numpy())
              for c in tpos.device_params(params).group_consts("cpu")]
    buf = np.ascontiguousarray(tfr.pack_ints(xs, mont=True))
    rc = host_check_lib().hc_permute_group(
        buf.ctypes.data, B, t, *tpos.group_layout(B, t), params.rf,
        params.rp, *[c.ctypes.data for c in consts])
    assert rc == 0
    assert tfr.unpack_ints(buf, mont=True) == sum(
        [spos.permute(xs[b * t:(b + 1) * t], params) for b in range(B)], [])


def test_group_constants_are_the_transposed_packs():
    params = spos.params_for_width(33)
    dp = tpos.device_params(params)
    mds, rcf, rcp, qrow, qcol, mfin = dp.kernel_consts("cpu")
    g = dp.group_consts("cpu")
    assert np.array_equal(g[0].numpy()[3, 5], mds.reshape(33, 33, 8)[5, 3])
    assert np.array_equal(g[5].numpy()[0, 32], mfin.reshape(33, 33, 8)[32, 0])
    for a, b in zip(g[1:5], (rcf, rcp, qrow, qcol)):
        assert a is b
    assert (params.rp, qrow.shape[0], qcol.shape[0]) == (68, 67 * 33, 67 * 32)


def test_params_from_numpy_round_trip_t33():
    jparams = jspos.params_for_width(33)
    jdp = jpos.device_params(jparams)
    back = convert.params_from_numpy(jdp.mds_scaled, jdp.rc_full,
                                     jdp.rc_part, jdp.t, jdp.rate, jdp.rf,
                                     jdp.rp)
    params = spos.params_for_width(33)
    assert (back.mds, back.rc_full, back.rc_partial) == (
        params.mds, params.rc_full, params.rc_partial)


@pytest.mark.parametrize("name", ["wide32_k6", "wide64_k7", "wide128_k8"])
def test_wide_schedule_proof_equals_golden(name):
    """One schedule per wide width at a small k, four random columns: the
    port's proof is byte-equal to the JAX package's recorded one
    (tests/data/torch_golden.json), verifies, and a flipped byte in a root
    is refused."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "torch_golden.json")
    with open(path) as f:
        ent = {e["name"]: e for e in json.load(f)["entries"]}[name]
    w = tstark.MlweWitness.random_unstructured(k=ent["k"], seed=ent["seed"])
    params = tstark.DeepFriParams(schedule=ent["schedule"], r=ent["r"],
                                  seed_z=ent["seed_z"])
    proof = tstark.prove(w, params, device="cpu")
    buf = tstark.serialize_proof(proof)
    assert len(buf) == ent["proof_bytes"]
    assert hashlib.sha256(buf).hexdigest() == ent["sha256"]
    assert tstark.verify(params, proof, device="cpu")
    bad = bytearray(buf)
    bad[8 + 32 + 8 + 3] ^= 1
    assert not tstark.verify(params, tstark.deserialize_proof(bytes(bad)),
                             device="cpu")
