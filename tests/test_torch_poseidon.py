"""Port Poseidon (stark_mlwe_tpu_torch.ops.poseidon) vs the JAX package.

The JAX `ops.poseidon.permute` takes its `lax.scan` route on the CPU, which
is the plain reference of the Pallas kernel the port's CUDA kernel replaces;
`spec.poseidon` is a second oracle.  Tolerance: exact.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from stark_mlwe_tpu.ops import poseidon as jpos
from stark_mlwe_tpu.spec import merkle as jsmk
from stark_mlwe_tpu.spec import transcript as jstr
from stark_mlwe_tpu_torch import convert, native
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.ops import poseidon as tpos
from stark_mlwe_tpu_torch.spec import merkle as smk
from stark_mlwe_tpu_torch.spec import poseidon as spos
from stark_mlwe_tpu_torch.spec import transcript as strn
from stark_mlwe_tpu_torch.spec.field import P

from torch_port_util import (host_check_lib, jax_limbs, port_tensor,
                             rand_ints, same, u64p)

B = 5       # not a power of two


def _params(which):
    """(port spec params, JAX-package spec params) of one width."""
    if which == "t17":
        return strn.default_params(), jstr.default_params()
    return (smk.MerkleChannelCfg.new(8).params,
            jsmk.MerkleChannelCfg.new(8).params)


@pytest.mark.parametrize("which", ["t17", "t9"])
def test_permute_matches_jax_and_spec(which):
    params, jparams = _params(which)
    t = params.t
    xs = rand_ints(40 + t, (B - 1) * t) + [P - 1] * t
    got = tpos.permute(port_tensor(xs, mont=True).reshape(B, t, 8),
                       tpos.device_params(params))
    want = jpos.permute(
        jnp.asarray(jax_limbs(xs, mont=True)).reshape(B, t, 16),
        jpos.device_params(jparams))
    assert same(got, want)
    ints = tfr.unpack_ints(got, mont=True)
    for b in (0, B - 1):
        assert ints[b * t:(b + 1) * t] == spos.permute(
            xs[b * t:(b + 1) * t], params)


@pytest.mark.parametrize("which,k", [("t17", 3), ("t17", 16), ("t9", 2),
                                     ("t9", 8)])
def test_sponge_hash_ds_dynamic_matches_jax(which, k):
    """One-block (4 + k + 1 <= rate) and two-block sponges; at arity 16 and
    8 every inner tree node is the two-block case."""
    params, jparams = _params(which)
    ds = [[k, 3, i, 9] for i in range(B)]
    inp = [rand_ints(50 + k + i, k) for i in range(B)]
    got = tpos.sponge_hash_ds_dynamic(
        port_tensor(sum(ds, []), mont=True).reshape(B, 4, 8),
        port_tensor(sum(inp, []), mont=True).reshape(B, k, 8),
        tpos.device_params(params))
    want = jpos.sponge_hash_ds_dynamic(
        jnp.asarray(jax_limbs(sum(ds, []), mont=True)).reshape(B, 4, 16),
        jnp.asarray(jax_limbs(sum(inp, []), mont=True)).reshape(B, k, 16),
        jpos.device_params(jparams))
    assert same(got, want)
    assert tfr.unpack_ints(got, mont=True) == [
        spos.hash_with_ds_dynamic(d, i, params) for d, i in zip(ds, inp)]


@pytest.mark.parametrize("which", ["t17", "t9"])
def test_params_from_numpy_round_trip(which):
    """The JAX DeviceParams' numpy arrays carry across: the rebuilt spec
    parameters equal the port's own, and so do the packed constants."""
    params, jparams = _params(which)
    jdp = jpos.device_params(jparams)
    back = convert.params_from_numpy(jdp.mds_scaled, jdp.rc_full,
                                     jdp.rc_part, jdp.t, jdp.rate, jdp.rf,
                                     jdp.rp)
    assert back.mds == params.mds
    assert back.rc_full == params.rc_full
    assert back.rc_partial == params.rc_partial
    for a, b in zip(native.pack_params(back), native.pack_params(params)):
        assert np.array_equal(a, b)
    # round constants are the same Montgomery integers in both layouts
    rc, _, _ = tpos.device_params(params).plain_consts("cpu")
    half = params.rf // 2
    assert same(rc[:half], jdp.rc_full[:half])
    assert same(rc[half:half + params.rp, 0], jdp.rc_part)


def test_unsupported_width_raises():
    with pytest.raises(NotImplementedError):
        tpos.device_params(spos.params_for_width(33))


@pytest.mark.parametrize("which", ["t17", "t9"])
def test_kernel_source_permutation_on_host(which):
    """csrc/poseidon.cuh as the CUDA kernel includes it (sparse partial
    rounds, lazy row sums), compiled with g++, against the spec, the host
    engine and the plain PyTorch version."""
    params, _ = _params(which)
    t = params.t
    states = [rand_ints(60 + t + i, t) for i in range(3)]
    states += [[P - 1] * t, [0] * t]
    flat = [v for s in states for v in s]
    buf = tfr.to_u64(tfr.pack_ints(flat, mont=True)).copy()
    rc = host_check_lib().hc_permute(
        u64p(buf), len(states), t, params.rf, params.rp,
        *[u64p(a) for a in native.pack_params(params)])
    assert rc == 0
    got = tfr.unpack_ints(tfr.from_u64(buf), mont=True)
    want = [v for s in states for v in spos.permute(s, params)]
    assert got == want
    assert native.permute_ints_batch(states, params) == [
        want[i * t:(i + 1) * t] for i in range(len(states))]
    plain = tpos.permute_plain(
        port_tensor(flat, mont=True).reshape(len(states), t, 8),
        tpos.device_params(params))
    assert np.array_equal(plain.numpy().reshape(-1, 8), tfr.from_u64(buf))
