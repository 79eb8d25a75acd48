"""`fri.deep_ali.DeviceDomainH` of the port against the JAX package's
(through `convert.py`) and the spec's `DomainH` at n = 64: barycentric
evaluation and both DEEP-ALI merges on random columns from a numpy seed,
z outside H.  Tolerance 0: exact field values.

Nearly all of the file's time is the JAX side's three first-call XLA
compiles (`eval_lagrange`'s ops and the two merge kernels, 11-20 s each
on one CPU); later seeds reuse them at ~0.1 s a case.  The fixture starts
the three compiles at once in threads (XLA compiles with the GIL
released), which halves the wait."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import pytest
import torch

from stark_mlwe_tpu.fri import deep_ali as jdali
from stark_mlwe_tpu.spec import deep_ali as sdali
from stark_mlwe_tpu_torch import convert
from stark_mlwe_tpu_torch.fri import deep_ali as tdali
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.spec.field import P
from torch_port_util import jax_limbs, port_tensor, rand_ints

N = 64


@pytest.fixture(scope="module")
def domains():
    jax_dom = jdali.DeviceDomainH(N)
    col = jnp.asarray(jax_limbs(rand_ints(0, N), mont=True))
    z = _z(1)
    calls = (lambda: jax_dom.eval_lagrange(col, z),
             lambda: jax_dom.merge_deep_ali(col, col, col, col, z),
             lambda: jax_dom.merge_deep_ali_blinded(col, col, col, col, col,
                                                    3, z))
    with ThreadPoolExecutor(len(calls)) as pool:
        for out in pool.map(lambda call: call(), calls):
            jax.block_until_ready(out)
    return (tdali.DeviceDomainH(N, device="cpu"), jax_dom, sdali.DomainH(N))


def _z(seed: int) -> int:
    z = rand_ints(seed, 1)[0]
    assert pow(z, N, P) != 1
    return z


def _cols(seed: int, count: int):
    return [rand_ints(seed + i, N) for i in range(count)]


def test_omega_table(domains):
    port, jax_dom, spec = domains
    assert port.omega == jax_dom.omega == spec.omega
    assert tfr.unpack_ints(port.omega_pows, mont=True) == spec.omega_pows
    assert torch.equal(port.omega_pows,
                       convert.from_jax_limbs(jax_dom.omega_pows))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_eval_lagrange(domains, seed):
    port, jax_dom, spec = domains
    (vals,) = _cols(100 * seed, 1)
    z = _z(100 * seed + 50)
    got = port.eval_lagrange(port_tensor(vals, mont=True), z)
    assert got == jax_dom.eval_lagrange(
        jnp.asarray(jax_limbs(vals, mont=True)), z)
    assert got == spec.eval_lagrange(vals, z)


def test_eval_lagrange_refuses_z_in_h(domains):
    port = domains[0]
    vals = port_tensor(rand_ints(7, N), mont=True)
    with pytest.raises(ValueError, match="outside H"):
        port.eval_lagrange(vals, port.omega)


def _merge_equal(port_out, jax_out, spec_out):
    f0, z, c_star = port_out
    jf0, jz, jc = jax_out
    sf0, sz, sc = spec_out
    assert z == jz == sz and c_star == jc == sc
    assert torch.equal(f0, convert.from_jax_limbs(jf0))
    assert tfr.unpack_ints(f0, mont=True) == sf0


@pytest.mark.parametrize("seed", [1, 2])
def test_merge_deep_ali(domains, seed):
    port, jax_dom, spec = domains
    cols = _cols(1000 * seed, 4)
    z = _z(1000 * seed + 77)
    _merge_equal(
        port.merge_deep_ali(*[port_tensor(c, mont=True) for c in cols], z),
        jax_dom.merge_deep_ali(
            *[jnp.asarray(jax_limbs(c, mont=True)) for c in cols], z),
        spec.merge_deep_ali(*cols, z))


@pytest.mark.parametrize("seed", [1, 2])
def test_merge_deep_ali_blinded(domains, seed):
    port, jax_dom, spec = domains
    cols = _cols(2000 * seed, 5)
    z = _z(2000 * seed + 77)
    beta = rand_ints(2000 * seed + 99, 1)[0]
    a, s, e, t, r = cols
    _merge_equal(
        port.merge_deep_ali_blinded(
            *[port_tensor(c, mont=True) for c in (a, s, e, t)],
            port_tensor(r, mont=True), beta, z),
        jax_dom.merge_deep_ali_blinded(
            *[jnp.asarray(jax_limbs(c, mont=True)) for c in (a, s, e, t)],
            jnp.asarray(jax_limbs(r, mont=True)), beta, z),
        spec.merge_deep_ali_blinded(a, s, e, t, r, beta, z))


def test_the_table_goes_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdali.DeviceDomainH(N)
