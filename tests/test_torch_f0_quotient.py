"""The batch-inversion kernel and the DEEP-ALI f0 quotient, on the CPU.

`fr_batch_inv` (csrc/fr_batch_inv.cu) computes out[i] = phi[i] * (x[i] - z)^-1
in three launches (scan, total, sweep) on `csrc/batch_inv.cuh` over
`csrc/fr32.cuh`.  Both headers compile with g++ through
`csrc/host_check.cpp`: `hc_fr32_sub` and `hc_fr32_inv` run the new field
routines, `hc_batch_inv` replays the three launches block by block and, in a
block, each step between two barriers over all its threads, with the CUDA
entry point's arguments.  They are held to Python ints and to the JAX
package's pure-int spec (`spec.deep_ali.batch_inverse`: no JAX shape
compiled), and to the port's plain versions `batch_inv_plain` and
`f0_quotient_plain`, which are held to the JAX package's `fr.batch_inv` and
`deep_ali.f0_from_phi` at shapes the other port tests compile.  Inputs come
from numpy seeds; tolerance: exact (field elements).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_mlwe_tpu.fri import deep_ali as jdali
from stark_mlwe_tpu.ops import fr as jfr
from stark_mlwe_tpu.spec import deep_ali as jsdali
from stark_mlwe_tpu_torch import kernels
from stark_mlwe_tpu_torch.fri import deep_ali as tdali
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.spec.field import P, get_root_of_unity

from torch_port_util import (EDGE, host_check_lib, jax_limbs, port_tensor,
                             rand_ints, same)

R = tfr.R_MONT
EDGES = EDGE + [1 << 254]
SIZES = [1, 2, 3, 255, 256, 257, 1001, 4096]
Z = rand_ints(800, 1)[0]


def _limbs(xs, mont=False) -> np.ndarray:
    return np.ascontiguousarray(tfr.pack_ints(xs, mont=mont))


def _replay(xs, z=None, phi=None, layout=None, stages=(7,)):
    """`hc_batch_inv` over Montgomery inputs; returns canonical ints."""
    n = len(xs)
    layout = layout or tfr.batch_inv_layout(n)
    x = _limbs(xs, mont=True)
    za = None if z is None else _limbs([z], mont=True)
    pa = None if phi is None else _limbs(phi, mont=True)
    out = np.zeros_like(x)
    ns = tfr.batch_inv_scratch(n, layout)
    scratch = np.zeros((ns, 8), np.int32)
    lib = host_check_lib()
    for st in stages:
        rc = lib.hc_batch_inv(x.ctypes.data,
                              None if za is None else za.ctypes.data,
                              None if pa is None else pa.ctypes.data,
                              out.ctypes.data, scratch.ctypes.data, ns, n,
                              *layout, st)
        assert rc == 0
    return tfr.unpack_ints(out, mont=True)


def test_fr32_sub():
    """Every pair of edge values and random pairs: canonical a - b mod P."""
    xs = [x for x in EDGES for _ in EDGES] + rand_ints(801, 40)
    ys = [y for _ in EDGES for y in EDGES] + rand_ints(802, 40)
    out = np.zeros((len(xs), 8), np.int32)
    a, b = _limbs(xs), _limbs(ys)
    host_check_lib().hc_fr32_sub(a.ctypes.data, b.ctypes.data,
                                 out.ctypes.data, len(xs))
    assert tfr.unpack_ints(out) == [(x - y) % P for x, y in zip(xs, ys)]
    assert np.array_equal(out, tfr.sub_plain(port_tensor(xs),
                                             port_tensor(ys)).numpy())


def test_fr32_inv():
    """x^(P-2), Montgomery in and out, on edge and random values; 0 -> 0."""
    xs = EDGES + [R, P - R] + rand_ints(803, 24)
    a = _limbs(xs, mont=True)
    out = np.zeros_like(a)
    host_check_lib().hc_fr32_inv(a.ctypes.data, out.ctypes.data, len(xs))
    assert tfr.unpack_ints(out, mont=True) == [pow(x, P - 2, P) for x in xs]


_PLAIN = {}


def _plain(n):
    """The plain versions at n (one computation per size and process)."""
    if n not in _PLAIN:
        xs = rand_ints(810 + n, n)
        phi = rand_ints(820 + n, n)
        xt = port_tensor(xs, mont=True)
        _PLAIN[n] = (xs, phi, tfr.unpack_ints(
            tfr.batch_inv_plain(xt), mont=True), tfr.unpack_ints(
            tfr.f0_quotient_plain(port_tensor(phi, mont=True), xt,
                                  port_tensor([Z], mont=True)[0]),
            mont=True))
    return _PLAIN[n]


@pytest.mark.parametrize("layout", ["dispatch", "small"])
@pytest.mark.parametrize("n", SIZES)
def test_batch_inv_replay(n, layout):
    """The three launches, with and without z and phi, against the spec's
    Montgomery trick and the plain versions: at the layout
    `batch_inv_layout` gives and at one with several blocks and runs of
    several elements (ragged last block and run)."""
    lay = None if layout == "dispatch" else ((2, 1, 2) if n < 16
                                             else (4, 3, 8))
    xs, phi, plain_inv, plain_f0 = _plain(n)
    inv = jsdali.batch_inverse(xs)
    assert plain_inv == inv
    assert _replay(xs, layout=lay) == inv
    # the stages one call each, as separate launches run
    assert _replay(xs, layout=lay, stages=(1, 2, 4)) == inv
    d = [(x - Z) % P for x in xs]
    inv_d = jsdali.batch_inverse(d)
    assert _replay(xs, z=Z, layout=lay) == inv_d
    assert _replay(xs, phi=phi, layout=lay) == [
        p * v % P for p, v in zip(phi, inv)]
    f0 = [p * v % P for p, v in zip(phi, inv_d)]
    assert plain_f0 == f0
    assert _replay(xs, z=Z, phi=phi, layout=lay) == f0


@pytest.mark.parametrize("n,where", [(1, [0]), (3, [1]), (257, [0, 200]),
                                     (1001, [1000])])
def test_batch_inv_replay_zero(n, where):
    """A zero in the input (or an x equal to z) gives all zeros, as the
    JAX package's `batch_inv` and the plain version give."""
    xs = rand_ints(830 + n, n)
    for i in where:
        xs[i] = 0
    for lay in (None, (4, 3, 8)):
        assert _replay(xs, layout=lay) == [0] * n
    assert tfr.unpack_ints(tfr.batch_inv_plain(port_tensor(xs, mont=True)),
                           mont=True) == [0] * n
    ys = [x or 5 for x in xs]
    ys[where[0]] = Z
    assert _replay(ys, z=Z, phi=rand_ints(831, n)) == [0] * n


def test_batch_inv_layout():
    """The layout keeps one block of totals within reach and the card full
    at the prover's n; the scratch formula is the kernel's."""
    lib = host_check_lib()
    assert tfr.batch_inv_layout(1 << 16) == (128, 1, 256)
    for n in SIZES + [1 << 16, (1 << 17) + 1, 1 << 20, 3 << 21]:
        T, E, TB = layout = tfr.batch_inv_layout(n)
        G = -(-n // (T * E))
        assert G <= tfr.BATCH_INV_MAX_BLOCKS and (G - 1) * T * E < n
        assert E == 1 or -(-n // (T * E // 2)) > tfr.BATCH_INV_MAX_BLOCKS
        assert TB in (32, 64, 128, 256) and TB * -(-G // TB) >= G
        assert tfr.batch_inv_scratch(n, layout) == lib.hc_batch_inv_scratch(
            n, T, E)
    # a fixed block and run length, as scripts/batch_inv_sweep.py asks
    for T in (32, 64, 128, 256):
        for E in (1, 2, 4):
            lay = tfr.batch_inv_layout(1 << 16, T, E)
            G = -(-(1 << 16) // (T * E))
            assert lay[:2] == (T, E) and lay[2] == min(
                max(32, 1 << (G - 1).bit_length()), 256)


def test_batch_inv_replay_refuses_bad_arguments():
    xs = rand_ints(840, 9)
    x = _limbs(xs, mont=True)
    out = np.zeros_like(x)
    lib = host_check_lib()
    scratch = np.zeros((64, 8), np.int32)
    for n, T, E, TB, ns, st in ((9, 3, 1, 2, 64, 7), (9, 2, 0, 2, 64, 7),
                                (9, 2, 1, 512, 64, 7), (0, 2, 1, 2, 64, 7),
                                (9, 2, 1, 2, 5, 7), (9, 2, 1, 2, 64, 8)):
        assert lib.hc_batch_inv(x.ctypes.data, None, None, out.ctypes.data,
                                scratch.ctypes.data, ns, n, T, E, TB,
                                st) == 1


def test_plain_versions_match_jax():
    """batch_inv_plain against `fr.batch_inv` (n = 24, as
    tests/test_torch_fr.py) and f0_quotient_plain against
    `deep_ali.f0_from_phi` (n = 8, as tests/test_torch_merkle_fri.py)."""
    xs = [x or 7 for x in rand_ints(850, 24)]
    assert same(tfr.batch_inv_plain(port_tensor(xs, mont=True)),
                jfr.batch_inv(jnp.asarray(jax_limbs(xs, mont=True))))
    n = 8
    omega = get_root_of_unity(n)
    phi = rand_ints(851, n)
    w = tdali.omega_powers(omega, n, "cpu")
    got = tfr.f0_quotient_plain(port_tensor(phi, mont=True), w,
                                port_tensor([Z], mont=True)[0])
    want = jdali.f0_from_phi(jnp.asarray(jax_limbs(phi, mont=True)),
                             jdali.omega_powers(omega, n), Z)
    assert same(got, want)
    assert torch.equal(got, tdali.f0_from_phi(port_tensor(phi, mont=True),
                                              w, Z))


def test_cpu_route_launches_nothing():
    """On CPU tensors the wrappers take the plain versions: no launch is
    counted, and the results are the plain versions'."""
    xs, phi, plain_inv, plain_f0 = _plain(257)
    kernels.reset_launches()
    got_inv = tfr.batch_inv(port_tensor(xs, mont=True))
    got_f0 = tfr.f0_quotient(port_tensor(phi, mont=True),
                             port_tensor(xs, mont=True),
                             port_tensor([Z], mont=True)[0])
    assert not any(kernels.launches.values())
    assert tfr.unpack_ints(got_inv, mont=True) == plain_inv
    assert tfr.unpack_ints(got_f0, mont=True) == plain_f0


def test_wrappers_refuse_wrong_inputs():
    a = port_tensor(rand_ints(860, 6), mont=True)
    z = a[0]
    with pytest.raises(TypeError):
        tfr.batch_inv(a.to(torch.int64))
    with pytest.raises(TypeError):
        tfr.batch_inv(a[:, :4])
    with pytest.raises(ValueError):
        tfr.batch_inv(a[:0])
    with pytest.raises(ValueError):
        tfr.batch_inv(a.reshape(2, 3, 8))
    with pytest.raises(TypeError):
        tfr.f0_quotient(a, a, z.to(torch.int64))
    with pytest.raises(ValueError):
        tfr.f0_quotient(a[:5], a, z)
    with pytest.raises(ValueError):
        tfr.f0_quotient(a, a, a[:2])
    meta = torch.empty((6, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tfr.f0_quotient(a, meta, z)
    with pytest.raises(ValueError):
        tfr.f0_quotient(a, a, meta[0])
