"""Port field arithmetic (stark_mlwe_tpu_torch.ops.fr) vs the JAX package.

Same inputs (numpy seed) through `stark_mlwe_tpu.ops.fr` and its
counterpart; tolerance: exact (integer field arithmetic).  On the CPU the
port's wrappers take the kernels' plain versions; the kernels' own C
arithmetic (csrc/fr32.cuh, and K3's csrc/fold.cuh) is held against Python
ints through a g++ build.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_mlwe_tpu.ops import fr as jfr
from stark_mlwe_tpu_torch import convert
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.spec.field import P

from torch_port_util import (EDGE, host_check_lib, jax_limbs, port_tensor,
                             rand_ints, same, u64p)

N = 24      # one batch size for every JAX call: each new shape recompiles
A = rand_ints(11, N - 4) + [P - 1, 0, 1, tfr.R_MONT]
B = rand_ints(12, N - 4) + [P - 1, P - 1, 0, tfr.R2_MONT]


def test_layout_and_pack_roundtrip():
    xs = A + EDGE
    arr = tfr.pack_ints(xs)
    assert arr.shape == (len(xs), 8) and arr.dtype == np.int32
    assert tfr.unpack_ints(arr) == xs
    assert tfr.unpack_ints(tfr.pack_ints(xs, mont=True), mont=True) == xs
    # the same integers, limb for limb, as the JAX package's packing
    for mont in (False, True):
        j = jfr.pack_ints(xs, mont=mont)
        t = tfr.pack_ints(xs, mont=mont)
        assert np.array_equal(convert.to_jax_limbs(t), j)
        assert np.array_equal(convert.from_jax_limbs(j).numpy(), t)
    # the native (>= 1024) packing path agrees with the scalar one
    big = rand_ints(13, 1030)
    assert np.array_equal(tfr.pack_ints(big, mont=True)[:64],
                          tfr.pack_ints(big[:64], mont=True))
    assert tfr.to_u64(arr).shape == (len(xs), 4)
    assert np.array_equal(tfr.from_u64(tfr.to_u64(arr)), arr)


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_elementwise_matches_jax(op):
    got = getattr(tfr, op)(port_tensor(A), port_tensor(B))
    want = getattr(jfr, op)(jnp.asarray(jax_limbs(A)),
                            jnp.asarray(jax_limbs(B)))
    assert same(got, want)


@pytest.mark.parametrize("op,ref", [
    ("mont_mul", lambda x, y: x * y * tfr.R_INV % P),
    ("add", lambda x, y: (x + y) % P),
    ("sub", lambda x, y: (x - y) % P)])
def test_elementwise_worst_case_grid(op, ref):
    """Every pair of edge values (0, 1, P-1, R, R^2, long runs of ones):
    a missed carry shows only on such inputs."""
    xs = [x for x in EDGE for _ in EDGE]
    ys = [y for _ in EDGE for y in EDGE]
    got = getattr(tfr, op)(port_tensor(xs), port_tensor(ys))
    assert tfr.unpack_ints(got) == [ref(x, y) for x, y in zip(xs, ys)]


def test_broadcast_operand():
    a = port_tensor(A)
    z = port_tensor([B[0]])[0]
    assert tfr.unpack_ints(tfr.sub(a, z)) == [(x - B[0]) % P for x in A]
    assert tfr.unpack_ints(tfr.mont_mul(z, a)) == [
        x * B[0] * tfr.R_INV % P for x in A]
    assert tfr.unpack_ints(tfr.neg(a)) == [(-x) % P for x in A]


def test_pow5_and_mont_conversions_match_jax():
    a = port_tensor(A)
    ja = jnp.asarray(jax_limbs(A))
    assert same(tfr.pow5(a), jfr.pow5(ja))
    assert same(tfr.to_mont(a), jfr.to_mont(ja))
    assert same(tfr.from_mont(a), jfr.from_mont(ja))


def test_batch_inv_matches_jax():
    xs = [x or 7 for x in A]
    got = tfr.batch_inv(port_tensor(xs, mont=True))
    want = jfr.batch_inv(jnp.asarray(jax_limbs(xs, mont=True)))
    assert same(got, want)
    assert tfr.unpack_ints(got, mont=True) == [pow(x, P - 2, P) for x in xs]
    one = tfr.batch_inv(port_tensor([5], mont=True))
    assert tfr.unpack_ints(one, mont=True) == [pow(5, P - 2, P)]


def test_powers_matches_jax():
    base = A[0]
    got = tfr.powers(port_tensor([base], mont=True)[0], N)
    want = jfr.powers(jnp.asarray(jax_limbs([base], mont=True)[0]), N)
    assert same(got, want)
    assert tfr.unpack_ints(got, mont=True) == [pow(base, i, P)
                                              for i in range(N)]


def test_reduce_add_matches_jax():
    got = tfr.reduce_add(port_tensor(A))
    want = jfr.reduce_add(jnp.asarray(jax_limbs(A)))
    assert same(got, want)
    assert tfr.unpack_ints(got[None]) == [sum(A) % P]


@pytest.mark.parametrize("m,worst", [(16, False), (8, False), (16, True)])
def test_fold_matches_jax_mat_apply(m, worst):
    """The m-ary fold against `fr.mat_apply` with a z-power row, incl. the
    worst-case accumulator (all limbs of all operands at P-1)."""
    nb = 3
    f = [P - 1] * (nb * m) if worst else rand_ints(20 + m, nb * m)
    z = P - 1 if worst else rand_ints(21, 1)[0]
    zp = [P - 1] * m if worst else [pow(z, t, P) for t in range(m)]
    got = tfr.fold(port_tensor(f, mont=True), port_tensor(zp, mont=True))
    A_row = jnp.asarray(jfr.mat_scale([zp]))
    want = jfr.mat_apply(
        A_row, jnp.asarray(jax_limbs(f, mont=True)).reshape(nb, m, 16))
    assert same(got, np.asarray(want)[:, 0, :])
    assert tfr.unpack_ints(got, mont=True) == [
        sum(f[b * m + t] * zp[t] for t in range(m)) % P for b in range(nb)]


def test_plain_matrix_apply_worst_case_bounds():
    """Accumulator-bound stress of the plain constant-matrix apply: a 17 x 17
    matrix and state with every entry P-1."""
    t = 17
    rows = [[P - 1] * t for _ in range(t)]
    s = port_tensor([P - 1] * t, mont=True).reshape(1, t, 8)
    got = tfr.mat_apply_plain(tfr.PlainMatrix(rows, torch.device("cpu")), s)
    assert tfr.unpack_ints(got, mont=True) == [t * (P - 1) * (P - 1) % P] * t


def test_wrappers_reject_wrong_inputs():
    a = port_tensor(A)
    with pytest.raises(TypeError):
        tfr.mont_mul(a.to(torch.int64), a)
    with pytest.raises(TypeError):
        tfr.add(a[:, :4], a[:, :4])
    with pytest.raises(ValueError):
        tfr.fold(a[:23], a[:8])


@pytest.mark.parametrize("op,ref", [
    (0, lambda x, y: x * y * tfr.R_INV % P),
    (1, lambda x, y: (x + y) % P),
    (2, lambda x, y: (x - y) % P)])
def test_kernel_source_arithmetic_on_host(op, ref):
    """K2's element step (`fr32_binop` of csrc/fr32.cuh) as the CUDA kernel
    includes it, compiled with g++."""
    lib = host_check_lib()
    xs = A + [x for x in EDGE for _ in EDGE]
    ys = B + [y for _ in EDGE for y in EDGE]
    a, b = tfr.to_u64(tfr.pack_ints(xs)), tfr.to_u64(tfr.pack_ints(ys))
    out = np.zeros_like(a)
    lib.hc_elementwise(op, u64p(a), u64p(b), u64p(out), len(xs), 1, 1)
    assert tfr.unpack_ints(tfr.from_u64(out)) == [ref(x, y)
                                                  for x, y in zip(xs, ys)]
    lib.hc_elementwise(op, u64p(a), u64p(b), u64p(out), len(xs), 1, 0)
    assert tfr.unpack_ints(tfr.from_u64(out)) == [ref(x, ys[0]) for x in xs]


@pytest.mark.parametrize("m", [16, 8, 2])
def test_kernel_source_fold_on_host(m):
    lib = host_check_lib()
    f = rand_ints(30 + m, 5 * m) + [P - 1] * m
    zp = [P - 1] * m if m == 16 else [pow(A[1], t, P) for t in range(m)]
    fa = tfr.to_u64(tfr.pack_ints(f, mont=True))
    za = tfr.to_u64(tfr.pack_ints(zp, mont=True))
    out = np.zeros((len(f) // m, 4), np.uint64)
    lib.hc_fold(u64p(fa), u64p(za), u64p(out), len(f) // m, m)
    got = tfr.from_u64(out)
    assert tfr.unpack_ints(got, mont=True) == [
        sum(f[b * m + t] * zp[t] for t in range(m)) % P
        for b in range(len(f) // m)]
    assert np.array_equal(
        got, tfr.fold_plain(port_tensor(f, mont=True),
                            port_tensor(zp, mont=True)).numpy())
