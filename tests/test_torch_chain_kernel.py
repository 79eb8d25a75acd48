"""The chain kernel's own arithmetic and routine, on the CPU.

K4 `poseidon_absorb_chain` (csrc/poseidon_absorb_chain.cu) is built on
`csrc/fr32.cuh` (32-bit limbs, carry chains) and `csrc/poseidon_chain.cuh`
(one warp per chain, lane i holds element i, the partial rounds' row dot
summed by a butterfly while lane 0 takes the S-box).  Both headers compile
with g++ through `csrc/host_check.cpp`, whose portable carry steps stand one
for one for the PTX instructions: `hc_fr32_mont_mul` and `hc_fr32_row_dot`
run the field primitives, `hc_absorb_chain` replays the kernel lane by lane
and step by step in its own order, with the same argument list as the CUDA
entry point.  Each is held to the pure-int spec of the JAX package
(`stark_mlwe_tpu.spec`, plain Python: no JAX shape is compiled) and the chain
also to the port's plain version `absorb_chain_plain`.  Inputs come from
numpy seeds; tolerance: exact (field elements).
"""

import numpy as np
import pytest
import torch

from stark_mlwe_tpu.spec import poseidon as jspos
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.ops import poseidon as tpos
from stark_mlwe_tpu_torch.spec import poseidon as spos
from stark_mlwe_tpu_torch.spec.field import P

from torch_port_util import EDGE, host_check_lib, port_tensor, rand_ints

R_INV = pow(1 << 256, -1, P)
INV_2_320 = pow(2, -320, P)

# values whose top limbs are set (limb 7 at or near 0x3fffffff / 0x40000000)
TOP = [(1 << 254) - 1, ((1 << 32) - 1) << 222, P - 2, P - (1 << 64),
       (P - 1) // 2 + (1 << 253)]
KINDS = {
    "random": lambda seed, n: rand_ints(seed, n),
    "zero": lambda seed, n: [0] * n,
    "one": lambda seed, n: [1] * n,
    "p_minus_1": lambda seed, n: [P - 1] * n,
    "top_limbs": lambda seed, n: [TOP[i % len(TOP)] for i in range(n)],
}


def _ptr(a: np.ndarray) -> int:
    """The address of `a`'s buffer: the caller keeps `a` alive."""
    return a.ctypes.data


def _limbs(xs, mont=False) -> np.ndarray:
    return np.ascontiguousarray(tfr.pack_ints(xs, mont=mont))


@pytest.mark.parametrize("kind", list(KINDS))
def test_fr32_mont_mul(kind):
    """a of one kind against b = random values and every edge value (both
    orders): a*b*2^-256 mod P, fully reduced, as the spec and the plain
    PyTorch product give it."""
    bs = rand_ints(700, 24) + EDGE + TOP
    a = KINDS[kind](701, len(bs))
    xs, ys = a + bs, bs + a
    xa, ya = _limbs(xs), _limbs(ys)
    out = np.zeros((len(xs), 8), np.int32)
    host_check_lib().hc_fr32_mont_mul(_ptr(xa), _ptr(ya), _ptr(out), len(xs))
    got = tfr.unpack_ints(out)
    assert got == [x * y * R_INV % P for x, y in zip(xs, ys)]
    plain = tfr.mont_mul_plain(port_tensor(xs), port_tensor(ys))
    assert np.array_equal(plain.numpy(), out)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fr32_row_dot(kind):
    """Lazy row sums of 17 (t = 17) and 9 (t = 9) products, constants of one
    kind, one 2^320 reduction each: sum(q*x) * 2^-320 mod P."""
    lib = host_check_lib()
    for nterms, B in ((17, 6), (9, 4)):
        q = KINDS[kind](710 + nterms, nterms * B)
        x = rand_ints(720 + nterms, nterms * B)
        x[:nterms] = [P - 1] * nterms           # the largest sum of all
        x[nterms:2 * nterms] = [EDGE[i % len(EDGE)] for i in range(nterms)]
        qa, xa = _limbs(q), _limbs(x)
        out = np.zeros((B, 8), np.int32)
        assert lib.hc_fr32_row_dot(_ptr(qa), _ptr(xa), _ptr(out), B,
                                   nterms) == 0
        want = [sum(q[b * nterms + j] * x[b * nterms + j]
                    for j in range(nterms)) * INV_2_320 % P
                for b in range(B)]
        assert tfr.unpack_ints(out) == want
    assert lib.hc_fr32_row_dot(_ptr(out), _ptr(out), _ptr(out), 1, 18) == 1


def _chain_case(t, nb, kind, off=3):
    """States [C, t] and columns [C, off + nb*rate + 2] as ints: C = 3
    chains from non-zero states, the blocks read at an offset."""
    C, rate = 3, t - 1
    n = off + nb * rate + 2
    if kind == "random":
        init = [rand_ints(730 + t + c, t) for c in range(C)]
        cols = [rand_ints(740 + t + nb + c, n) for c in range(C)]
    else:       # 0, 1, P-1 and top-limb values, a different mix per chain
        vals = [0, 1, P - 1] + TOP + EDGE
        init = [[vals[(c + 3 * i) % len(vals)] for i in range(t)]
                for c in range(C)]
        cols = [[vals[(5 * c + i) % len(vals)] for i in range(n)]
                for c in range(C)]
        init[0] = [P - 1] * t
        cols[0] = [P - 1] * n
    return init, cols, off, n


@pytest.mark.parametrize("kind", ["random", "edge"])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("t", [9, 17])
def test_absorb_chain_replay(t, nb, kind):
    """`hc_absorb_chain` (the kernel's warp routine, lane by lane, the
    overlapped S_r and the butterfly in the kernel's order) against the
    spec's sponge steps and the port's `absorb_chain_plain`."""
    init, cols, off, n = _chain_case(t, nb, kind)
    C, rate = len(init), t - 1
    params = jspos.params_for_width(t)
    dp = tpos.device_params(spos.params_for_width(t))
    st = _limbs(sum(init, []), mont=True)
    cl = _limbs(sum(cols, []), mont=True)
    out = np.zeros_like(st)
    consts = [np.ascontiguousarray(c.numpy()) for c in dp.group_consts("cpu")]
    rc = host_check_lib().hc_absorb_chain(
        _ptr(st), _ptr(cl), _ptr(out), C, n, off, nb, t, dp.rf, dp.rp,
        *[_ptr(c) for c in consts])
    assert rc == 0
    want = []
    for c in range(C):
        s = list(init[c])
        for b in range(nb):
            for i in range(rate):
                s[i] = (s[i] + cols[c][off + b * rate + i]) % P
            s = jspos.permute(s, params)
        want += s
    assert tfr.unpack_ints(out, mont=True) == want
    plain = tpos.absorb_chain_plain(
        torch.from_numpy(st).reshape(C, t, 8),
        torch.from_numpy(cl).reshape(C, n, 8), off, nb, dp)
    assert np.array_equal(plain.numpy().reshape(-1, 8), out)


def test_absorb_chain_replay_refuses_what_the_kernel_refuses():
    """The entry point's argument checks: rows beyond the columns, a width
    the kernel does not have."""
    dp = tpos.device_params(spos.params_for_width(9))
    consts = [np.ascontiguousarray(c.numpy()) for c in dp.group_consts("cpu")]
    st = np.zeros((1, 9, 8), np.int32)
    cl = np.zeros((1, 20, 8), np.int32)
    lib = host_check_lib()
    args = [_ptr(c) for c in consts]
    assert lib.hc_absorb_chain(_ptr(st), _ptr(cl), _ptr(st), 1, 20, 5, 2, 9,
                               dp.rf, dp.rp, *args) == 1     # 5 + 16 > 20
    assert lib.hc_absorb_chain(_ptr(st), _ptr(cl), _ptr(st), 1, 20, 0, 1, 5,
                               dp.rf, dp.rp, *args) == 1     # t = 5
    assert lib.hc_absorb_chain(_ptr(st), _ptr(cl), _ptr(st), 1, 20, 0, 0, 9,
                               dp.rf, dp.rp, *args) == 0
