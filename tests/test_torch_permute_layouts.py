"""K1's two layouts and the choice between them, on the CPU.

K1 (csrc/poseidon_permute.cu) permutes a batch either with one warp per
state (`poseidon_chain.cuh` `poseidon_permute_warp`, the routine K4 runs) or
with one thread per state (`poseidon.cuh` `poseidon_permute_one`); both are
on the 32-bit carry-chain arithmetic of `csrc/fr32.cuh`.  `host_check.cpp`
compiles both with g++: `hc_permute_warp` runs the warp routine over the 32
lanes of `PcLanes` (a shuffle is a read of another lane's slot) with the
constants the warp kernel takes, `hc_permute` the thread routine with the
thread kernel's.  Each is held to the JAX package's pure-int spec
(`stark_mlwe_tpu.spec`, plain Python: no JAX shape is compiled), the host
engine and the port's plain version `permute_plain`, which
tests/test_torch_poseidon.py holds to the JAX package's permutation.
Inputs come from numpy seeds; tolerance: exact (field elements).
"""

import numpy as np
import pytest

from stark_mlwe_tpu.spec import poseidon as jspos
from stark_mlwe_tpu_torch import kernels, native
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.ops import poseidon as tpos
from stark_mlwe_tpu_torch.spec import poseidon as spos
from stark_mlwe_tpu_torch.spec.field import P

from torch_port_util import (EDGE, host_check_lib, port_tensor, rand_ints,
                             u64p)

TOP = [(1 << 254) - 1, ((1 << 32) - 1) << 222, P - 2, P - (1 << 64)]


def _states(t, kind):
    """Five states of width t: seeded random ones, or the edge values."""
    if kind == "random":
        return [rand_ints(800 + 10 * t + i, t) for i in range(5)]
    vals = [0, 1, P - 1] + TOP + EDGE
    return [[P - 1] * t, [0] * t] + [
        [vals[(c + 5 * i) % len(vals)] for i in range(t)] for c in range(3)]


def _replay(layout, states, t):
    """The layout's routine through g++ on `states`: Montgomery limbs
    [B, t, 8] out."""
    dp = tpos.device_params(spos.params_for_width(t))
    buf = np.ascontiguousarray(
        tfr.pack_ints([v for s in states for v in s], mont=True))
    if layout == "warp":
        consts = [np.ascontiguousarray(c.numpy())
                  for c in dp.group_consts("cpu")]
        entry, ptr = host_check_lib().hc_permute_warp, lambda a: a.ctypes.data
    else:
        consts = [np.ascontiguousarray(a)
                  for a in native.pack_params(dp.spec_params)]
        entry, ptr = host_check_lib().hc_permute, u64p
    rc = entry(ptr(buf), len(states), t, dp.rf, dp.rp,
               *[ptr(c) for c in consts])
    assert rc == 0
    return buf.reshape(len(states), t, 8)


@pytest.mark.parametrize("layout", tpos.K1_LAYOUTS)
@pytest.mark.parametrize("kind", ["random", "edge"])
@pytest.mark.parametrize("t", tpos.K1_WIDTHS)
def test_layout_routine_matches_spec(t, kind, layout):
    """The layout's own loop against the JAX package's spec, the host engine
    and `permute_plain`."""
    states = _states(t, kind)
    got = _replay(layout, states, t)
    jparams = jspos.params_for_width(t)
    want = [jspos.permute(s, jparams) for s in states]
    assert [tfr.unpack_ints(row, mont=True) for row in got] == want
    assert native.permute_ints_batch(states, spos.params_for_width(t)) == want
    dp = tpos.device_params(spos.params_for_width(t))
    plain = tpos.permute_plain(
        port_tensor([v for s in states for v in s], mont=True).reshape(
            len(states), t, 8), dp)
    assert np.array_equal(plain.numpy(), got)


@pytest.mark.parametrize("t", tpos.K1_WIDTHS)
def test_permute_layout_at_the_crossover(t):
    """A warp per state up to WARP_MAX_B[t] states, a thread per state
    above; the prover's tree levels (1 to 256 states) take the warp."""
    m = tpos.WARP_MAX_B[t]
    assert 256 <= m < 1 << 16
    for B in (1, 16, 32, 256, m - 1, m):
        assert tpos.permute_layout(B, t) == "warp", B
    for B in (m + 1, 2 * m, 1 << 16):
        assert tpos.permute_layout(B, t) == "thread", B


@pytest.mark.parametrize("t", tpos.K1_WIDTHS)
def test_cpu_route_ignores_the_layout(t):
    """On a CPU tensor every route is `permute_plain` and launches nothing;
    a layout K1 does not have is refused, and K5 no longer takes K1's
    widths."""
    dp = tpos.device_params(spos.params_for_width(t))
    st = port_tensor(rand_ints(900 + t, 2 * t), mont=True).reshape(2, t, 8)
    before = dict(kernels.launches)
    want = tpos.permute_plain(st, dp)
    assert np.array_equal(tpos.permute(st, dp).numpy(), want.numpy())
    for layout in tpos.K1_LAYOUTS:
        assert np.array_equal(tpos.permute_k1(st, dp, layout).numpy(),
                              want.numpy())
    assert kernels.launches == before
    with pytest.raises(ValueError):
        tpos.permute_k1(st, dp, "group")
    assert t not in tpos.GROUP_WIDTHS


def test_warp_replay_refuses_what_the_kernel_refuses():
    """The warp entry point's argument checks: a width K1 does not have, an
    empty batch, an odd number of full rounds."""
    dp = tpos.device_params(spos.params_for_width(9))
    consts = [np.ascontiguousarray(c.numpy()) for c in dp.group_consts("cpu")]
    st = np.zeros((1, 9, 8), np.int32)
    lib = host_check_lib()
    args = [c.ctypes.data for c in consts]
    assert lib.hc_permute_warp(st.ctypes.data, 1, 5, dp.rf, dp.rp, *args) == 1
    assert lib.hc_permute_warp(st.ctypes.data, 0, 9, dp.rf, dp.rp, *args) == 1
    assert lib.hc_permute_warp(st.ctypes.data, 1, 9, dp.rf + 1, dp.rp,
                               *args) == 1
    assert lib.hc_permute_warp(st.ctypes.data, 1, 9, dp.rf, dp.rp, *args) == 0
