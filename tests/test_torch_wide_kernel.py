"""The wide-width kernel's own routine and the choice of its layout, on the
CPU.

K5 `poseidon_permute_group` (csrc/poseidon_permute_group.cu) permutes a
batch at t = 33, 65, 129 with S states a block, their lanes packed, K
threads a dense row and C blocks (a cluster) a state (`csrc/poseidon_group.cuh`,
on the 32-bit carry-chain arithmetic of `csrc/fr32.cuh`).  `host_check.cpp`
compiles the same routine with g++ and runs it over `PgSlots`, every thread
of a cluster one after another in each step between two barriers, a shuffle
a read of another slot: `hc_permute_group` takes the CUDA entry point's arguments, so each
layout that `group_layout` can return is replayed in the kernel's order,
with a ragged last block and with B = 1.  Each is held to the JAX package's
pure-int spec (`stark_mlwe_tpu.spec`, plain Python: no JAX shape is
compiled), the host engine and the port's plain version `permute_plain`,
which tests/test_torch_wide.py holds to the JAX package's permutation.
Inputs come from numpy seeds; tolerance: exact (field elements).
"""

import ctypes
import functools

import numpy as np
import pytest

from stark_mlwe_tpu.spec import poseidon as jspos
from stark_mlwe_tpu_torch import kernels, native
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.ops import poseidon as tpos
from stark_mlwe_tpu_torch.spec import poseidon as spos
from stark_mlwe_tpu_torch.spec.field import P

from torch_port_util import EDGE, host_check_lib, port_tensor, rand_ints

SMEM_PER_BLOCK = 232_448        # bytes a block may use on an H100
LAYOUTS = [(t, layout) for t in tpos.GROUP_WIDTHS
           for layout in tpos.GROUP_LAYOUTS[t]]


def _states(t, kind):
    """Five states of width t: seeded random ones, or edge values (all
    P - 1, the largest row sums; all 0; all 1; two mixes of edge values)."""
    if kind == "random":
        return [rand_ints(1300 + 10 * t + i, t) for i in range(5)]
    return [[P - 1] * t, [0] * t, [1] * t] + [
        [EDGE[(c + 5 * i) % len(EDGE)] for i in range(t)] for c in range(2)]


@functools.lru_cache(maxsize=None)
def _expected(t, kind):
    """The spec's permutations of `_states(t, kind)`, checked once against
    the host engine and the plain version, as Montgomery limbs [5, t, 8]."""
    states = _states(t, kind)
    want = [jspos.permute(s, jspos.params_for_width(t)) for s in states]
    assert native.permute_ints_batch(states, spos.params_for_width(t)) == want
    dp = tpos.device_params(spos.params_for_width(t))
    plain = tpos.permute_plain(
        port_tensor([v for s in states for v in s], mont=True).reshape(
            len(states), t, 8), dp).numpy()
    assert [tfr.unpack_ints(row, mont=True) for row in plain] == want
    return plain


def _replay(states, t, layout, rf=None, rp=None):
    """`hc_permute_group` on `states` (lists of ints): its return code and
    the Montgomery limbs [B, t, 8] it leaves."""
    dp = tpos.device_params(spos.params_for_width(t))
    consts = [np.ascontiguousarray(c.numpy()) for c in dp.group_consts("cpu")]
    buf = np.ascontiguousarray(
        tfr.pack_ints([v for s in states for v in s], mont=True))
    rc = host_check_lib().hc_permute_group(
        buf.ctypes.data, len(states), t, *layout,
        dp.rf if rf is None else rf, dp.rp if rp is None else rp,
        *[c.ctypes.data for c in consts])
    return rc, buf.reshape(len(states), t, 8)


@pytest.mark.parametrize("kind", ["random", "edge"])
@pytest.mark.parametrize("t,layout", LAYOUTS)
def test_group_routine_matches_spec(t, layout, kind):
    """Five states through the layout's own loop: a ragged last block where
    the layout packs several states, five blocks or clusters where it splits
    rows."""
    rc, got = _replay(_states(t, kind), t, layout)
    assert rc == 0
    assert np.array_equal(got, _expected(t, kind))


@pytest.mark.parametrize("t,layout", LAYOUTS)
def test_group_routine_one_state(t, layout):
    """B = 1: a block whose other S - 1 states are past the batch."""
    rc, got = _replay(_states(t, "random")[3:4], t, layout)
    assert rc == 0
    assert np.array_equal(got, _expected(t, "random")[3:4])


@pytest.mark.parametrize("t", tpos.GROUP_WIDTHS)
def test_group_layout_at_the_crossover(t):
    """The width's small-batch layout below PACK_MIN_B[t] states (one state
    a block with its rows split at t = 33, one state a cluster at t = 65 and
    129), S states a block from there on."""
    small, pack = tpos.GROUP_LAYOUTS[t]
    hi = tpos.PACK_MIN_B[t]
    assert small[0] == 1 < small[1]
    assert (small[2] > 1) == (t > 33)
    assert pack[0] > 1 == pack[1] == pack[2]
    assert 1 < hi <= 1 << 16
    for B in (1, 2, hi - 1):
        assert tpos.group_layout(B, t) == small, B
    for B in (hi, hi + 1, 1 << 16):
        assert tpos.group_layout(B, t) == pack, B


def test_layouts_are_the_built_ones():
    """`GROUP_LAYOUTS` is the list the kernel is built for (PG_LAYOUTS): each
    fits one block of the card, with S ceil(t / C) K threads (the row slots)
    or one warp of owners and S (t - 1) threads (the partial rounds'
    elements), rounded up to whole warps once; nothing else is built."""
    lib = host_check_lib()
    th, nb = ctypes.c_int(), ctypes.c_int()
    for t, (S, K, C) in LAYOUTS:
        assert lib.hc_group_shape(t, S, K, C, ctypes.byref(th),
                                  ctypes.byref(nb)) == 0
        want = max(-(-S * -(-t // C) * K // 32) * 32, 32 + S * (t - 1))
        assert th.value == want <= 1024, (t, S, K, C)
        assert 0 < nb.value <= SMEM_PER_BLOCK, (t, S, K, C, nb.value)
    for t, S, K, C in ((17, 1, 1, 1), (33, 1, 2, 1), (33, 1, 4, 4),
                       (65, 1, 4, 1), (65, 16, 1, 1), (129, 1, 2, 1),
                       (129, 4, 1, 4), (129, 1, 4, 4)):
        assert lib.hc_group_shape(t, S, K, C, ctypes.byref(th),
                                  ctypes.byref(nb)) == 1


def test_replay_refuses_what_the_kernel_refuses():
    """The entry point's checks: a width or a layout it is not built for,
    an empty batch, an odd number of full rounds, no partial round."""
    st = [[0] * 33]
    assert _replay(st, 33, (1, 4, 1))[0] == 0
    assert _replay([[0] * 17], 17, (1, 4, 1))[0] == 1
    assert _replay(st, 33, (2, 2, 1))[0] == 1
    assert _replay(st, 33, (1, 4, 2))[0] == 1
    assert _replay(st, 33, (1, 4, 1), rf=9)[0] == 1
    assert _replay(st, 33, (1, 4, 1), rp=0)[0] == 1
    assert _replay([], 33, (1, 4, 1))[0] == 1


@pytest.mark.parametrize("t", tpos.GROUP_WIDTHS)
def test_cpu_route_ignores_the_layout(t):
    """On a CPU tensor the default layout at B = 1 and the packing one are
    `permute_plain` and launch nothing; a layout that is not built is
    refused."""
    dp = tpos.device_params(spos.params_for_width(t))
    st = port_tensor(_states(t, "random")[0], mont=True).reshape(1, t, 8)
    before = dict(kernels.launches)
    want = _expected(t, "random")[:1]
    assert np.array_equal(tpos.permute(st, dp).numpy(), want)
    pack = tpos.GROUP_LAYOUTS[t][-1]
    assert np.array_equal(tpos.permute_group(st, dp, pack).numpy(), want)
    assert kernels.launches == before
    with pytest.raises(ValueError):
        tpos.permute_group(st, dp, (3, 3, 1))
