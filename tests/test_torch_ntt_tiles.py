"""The port's NTT tile transform (stark_mlwe_tpu_torch.ops.ntt.ntt_tiles) and
the recursion built on it vs the JAX package's Pallas kernel.

`stark_mlwe_tpu.ops.ntt_pallas.ntt` runs in interpret mode (the way the JAX
package's own tests run its kernel on the CPU); the port's recursion runs on
the kernel's plain version, with the tile forced small so that two levels
recurse.  The constant tables are compared array by array, and the CUDA
kernel's per-thread steps (csrc/ntt.cuh) are replayed through a g++ build.
Tolerance: exact (integer field arithmetic, tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_mlwe_tpu.ops import ntt as jntt
from stark_mlwe_tpu.ops import ntt_pallas as jpal
from stark_mlwe_tpu_torch import convert
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.ops import ntt as tntt
from stark_mlwe_tpu_torch.spec.field import P

from torch_port_util import (EDGE, host_check_lib, port_tensor, same,
                             seeded_elems as elems)


@pytest.mark.parametrize("inverse", [False, True])
def test_recursion_matches_pallas_kernel_interpreted_2e12(inverse):
    """The four-step recursion on the plain tile transform, with the tile
    forced down to 16 so that two levels run (16 x (16 x 16)), against the
    JAX package's Pallas kernel in interpret mode at n = 2^12; also the
    default tile (64 x 64) and the flat plain transform."""
    n = 1 << 12
    raw = tfr.seeded_limbs(300 + inverse, n)
    x = tfr.to_device(raw, "cpu")
    want = jpal.ntt(jnp.asarray(convert.to_jax_limbs(raw)), inverse=inverse,
                    interpret=True)
    got = tntt.ntt(x, inverse=inverse, tile_max=16)
    assert same(got, want)
    assert torch.equal(tntt.ntt(x, inverse=inverse, tile_max=64), got)
    assert torch.equal(tntt.ntt(x, inverse=inverse), got)     # one tile
    assert torch.equal(tntt.ntt_plain(x, inverse), got)


@pytest.mark.parametrize("inverse", [False, True])
def test_stage_twiddles_match_jax_plan(inverse):
    """The port's one table omega_L^j read at stride L/2h against the JAX
    package's per-stage tables (`ops.ntt._plan`) and its packed tile table
    (`ntt_pallas._stage_table`)."""
    L = 64
    wt = tntt.stage_twiddles(L, inverse, "cpu")
    assert tuple(wt.shape) == (L // 2, 8)
    rev, tws = jntt._plan(L, inverse)
    assert np.array_equal(np.asarray(rev), tntt._bit_reverse_perm(L))
    omega = tntt._root(L, inverse)
    packed = jpal._stage_table(L, omega)
    h = 1
    for tw in tws:
        mine = wt[::L // (2 * h)][:h]
        assert same(mine, tw), h
        assert same(mine, packed[h:2 * h, :, 0]), h
        h *= 2
    assert h == L


@pytest.mark.parametrize("inverse,scaled", [(False, False), (True, True),
                                            (True, False)])
def test_step_twiddles_match_jax_step_ep(inverse, scaled):
    M, m1, m2 = 1 << 12, 32, 128       # the JAX package's split of 2^12
    assert jpal._split(M) == (m1, m2)
    ep = np.asarray(jpal._step_ep(M, m1, m2, inverse, scaled))  # [j1,16,i2]
    mine = tntt.step_twiddles(M, m1, m2, inverse, scaled, "cpu")
    assert same(mine, np.transpose(ep, (2, 0, 1)))
    # and the definition, at a few entries
    w = tntt._root(M, inverse)
    s = pow(M, P - 2, P) if scaled else 1
    for i2, j1 in ((0, 0), (1, 1), (5, 31), (127, 31), (77, 13)):
        assert tfr.unpack_ints(mine[i2, j1][None], mont=True) == [
            pow(w, i2 * j1, P) * s % P]


def test_tile_views_batches_and_epilogues():
    """`ntt_tiles` on transposed, sliced and broadcast views with full,
    periodic and absent epilogues, against one flat transform per row."""
    L, Bo, Bi = 8, 3, 4
    wt = tntt.stage_twiddles(L, False, "cpu")
    base = elems(700, L, Bo, Bi)                    # transforms down axis 0
    x = base.permute(1, 2, 0, 3)                    # [Bo, Bi, L, 8] view
    ep = elems(701, Bi, L)
    out_base = torch.zeros((Bi, L, Bo, 8), dtype=torch.int32)
    out = out_base.permute(2, 0, 1, 3)              # another layout
    got = tntt.ntt_tiles(x, wt, ep, out=out)
    assert got is out
    for bo in range(Bo):
        for bi in range(Bi):
            want = tfr.mont_mul(tntt.ntt_plain(x[bo, bi].contiguous()),
                                ep[bi])
            assert torch.equal(out[bo, bi], want), (bo, bi)
    # full epilogue = one batch dimension; ragged batch of 3; no out given
    x3 = elems(702, 3, L)
    ep3 = elems(703, 3, L)
    got = tntt.ntt_tiles(x3, wt, ep3)
    for b in range(3):
        assert torch.equal(got[b], tfr.mont_mul(tntt.ntt_plain(x3[b]),
                                                ep3[b]))
    # sliced batch, no epilogue
    got = tntt.ntt_tiles(x3[1:], wt)
    assert torch.equal(got[0], tntt.ntt_plain(x3[1]))
    # batched entry point on a transposed view
    xb = elems(704, L, 5).transpose(0, 1)
    got = tntt.ntt(xb)
    for b in range(5):
        assert torch.equal(got[b], tntt.ntt_plain(xb[b].contiguous()))


def hc_tiles(x, wt, ep, out, nthreads, tpb=None):
    """`csrc/ntt.cuh` through its host replay, with the wrapper's own
    argument derivation."""
    args = list(tntt._kernel_args(x, wt, ep, out))
    if tpb is not None:
        args[6] = tpb
    assert host_check_lib().hc_ntt_tile(*args, nthreads) == 0
    return out


HC_CASES = {
    # name: (L, batch shape, epilogue, threads of a block, tpb, layout)
    "L2_B1": (2, (1,), None, 4, None, "rows"),
    "L8_B3_ragged_full_ep": (8, (3,), "full", 5, 2, "rows"),
    "L16_columns_periodic_ep": (16, (3, 4), "periodic", 7, 5, "columns"),
    "L64_B20_no_ep": (64, (20,), None, 32, None, "rows"),
    "L256_scale_row": (256, (2, 2), "row", 256, 3, "columns"),
    "L2048_one_tile": (2048, (1,), "full", 256, None, "rows"),
}


@pytest.mark.parametrize("case", sorted(HC_CASES))
def test_kernel_source_ntt_tile_on_host(case):
    """The kernel's per-thread steps (index arithmetic, bit-reversed load,
    butterflies, epilogue, strided store) replayed thread by thread, block
    by block, against the plain version; inverse twiddles in the columns
    cases."""
    L, batch, epk, nthreads, tpb, layout = HC_CASES[case]
    inverse = layout == "columns"
    wt = tntt.stage_twiddles(L, inverse, "cpu")
    nb = int(np.prod(batch))
    flat = elems(1000 + L, nb * L)
    # edge values among the inputs: zeros, P-1, R
    edge = port_tensor(EDGE)[:min(len(EDGE), nb * L)]
    flat[:edge.shape[0]] = edge
    if layout == "rows":
        x = flat.reshape(*batch, L, 8)
        out = torch.zeros_like(x)
    else:   # transforms down the first axis of [L, *batch]: element stride nb
        x = flat.reshape(L, *batch, 8).permute(*range(1, len(batch) + 1), 0,
                                               len(batch) + 1)
        out = torch.zeros((batch[0], L) + batch[1:] + (8,),
                          dtype=torch.int32).movedim(1, -2)
    ep = None
    if epk == "full":
        ep = elems(1100 + L, batch[-1], L)
    elif epk == "periodic":
        ep = elems(1101 + L, batch[-1], L)
    elif epk == "row":
        ep = tntt._scale_row(L, "cpu")
    got = hc_tiles(x, wt, ep, out, nthreads, tpb)
    assert torch.equal(got, tntt.ntt_tiles_plain(x, wt, ep))
