"""K3 `fr_fold` and K6 `fr_ntt_tiles` replayed on the CPU, step by step.

The CUDA kernels' own steps (csrc/fold.cuh and csrc/ntt.cuh, on
csrc/fr32.cuh) run through a g++ build of csrc/host_check.cpp: the fold
lane by lane with its shuffle tree (`hc_fold`), the tile transform thread
by thread between its barriers (`hc_ntt_tile`).  They are held against Python ints, the JAX package's pure-int
spec (`spec.fri.fri_fold_layer`) and the port's plain versions
(`fold_plain`, `ntt_tiles_plain`); `tests/test_torch_ntt_tiles.py` holds the
plain tile transform against the JAX package's Pallas kernel.  No JAX
compile.  Tolerance: exact (integer field arithmetic, tolerance 0).
"""

import numpy as np
import pytest
import torch

from stark_mlwe_tpu.spec.fri import fri_fold_layer
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.ops import ntt as tntt
from stark_mlwe_tpu_torch.spec.field import P

from torch_port_util import (EDGE, host_check_lib, port_tensor, rand_ints,
                             seeded_elems as elems, u64p)

# ---------------------------------------------------------------------------
# K3: the fold.
# ---------------------------------------------------------------------------

FOLD_THREADS = 128      # csrc/fold.cuh


def fold_lanes(m: int) -> int:
    g = 1
    while 2 * g <= m and g < 32:
        g *= 2
    return g


@pytest.mark.parametrize("kind", ["random_ragged", "all_p_minus_1", "zeros"])
@pytest.mark.parametrize("m", [2, 8, 16, 32, 64, 128])
def test_fold_lanes_on_host(m, kind):
    """`hc_fold`: each warp's lanes, its shuffle tree and lane 0's one
    reduction, block after block; a number of outputs that leaves the last
    block ragged."""
    per_block = FOLD_THREADS // fold_lanes(m)
    nout = per_block + 3 if m <= 32 else 2 * per_block - 1
    if kind == "random_ragged":
        f = rand_ints(40 + m, nout * m)
        f[:len(EDGE)] = EDGE
        z = rand_ints(41 + m, 1)[0]
        zp = [pow(z, t, P) for t in range(m)]
    elif kind == "all_p_minus_1":
        f, zp, z = [P - 1] * (nout * m), [P - 1] * m, None
    else:
        f = [0] * (nout * m)
        f[m:2 * m] = [P - 1] * m        # one output that is not zero
        z = rand_ints(42 + m, 1)[0]
        zp = [pow(z, t, P) for t in range(m)]
    fa = tfr.to_u64(tfr.pack_ints(f, mont=True))
    za = tfr.to_u64(tfr.pack_ints(zp, mont=True))
    out = np.zeros((nout, 4), np.uint64)
    assert host_check_lib().hc_fold(u64p(fa), u64p(za), u64p(out), nout,
                                    m) == 0
    got = tfr.from_u64(out)
    want = [sum(f[b * m + t] * zp[t] for t in range(m)) % P
            for b in range(nout)]
    assert tfr.unpack_ints(got, mont=True) == want
    if z is not None:
        assert want == fri_fold_layer(f, z, m)
    assert np.array_equal(
        got, tfr.fold_plain(port_tensor(f, mont=True),
                            port_tensor(zp, mont=True)).numpy())


@pytest.mark.parametrize("m", [1, 3, 24, 1024])
def test_fold_odd_arity_on_host(m):
    """m that is not a power of two (lanes take m/G terms and some one more)
    and the entry point's limits, 1 and 1,024; m = 0 and 1,025 refused."""
    nout = 5
    f = rand_ints(50 + m, nout * m)
    zp = rand_ints(51 + m, m)
    fa = tfr.to_u64(tfr.pack_ints(f, mont=True))
    za = tfr.to_u64(tfr.pack_ints(zp, mont=True))
    out = np.zeros((nout, 4), np.uint64)
    lib = host_check_lib()
    assert lib.hc_fold(u64p(fa), u64p(za), u64p(out), nout, m) == 0
    assert tfr.unpack_ints(tfr.from_u64(out), mont=True) == [
        sum(f[b * m + t] * zp[t] for t in range(m)) % P for b in range(nout)]
    for bad in (0, 1025):
        assert lib.hc_fold(u64p(fa), u64p(za), u64p(out), 1, bad) == 1


# ---------------------------------------------------------------------------
# K6: the tile transform.
# ---------------------------------------------------------------------------

# The pass radices whose accesses `ntt_phys` keeps conflict-free: the
# kernel's NTT_R = 2 and the 3 and 4 that scripts/ntt_tile_sweep.cu builds
# from the same steps.
SWIZZLE_RADII = (2, 3, 4)


def hc_tiles(x, wt, ep, out, nthreads, tpb):
    args = list(tntt._kernel_args(x, wt, ep, out))
    args[6] = tpb
    assert host_check_lib().hc_ntt_tile(*args, nthreads) == 0
    return out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("logL", range(1, 13))
def test_ntt_tile_passes_on_host(logL, inverse):
    """Every L from 2 to 4,096 (so both splits of the stages into passes of
    two: one stage first where log2 L is odd): a batch of columns (element
    stride B) with a full epilogue, written to columns of another tensor,
    with 37 threads a block (a count that divides no pass's groups), ragged
    last blocks where L is short; against the plain version, and for
    L <= 32 against the O(L^2) sum in Python ints."""
    L = 1 << logL
    B = 37 if L <= 64 else (5 if L <= 512 else 3)
    tpb = max(1, 64 // L)
    wt = tntt.stage_twiddles(L, inverse, "cpu")
    flat = elems(2000 + 2 * logL + inverse, L * B)
    flat[:len(EDGE)] = port_tensor(EDGE)
    x = flat.reshape(L, B, 8).transpose(0, 1)           # [B, L] columns
    ep = elems(2100 + 2 * logL + inverse, B, L)
    want = tntt.ntt_tiles_plain(x, wt, ep)
    out = torch.zeros((L, B, 8), dtype=torch.int32).transpose(0, 1)
    assert torch.equal(hc_tiles(x, wt, ep, out, 37, tpb), want)
    if L <= 32:
        w = tntt._root(L, inverse)
        xs = tfr.unpack_ints(x.reshape(-1, 8), mont=True)
        es = tfr.unpack_ints(ep.reshape(-1, 8), mont=True)
        got = tfr.unpack_ints(want.reshape(-1, 8), mont=True)
        for b in range(B):
            for j in range(L):
                s = sum(xs[b * L + i] * pow(w, i * j, P) for i in range(L))
                assert got[b * L + j] == s * es[b * L + j] % P, (b, j)


def test_ntt_tile_refuses_bad_layouts_on_host():
    """Calls the kernel does not take: a block whose slots are no multiple
    of the 2^NTT_R = 4 that a thread's group holds (one transform of 2),
    L past 4,096, no transform a block, no thread (refused before the
    twiddles are read)."""
    lib = host_check_lib()
    wt = tntt.stage_twiddles(2, False, "cpu")
    for logL, tpb, nthreads in ((1, 1, 8), (13, 1, 8), (2, 0, 8), (2, 4, 0)):
        x = elems(2400 + logL, 3, 1 << logL)
        args = list(tntt._kernel_args(x, wt, None, torch.zeros_like(x)))
        args[6] = tpb
        assert lib.hc_ntt_tile(*args, nthreads) == 1, (logL, tpb, nthreads)


def lane_slots(pattern: str, r: int, s0: int, logL: int) -> list:
    """The slots that the 32 lanes of one warp touch together: in a pass at
    s0 (register k = 0, groups 0..31), in the load (bit-reversed slots of 32
    consecutive elements) and in the store (32 consecutive slots)."""
    if pattern == "pass":
        low = (1 << s0) - 1
        return [((g & ~low) << r) | (g & low) for g in range(32)]
    if pattern == "load":
        return [int(bin(i | 1 << logL)[:2:-1], 2) for i in range(32)]
    return list(range(32))


def test_shared_planes_meet_32_banks():
    """`ntt_phys` permutes each row of 32 slots, and every warp access of
    the passes of each radix in SWIZZLE_RADII (every L up to 4,096), of the
    load and of the store meets 32 distinct banks."""
    lib = host_check_lib()
    phys = [lib.hc_ntt_phys(x) for x in range(1 << 13)]
    for row in range(len(phys) // 32):
        assert sorted(phys[32 * row:32 * row + 32]) == list(
            range(32 * row, 32 * row + 32))
    for logL in range(5, 13):
        for r in SWIZZLE_RADII:
            s0 = logL % r or r
            starts = [0] + list(range(s0, logL, r))
            for s in starts:
                banks = {phys[x] % 32 for x in lane_slots("pass", r, s, logL)}
                assert len(banks) == 32, (logL, r, s)
        for kind in ("load", "store"):
            banks = {phys[x] % 32 for x in lane_slots(kind, 3, 0, logL)}
            assert len(banks) == 32, (logL, kind)
