"""Roofline accounting for the hot kernels on one NVIDIA H100.

Counterpart of `utils/roofline.py` of the JAX package.  The algorithmic
count of a permutation (`poseidon_field_muls`) is the same; the peaks and
the work models are the card's and the port's own:

  - peaks: 3.35 TB/s of HBM (H100 SXM data sheet) and 67e12 operations/s,
    the float32 rate of the pipes outside the tensor cores.  The data
    sheet gives no rate for 32-bit integer multiply-adds there; the
    integer pipes are no faster than the float32 ones, so a time derived
    from this rate is a lower bound;
  - work: 64x64-bit multiply-adds (`mac64`) as the port's kernels compute
    them on `csrc/fr32.cuh`, each four 32-bit multiply-adds, i.e. eight
    operations; an element is 32 bytes (`[..., 8] int32`).

`bound` is the least time the card could take for a function: the larger
of its bytes (each input read once, each output written once) over the
memory rate and its operations over the operation rate.
"""

from __future__ import annotations

import math

from ..spec.poseidon import PoseidonParams

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
OPS_PER_MAC64 = 8              # a 64x64->128 multiply-add = 4 32-bit ones

# The work of the field primitives in 64x64-bit multiply-adds, whatever
# limbs a kernel uses.
MAC_MONT_MUL = 36              # 16 a*b + 16 m*P + 4 m
MAC_ACC_MUL = 16               # a lazy product, reduced later
MAC_REDC320 = 25               # one reduction of a 2^320-scaled row sum
MAC_POW5 = 3 * MAC_MONT_MUL


def poseidon_field_muls(params: PoseidonParams) -> int:
    """Modular multiplies of ONE reference permutation (poseidon/src/
    lib.rs:31-68): per full round, t S-boxes x^5 (3 multiplies each) and
    the dense t x t matrix; per partial round, one S-box and the dense
    matrix.  This is the algorithmic count that throughputs are measured
    against; the kernels' sparse partial rounds do less."""
    t = params.t
    full = params.rf * (3 * t + t * t)
    part = params.rp * (3 + t * t)
    return full + part


def permute_macs(t: int, rf: int, rp: int) -> int:
    """64-bit multiply-adds of one permutation as the kernels compute it
    (dense full rounds, sparse partial rounds, one dense matrix after)."""
    dense = t * t * MAC_ACC_MUL + t * MAC_REDC320
    full = rf * (t * MAC_POW5 + dense)
    part = rp * MAC_POW5 + (rp - 1) * (
        t * MAC_ACC_MUL + MAC_REDC320 + (t - 1) * MAC_MONT_MUL)
    return full + part + dense


def ntt_tile_macs(L: int, with_epilogue: bool) -> int:
    """64-bit multiply-adds of one length-L tile transform: a Montgomery
    product per butterfly of every stage but the first (whose twiddle is
    1), and one per element for the epilogue."""
    stages = L.bit_length() - 1
    return MAC_MONT_MUL * (L // 2 * (stages - 1) + (L if with_epilogue else 0))


def ntt_macs(n: int) -> int:
    """64-bit multiply-adds of a radix-2 NTT of n elements: one Montgomery
    product per butterfly, (n/2) log2 n butterflies."""
    return MAC_MONT_MUL * (n // 2) * int(math.log2(n))


def bound(nbytes: int, macs: int):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `nbytes` and compute `macs` 64-bit multiply-adds, and which of
    the two sets it."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = macs * OPS_PER_MAC64 / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def poseidon_rates(params: PoseidonParams, perms_per_s: float) -> dict:
    """Achieved rates of a measured permutation throughput: field
    multiplies (the algorithmic count), the kernels' 64-bit multiply-adds
    and their share of the operation peak (a t=17 permutation reads and writes
    1,088 bytes for ~1.2e5 multiply-adds: bound by operations)."""
    muls = poseidon_field_muls(params)
    macs = permute_macs(params.t, params.rf, params.rp)
    return {
        "field_muls_per_perm": muls,
        "field_muls_per_s": perms_per_s * muls,
        "mac64_per_perm": macs,
        "mac64_per_s": perms_per_s * macs,
        "ops_fraction": perms_per_s * macs * OPS_PER_MAC64 / INT_OPS_PER_S,
    }


def ntt_rates(n: int, seconds: float) -> dict:
    """Rates of a measured NTT of n elements: butterfly multiplies a
    second, the 64-bit multiply-adds a second and their share of the
    operation peak."""
    muls = (n // 2) * int(math.log2(n))
    macs = ntt_macs(n)
    return {
        "field_muls_per_s": muls / seconds,
        "mac64_per_s": macs / seconds,
        "ops_fraction": macs * OPS_PER_MAC64 / seconds / INT_OPS_PER_S,
    }
