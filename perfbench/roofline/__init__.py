"""The yardstick of the kernels' roofline shares on one NVIDIA H100 SXM.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 3.35e12
bytes/s of HBM3 and 67e12 operations/s, the float32 rate of the pipes
outside the tensor cores.  The data sheet gives no rate for 32-bit
integer multiply-adds there; the integer pipes are no faster than the
float32 ones, so this rate stands in for an integer one, a time derived
from it is a lower bound, and every share against it reads low.  A
share is stated with the card's power limit beside it.

Work (frozen from the port's `utils/roofline.py` as it stood when the
benchmark was defined): 64x64-bit multiply-adds ("mac64", each four
32-bit ones, i.e. eight operations) of a Poseidon permutation as the
kernels compute it (dense full rounds, sparse partial rounds, one dense
matrix after), and 32 bytes an element, each state read once and
written once.

`work(config, traffic)` gives a proof's states by kernel and width,
counted from the configuration and the traffic by
`perfbench/roofline/<system>.py`.
"""

from __future__ import annotations

import importlib
import math

from perfbench.reference.poseidon import RF, RP_FOR_T, width_for_arity

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
OPS_PER_MAC64 = 8
ELEMENT_BYTES = 32

MAC_MONT_MUL = 36              # 16 a*b + 16 m*P + 4 m
MAC_ACC_MUL = 16               # a lazy product, reduced later
MAC_REDC320 = 25               # one reduction of a 2^320-scaled row sum
MAC_POW5 = 3 * MAC_MONT_MUL

def permute_macs(t: int, rf: int = RF, rp: int | None = None) -> int:
    rp = RP_FOR_T[t] if rp is None else rp
    dense = t * t * MAC_ACC_MUL + t * MAC_REDC320
    full = rf * (t * MAC_POW5 + dense)
    part = rp * MAC_POW5 + (rp - 1) * (
        t * MAC_ACC_MUL + MAC_REDC320 + (t - 1) * MAC_MONT_MUL)
    return full + part + dense


def sponge_perms(inputs: int, t: int) -> int:
    """Permutations of a DS sponge over `inputs` fields: 4 DS fields, the
    inputs and a 1, padded to whole blocks of rate t - 1."""
    return math.ceil((4 + inputs + 1) / (t - 1))


def tree_perms(leaves: int, arity: int) -> int:
    """Permutations of the internal nodes of an arity-ary DS tree."""
    t, total, n = width_for_arity(arity), 0, leaves
    while n > 1:
        full, rest = divmod(n, arity)
        total += full * sponge_perms(arity, t)
        if rest:
            total += sponge_perms(rest, t)
        n = full + (1 if rest else 0)
    return total


def work(config: dict, traffic: dict) -> dict:
    """{kernel: {width t: permutations a proof}}."""
    mod = importlib.import_module(f"perfbench.roofline.{config['system']}")
    return mod.work(config, traffic)


def bound_seconds(states_by_t: dict, nbytes: int | None = None) -> tuple:
    """(seconds, "bytes" or "operations"): the least time the card could
    take for these permutations: their bytes at the HBM rate (by default
    each state read and written once) or their multiply-adds at the
    operation rate, whichever is longer."""
    macs = sum(n * permute_macs(t) for t, n in states_by_t.items())
    if nbytes is None:
        nbytes = sum(2 * n * t * ELEMENT_BYTES
                     for t, n in states_by_t.items())
    tb = nbytes / HBM_BYTES_PER_S
    to = macs * OPS_PER_MAC64 / OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")
