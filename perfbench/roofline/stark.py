"""A DEEP-ALI + FRI proof's permutations by kernel and width.

K1 (`poseidon_permute*`, widths 9 and 17) takes every commit: the
one-permutation leaf digest Poseidon(f, s) of each element of a layer
committed at arity >= 8, the pair-leaf digests of a layer below, and
the internal nodes of every tree whose width is 9 or 17; K5 the nodes of
wider trees.  The Fiat-Shamir absorb of columns on the card runs in K4
(`poseidon_absorb_chain`): the rate blocks after the first of each of
the four column chains, whose first block (completed after the
transcript's 4-field prefix) is one K1 permutation a column.  Host
columns are absorbed in the host engine, and the query-index seeds
(r x layers one-block hashes) are hashed on the host: neither is
counted here.
"""

from __future__ import annotations

from collections import Counter

from perfbench.reference.stark import HASHED_LEAF_ARITIES, pick_arity

from . import sponge_perms, tree_perms, width_for_arity

PREFIX_FIELDS = 4      # Transcript("FRI/FS") + absorb_bytes(tag): 2 + 2
RATE = 16


def work(config: dict, traffic: dict) -> dict:
    n0, schedule = 1 << int(traffic["k"]), list(config["schedule"])
    sizes = [n0]
    for m in schedule:
        sizes.append(sizes[-1] // m)
    k1, k5 = Counter(), Counter()
    for ell, n in enumerate(sizes):
        arity = pick_arity(n, schedule[ell] if ell < len(schedule) else 1)
        t = width_for_arity(arity)
        if arity in HASHED_LEAF_ARITIES:
            k1[17] += n
        else:
            k1[t] += n * sponge_perms(2, t)
        (k1 if t in (9, 17) else k5)[t] += tree_perms(n, arity)
    out = {"k1": dict(k1)}
    if k5:
        out["k5"] = dict(k5)
    if traffic["witness"] == "device":
        head = min(n0, RATE - PREFIX_FIELDS)
        if PREFIX_FIELDS + head == RATE:
            k1[17] += 4
            out["k1"] = dict(k1)
        out["k4"] = {17: 4 * ((n0 - head) // RATE)}
    return out
