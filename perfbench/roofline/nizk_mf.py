"""A Merkle-folded NIZK proof's permutations by kernel and width.

K1 (`poseidon_permute*`, t = 17) takes the arity-16 tree of every
layer, 2^k values down to 1 (internal nodes only: the values are the
leaves), and the k round challenges (one state each).  The channel's
transcript runs on the host and is not counted.
"""

from __future__ import annotations

from . import tree_perms


def work(config: dict, traffic: dict) -> dict:
    k = int(traffic["k"])
    return {"k1": {17: sum(tree_perms(1 << j, 16) for j in range(k + 1))
                   + k}}
