"""m-ary Poseidon Merkle trees with DS labels and union-of-paths
multiproofs (crates/merkle/src/lib.rs).

An internal node is `hash_with_ds_dynamic([arity, level, position,
tree_label], children)` at the width the arity needs; a pair leaf is the
same hash at level u32::MAX over [f, s].  `open_many` gives, level by
level, the siblings of the opened nodes' groups and each group's child
count.
"""

from __future__ import annotations

from dataclasses import dataclass

from .field import P
from .poseidon import Params, hash_with_ds_dynamic

LEAF_LEVEL_DS = 0xFFFFFFFF


def ds_fields(arity: int, level: int, position: int, label: int) -> list:
    return [arity % P, level % P, position % P, label % P]


def _node_digests(p: Params, arity: int, level: int, label: int,
                  groups: list) -> list:
    """Digests of (position, children) groups of one level."""
    return [hash_with_ds_dynamic(ds_fields(arity, level, pos, label),
                                 children, p)
            for pos, children in groups]


def _pair_leaf_digests(p: Params, arity: int, label: int,
                       items: list) -> list:
    """Digests of (index, f, s) pair leaves."""
    return [hash_with_ds_dynamic(ds_fields(arity, LEAF_LEVEL_DS, i, label),
                                 [f, s], p)
            for i, f, s in items]


def pair_leaves(f: list, s: list, arity: int, p: Params, label: int,
                workers) -> list:
    items = [(i, a, b) for i, (a, b) in enumerate(zip(f, s))]
    return workers.map_items(_pair_leaf_digests, (p, arity, label), items)


@dataclass
class MerkleProof:
    indices: list
    siblings: list         # per level: the siblings, group by group
    group_sizes: list      # per level: the child count of each group
    arity: int


class MerkleTree:
    def __init__(self, leaves: list, arity: int, p: Params, label: int,
                 workers):
        if not leaves:
            raise ValueError("no leaves")
        if p.t < arity + 1:
            raise ValueError(f"arity {arity} needs a wider permutation")
        self.arity = arity
        self.levels = [list(leaves)]
        level = 0
        while len(self.levels[-1]) > 1:
            cur = self.levels[-1]
            groups = [(g, cur[g * arity:(g + 1) * arity])
                      for g in range((len(cur) + arity - 1) // arity)]
            self.levels.append(workers.map_items(
                _node_digests, (p, arity, level, label), groups))
            level += 1

    def root(self) -> int:
        return self.levels[-1][0]

    def open_many(self, indices: list) -> MerkleProof:
        arity = self.arity
        cur = sorted(set(indices))
        if not cur or not all(0 <= i < len(self.levels[0]) for i in cur):
            raise ValueError("bad opening indices")
        siblings, sizes = [], []
        for nodes in self.levels[:-1]:
            groups: dict = {}
            for i in cur:
                groups.setdefault(i // arity, set()).add(i % arity)
            lvl_sib, lvl_sizes = [], []
            for parent in sorted(groups):
                base = parent * arity
                count = min(base + arity, len(nodes)) - base
                lvl_sizes.append(count)
                lvl_sib.extend(nodes[base + c] for c in range(count)
                               if c not in groups[parent])
            siblings.append(lvl_sib)
            sizes.append(lvl_sizes)
            cur = sorted(set(i // arity for i in cur))
        return MerkleProof(sorted(set(indices)), siblings, sizes, arity)
