"""m-ary Poseidon Merkle trees with union-of-paths multiproofs: golden spec.

Mirrors `the Rust reference, crates/merkle/src/lib.rs`:
  - DS-aware trees: every internal node hash is domain-separated by
    DsLabel{arity, level, position(parent idx), tree_label} absorbed as a
    4-field preamble (:57-74, :166-178),
  - single-column (`new`, :147-193) and pair-leaf (`new_pairs`, :392-445,
    leaf DS level = u32::MAX) constructors,
  - legacy t=17 constructors without per-node DS (:196-223, :448-483),
  - union-of-paths batched multiproof encoder (:246-315) and the
    level-by-level frontier-reconstruction verifiers (:487-773),
  - `MerkleProver` / `LegacyMerkleProver` facades (:777-905),
  - `default_params()` seeded with b"POSEIDON-T17-X5-SEED" (:366-369).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .field import P
from .poseidon import (PoseidonParams, generate_params_t17, hash_with_ds,
                       hash_with_ds_dynamic, params_for_arity, width_for_arity)

LEAF_LEVEL_DS = 0xFFFFFFFF  # u32::MAX (merkle/src/lib.rs:378)


def default_params() -> PoseidonParams:
    return generate_params_t17(b"POSEIDON-T17-X5-SEED")


def ds_fields(arity: int, level: int, position: int, tree_label: int) -> list:
    """DsLabel::to_fields (merkle/src/lib.rs:66-74)."""
    return [arity % P, level % P, position % P, tree_label % P]


@dataclass
class MerkleChannelCfg:
    arity: int
    params: PoseidonParams
    tree_label: int = 0

    @classmethod
    def new(cls, arity: int, tree_label: int = 0) -> "MerkleChannelCfg":
        return cls(arity, params_for_arity(arity), tree_label)


def _check_width(arity: int, t: int) -> None:
    assert width_for_arity(arity) == t, \
        f"arity {arity} incompatible with Poseidon width t={t}"


@dataclass
class MerkleProof:
    """Union-of-paths multiproof (merkle/src/lib.rs:131-143)."""
    indices: list          # unique-sorted requested leaf indices
    siblings: list         # per level: flat list of sibling digests
    group_sizes: list      # per level: child_count per touched parent
    arity: int


class MerkleTree:
    """Stores all levels; levels[0] = leaves (digests), last = [root]."""

    def __init__(self, levels: list, arity: int, cfg=None, ds_tag: int = 0,
                 params: PoseidonParams | None = None):
        self.levels = levels
        self.arity = arity
        self.cfg = cfg              # DS-aware config, or None for legacy
        self.ds_tag = ds_tag        # legacy capacity DS tag
        self.params = params        # legacy static params

    # -- constructors -------------------------------------------------------

    @classmethod
    def new(cls, leaves: list, cfg: MerkleChannelCfg) -> "MerkleTree":
        """Single-column DS-aware (merkle/src/lib.rs:147-193)."""
        assert leaves, "no leaves"
        _check_width(cfg.arity, cfg.params.t)
        levels = [list(leaves)]
        level = 0
        while len(levels[-1]) > 1:
            cur = levels[-1]
            nxt = []
            for parent_idx in range((len(cur) + cfg.arity - 1) // cfg.arity):
                chunk = cur[parent_idx * cfg.arity:(parent_idx + 1) * cfg.arity]
                nxt.append(hash_with_ds_dynamic(
                    ds_fields(cfg.arity, level, parent_idx, cfg.tree_label),
                    chunk, cfg.params))
            levels.append(nxt)
            level += 1
        return cls(levels, cfg.arity, cfg=cfg)

    @classmethod
    def new_pairs(cls, f_vals: list, cp_vals: list,
                  cfg: MerkleChannelCfg) -> "MerkleTree":
        """Pair-leaf DS-aware; leaf = H(ds(LEAF_LEVEL, idx) || [f, cp])
        (merkle/src/lib.rs:380-445)."""
        assert len(f_vals) == len(cp_vals) and f_vals
        level0 = [
            encode_leaf_digest_ds(i, cfg, f_vals[i], cp_vals[i])
            for i in range(len(f_vals))
        ]
        return cls.new(level0, cfg)

    @classmethod
    def new_legacy(cls, leaves: list, ds_tag: int,
                   params: PoseidonParams) -> "MerkleTree":
        """Legacy t=17, chunked by RATE=16, DS tag in capacity
        (merkle/src/lib.rs:196-223)."""
        assert leaves, "no leaves"
        rate = params.rate
        levels = [list(leaves)]
        while len(levels[-1]) > 1:
            cur = levels[-1]
            nxt = [hash_with_ds(cur[o:o + rate], ds_tag, params)
                   for o in range(0, len(cur), rate)]
            levels.append(nxt)
        return cls(levels, rate, ds_tag=ds_tag, params=params)

    @classmethod
    def new_pairs_legacy(cls, f_vals, cp_vals, ds_tag: int,
                         params: PoseidonParams) -> "MerkleTree":
        """merkle/src/lib.rs:448-483."""
        assert len(f_vals) == len(cp_vals) and f_vals
        level0 = [hash_with_ds([f, cp], ds_tag, params)
                  for f, cp in zip(f_vals, cp_vals)]
        return cls.new_legacy(level0, ds_tag, params)

    # -- accessors -----------------------------------------------------------

    def root(self) -> int:
        return self.levels[-1][0]

    def height(self) -> int:
        return len(self.levels) - 1

    # -- union-of-paths multiproof encoder (merkle/src/lib.rs:246-315) -------

    def open_many(self, indices: list) -> MerkleProof:
        assert indices, "open_many: empty indices"
        arity = self.arity
        cur = sorted(set(indices))
        assert all(0 <= i < len(self.levels[0]) for i in cur)

        siblings_per_level = []
        group_sizes_per_level = []
        for level in range(self.height()):
            nodes = self.levels[level]
            groups: dict = {}
            for i in cur:
                groups.setdefault(i // arity, []).append(i % arity)

            level_siblings = []
            level_group_sizes = []
            for parent_idx in sorted(groups):
                opened = sorted(groups[parent_idx])
                base = parent_idx * arity
                child_count = min(base + arity, len(nodes)) - base
                level_group_sizes.append(child_count)
                opened_set = set(opened)
                for cpos in range(child_count):
                    if cpos not in opened_set:
                        level_siblings.append(nodes[base + cpos])
            siblings_per_level.append(level_siblings)
            group_sizes_per_level.append(level_group_sizes)
            cur = sorted(set(i // arity for i in cur))

        return MerkleProof(sorted(set(indices)), siblings_per_level,
                           group_sizes_per_level, arity)

    open_many_single = open_many


def encode_leaf_digest_ds(index: int, cfg: MerkleChannelCfg,
                          f: int, cp: int) -> int:
    """merkle/src/lib.rs:380-388."""
    return hash_with_ds_dynamic(
        ds_fields(cfg.arity, LEAF_LEVEL_DS, index, cfg.tree_label),
        [f, cp], cfg.params)


# ---------------------------------------------------------------------------
# Verifiers: frontier reconstruction level by level.
# ---------------------------------------------------------------------------

def _reconstruct(root: int, indices: list, values: list, proof: MerkleProof,
                 parent_hash) -> bool:
    """Shared union-of-paths reconstruction; `parent_hash(level, parent_idx,
    children) -> digest` supplies the hashing policy."""
    if not indices or len(indices) != len(values):
        return False
    req = sorted(set(indices))
    if proof.indices != req:
        return False
    if len(proof.siblings) != len(proof.group_sizes):
        return False
    arity = proof.arity

    val_map = dict(zip(indices, values))
    cur_indices = req
    cur_values = [val_map[i] for i in req]

    for level, (level_siblings, level_group_sizes) in enumerate(
            zip(proof.siblings, proof.group_sizes)):
        groups: dict = {}
        for idx, val in zip(cur_indices, cur_values):
            groups.setdefault(idx // arity, []).append((idx % arity, val))
        if len(groups) != len(level_group_sizes):
            return False

        next_indices, next_values = [], []
        off = 0
        for (parent_idx, opened), child_count in zip(
                sorted(groups.items()), level_group_sizes):
            if child_count == 0 or child_count > arity:
                return False
            opened = sorted(opened)
            opened_iter = iter(opened)
            pending = next(opened_iter, None)
            children = []
            for cpos in range(child_count):
                if pending is not None and pending[0] == cpos:
                    children.append(pending[1])
                    pending = next(opened_iter, None)
                else:
                    if off >= len(level_siblings):
                        return False
                    children.append(level_siblings[off])
                    off += 1
            next_indices.append(parent_idx)
            next_values.append(parent_hash(level, parent_idx, children))
        if off != len(level_siblings):
            return False
        cur_indices, cur_values = next_indices, next_values

    return len(cur_values) == 1 and cur_values[0] == root


def verify_many(root, indices, values, proof, ds_tag: int,
                params: PoseidonParams) -> bool:
    """Legacy verifier (merkle/src/lib.rs:487-584)."""
    return _reconstruct(
        root, indices, values, proof,
        lambda level, pidx, children: hash_with_ds(children, ds_tag, params))


def verify_many_ds(root, indices, values, proof, tree_label: int,
                   params: PoseidonParams) -> bool:
    """DS-aware verifier (merkle/src/lib.rs:587-701)."""
    if width_for_arity(proof.arity) != params.t:
        return False
    return _reconstruct(
        root, indices, values, proof,
        lambda level, pidx, children: hash_with_ds_dynamic(
            ds_fields(proof.arity, level, pidx, tree_label),
            children, params))


def verify_pairs_legacy(root, indices, pairs, proof, ds_tag,
                        params: PoseidonParams) -> bool:
    """merkle/src/lib.rs:704-720."""
    if len(indices) != len(pairs) or not indices:
        return False
    leaves = [hash_with_ds([f, cp], ds_tag, params) for f, cp in pairs]
    return verify_many(root, indices, leaves, proof, ds_tag, params)


def verify_pairs_ds(root, indices, pairs, proof, tree_label,
                    params: PoseidonParams) -> bool:
    """merkle/src/lib.rs:723-773 (recomputes leaf digests with LEAF_LEVEL_DS,
    aligned to unique-sorted index order)."""
    if len(indices) != len(pairs) or not indices:
        return False
    if width_for_arity(proof.arity) != params.t:
        return False
    pair_map = dict(zip(indices, pairs))
    req = sorted(set(indices))
    cfg = MerkleChannelCfg(proof.arity, params, tree_label)
    leaves = [encode_leaf_digest_ds(i, cfg, *pair_map[i]) for i in req]
    return verify_many_ds(root, req, leaves, proof, tree_label, params)


# ---------------------------------------------------------------------------
# Facades (merkle/src/lib.rs:777-905).
# ---------------------------------------------------------------------------

class MerkleProver:
    def __init__(self, cfg: MerkleChannelCfg):
        self.cfg = cfg

    def commit_single(self, leaves):
        tree = MerkleTree.new(list(leaves), self.cfg)
        return tree.root(), tree

    def open_single(self, tree: MerkleTree, indices):
        return tree.open_many(indices)

    def verify_single(self, root, indices, leaves, proof) -> bool:
        return verify_many_ds(root, indices, leaves, proof,
                              self.cfg.tree_label, self.cfg.params)

    def commit_pairs(self, f_vals, cp_vals):
        tree = MerkleTree.new_pairs(f_vals, cp_vals, self.cfg)
        return tree.root(), tree

    def open_pairs(self, tree, f_vals, cp_vals, indices):
        uniq = sorted(set(indices))
        pairs = [(f_vals[i], cp_vals[i]) for i in uniq]
        return pairs, tree.open_many(uniq)

    def verify_pairs(self, root, indices, pairs, proof) -> bool:
        return verify_pairs_ds(root, indices, pairs, proof,
                               self.cfg.tree_label, self.cfg.params)


class LegacyMerkleProver:
    def __init__(self, ds_tag: int, params: PoseidonParams):
        self.ds_tag = ds_tag
        self.params = params

    def commit_pairs(self, f_vals, cp_vals):
        tree = MerkleTree.new_pairs_legacy(f_vals, cp_vals, self.ds_tag,
                                           self.params)
        return tree.root(), tree

    def open_pairs(self, tree, f_vals, cp_vals, indices):
        uniq = sorted(set(indices))
        pairs = [(f_vals[i], cp_vals[i]) for i in uniq]
        return pairs, tree.open_many(uniq)

    def verify_pairs(self, root, indices, pairs, proof) -> bool:
        return verify_pairs_legacy(root, indices, pairs, proof, self.ds_tag,
                                   self.params)
