"""Batched m-ary Poseidon Merkle tree engine on the card.

Counterpart of `merkle/__init__.py` of the JAX package (itself the device
form of crates/merkle/src/lib.rs of the Rust reference), bit-exact against
`spec.merkle`:

  - tree build is level-by-level batched sponge hashing on the device:
    each level is one (or two, with a partial tail group) reshape ->
    Poseidon call over all parents, incl. the DsLabel 4-field preamble,
  - pair-leaf trees hash (f, cp) with the LEAF_LEVEL_DS sentinel,
  - union-of-paths multiproofs are planned host-side from indices alone and
    assembled from gathered device nodes, producing spec `MerkleProof`s,
  - verifiers mirror the spec frontier reconstruction but batch each
    level's parent hashes into one call: small batches run in the host
    engine (no device round trip), large ones on the device.

Digests live on the device in Montgomery form; host ints are materialized
only for proof assembly and transcript absorption.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..ops import fr
from ..ops import poseidon as dpos
from ..spec.merkle import LEAF_LEVEL_DS, MerkleChannelCfg, MerkleProof
from ..spec.poseidon import PoseidonParams, width_for_arity

__all__ = ["DeviceMerkleTree", "build_levels_from", "build_tree",
           "build_tree_pairs", "hash_pair_leaves", "ds_rows_mont",
           "ds_rows_device", "verify_many_ds", "verify_pairs_ds",
           "MerkleChannelCfg", "MerkleProof"]


# ---------------------------------------------------------------------------
# DS label rows.
# ---------------------------------------------------------------------------

def ds_rows_mont(arity: int, level: int, positions, tree_label: int):
    """[g, 4, 8] Montgomery DS preambles (DsLabel::to_fields order), built
    on the host with numpy for arbitrary positions."""
    pos = np.asarray(positions, dtype=np.uint64).reshape(-1)
    g = pos.shape[0]
    consts = fr.pack_ints([arity, level, tree_label], mont=True)
    pos_limbs = fr.pack_ints([int(p) for p in pos], mont=True)
    out = np.empty((g, 4, fr.N), dtype=np.int32)
    out[:, 0, :] = consts[0]
    out[:, 1, :] = consts[1]
    out[:, 2, :] = pos_limbs
    out[:, 3, :] = consts[2]
    return out


def ds_rows_device(arity: int, level: int, g: int, tree_label: int, device,
                   start: int = 0) -> torch.Tensor:
    """[g, 4, 8] Montgomery DS preambles for positions start..start+g-1,
    computed ON the device: the only non-constant column is the position,
    built from an arange and converted with `fr.to_mont`, so a large level
    costs no host build and no upload."""
    consts = fr.to_device(fr.pack_ints([arity, level, tree_label],
                                       mont=True), device)
    i = torch.arange(start, start + g, dtype=torch.int64, device=device)
    pos = torch.zeros((g, fr.N), dtype=torch.int64, device=device)
    pos[:, 0] = i & 0xFFFFFFFF
    pos[:, 1] = (i >> 32) & 0xFFFFFFFF
    pos = (pos - ((pos >> 31) << 32)).to(torch.int32)
    out = torch.empty((g, 4, fr.N), dtype=torch.int32, device=device)
    out[:, 0] = consts[0]
    out[:, 1] = consts[1]
    out[:, 2] = fr.to_mont(pos)
    out[:, 3] = consts[2]
    return out


def _hash_level_ds(ds_rows, chunks, dp):
    return dpos.sponge_hash_ds_dynamic(ds_rows, chunks, dp)


# ---------------------------------------------------------------------------
# Tree object (duck-types the spec MerkleTree for open_many/root).
# ---------------------------------------------------------------------------

class DeviceMerkleTree:
    """Per-level device digest tensors ([n_l, 8] Montgomery limbs)."""

    def __init__(self, levels_dev, arity, cfg=None):
        self.levels_dev = levels_dev
        self.arity = arity
        self.cfg = cfg
        self._levels_host = [None] * len(levels_dev)

    def level_ints(self, level: int) -> list:
        """Whole level as canonical ints (one bulk transfer, cached) -
        proof assembly then needs no further device round trips."""
        if self._levels_host[level] is None:
            self._levels_host[level] = fr.unpack_ints(
                fr.from_mont(self.levels_dev[level]))
        return self._levels_host[level]

    def root(self) -> int:
        return self.level_ints(len(self.levels_dev) - 1)[0]

    def height(self) -> int:
        return len(self.levels_dev) - 1

    def num_leaves(self) -> int:
        return int(self.levels_dev[0].shape[0])

    def node_ints(self, level: int, indices) -> list:
        lvl = self.level_ints(level)
        return [lvl[i] for i in indices]

    def open_plan(self, indices):
        """Pure index planning of a union-of-paths multiproof
        (merkle/src/lib.rs:246-315): (requested, sibling indices per level,
        group sizes per level).  No value fetches."""
        assert len(indices) > 0, "open_many: empty indices"
        arity = self.arity
        cur = sorted(set(int(i) for i in indices))
        n0 = self.num_leaves()
        assert all(0 <= i < n0 for i in cur)

        sib_indices_per_level = []
        group_sizes_per_level = []
        for level in range(self.height()):
            n_level = int(self.levels_dev[level].shape[0])
            groups: dict = {}
            for i in cur:
                groups.setdefault(i // arity, []).append(i % arity)

            sib_indices = []
            level_group_sizes = []
            for parent_idx in sorted(groups):
                opened = set(groups[parent_idx])
                base = parent_idx * arity
                child_count = min(base + arity, n_level) - base
                level_group_sizes.append(child_count)
                for cpos in range(child_count):
                    if cpos not in opened:
                        sib_indices.append(base + cpos)
            sib_indices_per_level.append(sib_indices)
            group_sizes_per_level.append(level_group_sizes)
            cur = sorted(set(i // arity for i in cur))

        return (sorted(set(int(i) for i in indices)),
                sib_indices_per_level, group_sizes_per_level)

    def open_from_plan(self, plan, sibling_values_per_level) -> MerkleProof:
        req, _, group_sizes = plan
        return MerkleProof(req, sibling_values_per_level, group_sizes,
                           self.arity)

    def open_many(self, indices) -> MerkleProof:
        """Union-of-paths multiproof with values fetched from the cached
        host levels."""
        plan = self.open_plan(indices)
        _, sib_idx, _ = plan
        values = [self.node_ints(level, idxs)
                  for level, idxs in enumerate(sib_idx)]
        return self.open_from_plan(plan, values)


# ---------------------------------------------------------------------------
# Builders.
# ---------------------------------------------------------------------------

def build_levels_from(cur, cfg: MerkleChannelCfg, level_start: int):
    """Hash levels upward from an arbitrary tree level: `cur` holds the
    nodes of level `level_start` (global positions 0..); returns the list
    of device level tensors from `cur` to the root."""
    dp = dpos.device_params(cfg.params)
    arity = cfg.arity
    dev = cur.device
    levels = [cur]
    level = level_start
    while cur.shape[0] > 1:
        n = int(cur.shape[0])
        full = n // arity
        outs = []
        if full:
            ds = ds_rows_device(arity, level, full, cfg.tree_label, dev)
            chunks = cur[:full * arity].reshape(full, arity, fr.N)
            outs.append(_hash_level_ds(ds, chunks, dp))
        if n % arity:
            # the ragged last group: fewer children, its own pad position
            ds = ds_rows_device(arity, level, 1, cfg.tree_label, dev,
                                start=full)
            chunk = cur[full * arity:].reshape(1, n - full * arity, fr.N)
            outs.append(_hash_level_ds(ds, chunk, dp))
        cur = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        levels.append(cur)
        level += 1
    return levels


def build_tree(leaves_mont, cfg: MerkleChannelCfg) -> DeviceMerkleTree:
    """Single-column DS-aware tree (merkle/src/lib.rs:147-193)."""
    assert width_for_arity(cfg.arity) == cfg.params.t
    levels = build_levels_from(leaves_mont, cfg, 0)
    return DeviceMerkleTree(levels, cfg.arity, cfg=cfg)


def hash_pair_leaves(f_mont, cp_mont, cfg: MerkleChannelCfg):
    """Leaf digests H(ds(arity, LEAF_LEVEL, idx, label) || [f, cp])
    (merkle/src/lib.rs:378-388), batched."""
    n = int(f_mont.shape[0])
    dp = dpos.device_params(cfg.params)
    ds = ds_rows_device(cfg.arity, LEAF_LEVEL_DS, n, cfg.tree_label,
                        f_mont.device)
    inputs = torch.stack([f_mont, cp_mont], dim=1)
    return _hash_level_ds(ds, inputs, dp)


def build_tree_pairs(f_mont, cp_mont, cfg: MerkleChannelCfg):
    return build_tree(hash_pair_leaves(f_mont, cp_mont, cfg), cfg)


# ---------------------------------------------------------------------------
# Fast verifiers: spec frontier reconstruction with batched hashing.
# ---------------------------------------------------------------------------

# Rows at or below this hash in the host engine (no device round trip).
_NATIVE_CUTOFF = 1024


def _hash_groups_ds(entries, arity, level, tree_label, params, device=None):
    """entries: list[(parent_idx, children_ints)] with equal child counts.
    Returns canonical digests.  Small batches run in the host engine;
    large ones batch on `device`."""
    if len(entries) <= _NATIVE_CUTOFF:
        rows = [[arity, level, pidx, tree_label] + list(children)
                for pidx, children in entries]
        return native.hash_ds_dynamic_rows(rows, params)
    dev = resolve(device)
    g = len(entries)
    cc = len(entries[0][1])
    dp = dpos.device_params(params)
    flat = [v for _, children in entries for v in children]
    inputs = fr.to_device(fr.pack_ints(flat, mont=True), dev).reshape(
        g, cc, fr.N)
    ds = fr.to_device(ds_rows_mont(
        arity, level, np.array([e[0] for e in entries], np.uint64),
        tree_label), dev)
    return fr.unpack_ints(_hash_level_ds(ds, inputs, dp), mont=True)


def _reconstruct_fast(root, indices, values, proof: MerkleProof,
                      hash_level_groups) -> bool:
    """Union-of-paths frontier walk (mirrors spec merkle._reconstruct,
    merkle/src/lib.rs:487-701) with `hash_level_groups(level, groups)`
    batching all parent hashes of one level; groups is
    list[(parent_idx, children_ints)]."""
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

        assembled = []
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
            assembled.append((parent_idx, children))
        if off != len(level_siblings):
            return False

        # batch hashes by child_count (at most one partial tail group size)
        by_cc: dict = {}
        for gi, (pidx, children) in enumerate(assembled):
            by_cc.setdefault(len(children), []).append((gi, pidx, children))
        digests = [None] * len(assembled)
        for cc, items in by_cc.items():
            outs = hash_level_groups(
                level, [(pidx, children) for _, pidx, children in items])
            for (gi, _, _), dig in zip(items, outs):
                digests[gi] = dig

        cur_indices = [p for p, _ in assembled]
        cur_values = digests

    return len(cur_values) == 1 and cur_values[0] == root


def verify_many_ds(root, indices, values, proof, tree_label: int,
                   params: PoseidonParams, device=None) -> bool:
    """Batched verify_many_ds (merkle/src/lib.rs:587-701)."""
    if width_for_arity(proof.arity) != params.t:
        return False
    return _reconstruct_fast(
        root, indices, values, proof,
        lambda level, groups: _hash_groups_ds(
            groups, proof.arity, level, tree_label, params, device))


def verify_pairs_ds(root, indices, pairs, proof, tree_label: int,
                    params: PoseidonParams, device=None) -> bool:
    """Batched verify_pairs_ds (merkle/src/lib.rs:723-773)."""
    if len(indices) != len(pairs) or not indices:
        return False
    if width_for_arity(proof.arity) != params.t:
        return False
    pair_map = dict(zip(indices, pairs))
    req = sorted(set(indices))
    # a pair-leaf digest is a DS hash of level LEAF_LEVEL_DS at position i
    leaves = _hash_groups_ds([(i, list(pair_map[i])) for i in req],
                             proof.arity, LEAF_LEVEL_DS, tree_label, params,
                             device)
    return verify_many_ds(root, req, leaves, proof, tree_label, params,
                          device)
