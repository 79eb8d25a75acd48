"""Canonical byte (de)serialization for Merkle trees, multiproofs and the
sum-check NIZK proofs.

Counterpart of `serde.py` of the JAX package.  The Rust reference derives
serde on `SerFr` (ark canonical compressed 32-byte LE field encoding),
`MerkleTree` (all levels; Poseidon params skipped and re-attached at load)
and `MerkleProof` (crates/merkle/src/lib.rs:10-54,114-143).  This module is
the wire-format counterpart: length-prefixed little-endian u64 framing
with 32-byte LE field elements (`FBytes` convention,
channel/src/lib.rs:894-922), working for both the spec `MerkleTree` and
the port's `DeviceMerkleTree` (levels are materialized to canonical ints,
one bulk read per level - persistence of committed state, not of device
buffers).

`serialize_nizk_proof` is the canonical encoding of a `ProofPlain` or
`ProofMF` (`spec.channel`): its fields in declaration order, byte strings
as they are, lists as a u64 length and their items, integers as u64.
It reads the fields by name, so it encodes the JAX package's proof objects
to the same bytes; the recorded digests of the NIZK proofs are taken on
it.
"""

from __future__ import annotations

import struct

from .spec.field import fr_from_bytes, fr_to_bytes
from .spec.merkle import MerkleProof, MerkleTree


def _w_u64(out: list, v: int) -> None:
    out.append(struct.pack("<Q", v))


def _w_u64_vec(out: list, xs) -> None:
    _w_u64(out, len(xs))
    for x in xs:
        _w_u64(out, x)


def _w_fr_vec(out: list, xs) -> None:
    _w_u64(out, len(xs))
    for x in xs:
        out.append(fr_to_bytes(x))


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.buf, self.off)[0]
        self.off += 8
        return v

    def fr_(self) -> int:
        v = fr_from_bytes(self.buf[self.off:self.off + 32])
        self.off += 32
        return v

    def fr_vec(self) -> list:
        return [self.fr_() for _ in range(self.u64())]

    def u64_vec(self) -> list:
        return [self.u64() for _ in range(self.u64())]

    def done(self) -> None:
        if self.off != len(self.buf):
            raise ValueError(f"{len(self.buf) - self.off} trailing bytes")


# ---------------------------------------------------------------------------
# MerkleTree (merkle/src/lib.rs:114-128: serde skips params/cfg — the
# loader re-attaches them, like ark re-attaching the field context).
# ---------------------------------------------------------------------------

def serialize_tree(tree) -> bytes:
    """Spec `MerkleTree` or device `DeviceMerkleTree` -> canonical bytes."""
    if hasattr(tree, "levels_dev"):  # device tree: one bulk read a level
        levels = [tree.level_ints(i) for i in range(len(tree.levels_dev))]
    else:
        levels = tree.levels
    out: list = []
    _w_u64(out, tree.arity)
    _w_u64(out, tree.ds_tag)
    _w_u64(out, len(levels))
    for lvl in levels:
        _w_fr_vec(out, lvl)
    return b"".join(out)


def deserialize_tree(buf: bytes, cfg=None, params=None) -> MerkleTree:
    """Canonical bytes -> spec `MerkleTree`.

    `cfg` (DS-aware `MerkleChannelCfg`) or `params` (legacy static) are
    re-attached by the caller, mirroring the reference's skip-params
    serde.  The loaded tree serves opens/verifies identically.
    """
    r = _Reader(buf)
    arity = r.u64()
    ds_tag = r.u64()
    n_levels = r.u64()
    levels = [r.fr_vec() for _ in range(n_levels)]
    r.done()
    return MerkleTree(levels, arity, cfg=cfg, ds_tag=ds_tag, params=params)


# ---------------------------------------------------------------------------
# MerkleProof (merkle/src/lib.rs:131-143).
# ---------------------------------------------------------------------------

def serialize_merkle_proof(mp: MerkleProof) -> bytes:
    out: list = []
    _w_u64(out, mp.arity)
    _w_u64_vec(out, mp.indices)
    _w_u64(out, len(mp.siblings))
    for lvl in mp.siblings:
        _w_fr_vec(out, lvl)
    _w_u64(out, len(mp.group_sizes))
    for lvl in mp.group_sizes:
        _w_u64_vec(out, lvl)
    return b"".join(out)


def deserialize_merkle_proof(buf: bytes) -> MerkleProof:
    r = _Reader(buf)
    arity = r.u64()
    indices = r.u64_vec()
    siblings = [r.fr_vec() for _ in range(r.u64())]
    group_sizes = [r.u64_vec() for _ in range(r.u64())]
    r.done()
    return MerkleProof(indices, siblings, group_sizes, arity)


# ---------------------------------------------------------------------------
# Sum-check NIZK proofs (spec.channel ProofPlain / ProofMF).
# ---------------------------------------------------------------------------

def _w_bytes_vec(out: list, xs) -> None:
    _w_u64(out, len(xs))
    out.extend(xs)


def _w_merkle_proof_bytes(out: list, mp) -> None:
    """`MerkleProofBytes`: arity, group_sizes, indices, siblings."""
    _w_u64(out, mp.arity)
    _w_u64(out, len(mp.group_sizes))
    for lvl in mp.group_sizes:
        _w_u64_vec(out, lvl)
    _w_u64_vec(out, mp.indices)
    _w_u64(out, len(mp.siblings))
    for lvl in mp.siblings:
        _w_bytes_vec(out, lvl)


def serialize_nizk_proof(proof) -> bytes:
    """ProofPlain (root, rounds [(c0, c1)], final_eval) or ProofMF
    (initial_root, rounds [RoundMF], final_eval) -> canonical bytes."""
    out: list = []
    if hasattr(proof, "initial_root"):
        out.append(proof.initial_root)
        _w_u64(out, len(proof.rounds))
        for r in proof.rounds:
            out.extend((r.c0, r.c1, r.next_root))
            _w_u64_vec(out, r.cur_indices)
            _w_bytes_vec(out, r.cur_values)
            _w_merkle_proof_bytes(out, r.cur_proof)
            _w_u64_vec(out, r.next_indices)
            _w_bytes_vec(out, r.next_values)
            _w_merkle_proof_bytes(out, r.next_proof)
    else:
        out.append(proof.root)
        _w_u64(out, len(proof.rounds))
        for c0, c1 in proof.rounds:
            out.extend((c0, c1))
    out.append(proof.final_eval)
    return b"".join(bytes(b) for b in out)
