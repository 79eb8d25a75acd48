"""Device/native-accelerated Fiat-Shamir transcript hashing.

The Rust reference drives FS through a Poseidon sponge transcript
(crates/transcript/src/lib.rs) and hashes *entire witness columns* into it
(`tr_hash_fields_tagged`, deep_ali/src/fri.rs:28-35).  The sponge chain is
inherently sequential, so the long column hashes run as four parallel
chains in the host engine; *independent* one-block tagged hashes (the
per-(layer, query) index seeds, the per-leaf pair hashes) batch across the
leading axis: whole FRI layers of leaf hashes on the device, small batches
in the host engine to avoid a device round trip.

Everything is bit-exact against `spec.transcript.Transcript`: prefix
states are replayed host-side with the golden model, and the final
challenge squeeze is finished host-side.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..ops import fr
from ..ops import poseidon as dpos
from ..spec.field import P
from ..spec.transcript import (DS_ABSORB_BYTES, DS_CHALLENGE, RATE, T,
                               Transcript, bytes_to_field_words,
                               default_params, domain_tag_to_field)
from ..transcript import resume_fast

# At or below this many rows, host-native hashing beats a device dispatch.
NATIVE_BATCH_CUTOFF = 1024


def _dp():
    return dpos.device_params(default_params())


@lru_cache(maxsize=None)
def transcript_prefix(label: bytes, tag: bytes):
    """(state ints tuple, pos) after Transcript(label).absorb_bytes(tag)."""
    tr = Transcript(label)
    tr.absorb_bytes(tag)
    return tuple(tr.state), tr.pos


# ---------------------------------------------------------------------------
# One-block tagged hashes, batched over rows.
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _one_block_consts(label: bytes, tag: bytes, k: int, out_label: bytes):
    """Constant sponge state (ints + packed numpy Montgomery limbs) for a
    tagged hash whose row fields + challenge preamble fit in one block."""
    state, p0 = transcript_prefix(label, tag)
    state = list(state)
    assert all(state[i] == 0 for i in range(p0, RATE)), "prefix crossed block"
    suffix = [domain_tag_to_field(DS_CHALLENGE),
              domain_tag_to_field(DS_ABSORB_BYTES)]
    suffix += bytes_to_field_words(out_label)
    assert p0 + k + len(suffix) <= RATE, "tagged hash does not fit one block"
    for i, v in enumerate(suffix):
        state[p0 + k + i] = v
    packed = fr.pack_ints(state, mont=True).reshape(T, fr.N)
    return tuple(state), packed, p0


def _one_block_hash_native(state_ints, p0, rows, params):
    """Host path: build the B sponge states and permute once in C++."""
    states = []
    for row in rows:
        st = list(state_ints)
        for i, v in enumerate(row):
            st[p0 + i] = (st[p0 + i] + v) % P
        states.append(st)
    return [s[0] for s in native.permute_ints_batch(states, params)]


def _one_block_hash_dev(packed, p0, vals):
    """Device path: vals [g, k, 8] Montgomery are placed at positions
    p0..p0+k of the constant state (zero there), one permutation each."""
    g, k = int(vals.shape[0]), int(vals.shape[1])
    state = fr.to_device(packed, vals.device).unsqueeze(0).repeat(g, 1, 1)
    state[:, p0:p0 + k] = vals
    return dpos.permute(state, _dp())[:, 0, :].contiguous()


def one_block_tagged_hash_batch(tag: bytes, rows, label: bytes = b"FRI/FS",
                                out_label: bytes = b"out", device=None):
    """Batched `tr_hash_fields_tagged(tag, row)` (fri.rs:28-35) for short
    rows of equal length.  rows: list[list[int]] -> list[int]."""
    g = len(rows)
    k = len(rows[0])
    state_ints, packed, p0 = _one_block_consts(label, tag, k, out_label)
    rows = [[v % P for v in row] for row in rows]
    if g <= NATIVE_BATCH_CUTOFF:
        return _one_block_hash_native(state_ints, p0, rows,
                                      default_params())
    dev = resolve(device)
    flat = [v for row in rows for v in row]
    vals = fr.to_device(fr.pack_ints(flat, mont=True), dev).reshape(
        g, k, fr.N)
    return fr.unpack_ints(_one_block_hash_dev(packed, p0, vals), mont=True)


# ---------------------------------------------------------------------------
# Batched FRI leaf-pair hash (fri.rs:38-44): Poseidon(f, s) via a fresh
# one-shot transcript -> exactly one permutation per leaf.
# ---------------------------------------------------------------------------

def _leaf_consts():
    state_ints, packed, p0 = _one_block_consts(
        b"FRI/leaf/poseidon", b"FRI/leaf", 2, b"leaf")
    assert p0 == 4
    return state_ints, packed


def hash_leaf_pairs_dev(f_mont, s_mont):
    """[n, 8] x 2 Montgomery -> [n, 8] Montgomery leaf digests: f and s sit
    at positions 4 and 5 of a constant sponge state."""
    _, packed = _leaf_consts()
    return _one_block_hash_dev(packed, 4,
                               torch.stack([f_mont, s_mont], dim=1))


def hash_leaf_pairs_ints(pairs, device=None) -> list:
    """Host-int convenience; host engine for small batches, device above."""
    g = len(pairs)
    state_ints, _ = _leaf_consts()
    if g <= NATIVE_BATCH_CUTOFF:
        return _one_block_hash_native(state_ints, 4, [list(p) for p in pairs],
                                      default_params())
    dev = resolve(device)
    f = fr.to_device(fr.pack_ints([p[0] for p in pairs], mont=True), dev)
    s = fr.to_device(fr.pack_ints([p[1] for p in pairs], mont=True), dev)
    return fr.unpack_ints(hash_leaf_pairs_dev(f, s), mont=True)


# ---------------------------------------------------------------------------
# Long-vector tagged hashes (the ALI/{A,S,E,T} witness-column hashes).
# ---------------------------------------------------------------------------

def tagged_hash_cols_native(tags, cols_u64, label: bytes = b"FRI/FS",
                            out_label: bytes = b"out") -> list:
    """Native-threaded sequential absorb chains for host-resident columns.

    cols_u64: list of [n, 4] uint64 Montgomery limb arrays (the bytes of
    the port's limb layout).  The sponge chain is inherently sequential
    (one permutation per rate block); C++ runs the chains across OpenMP
    threads, one each.
    """
    prefixes = [transcript_prefix(label, t) for t in tags]
    states = [list(st) for st, _ in prefixes]
    poss = [p for _, p in prefixes]
    cols64 = np.stack([np.asarray(c, dtype=np.uint64) for c in cols_u64],
                      axis=0)
    new_states, new_pos = native.absorb_chains(states, poss, cols64,
                                               default_params())
    return [resume_fast(s, p).challenge(out_label)
            for s, p in zip(new_states, new_pos)]
