"""The Merkle-folded sum-check NIZK: the prover
(crates/channel/src/lib.rs:548-879, :1130-1172 and
crates/channel/src/protocol.rs:176-273 of saholmes/stark-mlwe).

The witness, 2^k field values, is the table of a multilinear polynomial.
A channel transcript ("E2E/MF") absorbs every message.  The table is
committed (arity 16, t = 17 with the Merkle default constants, tree
label = the VK's tag as u64) and its sum claimed; then k rounds: c0 =
the sum of the even entries, c1 = the sum of (odd - even); r_i from a
fresh transcript over (i, the previous root) alone; the fold
(1 - r_i) v[2j] + r_i v[2j+1] committed; `queries_per_round` distinct
spot checks j drawn from channel challenges (their four u64 limbs XORed,
mod the half); the pairs (2j, 2j+1) opened in the old tree and j in the
new one, each opening absorbed whole.  Last, the single value left.
"""

from __future__ import annotations

from dataclasses import dataclass

from .field import P, fr_to_bytes
from .merkle import MerkleProof, MerkleTree
from .poseidon import Params, Suite
from .transcript import Transcript

COMMIT_ARITY = 16


@dataclass
class MerkleProofBytes:
    arity: int
    group_sizes: list
    indices: list
    siblings: list          # per level: 32-byte digests


@dataclass
class RoundMF:
    c0: bytes
    c1: bytes
    next_root: bytes
    cur_indices: list
    cur_values: list
    cur_proof: MerkleProofBytes
    next_indices: list
    next_values: list
    next_proof: MerkleProofBytes


@dataclass
class ProofMF:
    initial_root: bytes
    rounds: list
    final_eval: bytes


def _proof_bytes(p: MerkleProof) -> MerkleProofBytes:
    return MerkleProofBytes(p.arity, [list(g) for g in p.group_sizes],
                            list(p.indices),
                            [[fr_to_bytes(s) for s in lvl]
                             for lvl in p.siblings])


class _Channel:
    def __init__(self, tp: Params):
        self.tr = Transcript(b"E2E/MF", tp)

    def send_digest(self, label: bytes, digest: int) -> None:
        self.tr.absorb_bytes(b"CHAN/SEND/DIGEST")
        self.tr.absorb_bytes(label)
        self.tr.absorb_field(digest)

    def send_opening(self, indices, values, proof: MerkleProof) -> None:
        tr = self.tr
        tr.absorb_bytes(b"CHAN/SEND/OPEN")
        for i in indices:
            tr.absorb_bytes(i.to_bytes(8, "little"))
        for v in values:
            tr.absorb_field(v)
        tr.absorb_bytes(b"PROOF/ARITY")
        tr.absorb_bytes(proof.arity.to_bytes(8, "little"))
        tr.absorb_bytes(b"PROOF/GROUP_SIZES")
        for lvl in proof.group_sizes:
            tr.absorb_bytes(len(lvl).to_bytes(8, "little"))
            for sz in lvl:
                tr.absorb_bytes(bytes([sz]))
        tr.absorb_bytes(b"PROOF/SIBLINGS")
        for lvl in proof.siblings:
            tr.absorb_bytes(len(lvl).to_bytes(8, "little"))
            for s in lvl:
                tr.absorb_field(s)


def round_challenge(i: int, prev_root: int, tp: Params) -> int:
    tmp = Transcript(b"SUMCHECK-MF/ROUND-CHAL", tp)
    tmp.absorb_bytes(b"SUMCHECK/MF/R")
    tmp.absorb_bytes(i.to_bytes(8, "little"))
    tmp.absorb_field(prev_root)
    return tmp.challenge(b"r_i")


def _xor_fold_u64(x: int) -> int:
    b = fr_to_bytes(x)
    acc = 0
    for off in range(0, 32, 8):
        acc ^= int.from_bytes(b[off:off + 8], "little")
    return acc


def _spot_checks(chan: _Channel, q: int, i: int, half: int) -> list:
    target = min(max(q, 1), half)
    picked: set = set()
    for j in range(max(target * 16, 16)):
        if len(picked) >= target:
            break
        rr = chan.tr.challenge(b"sumcheck-mf/q" + i.to_bytes(8, "little")
                               + j.to_bytes(8, "little"))
        if half > 0:
            picked.add(_xor_fold_u64(rr) % half)
    for idx in range(half):
        if len(picked) >= target:
            break
        picked.add(idx)
    return sorted(picked)


def prove(witness: list, k: int, ds_tag: int, queries_per_round: int,
          suite: Suite, workers) -> ProofMF:
    if len(witness) != 1 << k:
        raise ValueError("the witness has 2^k values")
    tp, mp = suite.transcript(), suite.merkle_default()
    label = ds_tag & 0xFFFFFFFFFFFFFFFF
    chan = _Channel(tp)

    def commit(values):
        return MerkleTree(values, COMMIT_ARITY, mp, label, workers)

    values = [v % P for v in witness]
    tree = commit(values)
    initial_root = tree.root()
    chan.send_digest(b"sumcheck-mf/root/0", initial_root)
    chan.tr.absorb_bytes(b"SUMCHECK/MF/CLAIM")
    chan.tr.absorb_field(sum(values) % P)
    rounds = []
    for i in range(k):
        c0 = sum(values[0::2]) % P
        c1 = (sum(values[1::2]) - sum(values[0::2])) % P
        tr = chan.tr
        tr.absorb_bytes(b"SUMCHECK/MF/ROUND")
        tr.absorb_bytes(i.to_bytes(8, "little"))
        tr.absorb_bytes(b"COEFF/c0")
        tr.absorb_field(c0)
        tr.absorb_bytes(b"COEFF/c1")
        tr.absorb_field(c1)
        r_i = round_challenge(i, tree.root(), tp)
        om = (1 - r_i) % P
        nxt = [(om * values[2 * j] + r_i * values[2 * j + 1]) % P
               for j in range(len(values) // 2)]
        next_tree = commit(nxt)
        chan.send_digest(b"sumcheck-mf/root/next", next_tree.root())

        picked = _spot_checks(chan, queries_per_round, i, len(nxt))
        cur_indices = [x for j in picked for x in (2 * j, 2 * j + 1)]
        cur_values = [values[x] for x in cur_indices]
        cur_proof = tree.open_many(cur_indices)
        next_values = [nxt[x] for x in picked]
        next_proof = next_tree.open_many(picked)
        chan.send_opening(cur_indices, cur_values, cur_proof)
        chan.send_opening(picked, next_values, next_proof)
        rounds.append(RoundMF(
            fr_to_bytes(c0), fr_to_bytes(c1), fr_to_bytes(next_tree.root()),
            cur_indices, [fr_to_bytes(v) for v in cur_values],
            _proof_bytes(cur_proof), list(picked),
            [fr_to_bytes(v) for v in next_values], _proof_bytes(next_proof)))
        values, tree = nxt, next_tree
    return ProofMF(fr_to_bytes(initial_root), rounds, fr_to_bytes(values[0]))
