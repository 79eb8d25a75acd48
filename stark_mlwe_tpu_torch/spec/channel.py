"""Protocol channel & NIZK API: golden spec.

Mirrors `the Rust reference, crates/channel/src/lib.rs`:
  - ProverChannel/VerifierChannel wrap one Transcript with a symmetric
    absorb-everything discipline (:7-117): digests, and openings including
    the full proof structure (indices, values, arity, group_sizes,
    siblings),
  - channel-bound MerkleProver/MerkleVerifier over the arity-16 DS-aware
    Merkle commitment (commitment/src/lib.rs:60-114),
  - MleProver/MleVerifier with per-coordinate labeled challenges (:303-400),
  - plain sum-check with degree-1 rounds (c0, c1) (:406-541),
  - Merkle-folded (MF) sum-check: per-round commits, round challenge
    derived from the previous root alone via a fresh temp transcript
    (:548-879),
  - NIZK wire API: VK, ProofPlain, ProofMF, prove/verify for both
    variants (:894-1240).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .field import P, fr_from_bytes, fr_tag_to_u64, fr_to_bytes
from .merkle import (MerkleChannelCfg as TreeCfg, MerkleProof, MerkleTree,
                     default_params as merkle_default_params, verify_many_ds)
from .mle import MLE
from .transcript import Transcript

COMMIT_ARITY = 16  # commitment/src/lib.rs:69-78


# ---------------------------------------------------------------------------
# FS channels (channel/src/lib.rs:7-117).
# ---------------------------------------------------------------------------

class _Channel:
    def __init__(self, transcript: Transcript):
        self.tr = transcript

    def challenge_scalar(self, label: bytes) -> int:
        return self.tr.challenge(label)

    def _absorb_digest(self, label: bytes, digest: int) -> None:
        self.tr.absorb_bytes(b"CHAN/SEND/DIGEST")
        self.tr.absorb_bytes(label)
        self.tr.absorb_field(digest)

    def _absorb_opening(self, indices, values, proof: MerkleProof) -> None:
        self.tr.absorb_bytes(b"CHAN/SEND/OPEN")
        for i in indices:
            self.tr.absorb_bytes(i.to_bytes(8, "little"))
        for v in values:
            self.tr.absorb_field(v)
        self.tr.absorb_bytes(b"PROOF/ARITY")
        self.tr.absorb_bytes(proof.arity.to_bytes(8, "little"))
        self.tr.absorb_bytes(b"PROOF/GROUP_SIZES")
        for lvl in proof.group_sizes:
            self.tr.absorb_bytes(len(lvl).to_bytes(8, "little"))
            for sz in lvl:
                self.tr.absorb_bytes(bytes([sz]))
        self.tr.absorb_bytes(b"PROOF/SIBLINGS")
        for lvl in proof.siblings:
            self.tr.absorb_bytes(len(lvl).to_bytes(8, "little"))
            for s in lvl:
                self.tr.absorb_field(s)


class ProverChannel(_Channel):
    send_digest = _Channel._absorb_digest
    send_opening = _Channel._absorb_opening


class VerifierChannel(_Channel):
    recv_digest = _Channel._absorb_digest
    recv_opening = _Channel._absorb_opening


# ---------------------------------------------------------------------------
# Merkle commitment scheme bound to arity 16 / t = 17
# (commitment/src/lib.rs:60-114).
# ---------------------------------------------------------------------------

class MerkleCommitment:
    def __init__(self, tree_label: int, params=None):
        self.tree_label = tree_label
        # Static t=17 default params (seed "POSEIDON-T17-X5-SEED") used
        # as-is for the dynamic arity-16 DS-aware tree.
        self.params = params if params is not None else merkle_default_params()

    def _tree_cfg(self) -> TreeCfg:
        return TreeCfg(COMMIT_ARITY, self.params, self.tree_label)

    def commit(self, leaves):
        tree = MerkleTree.new(list(leaves), self._tree_cfg())
        return tree.root(), tree

    def open(self, indices, tree: MerkleTree) -> MerkleProof:
        return tree.open_many(indices)

    def verify(self, root, indices, values, proof) -> bool:
        return verify_many_ds(root, indices, values, proof,
                              self.tree_label, self.params)


@dataclass
class MerkleChannelCfg:
    """Channel-level config: Fr ds_tag truncated to a u64 tree_label
    (channel/src/lib.rs:127-147)."""
    tree_label: int

    @classmethod
    def new(cls, ds_tag_fr: int) -> "MerkleChannelCfg":
        return cls(fr_tag_to_u64(ds_tag_fr))

    def scheme(self) -> MerkleCommitment:
        return MerkleCommitment(self.tree_label)


class MerkleProver:
    """Channel-bound prover (channel/src/lib.rs:149-202)."""

    def __init__(self, chan: ProverChannel, cfg: MerkleChannelCfg):
        self.chan = chan
        self.cfg = cfg
        self.root = None
        self.tree = None

    def commit_vector(self, leaves) -> int:
        root, tree = self.cfg.scheme().commit(leaves)
        self.chan.send_digest(b"commit/root", root)
        self.root, self.tree = root, tree
        return root

    def open_indices(self, indices, table):
        values = [table[i] for i in indices]
        proof = self.cfg.scheme().open(indices, self.tree)
        self.chan.send_opening(indices, values, proof)
        return values, proof

    def challenge_scalar(self, label: bytes) -> int:
        return self.chan.challenge_scalar(label)


class MerkleVerifier:
    """channel/src/lib.rs:204-237."""

    def __init__(self, chan: VerifierChannel, cfg: MerkleChannelCfg):
        self.chan = chan
        self.cfg = cfg
        self.root = None

    def receive_root(self, root: int) -> None:
        self.chan.recv_digest(b"commit/root", root)
        self.root = root

    def verify_openings(self, indices, values, proof) -> bool:
        self.chan.recv_opening(indices, values, proof)
        if self.root is None:
            return False
        return self.cfg.scheme().verify(self.root, indices, values, proof)

    def challenge_scalar(self, label: bytes) -> int:
        return self.chan.challenge_scalar(label)


# ---------------------------------------------------------------------------
# MLE channel layer (channel/src/lib.rs:303-400).
# ---------------------------------------------------------------------------

class MleProver:
    def __init__(self, merkle: MerkleProver, mle: MLE):
        self.merkle = merkle
        self.mle = mle

    def commit(self) -> int:
        return self.merkle.commit_vector(self.mle.values)

    def draw_point(self, label: bytes):
        return [self.merkle.challenge_scalar(label + j.to_bytes(8, "little"))
                for j in range(self.mle.n)]

    def evaluate_and_bind(self, r) -> int:
        val = self.mle.eval(r)
        self.merkle.chan.tr.absorb_bytes(b"MLE/EVAL")
        self.merkle.chan.tr.absorb_field(val)
        return val

    def open_indices(self, indices):
        return self.merkle.open_indices(indices, self.mle.values)


class MleVerifier:
    def __init__(self, merkle: MerkleVerifier, k: int):
        self.merkle = merkle
        self.k = k

    def receive_root(self, root: int) -> None:
        self.merkle.receive_root(root)

    def draw_point(self, label: bytes):
        return [self.merkle.challenge_scalar(label + j.to_bytes(8, "little"))
                for j in range(self.k)]

    def bind_claimed_eval(self, value: int) -> None:
        self.merkle.chan.tr.absorb_bytes(b"MLE/EVAL")
        self.merkle.chan.tr.absorb_field(value)

    def verify_openings(self, indices, values, proof) -> bool:
        return self.merkle.verify_openings(indices, values, proof)


# ---------------------------------------------------------------------------
# Plain sum-check (channel/src/lib.rs:406-541).
# ---------------------------------------------------------------------------

def sumcheck_round_coeffs(layer):
    """(c0, c1): c0 = sum of evens, c1 = sum of (odd - even) (:406-416)."""
    c0 = c1 = 0
    for i in range(0, len(layer), 2):
        c0 += layer[i]
        c1 += layer[i + 1] - layer[i]
    return c0 % P, c1 % P


class SumCheckProver:
    def __init__(self, mle_prover: MleProver):
        self.mle = mle_prover
        self.layer = list(mle_prover.mle.values)

    def _tr(self):
        return self.mle.merkle.chan.tr

    def send_claim(self) -> int:
        s = sum(self.layer) % P
        self._tr().absorb_bytes(b"SUMCHECK/CLAIM")
        self._tr().absorb_field(s)
        return s

    def round(self, round_idx: int, chal_label: bytes):
        c0, c1 = sumcheck_round_coeffs(self.layer)
        t = self._tr()
        t.absorb_bytes(b"SUMCHECK/ROUND")
        t.absorb_bytes(round_idx.to_bytes(8, "little"))
        t.absorb_bytes(b"COEFF/c0")
        t.absorb_field(c0)
        t.absorb_bytes(b"COEFF/c1")
        t.absorb_field(c1)

        r_i = self.mle.merkle.challenge_scalar(
            chal_label + round_idx.to_bytes(8, "little"))
        om = (1 - r_i) % P
        self.layer = [(om * self.layer[2 * j] + r_i * self.layer[2 * j + 1]) % P
                      for j in range(len(self.layer) // 2)]
        return c0, c1, r_i

    def finalize_and_bind_eval(self) -> int:
        assert len(self.layer) == 1
        val = self.layer[0]
        self._tr().absorb_bytes(b"SUMCHECK/FINAL/EVAL")
        self._tr().absorb_field(val)
        return val


class SumCheckVerifier:
    def __init__(self, mle_verifier: MleVerifier):
        self.mle = mle_verifier

    def _tr(self):
        return self.mle.merkle.chan.tr

    def recv_claim(self, s: int) -> None:
        self._tr().absorb_bytes(b"SUMCHECK/CLAIM")
        self._tr().absorb_field(s)

    def round(self, round_idx: int, s_prev: int, c0: int, c1: int,
              chal_label: bytes):
        t = self._tr()
        t.absorb_bytes(b"SUMCHECK/ROUND")
        t.absorb_bytes(round_idx.to_bytes(8, "little"))
        t.absorb_bytes(b"COEFF/c0")
        t.absorb_field(c0)
        t.absorb_bytes(b"COEFF/c1")
        t.absorb_field(c1)

        if (2 * c0 + c1) % P != s_prev % P:
            raise AssertionError("sum-check round consistency failed")
        r_i = self.mle.merkle.challenge_scalar(
            chal_label + round_idx.to_bytes(8, "little"))
        return r_i, (c0 + c1 * r_i) % P

    def finalize_and_check(self, eval_at_r: int, s_k: int) -> None:
        self._tr().absorb_bytes(b"SUMCHECK/FINAL/EVAL")
        self._tr().absorb_field(eval_at_r)
        if eval_at_r % P != s_k % P:
            raise AssertionError("final sum-check evaluation mismatch")


# ---------------------------------------------------------------------------
# Merkle-folded sum-check (channel/src/lib.rs:548-879).
# ---------------------------------------------------------------------------

@dataclass
class SumCheckMFConfig:
    queries_per_round: int = 2


@dataclass
class MFFoldOpenings:
    cur_indices: list
    cur_values: list
    cur_proof: MerkleProof
    next_indices: list
    next_values: list
    next_proof: MerkleProof


def mf_round_challenge_from_root(round_idx: int, prev_root: int) -> int:
    """Fresh temp transcript over (round index, prev root) (:592-599)."""
    tmp = Transcript(b"SUMCHECK-MF/ROUND-CHAL")
    tmp.absorb_bytes(b"SUMCHECK/MF/R")
    tmp.absorb_bytes(round_idx.to_bytes(8, "little"))
    tmp.absorb_field(prev_root)
    return tmp.challenge(b"r_i")


def _xor_fold_u64(x: int) -> int:
    """XOR of the four little-endian u64 limbs of the canonical bytes
    (:672-678)."""
    b = fr_to_bytes(x)
    acc = 0
    for off in range(0, 32, 8):
        acc ^= int.from_bytes(b[off:off + 8], "little")
    return acc


class SumCheckMFProver:
    def __init__(self, cfg: SumCheckMFConfig, merkle_cfg: MerkleChannelCfg,
                 chan: ProverChannel, mle: MLE):
        self.cfg = cfg
        self.chan = chan
        self.scheme = merkle_cfg.scheme()
        root, tree = self.scheme.commit(mle.values)
        chan.send_digest(b"sumcheck-mf/root/0", root)
        self.values = list(mle.values)
        self.tree = tree
        self.root = root
        self.rounds = mle.n

    def send_claim(self) -> int:
        s = sum(self.values) % P
        self.chan.tr.absorb_bytes(b"SUMCHECK/MF/CLAIM")
        self.chan.tr.absorb_field(s)
        return s

    def round(self, i: int):
        c0, c1 = sumcheck_round_coeffs(self.values)
        t = self.chan.tr
        t.absorb_bytes(b"SUMCHECK/MF/ROUND")
        t.absorb_bytes(i.to_bytes(8, "little"))
        t.absorb_bytes(b"COEFF/c0")
        t.absorb_field(c0)
        t.absorb_bytes(b"COEFF/c1")
        t.absorb_field(c1)

        r_i = mf_round_challenge_from_root(i, self.root)

        om = (1 - r_i) % P
        half = len(self.values) // 2
        nxt = [(om * self.values[2 * j] + r_i * self.values[2 * j + 1]) % P
               for j in range(half)]
        next_root, next_tree = self.scheme.commit(nxt)
        self.chan.send_digest(b"sumcheck-mf/root/next", next_root)

        # Sample unique sorted spot-check indices (:659-695).
        q_target = min(max(self.cfg.queries_per_round, 1), half)
        queries: set = set()
        attempt = 0
        max_attempts = max(q_target * 16, 16)
        j = 0
        while len(queries) < q_target and attempt < max_attempts:
            qlabel = (b"sumcheck-mf/q" + i.to_bytes(8, "little")
                      + j.to_bytes(8, "little"))
            rr = self.chan.challenge_scalar(qlabel)
            if half > 0:
                queries.add(_xor_fold_u64(rr) % half)
            j += 1
            attempt += 1
        if len(queries) < q_target:
            for idx in range(half):
                queries.add(idx)
                if len(queries) == q_target:
                    break
        qsorted = sorted(queries)

        cur_indices = []
        for jj in qsorted:
            cur_indices.extend((2 * jj, 2 * jj + 1))
        cur_values = [self.values[ix] for ix in cur_indices]
        cur_proof = self.scheme.open(cur_indices, self.tree)
        next_indices = list(qsorted)
        next_values = [nxt[ix] for ix in next_indices]
        next_proof = self.scheme.open(next_indices, next_tree)

        self.chan.send_opening(cur_indices, cur_values, cur_proof)
        self.chan.send_opening(next_indices, next_values, next_proof)

        self.values, self.tree, self.root = nxt, next_tree, next_root
        openings = MFFoldOpenings(cur_indices, cur_values, cur_proof,
                                  next_indices, next_values, next_proof)
        return c0, c1, r_i, next_root, openings

    def finalize_eval(self) -> int:
        assert len(self.values) == 1
        val = self.values[0]
        self.chan.tr.absorb_bytes(b"SUMCHECK/MF/FINAL/EVAL")
        self.chan.tr.absorb_field(val)
        return val

    def current_root(self) -> int:
        return self.root


class SumCheckMFVerifier:
    def __init__(self, cfg: SumCheckMFConfig, merkle_cfg: MerkleChannelCfg,
                 chan: VerifierChannel, initial_root: int, rounds: int):
        self.cfg = cfg
        self.chan = chan
        self.scheme = merkle_cfg.scheme()
        self.cur_root = initial_root
        self.rounds = rounds

    def receive_initial_root(self, root: int) -> None:
        self.chan.recv_digest(b"sumcheck-mf/root/0", root)
        self.cur_root = root

    def recv_claim(self, s: int) -> None:
        self.chan.tr.absorb_bytes(b"SUMCHECK/MF/CLAIM")
        self.chan.tr.absorb_field(s)

    def start_round(self, i: int, s_prev: int, c0: int, c1: int) -> None:
        t = self.chan.tr
        t.absorb_bytes(b"SUMCHECK/MF/ROUND")
        t.absorb_bytes(i.to_bytes(8, "little"))
        t.absorb_bytes(b"COEFF/c0")
        t.absorb_field(c0)
        t.absorb_bytes(b"COEFF/c1")
        t.absorb_field(c1)
        if (2 * c0 + c1) % P != s_prev % P:
            raise AssertionError("sum-check MF round consistency failed")

    def derive_round_challenge(self, i: int) -> int:
        return mf_round_challenge_from_root(i, self.cur_root)

    def recv_next_root(self, next_root: int) -> None:
        self.chan.recv_digest(b"sumcheck-mf/root/next", next_root)
        self.cur_root = next_root

    def compute_s_next(self, c0: int, c1: int, r_i: int) -> int:
        return (c0 + c1 * r_i) % P

    def verify_fold_openings(self, cur_indices, cur_values, cur_proof,
                             next_indices, next_values, next_proof,
                             r_i, prev_root, next_root) -> bool:
        """Multiproofs + fold equation (1-r)a + r b == next[j] (:812-862)."""
        if not self.scheme.verify(prev_root, cur_indices, cur_values,
                                  cur_proof):
            return False
        if not self.scheme.verify(next_root, next_indices, next_values,
                                  next_proof):
            return False
        if (len(cur_indices) != len(cur_values)
                or len(next_indices) != len(next_values)):
            return False
        pairs: dict = {}
        for ix, val in zip(cur_indices, cur_values):
            slot = pairs.setdefault(ix // 2, [None, None])
            slot[ix % 2] = val
        om = (1 - r_i) % P
        for j, vj in zip(next_indices, next_values):
            a, b = pairs.get(j, (None, None))
            if a is None or b is None:
                return False
            if (om * a + r_i * b) % P != vj % P:
                return False
        return True

    def finalize_and_check(self, final_eval: int, s_k: int) -> None:
        self.chan.tr.absorb_bytes(b"SUMCHECK/MF/FINAL/EVAL")
        self.chan.tr.absorb_field(final_eval)
        if final_eval % P != s_k % P:
            raise AssertionError("final MF sum-check evaluation mismatch")


# ---------------------------------------------------------------------------
# NIZK wire API (channel/src/lib.rs:894-1240).
# ---------------------------------------------------------------------------

@dataclass
class VK:
    poseidon_seed: str
    tree_label: int
    k: int
    variant: str                      # "plain" | "mf"
    queries_per_round: int = 0


def build_vk_plain(k: int, ds_tag: int) -> VK:
    return VK("default", fr_tag_to_u64(ds_tag), k, "plain")


def build_vk_mf(k: int, ds_tag: int, queries_per_round: int) -> VK:
    return VK("default", fr_tag_to_u64(ds_tag), k, "mf", queries_per_round)


@dataclass
class MerkleProofBytes:
    arity: int
    group_sizes: list
    indices: list
    siblings: list                    # per level: list[bytes]

    @classmethod
    def from_proof(cls, p: MerkleProof) -> "MerkleProofBytes":
        return cls(p.arity, [list(g) for g in p.group_sizes],
                   list(p.indices),
                   [[fr_to_bytes(s) for s in lvl] for lvl in p.siblings])

    def to_proof(self) -> MerkleProof:
        return MerkleProof(list(self.indices),
                           [[fr_from_bytes(s) for s in lvl]
                            for lvl in self.siblings],
                           [list(g) for g in self.group_sizes], self.arity)

    def size_bytes(self) -> int:
        return (8 + sum(8 + len(g) for g in self.group_sizes)
                + 8 * len(self.indices)
                + sum(8 + 32 * len(lvl) for lvl in self.siblings))


@dataclass
class ProofPlain:
    root: bytes
    rounds: list                      # [(c0_bytes, c1_bytes)]
    final_eval: bytes

    def size_bytes(self) -> int:
        return 32 + 64 * len(self.rounds) + 32


@dataclass
class RoundMF:
    c0: bytes
    c1: bytes
    next_root: bytes
    cur_indices: list
    cur_values: list                  # list[bytes]
    cur_proof: MerkleProofBytes
    next_indices: list
    next_values: list
    next_proof: MerkleProofBytes


@dataclass
class ProofMF:
    initial_root: bytes
    rounds: list                      # list[RoundMF]
    final_eval: bytes

    def size_bytes(self) -> int:
        total = 64
        for r in self.rounds:
            total += 96
            total += 8 * (len(r.cur_indices) + len(r.next_indices))
            total += 32 * (len(r.cur_values) + len(r.next_values))
            total += r.cur_proof.size_bytes() + r.next_proof.size_bytes()
        return total


def prove_plain(vk: VK, witness) -> ProofPlain:
    """channel/src/lib.rs:1045-1076."""
    assert vk.variant == "plain"
    chan = ProverChannel(Transcript(b"E2E/PLAIN"))
    mp = MerkleProver(chan, MerkleChannelCfg(vk.tree_label))
    root = mp.commit_vector(witness)
    sp = SumCheckProver(MleProver(mp, MLE(list(witness))))
    sp.send_claim()
    rounds = []
    for i in range(vk.k):
        c0, c1, _ = sp.round(i, b"sumcheck/r")
        rounds.append((fr_to_bytes(c0), fr_to_bytes(c1)))
    final_eval = sp.finalize_and_bind_eval()
    return ProofPlain(fr_to_bytes(root), rounds, fr_to_bytes(final_eval))


def verify_plain(vk: VK, proof: ProofPlain) -> bool:
    """channel/src/lib.rs:1080-1126: s0 reconstructed as 2*c0 + c1."""
    assert vk.variant == "plain"
    chan = VerifierChannel(Transcript(b"E2E/PLAIN"))
    mv = MerkleVerifier(chan, MerkleChannelCfg(vk.tree_label))
    mv.receive_root(fr_from_bytes(proof.root))
    sv = SumCheckVerifier(MleVerifier(mv, vk.k))
    if not proof.rounds:
        return False
    c0_0 = fr_from_bytes(proof.rounds[0][0])
    c1_0 = fr_from_bytes(proof.rounds[0][1])
    s0 = (2 * c0_0 + c1_0) % P
    sv.recv_claim(s0)
    running = s0
    try:
        for i, (c0_b, c1_b) in enumerate(proof.rounds):
            _, running = sv.round(i, running, fr_from_bytes(c0_b),
                                  fr_from_bytes(c1_b), b"sumcheck/r")
        sv.finalize_and_check(fr_from_bytes(proof.final_eval), running)
    except AssertionError:
        return False
    return True


def prove_mf(vk: VK, witness) -> ProofMF:
    """channel/src/lib.rs:1130-1172."""
    assert vk.variant == "mf"
    chan = ProverChannel(Transcript(b"E2E/MF"))
    cfg = SumCheckMFConfig(vk.queries_per_round)
    sp = SumCheckMFProver(cfg, MerkleChannelCfg(vk.tree_label), chan,
                          MLE(list(witness)))
    initial_root = sp.current_root()
    sp.send_claim()
    rounds = []
    for i in range(vk.k):
        c0, c1, _r, next_root, op = sp.round(i)
        rounds.append(RoundMF(
            fr_to_bytes(c0), fr_to_bytes(c1), fr_to_bytes(next_root),
            op.cur_indices, [fr_to_bytes(v) for v in op.cur_values],
            MerkleProofBytes.from_proof(op.cur_proof),
            op.next_indices, [fr_to_bytes(v) for v in op.next_values],
            MerkleProofBytes.from_proof(op.next_proof)))
    final_eval = sp.finalize_eval()
    return ProofMF(fr_to_bytes(initial_root), rounds,
                   fr_to_bytes(final_eval))


def verify_mf(vk: VK, proof: ProofMF) -> bool:
    """channel/src/lib.rs:1176-1240."""
    assert vk.variant == "mf"
    chan = VerifierChannel(Transcript(b"E2E/MF"))
    init_root = fr_from_bytes(proof.initial_root)
    sv = SumCheckMFVerifier(SumCheckMFConfig(vk.queries_per_round),
                            MerkleChannelCfg(vk.tree_label), chan,
                            init_root, vk.k)
    sv.receive_initial_root(init_root)
    running = None
    prev_root = init_root
    try:
        for i, r in enumerate(proof.rounds):
            c0 = fr_from_bytes(r.c0)
            c1 = fr_from_bytes(r.c1)
            next_root = fr_from_bytes(r.next_root)
            s_prev = running if running is not None else (2 * c0 + c1) % P
            sv.start_round(i, s_prev, c0, c1)
            r_i = sv.derive_round_challenge(i)
            sv.recv_next_root(next_root)
            ok = sv.verify_fold_openings(
                r.cur_indices, [fr_from_bytes(v) for v in r.cur_values],
                r.cur_proof.to_proof(),
                r.next_indices, [fr_from_bytes(v) for v in r.next_values],
                r.next_proof.to_proof(),
                r_i, prev_root, next_root)
            if not ok:
                return False
            running = sv.compute_s_next(c0, c1, r_i)
            prev_root = next_root
        final_eval = fr_from_bytes(proof.final_eval)
        sv.finalize_and_check(final_eval,
                              running if running is not None else final_eval)
    except AssertionError:
        return False
    return True
