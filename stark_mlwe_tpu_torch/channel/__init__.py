"""Device-backed protocol channel and sum-check NIZK API.

Counterpart of `channel/__init__.py` of the JAX package (the Rust
reference's crates/channel/src/lib.rs; golden spec in `spec.channel`),
producing byte-identical proofs:

  - the Fiat-Shamir channels replay the exact absorb discipline
    (:7-117) on a `FastTranscript`, whose sequential t=17 permutations run
    in the host engine,
  - Merkle commitments (arity 16, commitment/src/lib.rs:60-114) build on
    the batched device tree engine (`merkle`: K1 at t=17),
  - sum-check layers live on the device as Montgomery limb tensors:
    claims, round coefficients (c0, c1) and folds are K2 launches
    (:406-541 plain, :548-879 Merkle-folded),
  - the NIZK wire structs (VK / ProofPlain / ProofMF, :894-1240) are
    the spec's, so serialization is shared.

`prove_plain` and `prove_mf` run the whole round chain on the device as
eager calls with no readback inside it (`_plain_chain`: the FS transcript
itself on the device, `transcript_dev.DeviceTranscript`;
`_mf_chain_device`: each round challenge derived on the device from the
previous root), then read back once: one bulk `.cpu()` (plain, and MF below
`MF_GATHER_MIN_N`) or one gather per round (`_MFGatherCtx`).  The
verifiers stay on the host (host engine for the transcripts and the
Merkle checks).  `phase_seconds` holds the wall seconds of the last
prove's phases.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import merkle as dmk
from ..device import resolve
from ..mle import DeviceMLE, fold_halves
from ..ops import fr
from ..ops import poseidon as dpos
from ..spec.channel import (COMMIT_ARITY, MFFoldOpenings, MerkleChannelCfg,
                            MerkleProofBytes, ProofMF, ProofPlain,
                            ProverChannel, RoundMF, SumCheckMFConfig,
                            SumCheckVerifier, VerifierChannel, VK,
                            _xor_fold_u64, build_vk_mf, build_vk_plain)
from ..spec.field import P, fr_from_bytes, fr_to_bytes
from ..spec.merkle import MerkleChannelCfg as TreeCfg
from ..spec.merkle import default_params as merkle_default_params
from ..spec.transcript import (DS_ABSORB_BYTES, DS_CHALLENGE, RATE,
                               Transcript, bytes_to_field_words,
                               domain_tag_to_field)
from ..transcript import FastTranscript
from ..transcript_dev import DeviceTranscript, transcript_params
from ..utils import phase_timer

__all__ = ["prove_plain", "verify_plain", "prove_mf", "verify_mf",
           "build_vk_plain", "build_vk_mf", "VK", "ProofPlain", "ProofMF",
           "DeviceMerkleCommitment", "ChanMerkleProver",
           "ChanMerkleVerifier", "MleProver", "MleVerifier",
           "SumCheckProver", "SumCheckMFProver", "SumCheckMFVerifier",
           "MF_GATHER_MIN_N", "phase_seconds"]

# prove_mf reads its proof's values back by per-round gathers from this many
# witness values on (the download of every level and layer below it).
MF_GATHER_MIN_N = 1 << 14

# Wall seconds of the last prove's phases, by name (host clock; the chain
# phases are eager enqueues, so the device work they start is waited for in
# the readback phase after them).
phase_seconds: dict = {}


def mf_round_challenge_from_root(round_idx: int, prev_root: int) -> int:
    """channel/src/lib.rs:592-599 on the fast transcript."""
    tmp = FastTranscript(b"SUMCHECK-MF/ROUND-CHAL")
    tmp.absorb_bytes(b"SUMCHECK/MF/R")
    tmp.absorb_bytes(round_idx.to_bytes(8, "little"))
    tmp.absorb_field(prev_root)
    return tmp.challenge(b"r_i")


# ---------------------------------------------------------------------------
# Device Merkle commitment scheme (commitment/src/lib.rs:60-114).
# ---------------------------------------------------------------------------

class DeviceMerkleCommitment:
    """Arity-16 DS-aware Poseidon Merkle commitment on the device; host int
    lists are sent to `device`, tensors stay where they lie."""

    def __init__(self, tree_label: int, params=None, device=None):
        self.tree_label = tree_label
        self.params = params if params is not None else merkle_default_params()
        self.device = device

    def _tree_cfg(self) -> TreeCfg:
        return TreeCfg(COMMIT_ARITY, self.params, self.tree_label)

    def commit(self, leaves):
        if isinstance(leaves, (list, tuple)):
            leaves = fr.to_device(fr.pack_ints(list(leaves), mont=True),
                                  resolve(self.device))
        tree = dmk.build_tree(leaves, self._tree_cfg())
        return tree.root(), tree

    def open(self, indices, tree):
        return tree.open_many(indices)

    def verify(self, root, indices, values, proof) -> bool:
        return dmk.verify_many_ds(root, indices, values, proof,
                                  self.tree_label, self.params, self.device)


def _scheme(cfg: MerkleChannelCfg, device=None) -> DeviceMerkleCommitment:
    return DeviceMerkleCommitment(cfg.tree_label, device=device)


# ---------------------------------------------------------------------------
# Channel-bound Merkle / MLE layers (channel/src/lib.rs:149-400).
# ---------------------------------------------------------------------------

class ChanMerkleProver:
    def __init__(self, chan: ProverChannel, cfg: MerkleChannelCfg,
                 device=None):
        self.chan = chan
        self.cfg = cfg
        self.scheme = _scheme(cfg, device)
        self.root = None
        self.tree = None

    def commit_vector(self, leaves) -> int:
        root, tree = self.scheme.commit(leaves)
        self.chan.send_digest(b"commit/root", root)
        self.root, self.tree = root, tree
        return root

    def open_indices(self, indices, table):
        values = (table.value_at(indices) if isinstance(table, DeviceMLE)
                  else [table[i] for i in indices])
        proof = self.scheme.open(indices, self.tree)
        self.chan.send_opening(indices, values, proof)
        return values, proof

    def challenge_scalar(self, label: bytes) -> int:
        return self.chan.challenge_scalar(label)


class ChanMerkleVerifier:
    def __init__(self, chan: VerifierChannel, cfg: MerkleChannelCfg,
                 device=None):
        self.chan = chan
        self.cfg = cfg
        self.scheme = _scheme(cfg, device)
        self.root = None

    def receive_root(self, root: int) -> None:
        self.chan.recv_digest(b"commit/root", root)
        self.root = root

    def verify_openings(self, indices, values, proof) -> bool:
        self.chan.recv_opening(indices, values, proof)
        if self.root is None:
            return False
        return self.scheme.verify(self.root, indices, values, proof)

    def challenge_scalar(self, label: bytes) -> int:
        return self.chan.challenge_scalar(label)


class MleProver:
    def __init__(self, merkle: ChanMerkleProver, mle: DeviceMLE):
        self.merkle = merkle
        self.mle = mle

    def commit(self) -> int:
        return self.merkle.commit_vector(self.mle.values_dev)

    def draw_point(self, label: bytes):
        return [self.merkle.challenge_scalar(label + j.to_bytes(8, "little"))
                for j in range(self.mle.n)]

    def evaluate_and_bind(self, r) -> int:
        val = self.mle.eval(r)
        self.merkle.chan.tr.absorb_bytes(b"MLE/EVAL")
        self.merkle.chan.tr.absorb_field(val)
        return val

    def open_indices(self, indices):
        return self.merkle.open_indices(indices, self.mle)


class MleVerifier:
    def __init__(self, merkle: ChanMerkleVerifier, k: int):
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
# Device sum-check layers.
# ---------------------------------------------------------------------------

def _round_coeffs_dev(values_dev):
    """(c0, c1) = (sum evens, sum (odd - even)) as host ints
    (channel:406-416)."""
    v = values_dev.reshape(-1, 2, fr.N)
    c0 = fr.reduce_add(v[:, 0])
    c1 = fr.reduce_add(fr.sub(v[:, 1], v[:, 0]))
    return fr.unpack_ints(torch.stack([c0, c1]), mont=True)


class SumCheckProver:
    """channel/src/lib.rs:433-486 with the layer on the device."""

    def __init__(self, mle_prover: MleProver):
        self.mle = mle_prover
        self.layer = DeviceMLE(mle_prover.mle.values_dev)

    def _tr(self):
        return self.mle.merkle.chan.tr

    def send_claim(self) -> int:
        s = self.layer.sum()
        self._tr().absorb_bytes(b"SUMCHECK/CLAIM")
        self._tr().absorb_field(s)
        return s

    def round(self, round_idx: int, chal_label: bytes):
        c0, c1 = _round_coeffs_dev(self.layer.values_dev)
        t = self._tr()
        t.absorb_bytes(b"SUMCHECK/ROUND")
        t.absorb_bytes(round_idx.to_bytes(8, "little"))
        t.absorb_bytes(b"COEFF/c0")
        t.absorb_field(c0)
        t.absorb_bytes(b"COEFF/c1")
        t.absorb_field(c1)

        r_i = self.mle.merkle.challenge_scalar(
            chal_label + round_idx.to_bytes(8, "little"))
        self.layer = self.layer.fold_last(r_i)
        return c0, c1, r_i

    def finalize_and_bind_eval(self) -> int:
        if self.layer.n != 0:
            raise RuntimeError("sum-check: rounds left before the final "
                               "evaluation")
        val = self.layer.values()[0]
        self._tr().absorb_bytes(b"SUMCHECK/FINAL/EVAL")
        self._tr().absorb_field(val)
        return val


def _sample_queries(chan, cfg: SumCheckMFConfig, i: int, half: int) -> list:
    """Spot-check index sampling (channel/src/lib.rs:660-695): channel
    challenges folded to u64 mod half, deduped, with the exhaustive
    fallback.  Mutates the channel transcript."""
    q_target = min(max(cfg.queries_per_round, 1), half)
    queries: set = set()
    attempt = 0
    max_attempts = max(q_target * 16, 16)
    j = 0
    while len(queries) < q_target and attempt < max_attempts:
        qlabel = (b"sumcheck-mf/q" + i.to_bytes(8, "little")
                  + j.to_bytes(8, "little"))
        rr = chan.challenge_scalar(qlabel)
        if half > 0:
            queries.add(_xor_fold_u64(rr) % half)
        j += 1
        attempt += 1
    if len(queries) < q_target:
        for idx in range(half):
            queries.add(idx)
            if len(queries) == q_target:
                break
    return sorted(queries)


def _pair_indices(qsorted) -> list:
    return [ix for jj in qsorted for ix in (2 * jj, 2 * jj + 1)]


class SumCheckMFProver:
    """channel/src/lib.rs:632-730 with device layers and commits, round by
    round (`prove_mf` runs the same rounds as one device chain)."""

    def __init__(self, cfg: SumCheckMFConfig, merkle_cfg: MerkleChannelCfg,
                 chan: ProverChannel, mle: DeviceMLE):
        self.cfg = cfg
        self.chan = chan
        self.scheme = _scheme(merkle_cfg, mle.values_dev.device)
        root, tree = self.scheme.commit(mle.values_dev)
        chan.send_digest(b"sumcheck-mf/root/0", root)
        self.layer = mle
        self.tree = tree
        self.root = root
        self.rounds = mle.n

    def send_claim(self) -> int:
        s = self.layer.sum()
        self.chan.tr.absorb_bytes(b"SUMCHECK/MF/CLAIM")
        self.chan.tr.absorb_field(s)
        return s

    def round(self, i: int):
        c0, c1 = _round_coeffs_dev(self.layer.values_dev)
        t = self.chan.tr
        t.absorb_bytes(b"SUMCHECK/MF/ROUND")
        t.absorb_bytes(i.to_bytes(8, "little"))
        t.absorb_bytes(b"COEFF/c0")
        t.absorb_field(c0)
        t.absorb_bytes(b"COEFF/c1")
        t.absorb_field(c1)

        r_i = mf_round_challenge_from_root(i, self.root)

        nxt = self.layer.fold_last(r_i)
        half = int(nxt.values_dev.shape[0])
        next_root, next_tree = self.scheme.commit(nxt.values_dev)
        self.chan.send_digest(b"sumcheck-mf/root/next", next_root)

        qsorted = _sample_queries(self.chan, self.cfg, i, half)

        cur_indices = _pair_indices(qsorted)
        cur_values = self.layer.value_at(cur_indices)
        cur_proof = self.scheme.open(cur_indices, self.tree)
        next_indices = list(qsorted)
        next_values = nxt.value_at(next_indices)
        next_proof = self.scheme.open(next_indices, next_tree)

        self.chan.send_opening(cur_indices, cur_values, cur_proof)
        self.chan.send_opening(next_indices, next_values, next_proof)

        self.layer, self.tree, self.root = nxt, next_tree, next_root
        openings = MFFoldOpenings(cur_indices, cur_values, cur_proof,
                                  next_indices, next_values, next_proof)
        return c0, c1, r_i, next_root, openings

    def finalize_eval(self) -> int:
        if self.layer.n != 0:
            raise RuntimeError("MF sum-check: rounds left before the final "
                               "evaluation")
        val = self.layer.values()[0]
        self.chan.tr.absorb_bytes(b"SUMCHECK/MF/FINAL/EVAL")
        self.chan.tr.absorb_field(val)
        return val

    def current_root(self) -> int:
        return self.root


class SumCheckMFVerifier:
    """channel/src/lib.rs:749-879 with batched Merkle verification (host
    engine for the proof's few dozen rows)."""

    def __init__(self, cfg: SumCheckMFConfig, merkle_cfg: MerkleChannelCfg,
                 chan: VerifierChannel, initial_root: int, rounds: int,
                 device=None):
        self.cfg = cfg
        self.chan = chan
        self.scheme = _scheme(merkle_cfg, device)
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
# NIZK wire API (channel/src/lib.rs:1045-1240): the plain variant.
# ---------------------------------------------------------------------------

def _witness_mle(witness, device) -> DeviceMLE:
    """A DeviceMLE as it is (its tensor decides the device), else the
    witness ints packed and sent to `device`."""
    if isinstance(witness, DeviceMLE):
        return witness
    return DeviceMLE.from_ints(witness, device)


def _plain_chain(values, root_dev, k: int):
    """All k plain sum-check rounds (claim, coefficients, FS challenges,
    folds) as eager device calls on a DeviceTranscript, with no readback.
    Replays prove_plain's absorb discipline (channel/src/lib.rs:406-486)
    bit-exactly; returns (claim [8], coefficients [k, 2, 8], final [8])."""
    dt = DeviceTranscript(b"E2E/PLAIN", values.device)
    dt.absorb_bytes(b"CHAN/SEND/DIGEST")
    dt.absorb_bytes(b"commit/root")
    dt.absorb_field_dev(root_dev)
    s = fr.reduce_add(values)
    dt.absorb_bytes(b"SUMCHECK/CLAIM")
    dt.absorb_field_dev(s)
    cur = values
    cpairs = []
    for i in range(k):
        v = cur.reshape(-1, 2, fr.N)
        c0 = fr.reduce_add(v[:, 0])
        c1 = fr.reduce_add(fr.sub(v[:, 1], v[:, 0]))
        cpairs.append(torch.stack([c0, c1]))
        dt.absorb_bytes(b"SUMCHECK/ROUND")
        dt.absorb_bytes(i.to_bytes(8, "little"))
        dt.absorb_bytes(b"COEFF/c0")
        dt.absorb_field_dev(c0)
        dt.absorb_bytes(b"COEFF/c1")
        dt.absorb_field_dev(c1)
        r = dt.challenge_dev(b"sumcheck/r" + i.to_bytes(8, "little"))
        cur = fold_halves(v[:, 0], v[:, 1], r)
    return s, torch.stack(cpairs), cur[0]


def prove_plain(vk: VK, witness, device=None) -> ProofPlain:
    """channel/src/lib.rs:1045-1076.  witness: 2^k ints (sent to `device`)
    or a DeviceMLE.  Phases: `plain/pack` (witness to Montgomery limbs on
    the device), `plain/chain` (tree and round chain, enqueued),
    `plain/bundle` (the one readback of every proof value)."""
    if vk.variant != "plain":
        raise ValueError(f"prove_plain: VK of variant {vk.variant!r}")
    phase_seconds.clear()
    with phase_timer("plain/pack", phase_seconds):
        values = _witness_mle(witness, device).values_dev
    with phase_timer("plain/chain", phase_seconds):
        tree = dmk.build_tree(
            values, DeviceMerkleCommitment(vk.tree_label)._tree_cfg())
        root_dev = tree.levels_dev[-1][0]
        s, cps, final = _plain_chain(values, root_dev, vk.k)
    with phase_timer("plain/bundle", phase_seconds):
        # ONE device->host transfer for every value the proof carries.
        bundle = fr.unpack_ints(fr.from_mont(torch.cat(
            [root_dev[None], s[None], cps.reshape(-1, fr.N), final[None]])))
    rounds = [(fr_to_bytes(bundle[2 + 2 * i]), fr_to_bytes(bundle[3 + 2 * i]))
              for i in range(vk.k)]
    return ProofPlain(fr_to_bytes(bundle[0]), rounds,
                      fr_to_bytes(bundle[-1]))


def verify_plain(vk: VK, proof: ProofPlain, device=None) -> bool:
    """channel/src/lib.rs:1080-1126 on the host: s0 reconstructed as
    2*c0 + c1."""
    if vk.variant != "plain":
        raise ValueError(f"verify_plain: VK of variant {vk.variant!r}")
    chan = VerifierChannel(FastTranscript(b"E2E/PLAIN"))
    mv = ChanMerkleVerifier(chan, MerkleChannelCfg(vk.tree_label),
                            resolve(device))
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


# ---------------------------------------------------------------------------
# The Merkle-folded variant: the whole round chain (fold -> commit -> root
# -> round challenge) on the device with no readback, then the host
# Fiat-Shamir assembly.  r_i depends only on (i, prev_root)
# (channel/src/lib.rs:592-599), so it is derived on the device from a
# one-block sponge state that is constant but for the root's slot.
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _mf_chal_consts(i: int):
    """Constant sponge state for mf_round_challenge_from_root(i, .) as host
    Montgomery limbs [17, 8], and the rate slot p the root is added at:
    markers, label words and the challenge suffix are static; one
    permutation in all."""
    tr = Transcript(b"SUMCHECK-MF/ROUND-CHAL")
    tr.absorb_bytes(b"SUMCHECK/MF/R")
    tr.absorb_bytes(i.to_bytes(8, "little"))
    state = list(tr.state)
    p = tr.pos
    suffix = ([domain_tag_to_field(DS_CHALLENGE),
               domain_tag_to_field(DS_ABSORB_BYTES)]
              + bytes_to_field_words(b"r_i"))
    if p + 1 + len(suffix) > RATE:
        raise AssertionError("mf challenge crossed a block")
    for j, v in enumerate(suffix):
        state[p + 1 + j] = v
    return fr.pack_ints(state, mont=True), p


_MF_CHAL_DEV: dict = {}


def _mf_chal_state(i: int, device) -> torch.Tensor:
    """`_mf_chal_consts(i)`'s state on `device`, staged once per device."""
    key = (i, str(device))
    if key not in _MF_CHAL_DEV:
        _MF_CHAL_DEV[key] = fr.upload(_mf_chal_consts(i)[0], device)
    return _MF_CHAL_DEV[key]


def _mf_round_chal_dev(i: int, root_dev):
    """Device r_i = mf_round_challenge_from_root(i, root): [8] Montgomery,
    one t=17 permutation of one state."""
    cs = _mf_chal_state(i, root_dev.device)
    p = _mf_chal_consts(i)[1]
    st = torch.cat([cs[:p], fr.add(cs[p:p + 1], root_dev[None]), cs[p + 1:]])
    return dpos.permute(st[None], transcript_params())[0, 0]


def _mf_chain_device(mle: DeviceMLE, tree_cfg, k: int):
    """All k rounds of fold -> commit -> root -> round challenge as eager
    device calls with no readback (channel/src/lib.rs:632-730,
    protocol.rs:176-273).  Returns (layers [k + 1], trees [k + 1],
    coefficient pairs [k] of device [8] tensors)."""
    layers = [mle]
    trees = [dmk.build_tree(mle.values_dev, tree_cfg)]
    cpairs = []
    cur = mle.values_dev
    for i in range(k):
        v = cur.reshape(-1, 2, fr.N)
        c0 = fr.reduce_add(v[:, 0])
        c1 = fr.sub(fr.reduce_add(v[:, 1]), c0)
        cpairs.append((c0, c1))
        r = _mf_round_chal_dev(i, trees[i].levels_dev[-1][0])
        cur = fold_halves(v[:, 0], v[:, 1], r)
        layers.append(DeviceMLE(cur))
        trees.append(dmk.build_tree(cur, tree_cfg))
    return layers, trees, cpairs


def _mf_download(layers, trees, cpairs):
    """ONE device->host transfer: every tree level, every (c0, c1), every
    layer - primes the host caches so proof assembly never reads again."""
    arrays = [lv for t in trees for lv in t.levels_dev]
    arrays += [c[None] for pair in cpairs for c in pair]
    arrays += [lay.values_dev for lay in layers]
    bundle = fr.unpack_ints(fr.from_mont(torch.cat(arrays)))
    off = 0
    for t in trees:
        for li, lv in enumerate(t.levels_dev):
            n = int(lv.shape[0])
            t._levels_host[li] = bundle[off:off + n]
            off += n
    cints = []
    for _ in cpairs:
        cints.append((bundle[off], bundle[off + 1]))
        off += 2
    for lay in layers:
        n = int(lay.values_dev.shape[0])
        lay._ints = bundle[off:off + n]
        off += n
    return cints


class _MFGatherCtx:
    """Query-driven device gathers for MF proof assembly at large n.

    `_mf_download` moves every tree level and every layer to the host
    (~4.4*n rows), while ~2% of those rows end up in the proof.  This
    context keeps all chain outputs on the device in ONE concatenated
    buffer and, per round, gathers only the queried values and
    union-of-paths siblings (~200 rows) with one `index_select` and one
    `.cpu()`."""

    def __init__(self, layers, trees, cpairs):
        self.layers, self.trees = layers, trees
        arrays, off = [], 0
        self.off = {}
        for ti, t in enumerate(trees):
            for li, lv in enumerate(t.levels_dev):
                self.off[("t", ti, li)] = off
                arrays.append(lv)
                off += int(lv.shape[0])
        for ci, (c0, c1) in enumerate(cpairs):
            self.off[("c", ci)] = off
            arrays += [c0[None], c1[None]]
            off += 2
        for li, lay in enumerate(layers):
            self.off[("l", li)] = off
            arrays.append(lay.values_dev)
            off += int(lay.values_dev.shape[0])
        self.buf = torch.cat(arrays)

    def _fetch(self, idx):
        g = self.buf.index_select(0, torch.tensor(idx, dtype=torch.int64)
                                  .to(self.buf.device))
        return fr.unpack_ints(fr.from_mont(g))

    def roots_and_cpairs(self, k: int):
        idx = [self.off[("t", ti, len(self.trees[ti].levels_dev) - 1)]
               for ti in range(k + 1)]
        for ci in range(k):
            idx.extend((self.off[("c", ci)], self.off[("c", ci)] + 1))
        vals = self._fetch(idx)
        roots = vals[:k + 1]
        cints = [(vals[k + 1 + 2 * i], vals[k + 2 + 2 * i])
                 for i in range(k)]
        return roots, cints

    def round_data(self, i: int, cur_indices, next_indices):
        """(cur_values, cur_proof, next_values, next_proof) for round i,
        through one device gather."""
        tc, tn = self.trees[i], self.trees[i + 1]
        pc, pn = tc.open_plan(cur_indices), tn.open_plan(next_indices)
        idx = [self.off[("l", i)] + j for j in cur_indices]
        idx += [self.off[("l", i + 1)] + j for j in next_indices]
        for level, idxs in enumerate(pc[1]):
            idx += [self.off[("t", i, level)] + j for j in idxs]
        for level, idxs in enumerate(pn[1]):
            idx += [self.off[("t", i + 1, level)] + j for j in idxs]
        vals = self._fetch(idx)
        p = len(cur_indices)
        cur_values, p2 = vals[:p], p + len(next_indices)
        next_values = vals[p:p2]
        sib_c, sib_n, off = [], [], p2
        for idxs in pc[1]:
            sib_c.append(vals[off:off + len(idxs)])
            off += len(idxs)
        for idxs in pn[1]:
            sib_n.append(vals[off:off + len(idxs)])
            off += len(idxs)
        return (cur_values, tc.open_from_plan(pc, sib_c),
                next_values, tn.open_from_plan(pn, sib_n))

    def final_eval(self, k: int):
        return self._fetch([self.off[("l", k)]])[0]


def prove_mf(vk: VK, witness, device=None) -> ProofMF:
    """channel/src/lib.rs:1130-1172.  witness: 2^k ints (sent to `device`)
    or a DeviceMLE.  Phases: `mf/pack`, `mf/chain_device` (enqueued),
    `mf/gather_ctx` (n >= MF_GATHER_MIN_N) or `mf/download` (below; each
    ends in a readback, so it waits for the chain), `mf/host_assembly`."""
    if vk.variant != "mf":
        raise ValueError(f"prove_mf: VK of variant {vk.variant!r}")
    phase_seconds.clear()
    chan = ProverChannel(FastTranscript(b"E2E/MF"))
    cfg = SumCheckMFConfig(vk.queries_per_round)
    with phase_timer("mf/pack", phase_seconds):
        mle = _witness_mle(witness, device)
    tree_cfg = DeviceMerkleCommitment(vk.tree_label)._tree_cfg()
    with phase_timer("mf/chain_device", phase_seconds):
        layers, trees, cpairs = _mf_chain_device(mle, tree_cfg, vk.k)
    ctx = None
    if int(mle.values_dev.shape[0]) >= MF_GATHER_MIN_N:
        with phase_timer("mf/gather_ctx", phase_seconds):
            ctx = _MFGatherCtx(layers, trees, cpairs)
            roots, cints = ctx.roots_and_cpairs(vk.k)
    else:
        with phase_timer("mf/download", phase_seconds):
            cints = _mf_download(layers, trees, cpairs)
            roots = [t.root() for t in trees]

    # Host Fiat-Shamir assembly, byte-identical to SumCheckMFProver's
    # absorb discipline; all data answered from the primed host caches
    # (small n) or per-round device gathers (large n).
    with phase_timer("mf/host_assembly", phase_seconds):
        chan.send_digest(b"sumcheck-mf/root/0", roots[0])
        s_claim = (2 * cints[0][0] + cints[0][1]) % P   # sum = 2*c0 + c1
        chan.tr.absorb_bytes(b"SUMCHECK/MF/CLAIM")
        chan.tr.absorb_field(s_claim)
        rounds = []
        for i in range(vk.k):
            c0, c1 = cints[i]
            t = chan.tr
            t.absorb_bytes(b"SUMCHECK/MF/ROUND")
            t.absorb_bytes(i.to_bytes(8, "little"))
            t.absorb_bytes(b"COEFF/c0")
            t.absorb_field(c0)
            t.absorb_bytes(b"COEFF/c1")
            t.absorb_field(c1)
            chan.send_digest(b"sumcheck-mf/root/next", roots[i + 1])

            half = int(layers[i + 1].values_dev.shape[0])
            qsorted = _sample_queries(chan, cfg, i, half)
            cur_indices = _pair_indices(qsorted)
            next_indices = list(qsorted)
            if ctx is not None:
                cur_values, cur_proof, next_values, next_proof = \
                    ctx.round_data(i, cur_indices, next_indices)
            else:
                cur_values = layers[i].value_at(cur_indices)
                cur_proof = trees[i].open_many(cur_indices)
                next_values = layers[i + 1].value_at(next_indices)
                next_proof = trees[i + 1].open_many(next_indices)
            chan.send_opening(cur_indices, cur_values, cur_proof)
            chan.send_opening(next_indices, next_values, next_proof)

            rounds.append(RoundMF(
                fr_to_bytes(c0), fr_to_bytes(c1), fr_to_bytes(roots[i + 1]),
                cur_indices, [fr_to_bytes(v) for v in cur_values],
                MerkleProofBytes.from_proof(cur_proof),
                next_indices, [fr_to_bytes(v) for v in next_values],
                MerkleProofBytes.from_proof(next_proof)))

        final_eval = (ctx.final_eval(vk.k) if ctx is not None
                      else layers[vk.k].value_at([0])[0])
        chan.tr.absorb_bytes(b"SUMCHECK/MF/FINAL/EVAL")
        chan.tr.absorb_field(final_eval)
    return ProofMF(fr_to_bytes(roots[0]), rounds, fr_to_bytes(final_eval))


def verify_mf(vk: VK, proof: ProofMF, device=None) -> bool:
    """channel/src/lib.rs:1176-1240 on the host (the Merkle checks in the
    host engine: a round's batches are a few rows)."""
    if vk.variant != "mf":
        raise ValueError(f"verify_mf: VK of variant {vk.variant!r}")
    chan = VerifierChannel(FastTranscript(b"E2E/MF"))
    init_root = fr_from_bytes(proof.initial_root)
    sv = SumCheckMFVerifier(SumCheckMFConfig(vk.queries_per_round),
                            MerkleChannelCfg(vk.tree_label), chan,
                            init_root, vk.k, resolve(device))
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
