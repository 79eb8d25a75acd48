"""Generalized m-ary FRI with DEEP-ALI front-end: golden spec.

Mirrors `the Rust reference, crates/deep_ali/src/fri.rs`:
  - FS z_l sampling per layer: Poseidon-transcript hash -> 32-byte seed ->
    StdRng(ChaCha12) -> u64 candidates rejected until nonzero and outside H
    (:59-82),
  - m-ary fold f'(b) = sum_t f[b*m+t] z^t and the broadcast s-layer
    (:85-143),
  - per-layer commits: greedy arity 128..2 by divisibility (:220-229);
    arity >= 8 uses "hashed-leaf" single-column commits of
    Poseidon(f, s) via a fresh one-shot transcript (:38-44, :275-291);
    smaller arity uses pair-leaf trees; tree_label = layer index,
  - FS query-index derivation from the hash of all roots with masked
    StdRng draws and a single reseed fallback (:178-191, :355-466),
  - batched union-of-paths child/parent multiproofs shared across queries,
  - DeepAliMock / DeepAliRealBuilder with FS-derived (z, beta) (:475-570),
  - deep_fri_prove / deep_fri_verify / proof-size accounting (:589-805).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .deep_ali import deep_ali_merge_evals, deep_ali_merge_evals_blinded
from .field import P, fr_to_bytes, get_root_of_unity
from .merkle import MerkleChannelCfg, MerkleProof, MerkleProver, MerkleTree
from .rng import StdRng
from .transcript import Transcript

DS_FRI_SEED = b"FRI/seed"
DS_FRI_INDEX = b"FRI/index"
DS_FRI_Z_L = b"FRI/z/l"
DS_FRI_LEAF = b"FRI/leaf"


def tr_hash_fields_tagged(tag: bytes, fields: list) -> int:
    """fri.rs:28-35."""
    tr = Transcript(b"FRI/FS")
    tr.absorb_bytes(tag)
    for x in fields:
        tr.absorb_field(x)
    return tr.challenge(b"out")


def hash_leaf_pair(f: int, s: int) -> int:
    """Poseidon hash of (f, s) via a fresh one-shot transcript (fri.rs:38-44)."""
    tr = Transcript(b"FRI/leaf/poseidon")
    tr.absorb_bytes(DS_FRI_LEAF)
    tr.absorb_field(f)
    tr.absorb_field(s)
    return tr.challenge(b"leaf")


@dataclass(frozen=True)
class FriDomain:
    omega: int
    size: int

    @classmethod
    def new_radix2(cls, size: int) -> "FriDomain":
        return cls(get_root_of_unity(size), size)


def fri_sample_z_ell(seed_z: int, level: int, domain_size: int) -> int:
    """fri.rs:59-82."""
    fused = tr_hash_fields_tagged(
        DS_FRI_Z_L, [seed_z % P, level % P, domain_size % P])
    rng = StdRng.from_seed(fr_to_bytes(fused))
    for _ in range(1000):
        cand = rng.gen_u64() % P
        if cand != 0 and pow(cand, domain_size, P) != 1:
            return cand
    fallback = (seed_z + level + 7) % (1 << 64) % P
    if pow(fallback, domain_size, P) != 1:
        return fallback
    return 11


def fri_fold_layer(f_l: list, z_l: int, m: int) -> list:
    """fri.rs:85-102."""
    assert m >= 2 and len(f_l) % m == 0
    z_pows = [1] * m
    for t in range(1, m):
        z_pows[t] = z_pows[t - 1] * z_l % P
    out = []
    for b in range(len(f_l) // m):
        base = b * m
        out.append(sum(f_l[base + t] * z_pows[t] for t in range(m)) % P)
    return out


def fri_fold_schedule(f0: list, schedule: list, seed: int) -> list:
    """fri.rs:104-118: returns all layers including the input."""
    layers = [list(f0)]
    cur = list(f0)
    for level, m in enumerate(schedule):
        assert len(cur) % m == 0
        z_l = fri_sample_z_ell(seed, level, len(cur))
        cur = fri_fold_layer(cur, z_l, m)
        layers.append(cur)
    return layers


def compute_s_layer(f_l: list, z_l: int, m: int) -> list:
    """Broadcast each parent fold value back to all m children (fri.rs:123-143)."""
    folded = fri_fold_layer(f_l, z_l, m)
    return [folded[i // m] for i in range(len(f_l))]


def layer_sizes_from_schedule(n0: int, schedule: list) -> list:
    sizes = [n0]
    n = n0
    for m in schedule:
        assert n % m == 0, "schedule not dividing domain size"
        n //= m
        sizes.append(n)
    return sizes


def pick_arity_for_layer(n: int, requested_m: int) -> int:
    """Greedy 128 -> 2 by divisibility (fri.rs:220-229)."""
    for a in (128, 64, 32, 16, 8, 4):
        if requested_m >= a and n % a == 0:
            return a
    if n % 2 == 0:
        return 2
    return 1


def use_hashed_leaves(arity: int) -> bool:
    return arity in (128, 64, 32, 16, 8)


def fs_seed_from_roots(roots: list) -> int:
    return tr_hash_fields_tagged(DS_FRI_SEED, roots)


def index_from_seed(seed_f: int, n_pow2: int) -> int:
    """fri.rs:180-187."""
    assert n_pow2 & (n_pow2 - 1) == 0
    rng = StdRng.from_seed(fr_to_bytes(seed_f))
    return rng.gen_u64() & (n_pow2 - 1)


def index_seed(roots_seed: int, ell: int, q: int) -> int:
    return tr_hash_fields_tagged(DS_FRI_INDEX, [roots_seed, ell % P, q % P])


def derive_query_index(roots_seed: int, ell: int, q: int, n: int) -> int:
    """fri.rs:374-382: masked draw with one reseed fallback."""
    n_pow2 = 1 << (n - 1).bit_length() if n > 1 else 1
    seed = index_seed(roots_seed, ell, q)
    i0 = index_from_seed(seed, n_pow2)
    if i0 < n:
        return i0
    reseed = tr_hash_fields_tagged(DS_FRI_INDEX, [seed, 1])
    i2 = index_from_seed(reseed, n_pow2)
    return i2 if i2 < n else i2 & (n - 1)


# ---------------------------------------------------------------------------
# Prover state / proof structures.
# ---------------------------------------------------------------------------

@dataclass
class FriLayerCommitment:
    n: int
    m: int
    root: int
    f: list
    s: list
    hashed_leaves: bool
    tree: MerkleTree
    cfg: MerkleChannelCfg


@dataclass
class FriProverState:
    f_layers: list
    s_layers: list
    schedule: list
    layers: list          # list[FriLayerCommitment], len L+1
    omega_layers: list
    z_layers: list


def commit_layer(ell: int, n: int, m_ell: int, f: list, s: list,
                 leaf_hash=hash_leaf_pair) -> FriLayerCommitment:
    """Commit one FRI layer (fri.rs:269-301).  `leaf_hash` may be swapped
    for a batched device implementation with identical outputs."""
    arity = pick_arity_for_layer(n, m_ell)
    hashed = use_hashed_leaves(arity)
    cfg = MerkleChannelCfg.new(arity, tree_label=ell)
    prover = MerkleProver(cfg)
    if hashed:
        h = [leaf_hash(f[i], s[i]) for i in range(n)]
        root, tree = prover.commit_single(h)
    else:
        root, tree = prover.commit_pairs(f, s)
    return FriLayerCommitment(n, m_ell, root, f, s, hashed, tree, cfg)


def fri_build_transcript(f0: list, domain0: FriDomain, schedule: list,
                         seed_z: int, commit_fn=commit_layer) -> FriProverState:
    """fri.rs:231-312."""
    L = len(schedule)
    f_layers = [list(f0)]
    z_layers, omega_layers = [], []
    cur = list(f0)
    cur_size = domain0.size
    for ell, m in enumerate(schedule):
        z = fri_sample_z_ell(seed_z, ell, cur_size)
        z_layers.append(z)
        omega_layers.append(get_root_of_unity(cur_size))
        cur = fri_fold_layer(cur, z, m)
        cur_size //= m
        f_layers.append(cur)

    s_layers = [compute_s_layer(f_layers[ell], z_layers[ell], schedule[ell])
                for ell in range(L)]
    s_layers.append([0] * len(f_layers[L]))

    layers = []
    for ell in range(L + 1):
        m_ell = schedule[ell] if ell < L else 1
        layers.append(commit_fn(ell, len(f_layers[ell]), m_ell,
                                f_layers[ell], s_layers[ell]))

    return FriProverState(f_layers, s_layers, list(schedule), layers,
                          omega_layers, z_layers)


@dataclass
class LayerQueryRef:
    i: int
    child_pos: int
    parent_index: int
    parent_pos: int


@dataclass
class LayerBatchProof:
    hashed_leaves: bool
    child_indices: list
    child_proof: MerkleProof
    parent_indices: list
    parent_proof: MerkleProof


@dataclass
class LayerOpenPayload:
    f_i: int
    s_i: int
    f_parent_b: int
    s_parent_b: int


@dataclass
class FriQueryPayload:
    per_layer_refs: list       # list[LayerQueryRef]
    per_layer_payloads: list   # list[LayerOpenPayload]
    final_index: int
    final_pair: tuple


@dataclass
class FriLayerBatches:
    layers: list               # list[LayerBatchProof]
    final_proof: MerkleProof


@dataclass
class DeepFriParams:
    schedule: list
    r: int
    seed_z: int


@dataclass
class DeepFriProof:
    roots: list
    layer_batches: FriLayerBatches
    queries: list              # list[FriQueryPayload]
    n0: int
    omega0: int


def fri_prove_queries(st: FriProverState, r: int, roots_seed: int):
    """fri.rs:355-466."""
    L = len(st.schedule)

    refs_per_query = []
    child_buckets = [[] for _ in range(L)]
    parent_buckets = [[] for _ in range(L)]
    for q in range(r):
        per_layer = []
        for ell in range(L):
            layer = st.layers[ell]
            i = derive_query_index(roots_seed, ell, q, layer.n)
            b = i // layer.m
            child_buckets[ell].append(i)
            parent_buckets[ell].append(b)
            per_layer.append(LayerQueryRef(i, 0, b, 0))
        last = st.layers[L]
        refs_per_query.append(FriQueryPayload(
            per_layer, [], 0, (last.f[0], last.s[0])))

    layer_batches = []
    for ell in range(L):
        child_idx = sorted(set(child_buckets[ell]))
        parent_idx = sorted(set(parent_buckets[ell]))
        child_proof = st.layers[ell].tree.open_many(child_idx)
        parent_proof = st.layers[ell + 1].tree.open_many(parent_idx)
        for q in range(r):
            ref = refs_per_query[q].per_layer_refs[ell]
            ref.child_pos = child_idx.index(ref.i)
            ref.parent_pos = parent_idx.index(ref.parent_index)
        layer_batches.append(LayerBatchProof(
            st.layers[ell].hashed_leaves, child_idx, child_proof,
            parent_idx, parent_proof))

    final_proof = st.layers[L].tree.open_many([0])
    roots = [lay.root for lay in st.layers]
    return refs_per_query, roots, FriLayerBatches(layer_batches, final_proof)


# ---------------------------------------------------------------------------
# DEEP-ALI builders (fri.rs:475-570).
# ---------------------------------------------------------------------------

class DeepAliMock:
    """Deterministic pseudo-random f0 from a hash of the inputs (fri.rs:480-495)."""

    def build_f0(self, a, s, e, t, n0, domain):
        seed_f = tr_hash_fields_tagged(b"ALI/mock/seed", [
            tr_hash_fields_tagged(b"ALI/a", a),
            tr_hash_fields_tagged(b"ALI/s", s),
            tr_hash_fields_tagged(b"ALI/e", e),
            tr_hash_fields_tagged(b"ALI/t", t),
            n0 % P,
        ])
        rng = StdRng.from_seed(fr_to_bytes(seed_f))
        return [rng.gen_u64() % P for _ in range(n0)]


def ali_sample_z_beta_fs(tag: bytes, n0: int, roots_seed: int):
    """fri.rs:511-533."""
    fused = tr_hash_fields_tagged(tag, [roots_seed, n0 % P])
    rng = StdRng.from_seed(fr_to_bytes(fused))
    beta = rng.gen_u64() % P
    for _ in range(1000):
        cand = rng.gen_u64() % P
        if cand != 0 and pow(cand, n0, P) != 1:
            return cand, beta
    fallback = (roots_seed + 17) % P
    if pow(fallback, n0, P) != 1:
        return fallback, beta
    return 19, beta


class DeepAliRealBuilder:
    """fri.rs:498-570."""

    def __init__(self, r_eval_opt=None, use_blinding=False,
                 ds_tag=b"ALI/DEEP"):
        self.r_eval_opt = r_eval_opt
        self.use_blinding = use_blinding
        self.ds_tag = ds_tag

    def build_f0(self, a, s, e, t, n0, domain: FriDomain):
        assert len(a) == len(s) == len(e) == len(t) == n0
        seed_f = tr_hash_fields_tagged(b"ALI/seed", [
            tr_hash_fields_tagged(b"ALI/A", a),
            tr_hash_fields_tagged(b"ALI/S", s),
            tr_hash_fields_tagged(b"ALI/E", e),
            tr_hash_fields_tagged(b"ALI/T", t),
            n0 % P,
        ])
        z, beta = ali_sample_z_beta_fs(self.ds_tag, n0, seed_f)
        if self.use_blinding:
            f0, _, _ = deep_ali_merge_evals_blinded(
                a, s, e, t, self.r_eval_opt, beta, domain.omega, z)
        else:
            f0, _, _ = deep_ali_merge_evals(a, s, e, t, domain.omega, z)
        return f0


# ---------------------------------------------------------------------------
# End-to-end prove / verify (fri.rs:601-762).
# ---------------------------------------------------------------------------

def deep_fri_prove(builder, a, s, e, t, n0: int,
                   params: DeepFriParams,
                   commit_fn=commit_layer) -> DeepFriProof:
    domain0 = FriDomain.new_radix2(n0)
    f0 = builder.build_f0(a, s, e, t, n0, domain0)

    st = fri_build_transcript(f0, domain0, params.schedule, params.seed_z,
                              commit_fn=commit_fn)
    roots = [lay.root for lay in st.layers]
    roots_seed = fs_seed_from_roots(roots)
    refs_only, roots2, batches = fri_prove_queries(st, params.r, roots_seed)
    assert roots == roots2

    queries = []
    L = len(params.schedule)
    for q in range(params.r):
        payloads = []
        for ell in range(L):
            ref = refs_only[q].per_layer_refs[ell]
            payloads.append(LayerOpenPayload(
                st.layers[ell].f[ref.i],
                st.layers[ell].s[ref.i],
                st.layers[ell + 1].f[ref.parent_index],
                st.layers[ell + 1].s[ref.parent_index],
            ))
        queries.append(FriQueryPayload(
            refs_only[q].per_layer_refs, payloads,
            refs_only[q].final_index, refs_only[q].final_pair))

    return DeepFriProof(roots, batches, queries, n0, domain0.omega)


def deep_fri_verify(params: DeepFriParams, proof: DeepFriProof,
                    leaf_hash=hash_leaf_pair) -> bool:
    L = len(params.schedule)
    if len(proof.roots) != L + 1:
        return False
    if len(proof.layer_batches.layers) != L:
        return False
    if len(proof.queries) != params.r:
        return False

    sizes = layer_sizes_from_schedule(proof.n0, params.schedule)

    child_maps = [{} for _ in range(L)]
    parent_maps = [{} for _ in range(L)]
    for q in range(params.r):
        qp = proof.queries[q]
        if len(qp.per_layer_refs) != L or len(qp.per_layer_payloads) != L:
            return False
        for ell in range(L):
            ref = qp.per_layer_refs[ell]
            pay = qp.per_layer_payloads[ell]
            child_maps[ell].setdefault(ref.i, (pay.f_i, pay.s_i))
            parent_maps[ell].setdefault(ref.parent_index,
                                        (pay.f_parent_b, pay.s_parent_b))

    def verify_batch(root, indices, val_map, proof_mp, n, req_m, label):
        arity = pick_arity_for_layer(n, req_m)
        hashed = use_hashed_leaves(arity)
        prover = MerkleProver(MerkleChannelCfg.new(arity, tree_label=label))
        try:
            entries = [val_map[i] for i in indices]
        except KeyError:
            return False
        if hashed:
            leaves = [leaf_hash(f, s) for f, s in entries]
            return prover.verify_single(root, indices, leaves, proof_mp)
        return prover.verify_pairs(root, indices, entries, proof_mp)

    for ell in range(L):
        lb = proof.layer_batches.layers[ell]
        if not verify_batch(proof.roots[ell], lb.child_indices,
                            child_maps[ell], lb.child_proof,
                            sizes[ell], params.schedule[ell], ell):
            return False
        req_parent = params.schedule[ell + 1] if ell + 1 < L else 1
        if not verify_batch(proof.roots[ell + 1], lb.parent_indices,
                            parent_maps[ell], lb.parent_proof,
                            sizes[ell + 1], req_parent, ell + 1):
            return False

    # Local fold checks: s_i == f_parent[i/m] (fri.rs:169-176, :724-738).
    for q in range(params.r):
        qp = proof.queries[q]
        for ell in range(L):
            ref = qp.per_layer_refs[ell]
            pay = qp.per_layer_payloads[ell]
            m = params.schedule[ell]
            b = ref.i // m
            if b >= sizes[ell] // m:
                return False
            if pay.s_i != pay.f_parent_b:
                return False

    # Final layer: opening at index 0 (fri.rs:741-759).
    final_idx = proof.queries[0].final_index
    if final_idx != 0:
        return False
    ar_last = pick_arity_for_layer(sizes[L], 1)
    prover_last = MerkleProver(MerkleChannelCfg.new(ar_last, tree_label=L))
    fpair = proof.queries[0].final_pair
    if use_hashed_leaves(ar_last):
        leaf_h = leaf_hash(fpair[0], fpair[1])
        return prover_last.verify_single(proof.roots[L], [0], [leaf_h],
                                         proof.layer_batches.final_proof)
    return prover_last.verify_pairs(proof.roots[L], [0], [fpair],
                                    proof.layer_batches.final_proof)


# ---------------------------------------------------------------------------
# Proof size accounting (fri.rs:764-805).
# ---------------------------------------------------------------------------

FR_BYTES = 32
INDEX_BYTES = 8


def merkle_proof_size_bytes(mp: MerkleProof) -> int:
    return sum(len(g) for g in mp.siblings) * FR_BYTES


def deep_fri_proof_size_bytes(p: DeepFriProof) -> int:
    total = len(p.roots) * FR_BYTES + FR_BYTES + INDEX_BYTES
    for lb in p.layer_batches.layers:
        total += merkle_proof_size_bytes(lb.child_proof)
        total += merkle_proof_size_bytes(lb.parent_proof)
        total += len(lb.child_indices) * INDEX_BYTES
        total += len(lb.parent_indices) * INDEX_BYTES
    total += merkle_proof_size_bytes(p.layer_batches.final_proof)
    for q in p.queries:
        total += INDEX_BYTES + 2 * FR_BYTES
        total += len(q.per_layer_refs) * 2 * INDEX_BYTES
        total += len(q.per_layer_payloads) * 4 * FR_BYTES
    return total
