"""DEEP-ALI + m-ary FRI for the MLWE relation a*s + e = t: the prover
(crates/deep_ali/src/{lib,fri}.rs of saholmes/stark-mlwe), from four
witness columns of field values to the whole proof.

  - Fiat-Shamir over the columns: a tagged transcript hash of each whole
    column ("ALI/A" .. "ALI/T"), then "ALI/seed" over the four digests
    and n; (z, beta) from StdRng seeded with that digest, z outside H,
  - f0(w^j) = (a*s + e - t)(w^j) / (w^j - z) on H (no blinding),
  - FRI: per layer z_l from ("FRI/z/l", seed_z, l, size), the m-ary fold
    f'(b) = sum_t f[b*m + t] z^t, s = the fold broadcast to its m
    children (zeros on the last layer); each layer committed at the
    greedy arity 128..2 that divides it, arity >= 8 over leaf digests
    Poseidon(f, s) of a one-shot transcript, below over pair leaves,
    tree label = layer index,
  - queries: roots -> "FRI/seed"; a query's index per layer from
    ("FRI/index", roots_seed, l, q), a masked StdRng draw with one
    reseed; one union-of-paths opening of the children and one of the
    parents per layer, and the last layer opened at 0.

The dataclasses carry the field names of the upstream proof, which the
harness compares field by field.
"""

from __future__ import annotations

from dataclasses import dataclass

from .field import P, fr_to_bytes, get_root_of_unity, inv
from .merkle import MerkleProof, MerkleTree, pair_leaves
from .poseidon import Params, Suite
from .rng import StdRng
from .transcript import Transcript, tagged_hash

HASHED_LEAF_ARITIES = (128, 64, 32, 16, 8)
COLUMN_TAGS = (b"ALI/A", b"ALI/S", b"ALI/E", b"ALI/T")


@dataclass
class LayerQueryRef:
    i: int
    child_pos: int
    parent_index: int
    parent_pos: int


@dataclass
class LayerOpenPayload:
    f_i: int
    s_i: int
    f_parent_b: int
    s_parent_b: int


@dataclass
class FriQueryPayload:
    per_layer_refs: list
    per_layer_payloads: list
    final_index: int
    final_pair: tuple


@dataclass
class LayerBatchProof:
    hashed_leaves: bool
    child_indices: list
    child_proof: MerkleProof
    parent_indices: list
    parent_proof: MerkleProof


@dataclass
class FriLayerBatches:
    layers: list
    final_proof: MerkleProof


@dataclass
class DeepFriProof:
    roots: list
    layer_batches: FriLayerBatches
    queries: list
    n0: int
    omega0: int


def pick_arity(n: int, requested_m: int) -> int:
    for a in (128, 64, 32, 16, 8, 4):
        if requested_m >= a and n % a == 0:
            return a
    return 2 if n % 2 == 0 else 1


def _sample_outside_h(rng: StdRng, n: int, fallback: int, last: int) -> int:
    for _ in range(1000):
        cand = rng.gen_u64() % P
        if cand != 0 and pow(cand, n, P) != 1:
            return cand
    return fallback if pow(fallback, n, P) != 1 else last


def sample_z_beta(tag: bytes, n0: int, seed_f: int, tp: Params):
    fused = tagged_hash(tag, [seed_f, n0 % P], tp)
    rng = StdRng(fr_to_bytes(fused))
    beta = rng.gen_u64() % P
    return _sample_outside_h(rng, n0, (seed_f + 17) % P, 19), beta


def sample_z_layer(seed_z: int, level: int, size: int, tp: Params) -> int:
    fused = tagged_hash(b"FRI/z/l", [seed_z % P, level % P, size % P], tp)
    rng = StdRng(fr_to_bytes(fused))
    return _sample_outside_h(
        rng, size, (seed_z + level + 7) % (1 << 64) % P, 11)


def f0_values(a, s, e, t, omega: int, z: int) -> list:
    """(a*s + e - t) / (w^j - z) at every w^j of H, by one inversion."""
    n = len(a)
    den, w = [], 1
    for _ in range(n):
        den.append((w - z) % P)
        w = w * omega % P
    prefix = [1] * (n + 1)
    for j, d in enumerate(den):
        prefix[j + 1] = prefix[j] * d % P
    acc = inv(prefix[n])
    out = [0] * n
    for j in range(n - 1, -1, -1):
        phi = (a[j] * s[j] + e[j] - t[j]) % P
        out[j] = phi * (acc * prefix[j] % P) % P
        acc = acc * den[j] % P
    return out


def fold(f: list, z: int, m: int) -> list:
    zp = [1] * m
    for k in range(1, m):
        zp[k] = zp[k - 1] * z % P
    return [sum(f[b * m + k] * zp[k] for k in range(m)) % P
            for b in range(len(f) // m)]


def _leaf_pair_digests(tp: Params, items: list) -> list:
    """fri.rs:38-44: Poseidon(f, s) through a fresh one-shot transcript."""
    out = []
    for f, s in items:
        tr = Transcript(b"FRI/leaf/poseidon", tp)
        tr.absorb_bytes(b"FRI/leaf")
        tr.absorb_field(f)
        tr.absorb_field(s)
        out.append(tr.challenge(b"leaf"))
    return out


def _tagged_hashes(tp: Params, items: list) -> list:
    return [tagged_hash(tag, fields, tp) for tag, fields in items]


@dataclass
class _Layer:
    n: int
    m: int
    f: list
    s: list
    hashed: bool
    tree: MerkleTree


def commit_layer(ell: int, m_ell: int, f: list, s: list, suite: Suite,
                 workers) -> _Layer:
    n = len(f)
    arity = pick_arity(n, m_ell)
    p = suite.arity(arity)
    hashed = arity in HASHED_LEAF_ARITIES
    if hashed:
        leaves = workers.map_items(_leaf_pair_digests, (suite.transcript(),),
                                   list(zip(f, s)))
    else:
        leaves = pair_leaves(f, s, arity, p, ell, workers)
    return _Layer(n, m_ell, f, s, hashed, MerkleTree(leaves, arity, p, ell,
                                                     workers))


def _index_from_seed(seed_f: int, n_pow2: int) -> int:
    return StdRng(fr_to_bytes(seed_f)).gen_u64() & (n_pow2 - 1)


def query_index(index_seed: int, n: int, tp: Params) -> int:
    """fri.rs:374-382: a masked draw, one reseed, then a mask."""
    n_pow2 = 1 << (n - 1).bit_length() if n > 1 else 1
    i0 = _index_from_seed(index_seed, n_pow2)
    if i0 < n:
        return i0
    i2 = _index_from_seed(tagged_hash(b"FRI/index", [index_seed, 1], tp),
                          n_pow2)
    return i2 if i2 < n else i2 & (n - 1)


def prove(cols: list, schedule: list, r: int, seed_z: int, suite: Suite,
          workers, ds_tag: bytes = b"ALI/DEEP") -> DeepFriProof:
    """The proof of four columns of field values (a, s, e, t)."""
    tp = suite.transcript()
    n0 = len(cols[0])
    if any(len(c) != n0 for c in cols):
        raise ValueError("columns of different lengths")
    digests = workers.map_jobs(_tagged_hashes, [
        (tp, [(tag, col)]) for tag, col in zip(COLUMN_TAGS, cols)])
    seed_f = tagged_hash(b"ALI/seed", [d[0] for d in digests] + [n0 % P],
                         tp)
    z, _beta = sample_z_beta(ds_tag, n0, seed_f, tp)
    omega0 = get_root_of_unity(n0)
    f_layers = [f0_values(*cols, omega0, z)]

    size = n0
    for ell, m in enumerate(schedule):
        if size % m:
            raise ValueError("schedule does not divide the domain")
        f_layers.append(fold(f_layers[-1], sample_z_layer(seed_z, ell,
                                                          size, tp), m))
        size //= m
    L = len(schedule)
    s_layers = [[f_layers[ell + 1][i // schedule[ell]]
                 for i in range(len(f_layers[ell]))] for ell in range(L)]
    s_layers.append([0] * len(f_layers[L]))
    layers = [commit_layer(ell, schedule[ell] if ell < L else 1,
                           f_layers[ell], s_layers[ell], suite, workers)
              for ell in range(L + 1)]
    roots = [lay.tree.root() for lay in layers]

    roots_seed = tagged_hash(b"FRI/seed", roots, tp)
    index_seeds = workers.map_items(_tagged_hashes, (tp,), [
        (b"FRI/index", [roots_seed, ell % P, q % P])
        for q in range(r) for ell in range(L)])
    refs = []
    for q in range(r):
        row = []
        for ell in range(L):
            i = query_index(index_seeds[q * L + ell], layers[ell].n, tp)
            row.append(LayerQueryRef(i, 0, i // layers[ell].m, 0))
        refs.append(row)

    batches = []
    for ell in range(L):
        child_idx = sorted({row[ell].i for row in refs})
        parent_idx = sorted({row[ell].parent_index for row in refs})
        for row in refs:
            row[ell].child_pos = child_idx.index(row[ell].i)
            row[ell].parent_pos = parent_idx.index(row[ell].parent_index)
        batches.append(LayerBatchProof(
            layers[ell].hashed, child_idx,
            layers[ell].tree.open_many(child_idx), parent_idx,
            layers[ell + 1].tree.open_many(parent_idx)))
    final_proof = layers[L].tree.open_many([0])

    last = layers[L]
    queries = []
    for row in refs:
        payloads = [LayerOpenPayload(
            layers[ell].f[ref.i], layers[ell].s[ref.i],
            layers[ell + 1].f[ref.parent_index],
            layers[ell + 1].s[ref.parent_index])
            for ell, ref in enumerate(row)]
        queries.append(FriQueryPayload(row, payloads, 0,
                                       (last.f[0], last.s[0])))
    return DeepFriProof(roots, FriLayerBatches(batches, final_proof),
                        queries, n0, omega0)
