"""Device DEEP-ALI + m-ary FRI prover/verifier.

Counterpart of `fri/__init__.py` of the JAX package (crates/deep_ali/src/
fri.rs of the Rust reference end to end; golden spec in `spec.fri`), with
the hot path on the card and every step an eager call:

  - folds are ONE `fr.fold` launch with the z-power row (a [n/m, m] x [m]
    contraction with a single Montgomery reduction per output),
  - s-layers are broadcast reshapes,
  - hashed-leaf commits batch one transcript permutation per leaf and the
    Merkle levels hash on the device,
  - Fiat-Shamir control flow (z_l sampling, roots seed, query indices)
    stays host-side and bit-exact (tiny), reusing the golden spec -
    including the proof structures, which operate on the device trees
    through duck typing,
  - the verifier mirrors spec.fri.deep_fri_verify with batched hashing for
    leaf digests and Merkle path reconstruction.

Proofs are bit-identical to the spec prover's output.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from .. import merkle as dmk
from .. import native
from ..device import resolve
from ..ops import fr
from ..spec.field import P, fr_to_bytes, get_root_of_unity
from ..spec.fri import (DeepFriParams, DeepFriProof, FriDomain,
                        FriLayerBatches, FriLayerCommitment, FriProverState,
                        FriQueryPayload, LayerBatchProof, LayerOpenPayload,
                        LayerQueryRef, MerkleChannelCfg,
                        ali_sample_z_beta_fs, fri_sample_z_ell,
                        fs_seed_from_roots,
                        layer_sizes_from_schedule, pick_arity_for_layer,
                        use_hashed_leaves)
from ..spec.rng import StdRng, chacha_first_u64_batch
from ..utils import phase_timer
from . import deep_ali as dali
from . import fs

# Wall seconds of the last prove's phases, by name (host clock; a phase
# that ends in a readback includes the device work it waited for).
phase_seconds: dict = {}


class HostFieldView:
    """Lazy canonical-int view of a device Montgomery tensor [n, 8].

    Individual entries can be primed sparsely (from a batched gather);
    full materialization is the fallback.
    """

    def __init__(self, dev):
        self.dev = dev
        self._ints = None
        self._sparse: dict = {}

    def prime(self, idx_to_int: dict):
        self._sparse.update(idx_to_int)

    def _mat(self):
        if self._ints is None:
            self._ints = fr.unpack_ints(fr.from_mont(self.dev))
        return self._ints

    def __getitem__(self, i):
        if self._ints is None and i in self._sparse:
            return self._sparse[i]
        return self._mat()[i]

    def __len__(self):
        return int(self.dev.shape[0])

    def __iter__(self):
        return iter(self._mat())


class GatherBatch:
    """Accumulates (tensor, indices) gathers and resolves them with one
    `index_select` each, one concatenation, one conversion out of
    Montgomery form and ONE device->host copy."""

    def __init__(self):
        self._items = []     # (tensor, [row indices])

    def add(self, arr, indices) -> int:
        """Queue a gather; returns a handle."""
        self._items.append((arr, [int(i) for i in indices]))
        return len(self._items) - 1

    def _rows(self):
        """Every queued row, in order: one [total, 8] Montgomery tensor
        (None when nothing was queued)."""
        parts = []
        for arr, idxs in self._items:
            if idxs:
                ix = torch.tensor(idxs, dtype=torch.int64, device=arr.device)
                parts.append(arr.index_select(0, ix))
        return torch.cat(parts, dim=0) if parts else None

    def run(self):
        """Resolves all gathers; returns one int list per handle."""
        rows = self._rows()
        ints = fr.unpack_ints(fr.from_mont(rows)) if rows is not None else []
        out = []
        off = 0
        for _, idxs in self._items:
            out.append(ints[off:off + len(idxs)])
            off += len(idxs)
        return out


# ---------------------------------------------------------------------------
# Device folds.
# ---------------------------------------------------------------------------

def fold_layer_dev(f_dev, z: int, m: int):
    """m-ary fold f'(b) = sum_t f[b*m+t] z^t (fri.rs:85-102) as one fused
    constant-row contraction; the z-powers go up in plain Montgomery form."""
    n = int(f_dev.shape[0])
    assert m >= 2 and n % m == 0
    zpow = fr.to_device(
        fr.pack_ints([pow(z, t, P) for t in range(m)], mont=True),
        f_dev.device)
    return fr.fold(f_dev, zpow)


def s_layer_dev(f_dev, folded_dev, m: int):
    """Broadcast each parent value to its m children (fri.rs:123-143)."""
    nb = int(folded_dev.shape[0])
    return folded_dev[:, None, :].expand(nb, m, fr.N).reshape(nb * m, fr.N)


# ---------------------------------------------------------------------------
# Layer commits (fri.rs:269-301) on the device.
# ---------------------------------------------------------------------------

def commit_layer_device(ell: int, n: int, m_ell: int, f_dev, s_dev,
                        defer_root: bool = False):
    arity = pick_arity_for_layer(n, m_ell)
    hashed = use_hashed_leaves(arity)
    cfg = MerkleChannelCfg.new(arity, tree_label=ell)
    if hashed:
        leaves = fs.hash_leaf_pairs_dev(f_dev, s_dev)
        tree = dmk.build_tree(leaves, cfg)
    else:
        tree = dmk.build_tree_pairs(f_dev, s_dev, cfg)
    root = None if defer_root else tree.root()
    return FriLayerCommitment(n, m_ell, root,
                              HostFieldView(f_dev), HostFieldView(s_dev),
                              hashed, tree, cfg)


def fri_build_transcript_dev(f0_dev, domain0: FriDomain, schedule,
                             seed_z: int) -> FriProverState:
    """fri.rs:231-312 with device folds/commits; FS sampling on host."""
    L = len(schedule)
    z_layers, omega_layers = [], []
    cur_size = domain0.size
    for ell, m in enumerate(schedule):
        z_layers.append(fri_sample_z_ell(seed_z, ell, cur_size))
        omega_layers.append(get_root_of_unity(cur_size))
        cur_size //= m

    f_layers = [f0_dev]
    cur = f0_dev
    for ell, m in enumerate(schedule):
        cur = fold_layer_dev(cur, z_layers[ell], m)
        f_layers.append(cur)
    s_layers = [s_layer_dev(f_layers[ell], f_layers[ell + 1],
                            schedule[ell]) for ell in range(L)]
    s_layers.append(torch.zeros_like(f_layers[L]))
    layers = []
    for ell in range(L + 1):
        m_ell = schedule[ell] if ell < L else 1
        layers.append(commit_layer_device(
            ell, int(f_layers[ell].shape[0]), m_ell,
            f_layers[ell], s_layers[ell], defer_root=True))

    with phase_timer("fri/roots_readback", phase_seconds):
        _roots_readback(layers)
    return FriProverState([lay.f for lay in layers],
                          [lay.s for lay in layers],
                          list(schedule), layers, omega_layers, z_layers)


def _roots_readback(layers):
    """One small sync: just the L+1 root digests (needed for the FS
    roots_seed before query derivation).  Everything else proof assembly
    needs is fetched later in ONE batched gather."""
    bundle = fr.from_mont(torch.cat(
        [lay.tree.levels_dev[-1] for lay in layers], dim=0))
    ints = fr.unpack_ints(bundle)
    for i, lay in enumerate(layers):
        lay.tree._levels_host[-1] = [ints[i]]
        lay.root = ints[i]


# ---------------------------------------------------------------------------
# DEEP-ALI builders (fri.rs:475-570) with device compute.
# ---------------------------------------------------------------------------

def _host_u64_cols(xs):
    """Witness columns as host [n, 4] uint64 Montgomery limb arrays, or
    None: int lists are packed here, numpy / CPU-tensor limb arrays pass as
    views; columns that live on the card return None - the device branch
    is taken then, and nothing is read back."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return None
        if isinstance(x, (list, tuple)):
            x = fr.pack_ints(list(x), mont=True)
        out.append(fr.to_u64(x))
    return out


def _device_column_hashes(tags, cols, dev):
    """The device branch's digests: the four columns stacked on `dev`,
    hashed by `fs.tagged_hash_vecs`.  Returns (digests, column tensors)."""
    cols = [_as_mont_dev(c, dev) for c in cols]
    with phase_timer("ali/column_hashes", phase_seconds):
        return fs.tagged_hash_vecs(tags, torch.stack(cols, dim=0)), cols


class DeviceDeepAliRealBuilder:
    """fri.rs:498-570: FS-derives (z, beta) from the hash of the witness
    columns, then merges on the device."""

    def __init__(self, r_eval_opt=None, use_blinding=False,
                 ds_tag=b"ALI/DEEP", device_columns=False):
        """`device_columns=True` sends host-resident columns through the
        device branch too (they are uploaded first); columns that already
        live on the card always take it."""
        self.r_eval_opt = r_eval_opt
        self.use_blinding = use_blinding
        self.ds_tag = ds_tag
        self.device_columns = device_columns

    def build_f0(self, a, s, e, t, n0: int, domain: FriDomain, device=None):
        dev = resolve(device)
        tags = [b"ALI/A", b"ALI/S", b"ALI/E", b"ALI/T"]
        cols = None if self.device_columns else _host_u64_cols((a, s, e, t))
        if cols is None:
            return self._build_f0_device(tags, (a, s, e, t), n0, domain, dev)
        # The absorb chain is inherently sequential (one permutation per
        # rate block) and runs in the host engine, one thread per column;
        # overlap it with everything that has no (z, beta) dependence: the
        # host phi = a*s + e - t merge, its upload, and the omega power
        # table.  The ctypes call releases the GIL.
        def absorb():
            with phase_timer("ali/host_absorb", phase_seconds):
                return fs.tagged_hash_cols_native(tags, cols)

        with phase_timer("ali/column_hashes+overlap", phase_seconds), \
                ThreadPoolExecutor(max_workers=1) as pool:
            hashes = pool.submit(absorb)
            phi0 = fr.to_device(fr.from_u64(native.phi_batch(cols)), dev)
            w = dali.omega_powers(domain.omega, n0, dev)
            r_dev = (_as_mont_dev(self.r_eval_opt, dev)
                     if (self.use_blinding
                         and self.r_eval_opt is not None) else None)
            ha, hs, he, ht = hashes.result()    # re-raises what absorb raised
        seed_f = fs.one_block_tagged_hash_batch(
            b"ALI/seed", [[ha, hs, he, ht, n0 % P]])[0]
        z, beta = ali_sample_z_beta_fs(self.ds_tag, n0, seed_f)
        with phase_timer("ali/f0_quotient", phase_seconds):
            return dali.f0_from_phi(
                phi0, w, z, beta=beta,
                r_eval=r_dev if self.use_blinding else None)

    def _build_f0_device(self, tags, cols, n0, domain, dev):
        """Columns on the card: the four Fiat-Shamir chains run there (one
        launch of the chain kernel), and f0 comes from the device merge."""
        (ha, hs, he, ht), cols = _device_column_hashes(tags, cols, dev)
        seed_f = fs.one_block_tagged_hash_batch(
            b"ALI/seed", [[ha, hs, he, ht, n0 % P]])[0]
        z, beta = ali_sample_z_beta_fs(self.ds_tag, n0, seed_f)
        r_dev = (_as_mont_dev(self.r_eval_opt, dev)
                 if (self.use_blinding and self.r_eval_opt is not None)
                 else None)
        with phase_timer("ali/f0_quotient", phase_seconds):
            f0, _, _ = dali.merge_evals_device(
                *cols, domain.omega, z, r_eval=r_dev, beta=beta,
                with_c_star=False)
        return f0


def _as_mont_dev(x, device):
    if isinstance(x, (list, tuple)):
        x = fr.pack_ints(list(x), mont=True)
    return fr.to_device(x, device)


class DeviceDeepAliMock:
    """fri.rs:480-495: deterministic pseudo-random f0 (device packing)."""

    def __init__(self, device_columns=False):
        self.device_columns = device_columns

    def build_f0(self, a, s, e, t, n0: int, domain: FriDomain, device=None):
        dev = resolve(device)
        tags = [b"ALI/a", b"ALI/s", b"ALI/e", b"ALI/t"]
        cols = None if self.device_columns else _host_u64_cols((a, s, e, t))
        if cols is None:
            (ha, hs, he, ht), _ = _device_column_hashes(tags, (a, s, e, t),
                                                        dev)
        else:
            ha, hs, he, ht = fs.tagged_hash_cols_native(tags, cols)
        seed_f = fs.one_block_tagged_hash_batch(
            b"ALI/mock/seed", [[ha, hs, he, ht, n0 % P]])[0]
        rng = StdRng.from_seed(fr_to_bytes(seed_f))
        vals = [rng.gen_u64() % P for _ in range(n0)]
        return fr.to_device(fr.pack_ints(vals, mont=True), dev)


# ---------------------------------------------------------------------------
# Query-index derivation (fri.rs:355-466) with batched seed hashing.
# ---------------------------------------------------------------------------

def derive_query_indices_batched(roots_seed: int, schedule, r: int, sizes):
    """All (layer, query) indices with the per-(l,q) seed hashes, the
    ChaCha12 first-u64 draws AND the rare reseed fallbacks batched into
    single calls.  Bit-exact with spec.fri.derive_query_index
    (fri.rs:374-382)."""
    L = len(schedule)
    pairs = [(ell, q) for ell in range(L) for q in range(r)]
    seeds = fs.one_block_tagged_hash_batch(
        b"FRI/index", [[roots_seed, ell % P, q % P] for ell, q in pairs])
    draws = chacha_first_u64_batch([fr_to_bytes(s) for s in seeds])
    out = {}
    retry = []
    for (ell, q), seed, u in zip(pairs, seeds, draws):
        n = sizes[ell]
        n_pow2 = 1 << (n - 1).bit_length() if n > 1 else 1
        i0 = u & (n_pow2 - 1)
        if i0 < n:
            out[(ell, q)] = i0
        else:
            retry.append(((ell, q), seed, n, n_pow2))
    if retry:
        reseeds = fs.one_block_tagged_hash_batch(
            b"FRI/index", [[seed, 1] for _, seed, _, _ in retry])
        redraws = chacha_first_u64_batch([fr_to_bytes(s) for s in reseeds])
        for ((ell, q), _, n, n_pow2), u2 in zip(retry, redraws):
            i2 = u2 & (n_pow2 - 1)
            out[(ell, q)] = i2 if i2 < n else i2 & (n - 1)
    return out


def fri_prove_queries_dev(st: FriProverState, r: int, roots_seed: int,
                          batch: GatherBatch | None = None):
    """fri.rs:355-466 with batched index derivation and ALL value fetches
    (Merkle path siblings, f/s payload entries, the final pair) resolved
    in ONE device->host gather; proof assembly is identical to
    spec.fri.fri_prove_queries.  `batch` resolves the gathers (default: a
    `GatherBatch`; the sharded prover passes one that reads every rank's
    rows)."""
    L = len(st.schedule)
    sizes = [lay.n for lay in st.layers]
    idx_map = derive_query_indices_batched(roots_seed, st.schedule, r, sizes)

    child_buckets = [[] for _ in range(L)]
    parent_buckets = [[] for _ in range(L)]
    refs_per_query = []
    for q in range(r):
        per_layer = []
        for ell in range(L):
            layer = st.layers[ell]
            i = idx_map[(ell, q)]
            b = i // layer.m
            child_buckets[ell].append(i)
            parent_buckets[ell].append(b)
            per_layer.append(LayerQueryRef(i, 0, b, 0))
        refs_per_query.append(per_layer)

    # ---- plan everything, then fetch in one batch --------------------
    batch = GatherBatch() if batch is None else batch
    plans = []
    for ell in range(L):
        child_idx = sorted(set(child_buckets[ell]))
        parent_idx = sorted(set(parent_buckets[ell]))
        for which, tree, idxs in (
                ("child", st.layers[ell].tree, child_idx),
                ("parent", st.layers[ell + 1].tree, parent_idx)):
            plan = tree.open_plan(idxs)
            handles = [batch.add(tree.levels_dev[lvl], sib)
                       for lvl, sib in enumerate(plan[1])]
            plans.append((ell, which, tree, plan, handles, idxs))
    final_tree = st.layers[L].tree
    final_plan = final_tree.open_plan([0])
    final_handles = [batch.add(final_tree.levels_dev[lvl], sib)
                     for lvl, sib in enumerate(final_plan[1])]

    # payload values: f/s at child indices, f/s at parent indices,
    # plus the final layer's (f[0], s[0])
    fs_handles = {}
    for ell in range(L):
        child_idx = sorted(set(child_buckets[ell]))
        parent_idx = sorted(set(parent_buckets[ell]))
        fs_handles[(ell, "cf")] = (child_idx,
                                   batch.add(st.layers[ell].f.dev, child_idx))
        fs_handles[(ell, "cs")] = (child_idx,
                                   batch.add(st.layers[ell].s.dev, child_idx))
        fs_handles[(ell, "pf")] = (parent_idx,
                                   batch.add(st.layers[ell + 1].f.dev,
                                             parent_idx))
        fs_handles[(ell, "ps")] = (parent_idx,
                                   batch.add(st.layers[ell + 1].s.dev,
                                             parent_idx))
    h_lastf = batch.add(st.layers[L].f.dev, [0])
    h_lasts = batch.add(st.layers[L].s.dev, [0])

    resolved = batch.run()

    # prime the layer views so payload assembly needs no further syncs
    for (ell, key), (idxs, h) in fs_handles.items():
        view = {"cf": st.layers[ell].f, "cs": st.layers[ell].s,
                "pf": st.layers[ell + 1].f,
                "ps": st.layers[ell + 1].s}[key]
        view.prime(dict(zip(idxs, resolved[h])))
    st.layers[L].f.prime({0: resolved[h_lastf][0]})
    st.layers[L].s.prime({0: resolved[h_lasts][0]})

    proofs = {}
    for ell, which, tree, plan, handles, idxs in plans:
        values = [resolved[h] for h in handles]
        proofs[(ell, which)] = (idxs, tree.open_from_plan(plan, values))
    final_proof = final_tree.open_from_plan(
        final_plan, [resolved[h] for h in final_handles])

    last = st.layers[L]
    out_refs = []
    for q in range(r):
        out_refs.append(FriQueryPayload(
            refs_per_query[q], [], 0, (last.f[0], last.s[0])))

    layer_batches = []
    for ell in range(L):
        child_idx, child_proof = proofs[(ell, "child")]
        parent_idx, parent_proof = proofs[(ell, "parent")]
        for q in range(r):
            ref = out_refs[q].per_layer_refs[ell]
            ref.child_pos = child_idx.index(ref.i)
            ref.parent_pos = parent_idx.index(ref.parent_index)
        layer_batches.append(LayerBatchProof(
            st.layers[ell].hashed_leaves, child_idx, child_proof,
            parent_idx, parent_proof))

    roots = [lay.root for lay in st.layers]
    return out_refs, roots, FriLayerBatches(layer_batches, final_proof)


# ---------------------------------------------------------------------------
# End-to-end prove (fri.rs:601-641).
# ---------------------------------------------------------------------------

def deep_fri_prove(builder, a, s, e, t, n0: int, params: DeepFriParams,
                   device=None) -> DeepFriProof:
    dev = resolve(device)
    phase_seconds.clear()
    domain0 = FriDomain.new_radix2(n0)
    with phase_timer("fri/build_f0", phase_seconds):
        f0 = builder.build_f0(a, s, e, t, n0, domain0, device=dev)

    with phase_timer("fri/fold+commit", phase_seconds):
        st = fri_build_transcript_dev(f0, domain0, params.schedule,
                                      params.seed_z)
    roots = [lay.root for lay in st.layers]
    roots_seed = fs_seed_from_roots(roots)
    with phase_timer("fri/queries", phase_seconds):
        refs_only, roots2, batches = fri_prove_queries_dev(st, params.r,
                                                           roots_seed)
    assert roots == roots2
    return DeepFriProof(roots, batches, query_payloads(st, refs_only), n0,
                        domain0.omega)


def query_payloads(st: FriProverState, refs_only) -> list:
    """The proof's queries: each query's refs with the opened f/s values of
    every layer, read from the primed layer views."""
    queries = []
    for qp in refs_only:
        payloads = []
        for ell, ref in enumerate(qp.per_layer_refs):
            payloads.append(LayerOpenPayload(
                st.layers[ell].f[ref.i],
                st.layers[ell].s[ref.i],
                st.layers[ell + 1].f[ref.parent_index],
                st.layers[ell + 1].s[ref.parent_index],
            ))
        queries.append(FriQueryPayload(qp.per_layer_refs, payloads,
                                       qp.final_index, qp.final_pair))
    return queries


# ---------------------------------------------------------------------------
# Verify (fri.rs:643-762) with batched hashing.
# ---------------------------------------------------------------------------

def deep_fri_verify(params: DeepFriParams, proof: DeepFriProof,
                    device=None) -> bool:
    """The verifier hashes a few dozen rows per level, which run in the
    host engine; `device` is where a batch above the host cutoff would go
    (None: the CUDA device, resolved only if such a batch occurs)."""
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
        cfg = MerkleChannelCfg.new(arity, tree_label=label)
        try:
            entries = [val_map[i] for i in indices]
        except KeyError:
            return False
        if hashed:
            leaves = fs.hash_leaf_pairs_ints(entries, device)
            return dmk.verify_many_ds(root, indices, leaves, proof_mp,
                                      cfg.tree_label, cfg.params, device)
        return dmk.verify_pairs_ds(root, indices, entries, proof_mp,
                                   cfg.tree_label, cfg.params, device)

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
    cfg_last = MerkleChannelCfg.new(ar_last, tree_label=L)
    fpair = proof.queries[0].final_pair
    if use_hashed_leaves(ar_last):
        leaf_h = fs.hash_leaf_pairs_ints([fpair], device)[0]
        return dmk.verify_many_ds(proof.roots[L], [0], [leaf_h],
                                  proof.layer_batches.final_proof,
                                  cfg_last.tree_label, cfg_last.params,
                                  device)
    return dmk.verify_pairs_ds(proof.roots[L], [0], [fpair],
                               proof.layer_batches.final_proof,
                               cfg_last.tree_label, cfg_last.params, device)
