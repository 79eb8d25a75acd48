"""Fully sharded `deep_fri_prove` over the ranks of a `Mesh`.

Counterpart of `parallel/prover.py` of the JAX package: the prove path of
fri.rs:601-641, one process per rank, each holding a contiguous block of
every layer:

  - DEEP-ALI merge (fri.rs:536-569): each rank builds its omega-power
    window as omega^(rank*local) times a local power table, then f0 =
    (a*s + e - t) / (w - z) locally (one `fr.f0_quotient`) - no collective,
  - every FRI layer (fri.rs:231-312): m-ary folds and s-layers are local,
    commits hash each rank's subtrees locally, all-gather the frontier
    and finish the top of the tree replicated,
  - layers too small to split (the deep tail of the schedule) are
    all-gathered once and stay replicated, on the single-device code,
  - Fiat-Shamir (the witness absorb, z_ell, the roots seed, the query
    indices) runs replicated on every rank's host,
  - the query openings: each rank reads the opened rows it owns (of a
    replicated array, rank 0 reads them all), leaves zeros in the others,
    and ONE all-reduce sum of the int32 limbs assembles them on every rank
    (exact: each row has one contributor), then one readback.  No rank
    holds a whole layer or tree.

Every rank returns the same proof, byte-identical to the single-device
prover's at any number of ranks.
"""

from __future__ import annotations

import torch

from .. import merkle as dmk
from ..fri import (GatherBatch, HostFieldView, _roots_readback,
                   commit_layer_device, fold_layer_dev,
                   fri_prove_queries_dev, fs as ffs, query_payloads,
                   s_layer_dev)
from ..fri import deep_ali as dali
from ..merkle import ds_rows_device
from ..ops import fr
from ..ops import poseidon as dpos
from ..spec.field import P, get_root_of_unity
from ..spec.fri import (DeepFriParams, DeepFriProof, FriDomain,
                        FriLayerCommitment, FriProverState, MerkleChannelCfg,
                        ali_sample_z_beta_fs, fri_sample_z_ell,
                        fs_seed_from_roots, layer_sizes_from_schedule,
                        pick_arity_for_layer, use_hashed_leaves)
from ..spec.merkle import LEAF_LEVEL_DS
from ..utils import phase_timer
from . import Mesh, _ds_tables, _hash_tail, _tree_level_plan, make_mesh

# Wall seconds of the last sharded prove's phases on this rank, by name.
phase_seconds: dict = {}


class RowShard:
    """This rank's rows [start, start + len(local)) of an array split in
    contiguous equal blocks over the ranks; `shape` is the whole array's,
    so tree planning sees global sizes."""

    def __init__(self, local: torch.Tensor, start: int, n: int):
        self.local = local
        self.start = start
        self.shape = (n,) + tuple(local.shape[1:])


class ShardedFieldView(HostFieldView):
    """A layer's field values split over the ranks: only rows primed from
    the sharded gather (by global index) can be read."""

    def __getitem__(self, i):
        if i not in self._sparse:
            raise KeyError(f"row {i} of a sharded layer was not gathered")
        return self._sparse[i]

    def __iter__(self):
        raise TypeError("a sharded layer is never read whole")


class ShardedGatherBatch(GatherBatch):
    """`GatherBatch` over the ranks: each rank fills the queued rows it
    owns (a `RowShard`'s rows in its block; a replicated tensor's on rank 0
    alone) and leaves zeros elsewhere; one all-reduce sum then gives every
    rank every row."""

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh

    def _rows(self):
        blocks = []
        for arr, idxs in self._items:
            if not idxs:
                continue
            block = torch.zeros((len(idxs), fr.N), dtype=torch.int32,
                                device=self.mesh.device)
            if isinstance(arr, RowShard):
                lo, src = arr.start, arr.local
                hi = lo + int(src.shape[0])
                pos = [j for j, i in enumerate(idxs) if lo <= i < hi]
            else:
                lo, src = 0, arr
                pos = list(range(len(idxs))) if self.mesh.rank == 0 else []
            if pos:
                rows = torch.tensor([idxs[j] - lo for j in pos],
                                    dtype=torch.int64, device=src.device)
                block[torch.tensor(pos, dtype=torch.int64,
                                   device=block.device)] = \
                    src.index_select(0, rows)
            blocks.append(block)
        if not blocks:
            return None
        return self.mesh.all_reduce_sum(torch.cat(blocks, dim=0))


# ---------------------------------------------------------------------------
# Sharded DEEP-ALI merge (fri.rs:536-569 compute part).
# ---------------------------------------------------------------------------

def merge_f0_sharded(mesh: Mesh, a, s, e, t, omega: int, z: int):
    """f0 = (a*s + e - t) / (w - z) on this rank's rows [n/D, 8]; its
    omega window starts at omega^(rank * n/D)."""
    local = int(a.shape[0])
    dev = a.device
    base = fr.to_device(fr.pack_int(pow(omega, mesh.rank * local, P),
                                    mont=True), dev)
    w_loc = fr.mont_mul(base, dali.omega_powers(omega, local, dev))
    return dali.f0_from_phi(dali.phi_kernel(a, s, e, t), w_loc, z)


# ---------------------------------------------------------------------------
# Sharded layer step: fold + s-layer + commit.
# ---------------------------------------------------------------------------

def _build_layer_step(mesh: Mesh, n: int, m: int, arity: int, hashed: bool):
    """This rank's step of one layer: f_ell (its rows) -> (f_next, s_ell,
    local tree levels, gathered frontier, tail levels).  m == 1 is the
    final layer: no fold, s is zeros (fri.rs:264-268).  The DS tables are
    arguments, so one step serves every tree_label."""
    local_sizes, tail_sizes = _tree_level_plan(n, arity, mesh.size)
    dp = dpos.device_params(MerkleChannelCfg.new(arity).params)

    def step(f, z, ds_leaf, ds_locals, ds_tails):
        if m > 1:
            f_next = fold_layer_dev(f, z, m)
            s = s_layer_dev(f, f_next, m)
        else:
            f_next, s = None, torch.zeros_like(f)
        if hashed:
            leaves = ffs.hash_leaf_pairs_dev(f, s)
        else:
            leaves = dpos.sponge_hash_ds_dynamic(
                ds_leaf, torch.stack([f, s], dim=1), dp)
        levels = [leaves]
        for ds in ds_locals:
            levels.append(dpos.sponge_hash_ds_dynamic(
                ds, levels[-1].reshape(-1, arity, fr.N), dp))
        frontier = mesh.all_gather(levels[-1])
        return f_next, s, levels, frontier, _hash_tail(frontier, ds_tails,
                                                      arity, dp)

    return step, local_sizes, tail_sizes


def _layer_ds_tables(mesh: Mesh, n: int, arity: int, tree_label: int,
                     local_sizes, tail_sizes, hashed: bool):
    """(ds_leaf, ds_locals, ds_tails) of one layer's tree on the mesh's
    device, at GLOBAL positions: this rank's pair-leaf rows (None for
    hashed leaves) and local levels, the tail levels whole."""
    local = n // mesh.size
    ds_leaf = None if hashed else ds_rows_device(
        arity, LEAF_LEVEL_DS, local, tree_label, mesh.device,
        start=mesh.rank * local)
    return (ds_leaf,) + _ds_tables(mesh, arity, tree_label, local_sizes,
                                   tail_sizes)


def commit_and_fold_sharded(mesh: Mesh, ell: int, n: int, m: int, f_dev,
                            z: int | None):
    """One FRI layer over the ranks: f_dev is this rank's rows.  Returns
    (commitment, this rank's rows of f_next, or None for the final
    layer)."""
    arity = pick_arity_for_layer(n, m)
    hashed = use_hashed_leaves(arity)
    cfg = MerkleChannelCfg.new(arity, tree_label=ell)
    step, local_sizes, tail_sizes = _build_layer_step(mesh, n, m, arity,
                                                      hashed)
    f_next, s_dev, levels, frontier, tails = step(
        f_dev, z, *_layer_ds_tables(mesh, n, arity, ell, local_sizes,
                                    tail_sizes, hashed))
    D, r = mesh.size, mesh.rank

    def shard(x):
        rows = int(x.shape[0])
        return RowShard(x, r * rows, rows * D)

    # the last local level is kept whole, as the gathered frontier
    tree = dmk.DeviceMerkleTree(
        [shard(lv) for lv in levels[:-1]] + [frontier] + tails, arity,
        cfg=cfg)
    com = FriLayerCommitment(n, m, None, ShardedFieldView(shard(f_dev)),
                             ShardedFieldView(shard(s_dev)), hashed, tree,
                             cfg)
    return com, f_next


def _can_shard(n: int, m: int, D: int) -> bool:
    # n > 1: a one-element layer's tree has arity 1, which the level plan
    # cannot split (it would divide by 1 forever); it stays replicated
    return n > 1 and n % D == 0 and (n // D) % max(m, 1) == 0


# ---------------------------------------------------------------------------
# Full transcript build + prove (fri.rs:231-312, 601-641) over the ranks.
# ---------------------------------------------------------------------------

def fri_build_transcript_sharded(mesh: Mesh, f0_dev, domain0: FriDomain,
                                 schedule, seed_z: int) -> FriProverState:
    """fri.rs:231-312: f0_dev is this rank's rows of f0."""
    L = len(schedule)
    sizes = layer_sizes_from_schedule(domain0.size, schedule)
    z_layers = [fri_sample_z_ell(seed_z, ell, sizes[ell])
                for ell in range(L)]
    omega_layers = [get_root_of_unity(sizes[ell]) for ell in range(L)]

    layers = []
    cur = f0_dev
    sharded = True
    for ell in range(L + 1):
        n = sizes[ell]
        m = schedule[ell] if ell < L else 1
        if sharded and not _can_shard(n, m, mesh.size):
            # deep tail: gather once, stay replicated (tiny layers)
            cur = mesh.all_gather(cur)
            sharded = False
        if sharded:
            com, f_next = commit_and_fold_sharded(
                mesh, ell, n, m, cur, z_layers[ell] if ell < L else None)
        else:
            if ell < L:
                f_next = fold_layer_dev(cur, z_layers[ell], m)
                s_dev = s_layer_dev(cur, f_next, m)
            else:
                f_next, s_dev = None, torch.zeros_like(cur)
            com = commit_layer_device(ell, n, m, cur, s_dev,
                                      defer_root=True)
        layers.append(com)
        if f_next is not None:
            cur = f_next

    _roots_readback(layers)
    return FriProverState([lay.f for lay in layers],
                          [lay.s for lay in layers],
                          list(schedule), layers, omega_layers, z_layers)


def sharded_deep_fri_prove(mesh: Mesh, a_np, s_np, e_np, t_np, n0: int,
                           params: DeepFriParams,
                           ds_tag: bytes = b"ALI/DEEP") -> DeepFriProof:
    """Full `deep_fri_prove` (fri.rs:601-641) with every O(n) stage split
    over the ranks of `mesh`.  The witness columns are host arrays of
    Montgomery limbs ([n, 8] int32, `MlweWitness.to_host_limbs`); every
    rank hashes them whole in the host engine, as the single-device
    prover's host branch does, and uploads only its own rows.  The proof
    is byte-identical to `fri.deep_fri_prove`'s."""
    phase_seconds.clear()
    D, r = mesh.size, mesh.rank
    if n0 % D:
        raise ValueError(f"sharded_deep_fri_prove: n0={n0} does not split "
                         f"over {D} ranks")
    domain0 = FriDomain.new_radix2(n0)
    cols = [a_np, s_np, e_np, t_np]

    # --- (z, beta) FS derivation: identical to the single-device builder
    with phase_timer("parallel/host_absorb", phase_seconds):
        ha, hs, he, ht = ffs.tagged_hash_cols_native(
            [b"ALI/A", b"ALI/S", b"ALI/E", b"ALI/T"],
            [fr.to_u64(c) for c in cols])
    seed_f = ffs.one_block_tagged_hash_batch(
        b"ALI/seed", [[ha, hs, he, ht, n0 % P]])[0]
    z, _beta = ali_sample_z_beta_fs(ds_tag, n0, seed_f)

    # --- this rank's rows + merge --------------------------------------
    local = n0 // D
    with phase_timer("parallel/merge", phase_seconds):
        mine = [fr.upload(c[r * local:(r + 1) * local], mesh.device)
                for c in cols]
        f0 = merge_f0_sharded(mesh, *mine, domain0.omega, z)

    # --- layers + commits ----------------------------------------------
    with phase_timer("parallel/fold+commit", phase_seconds):
        st = fri_build_transcript_sharded(mesh, f0, domain0,
                                          params.schedule, params.seed_z)
    roots = [lay.root for lay in st.layers]
    with phase_timer("parallel/queries", phase_seconds):
        refs_only, roots2, batches = fri_prove_queries_dev(
            st, params.r, fs_seed_from_roots(roots),
            batch=ShardedGatherBatch(mesh))
    assert roots == roots2
    return DeepFriProof(roots, batches, query_payloads(st, refs_only), n0,
                        domain0.omega)


def prove_sharded(witness, params: DeepFriParams,
                  mesh: Mesh | None = None) -> DeepFriProof:
    """`stark.prove` over the ranks of `mesh` (default: `make_mesh()`,
    which needs a process group)."""
    if mesh is None:
        mesh = make_mesh()
    a, s, e, t = witness.to_host_limbs()
    return sharded_deep_fri_prove(mesh, a, s, e, t, len(witness.a), params)
