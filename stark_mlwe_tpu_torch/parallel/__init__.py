"""Sharding of the proving pipeline over ranks of `torch.distributed`.

Counterpart of `parallel/__init__.py` of the JAX package: where JAX runs
one program over a device mesh (`shard_map`), the port runs one process
per rank, each holding its own rows, and issues the collectives itself.

  - the evaluation vector over H is split in contiguous equal blocks over
    the ranks (a 1-D `Mesh`); DEEP-ALI's phi merge and the f0 quotient are
    local elementwise work,
  - the barycentric Lagrange sum is a local modular reduction and an
    all-gather of the D partial sums, finished replicated,
  - Poseidon/Merkle leaf and subtree hashing is local (contiguous blocks
    never split an arity group); the small frontier is all-gathered and
    the top of the tree is finished replicated, so every rank derives the
    same root,
  - m-ary FRI folds are local (a block is a multiple of the fold m).

Hashing is position-based and blocks are contiguous, so results are
bit-identical at any number of ranks.  Every collective is issued at every
world size, one rank included, and counted in `Mesh.collectives`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..device import resolve
from ..distributed import initialize_distributed  # noqa: F401  (re-export)
from ..fri import deep_ali as dali
from ..fri import fs as ffs
from ..fri import s_layer_dev
from ..merkle import ds_rows_device
from ..ops import fr
from ..ops import ntt as dntt
from ..ops import poseidon as dpos
from ..spec.poseidon import params_for_arity

_COLLECTIVES = ("all_gather", "all_to_all", "all_reduce")


@dataclass
class Mesh:
    """One rank's view of a 1-D mesh: the process group, this rank, the
    number of ranks and the device this rank's rows live on.  The
    collectives go through the methods below, which count them."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "shard"
    collectives: dict = field(
        default_factory=lambda: dict.fromkeys(_COLLECTIVES, 0))

    def reset_collectives(self) -> None:
        self.collectives = dict.fromkeys(_COLLECTIVES, 0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x, concatenated along axis 0 in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        self.collectives["all_gather"] += 1
        return torch.cat(parts, dim=0)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [size, ...]: block d goes to rank d; returns [size, ...] whose
        block s came from rank s."""
        if int(x.shape[0]) != self.size:
            raise ValueError(f"all_to_all: {tuple(x.shape)} has no "
                             f"{self.size} blocks")
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        self.collectives["all_to_all"] += 1
        return out

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise integer sum of x over the ranks, in place."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        self.collectives["all_reduce"] += 1
        return x


def make_mesh(n_devices: int | None = None, axis: str = "shard",
              device=None) -> Mesh:
    """The mesh of every rank of the default process group (set up by
    `initialize_distributed`; raises if there is none).  `device=None` is
    this rank's card.  NCCL serves CUDA tensors and gloo CPU tensors; any
    other pairing raises."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call "
                           "initialize_distributed() first")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the group "
                         f"has {size} ranks")
    dev = resolve(device)
    backend = dist.get_backend()
    if (backend, dev.type) not in (("nccl", "cuda"), ("gloo", "cpu")):
        raise ValueError(f"make_mesh: backend {backend} does not serve "
                         f"{dev.type} tensors")
    return Mesh(dist.group.WORLD, dist.get_rank(), size, dev, axis)


def _tree_level_plan(n: int, arity: int, n_shards: int):
    """Static plan: local level sizes while divisible, then replicated tail.

    Returns (local_sizes, tail_sizes): local_sizes[i] is the per-shard node
    count hashed locally at level i; tail runs replicated after the gather.
    """
    local = n // n_shards
    local_sizes = []
    level_local = local
    while level_local % arity == 0 and level_local // arity >= 1:
        level_local //= arity
        local_sizes.append(level_local)
    tail_sizes = []
    g = level_local * n_shards
    while g > 1:
        g = -(-g // arity)
        tail_sizes.append(g)
    return local_sizes, tail_sizes


def _ds_tables(mesh: Mesh, arity: int, tree_label: int, local_sizes,
               tail_sizes):
    """(ds_locals, ds_tails) on the mesh's device: this rank's rows of each
    local level at their GLOBAL parent positions, and the tail levels
    whole."""
    ds_locals = [ds_rows_device(arity, level, g, tree_label, mesh.device,
                                start=mesh.rank * g)
                 for level, g in enumerate(local_sizes)]
    first = len(local_sizes)
    ds_tails = [ds_rows_device(arity, first + i, g, tree_label, mesh.device)
                for i, g in enumerate(tail_sizes)]
    return ds_locals, ds_tails


def _hash_tail(cur, ds_tails, arity: int, dp) -> list:
    """The replicated top of a tree from the gathered frontier `cur`: one
    level per DS table, a ragged last group hashed apart."""
    levels = []
    for ds in ds_tails:
        g = int(cur.shape[0])
        full = g // arity
        outs = []
        if full:
            outs.append(dpos.sponge_hash_ds_dynamic(
                ds[:full], cur[:full * arity].reshape(full, arity, fr.N), dp))
        if g % arity:
            outs.append(dpos.sponge_hash_ds_dynamic(
                ds[full:], cur[full * arity:].reshape(1, g - full * arity,
                                                      fr.N), dp))
        cur = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        levels.append(cur)
    return levels


def build_sharded_prove_step(mesh: Mesh, n: int, m: int, arity: int,
                             tree_label: int = 0):
    """One rank's step over `mesh`: DEEP-ALI merge + hashed-leaf commit of
    (f0, s0) + m-ary fold, with the collectives described above.

    Returns (step_fn, ds_locals, ds_tail) where step_fn(a, s, e, t, w, z_m,
    scale_m, zpow, *ds_locals) -> (root [8], phi_z [8], f1 local rows), all
    Montgomery: a..w are this rank's rows [n/D, 8], z_m and scale_m one
    element, zpow the m powers of the fold challenge [m, 8].  The DS
    tables are this rank's rows, so positions stay global.
    """
    D = mesh.size
    if n % D or (n // D) % m or (n // D) % arity:
        raise ValueError(f"build_sharded_prove_step: n={n} does not split "
                         f"over {D} ranks in multiples of m={m} and "
                         f"arity={arity}")
    dp = dpos.device_params(params_for_arity(arity))
    local_sizes, tail_sizes = _tree_level_plan(n, arity, D)
    ds_locals, ds_tail = _ds_tables(mesh, arity, tree_label, local_sizes,
                                    tail_sizes)

    def step(a, s, e, t, w, z_m, scale_m, zpow, *ds_loc):
        # --- DEEP-ALI merge (local elementwise + gathered Lagrange sum) ---
        f0 = fr.f0_quotient(dali.phi_kernel(a, s, e, t), w, z_m)
        # phi*w/(z-w) = -(f0*w): the terms of the barycentric sum
        part = fr.reduce_add(fr.mont_mul(f0, w))
        parts = mesh.all_gather(part.reshape(1, fr.N))
        phi_z = fr.mont_mul(scale_m, fr.neg(fr.reduce_add(parts)))

        # --- fold + s-layer (local: a block is a multiple of m) ----------
        f1 = fr.fold(f0, zpow)
        s0 = s_layer_dev(f0, f1, m)

        # --- hashed-leaf commit (fri.rs:38-44 + merkle levels) ------------
        cur = ffs.hash_leaf_pairs_dev(f0, s0)
        for ds in ds_loc:
            cur = dpos.sponge_hash_ds_dynamic(
                ds, cur.reshape(-1, arity, fr.N), dp)
        cur = mesh.all_gather(cur)
        tail = _hash_tail(cur, ds_tail, arity, dp)
        root = (tail[-1] if tail else cur)[0]
        return root, phi_z, f1

    return step, ds_locals, ds_tail


# ---------------------------------------------------------------------------
# Four-step NTT over the ranks: column transforms -> twiddle -> all-to-all
# transposes -> row transforms.  Bit-exact with ops.ntt.ntt at any count.
# ---------------------------------------------------------------------------

def build_ntt_sharded(mesh: Mesh, n1: int, n2: int):
    """One rank's NTT of size n = n1*n2 over `mesh`.

    Returns (step_fn, tw_local): step_fn(x, tw_local) takes this rank's
    block of the input [n/D, 8] Montgomery, in index order i = i1*n2 + i2,
    and returns its block of the output in index order k = j1 + n1*j2
    (both split contiguously).  tw_local is this rank's rows i2 of the
    twiddle table omega^(i2*j1) ([n2/D, n1, 8]).  Needs n1 % D == 0 and
    n2 % D == 0.  Each transform is a batched `ops.ntt.ntt` (K6 on the
    card); the three transposes are all-to-alls.
    """
    D, r = mesh.size, mesh.rank
    if n1 % D or n2 % D:
        raise ValueError(f"build_ntt_sharded: {n1} x {n2} does not split "
                         f"over {D} ranks")
    a, b = n1 // D, n2 // D
    tw_local = dntt.step_twiddles(n1 * n2, n1, n2, False, False,
                                  mesh.device)[r * b:(r + 1) * b]

    def step(x, tw):
        # local rows [i1 local, i2 full]; block d holds rank d's i2 columns
        blk = x.reshape(a, D, b, fr.N).transpose(0, 1)
        cols_i1 = mesh.all_to_all(blk).reshape(n1, b, fr.N)   # [i1, i2 loc]
        cols = dntt.ntt(cols_i1.transpose(0, 1))     # size-n1 -> j1
        cols = fr.mont_mul(cols, tw)                 # omega^(i2*j1)
        # to j1 blocks: block d holds rank d's j1 rows
        blk = cols.transpose(0, 1).reshape(D, a, b, fr.N)
        rows_j1 = mesh.all_to_all(blk).transpose(0, 1).reshape(a, n2, fr.N)
        rows = dntt.ntt(rows_j1)                     # size-n2 -> j2
        # to contiguous k = j1 + n1*j2: block d holds rank d's j2 columns
        blk = rows.reshape(a, D, b, fr.N).transpose(0, 1)
        out = mesh.all_to_all(blk).reshape(n1, b, fr.N)       # [j1, j2 loc]
        return out.transpose(0, 1).reshape(b * n1, fr.N)

    return step, tw_local
