"""Batched Poseidon permutation and sponges on the card.

Counterpart of `ops/poseidon.py` of the JAX package, bit-exact against the
golden spec in `spec.poseidon`.  State batches are `[B, t, 8]` Montgomery
limb tensors.

`permute` launches K1 (csrc/poseidon_permute.cu) at widths t = 17 and t = 9,
in the layout `permute_layout` picks by the batch size: one warp per state
(`poseidon_permute_warp`) up to `WARP_MAX_B[t]` states, one thread per state
(`poseidon_permute`) above; and K5 `poseidon_permute_group`
(csrc/poseidon_permute_group.cu; S states a block with their lanes packed,
K threads a dense row, C blocks a state, in the layout `group_layout` picks
by the batch size) at t = 33, 65 and 129.  Together they replace the Pallas
kernels `_permute_tiles` (ops/poseidon_pallas.py of the JAX package) and
`_permute_tiles_wide` (ops/poseidon_wide.py).  On a CPU tensor `permute`
takes `permute_plain`: the same rounds as dense PyTorch tensor code (ARK,
x^5, one fused constant-matrix apply per round), which runs on any device
and is what the kernels are held against.

`absorb_chain` launches K4 `poseidon_absorb_chain`
(csrc/poseidon_absorb_chain.cu; one warp per chain, the state in registers,
32-bit carry-chain field products): C sponge chains of nb sequential (add
rate block, permute) steps in one launch, in place of the Pallas kernels
`absorb_chain` (ops/poseidon_pallas.py) and `absorb_chain_lanes`
(ops/poseidon_chain.py).  Its plain version is `absorb_chain_plain`.

Sponges lay out their absorb schedule statically (block boundaries, the
10* pad marker), so each batched hash is a fixed sequence of block-add +
permute steps.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, native
from ..spec.poseidon import PoseidonParams
from . import fr

SUPPORTED_WIDTHS = (9, 17, 33, 65, 129)
K1_WIDTHS = (9, 17)                   # K1; the wider ones go to K5
GROUP_WIDTHS = (33, 65, 129)          # K5
CHAIN_WIDTHS = (9, 17)                # K4
K1_LAYOUTS = ("warp", "thread")

# The largest batch K1 runs with a warp per state; above it the thread layout
# is faster.  From `chip_smoke.py`'s sweep of both layouts on an H100 (PERF.md,
# K1 rows): the warp layout wins at 4,096 states of t=17 and loses at 8,192,
# wins at 2,048 of t=9 and loses at 4,096.
WARP_MAX_B = {17: 4096, 9: 2048}

# K5's layouts (S states a block, K threads a dense row, C blocks a cluster
# for one state), as built (`PG_LAYOUTS` in csrc/poseidon_group.cuh): for
# small batches one state a block with its rows split (t = 33) or one state
# over a cluster of four SMs (t = 65, 129; at t = 33 the dense products are
# too short to pay for it), S states a block for large ones.  The K of each
# was the fastest of 2, 4 and 8 tried on an H100 (PERF.md).
GROUP_LAYOUTS = {33: ((1, 4, 1), (16, 1, 1)),
                 65: ((1, 8, 4), (8, 1, 1)),
                 129: ((1, 8, 4), (4, 1, 1))}
# The first layout below PACK_MIN_B[t] states, the packing one from there on;
# from `chip_smoke.py`'s sweep of both (`k5_sweep`).
PACK_MIN_B = {33: 1024, 65: 128, 129: 128}


class DeviceParams:
    """Poseidon constants of one width, with per-device tensor caches.

    The kernel's constants are the host engine's packs (`native.pack_params`:
    dense matrices and sparse rows scaled by 2^320, the rest plain
    Montgomery); the plain version keeps the round constants as limb
    tensors and the MDS matrix as a `fr.PlainMatrix`."""

    def __init__(self, params: PoseidonParams):
        if params.t not in SUPPORTED_WIDTHS:
            raise NotImplementedError(
                f"Poseidon width t={params.t}: the port has t in "
                f"{SUPPORTED_WIDTHS}")
        self.spec_params = params
        self.t = params.t
        self.rate = params.rate
        self.rf = params.rf
        self.rp = params.rp
        self._kernel: dict = {}
        self._group: dict = {}
        self._plain: dict = {}

    def kernel_consts(self, device):
        """(mds, rc_full, rc_part, qrow, qcol, mfinal) int32 tensors."""
        key = str(device)
        if key not in self._kernel:
            self._kernel[key] = tuple(
                fr.to_device(fr.from_u64(a.reshape(-1, 4)), device)
                for a in native.pack_params(self.spec_params))
        return self._kernel[key]

    def group_consts(self, device):
        """The constants of K5, K4 and K1's warp layout (a thread or a lane
        per row): those of `kernel_consts` with the two dense matrices
        transposed, so that the threads of a warp, one per row, read
        neighbouring elements and a tile of matrix rows j.. is contiguous."""
        key = str(device)
        if key not in self._group:
            mds, rcf, rcp, qrow, qcol, mfin = self.kernel_consts(device)
            t = self.t

            def transposed(m):
                return m.reshape(t, t, fr.N).transpose(0, 1).contiguous()

            self._group[key] = (transposed(mds), rcf, rcp, qrow, qcol,
                                transposed(mfin))
        return self._group[key]

    def plain_consts(self, device):
        """(rc schedule [R, t, 8], full-round flags, PlainMatrix)."""
        key = str(device)
        if key not in self._plain:
            p = self.spec_params
            half, R = p.rf // 2, p.rf + p.rp
            rc_full = fr.pack_ints([c for row in p.rc_full for c in row],
                                   mont=True).reshape(p.rf, p.t, fr.N)
            rc = np.zeros((R, p.t, fr.N), dtype=np.int32)
            rc[:half] = rc_full[:half]
            rc[half:half + p.rp, 0, :] = fr.pack_ints(p.rc_partial, mont=True)
            rc[half + p.rp:] = rc_full[half:]
            full = [r < half or r >= half + p.rp for r in range(R)]
            self._plain[key] = (fr.to_device(rc, device), full,
                                fr.PlainMatrix(p.mds, device))
        return self._plain[key]


_CACHE: dict = {}


def device_params(params: PoseidonParams) -> DeviceParams:
    """Memoized packing, keyed by object (the entry's `spec_params` keeps
    the object alive, so its id stays its own)."""
    key = id(params)
    if key not in _CACHE:
        _CACHE[key] = DeviceParams(params)
    return _CACHE[key]


def permute_plain(state: torch.Tensor, dp: DeviceParams) -> torch.Tensor:
    """RF/2 full rounds, RP partial rounds (S-box on element 0 only), RF/2
    full rounds; ARK -> S-box -> MDS, dense matrix every round."""
    rc, full, mds = dp.plain_consts(state.device)
    for r, is_full in enumerate(full):
        if is_full:
            x = fr.pow5_plain(fr.add_plain(state, rc[r]))
        else:
            x0 = fr.pow5_plain(fr.add_plain(state[..., :1, :], rc[r, :1]))
            x = torch.cat([x0, state[..., 1:, :]], dim=-2)
        state = fr.mat_apply_plain(mds, x)
    return state


def _check_states(state: torch.Tensor, dp: DeviceParams, what: str) -> None:
    if state.dtype != torch.int32 or state.dim() != 3 \
            or state.shape[1:] != (dp.t, fr.N):
        raise TypeError(f"{what}: expected [B, {dp.t}, 8] int32, "
                        f"got {tuple(state.shape)} {state.dtype}")


def permute_layout(B: int, t: int) -> str:
    """K1's layout for a batch of B states of width t: "warp" (a warp per
    state) up to `WARP_MAX_B[t]`, "thread" (a thread per state) above."""
    return "warp" if B <= WARP_MAX_B[t] else "thread"


def group_layout(B: int, t: int) -> tuple:
    """K5's layout (S, K, C) for a batch of B states of width t: the width's
    small-batch layout (rows split, or a cluster per state) below
    `PACK_MIN_B[t]`, S states a block from there on."""
    return GROUP_LAYOUTS[t][B >= PACK_MIN_B[t]]


def permute(state: torch.Tensor, dp: DeviceParams) -> torch.Tensor:
    """Batched permutation: state [B, t, 8] Montgomery -> same shape."""
    _check_states(state, dp, "poseidon permute")
    if not state.is_cuda:
        return permute_plain(state, dp)
    if dp.t not in K1_WIDTHS:
        return permute_group(state, dp)
    return permute_k1(state, dp, permute_layout(int(state.shape[0]), dp.t))


def k1_counter(t: int, layout: str) -> str:
    """The launch counter of K1 at width t in a layout."""
    return (f"poseidon_permute_warp_t{t}" if layout == "warp"
            else f"poseidon_permute_t{t}")


def permute_k1(state: torch.Tensor, dp: DeviceParams,
               layout: str) -> torch.Tensor:
    """The permutation through K1 in the given layout: "warp" launches
    `poseidon_permute_warp`, "thread" launches `poseidon_permute` (counters:
    `k1_counter`).  `permute` picks the layout by `permute_layout`."""
    _check_states(state, dp, "poseidon permute_k1")
    if layout not in K1_LAYOUTS:
        raise ValueError(f"poseidon permute_k1: layout {layout!r} is not "
                         f"one of {K1_LAYOUTS}")
    if not state.is_cuda:
        return permute_plain(state, dp)
    if dp.t not in K1_WIDTHS:
        raise NotImplementedError(
            f"poseidon permute_k1: the kernel has t in {K1_WIDTHS}, "
            f"not t={dp.t}")
    state = state.contiguous()
    out = torch.empty_like(state)
    B = int(state.shape[0])
    if B == 0:
        return out
    warp = layout == "warp"
    consts = (dp.group_consts if warp else dp.kernel_consts)(state.device)
    lib = kernels.lib("poseidon_permute")
    entry = lib.poseidon_permute_warp if warp else lib.poseidon_permute
    rc = entry(state.data_ptr(), out.data_ptr(), B, dp.t, dp.rf, dp.rp,
               *[c.data_ptr() for c in consts], kernels.stream_ptr())
    name = k1_counter(dp.t, layout)
    kernels.check(rc, name)
    kernels.launches[name] += 1
    return out


def permute_group(state: torch.Tensor, dp: DeviceParams,
                  layout: tuple | None = None) -> torch.Tensor:
    """The permutation through K5 `poseidon_permute_group` in the layout
    (S, K, C) given, or by default the one `group_layout` picks.  `permute`
    sends the wide widths here."""
    _check_states(state, dp, "poseidon permute_group")
    B = int(state.shape[0])
    if dp.t in GROUP_WIDTHS:
        layout = group_layout(B, dp.t) if layout is None else tuple(layout)
    if layout not in GROUP_LAYOUTS.get(dp.t, ()):
        raise ValueError(f"poseidon permute_group: layout {layout} at t="
                         f"{dp.t} is not one of {GROUP_LAYOUTS}")
    if not state.is_cuda:
        return permute_plain(state, dp)
    state = state.contiguous()
    out = torch.empty_like(state)
    if B == 0:
        return out
    consts = dp.group_consts(state.device)
    lib = kernels.lib("poseidon_permute_group")
    rc = lib.poseidon_permute_group(
        state.data_ptr(), out.data_ptr(), B, dp.t, *layout, dp.rf, dp.rp,
        *[c.data_ptr() for c in consts], kernels.stream_ptr())
    kernels.check(rc, f"poseidon_permute_group t={dp.t} layout={layout}")
    kernels.launches[f"poseidon_permute_group_t{dp.t}"] += 1
    return out


def absorb_chain_plain(state, cols, off: int, nb: int, dp: DeviceParams):
    """Plain version of `absorb_chain`: nb times (add a rate block into the
    rate elements, `permute_plain`)."""
    rate = dp.rate
    for b in range(nb):
        blk = cols[:, off + b * rate:off + (b + 1) * rate, :]
        head = fr.add_plain(state[:, :rate, :], blk)
        state = permute_plain(torch.cat([head, state[:, rate:, :]], dim=1),
                              dp)
    return state


def absorb_chain(state: torch.Tensor, cols: torch.Tensor, off: int, nb: int,
                 dp: DeviceParams) -> torch.Tensor:
    """C independent sponge chains.  state: [C, t, 8]; cols: [C, n, 8]
    (both Montgomery).  Chain c absorbs rows off .. off + nb*rate - 1 of
    column c as nb rate blocks, one permutation after each; returns the
    states [C, t, 8].  The blocks are read from `cols` where they lie."""
    _check_states(state, dp, "poseidon absorb_chain")
    C, n = int(cols.shape[0]), int(cols.shape[1])
    if cols.dtype != torch.int32 or cols.dim() != 3 \
            or cols.shape[2] != fr.N or C != int(state.shape[0]):
        raise TypeError(f"poseidon absorb_chain: expected columns "
                        f"[{int(state.shape[0])}, n, 8] int32, got "
                        f"{tuple(cols.shape)} {cols.dtype}")
    if off < 0 or nb < 0 or off + nb * dp.rate > n:
        raise ValueError(f"poseidon absorb_chain: rows {off}..+{nb}*"
                         f"{dp.rate} exceed the {n} rows of the columns")
    if state.device != cols.device:
        raise ValueError(f"poseidon absorb_chain: state on {state.device}, "
                         f"columns on {cols.device}")
    if not state.is_cuda:
        return absorb_chain_plain(state, cols, off, nb, dp)
    if dp.t not in CHAIN_WIDTHS:
        raise NotImplementedError(
            f"poseidon absorb_chain: the chain kernel has t in "
            f"{CHAIN_WIDTHS}, not t={dp.t}")
    state = state.contiguous()
    if nb == 0 or C == 0:
        return state.clone()
    cols = cols.contiguous()
    out = torch.empty_like(state)
    consts = dp.group_consts(state.device)
    lib = kernels.lib("poseidon_absorb_chain")
    rc = lib.poseidon_absorb_chain(
        state.data_ptr(), cols.data_ptr(), out.data_ptr(), C, n, off, nb,
        dp.t, dp.rf, dp.rp, *[c.data_ptr() for c in consts],
        kernels.stream_ptr())
    kernels.check(rc, f"poseidon_absorb_chain t={dp.t}")
    kernels.launches["poseidon_absorb_chain"] += 1
    return out


def absorb_blocks(state, blocks, dp: DeviceParams):
    """Absorb rate-aligned blocks: blocks [nb, B, rate, 8].  Each step adds
    one block into the rate lanes and permutes."""
    for blk in blocks:
        head = fr.add(state[:, :dp.rate, :], blk)
        state = permute(torch.cat([head, state[:, dp.rate:, :]], dim=1), dp)
    return state


def sponge_hash_ds_dynamic(ds_fields, inputs, dp: DeviceParams):
    """Batched `hash_with_ds_dynamic` (poseidon/src/lib.rs:288-312 of the
    Rust reference).

    ds_fields: [B, d, 8]; inputs: [B, k, 8] (Montgomery).  The DS preamble,
    the inputs, the 10* pad marker (Montgomery one) and zero padding are
    laid out into rate-sized blocks; one permutation per block.  The first
    block is written into the zero state, later blocks are added."""
    B = max(int(ds_fields.shape[0]), int(inputs.shape[0]))
    d, k = int(ds_fields.shape[-2]), int(inputs.shape[-2])
    rate, t = dp.rate, dp.t
    total = d + k + 1
    nblocks = -(-total // rate)
    dev = inputs.device
    seq = torch.zeros((B, nblocks * rate + 1, fr.N), dtype=torch.int32,
                      device=dev)
    seq[:, :d] = ds_fields
    seq[:, d:d + k] = inputs
    seq[:, d + k] = fr.mont_one(dev)
    # columns [0, rate] of seq are the first block plus a zero capacity lane
    # when nblocks == 1; otherwise the capacity lane is cleared below
    state = seq[:, :t].clone()
    state[:, rate:] = 0
    state = permute(state, dp)
    if nblocks > 1:
        blocks = seq[:, rate:nblocks * rate].reshape(
            B, nblocks - 1, rate, fr.N).permute(1, 0, 2, 3)
        state = absorb_blocks(state, blocks, dp)
    return state[:, 0, :].contiguous()


def sponge_hash_ds_legacy(inputs, ds_tag_mont, dp: DeviceParams):
    """Batched legacy `hash_with_ds` (poseidon/src/lib.rs:85-100 of the
    Rust reference).

    The DS tag sits in the capacity element; the inputs [B, k, 8] are
    absorbed in raw rate chunks with NO padding; digest = state[0].
    ds_tag_mont: [8] Montgomery limbs of the tag."""
    B, k = int(inputs.shape[0]), int(inputs.shape[1])
    rate, t = dp.rate, dp.t
    state = torch.zeros((B, t, fr.N), dtype=torch.int32,
                        device=inputs.device)
    state[:, t - 1] = ds_tag_mont
    nb_full, rem = k // rate, k % rate
    if nb_full:
        blocks = inputs[:, :nb_full * rate].reshape(
            B, nb_full, rate, fr.N).permute(1, 0, 2, 3)
        state = absorb_blocks(state, blocks, dp)
    if rem:
        head = fr.add(state[:, :rem, :], inputs[:, nb_full * rate:, :])
        state = permute(torch.cat([head, state[:, rem:, :]], dim=1), dp)
    return state[:, 0, :].contiguous()
