"""Batched Poseidon permutation and sponges on the card.

Counterpart of `ops/poseidon.py` of the JAX package, bit-exact against the
golden spec in `spec.poseidon`.  State batches are `[B, t, 8]` Montgomery
limb tensors.

`permute` launches K1 `poseidon_permute` (csrc/poseidon_permute.cu), which
replaces the Pallas kernel `_permute_tiles` of the JAX package
(ops/poseidon_pallas.py), at widths t = 17 and t = 9.  On a CPU tensor it
takes `permute_plain`: the same rounds as dense PyTorch tensor code (ARK,
x^5, one fused constant-matrix apply per round), which runs on any device
and is what the kernel is held against.

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

SUPPORTED_WIDTHS = (9, 17)


class DeviceParams:
    """Poseidon constants of one width, with per-device tensor caches.

    The kernel's constants are the host engine's packs (`native.pack_params`:
    dense matrices and sparse rows scaled by 2^320, the rest plain
    Montgomery); the plain version keeps the round constants as limb
    tensors and the MDS matrix as a `fr.PlainMatrix`."""

    def __init__(self, params: PoseidonParams):
        if params.t not in SUPPORTED_WIDTHS:
            raise NotImplementedError(
                f"Poseidon width t={params.t}: the port has t=17 and t=9")
        self.spec_params = params
        self.t = params.t
        self.rate = params.rate
        self.rf = params.rf
        self.rp = params.rp
        self._kernel: dict = {}
        self._plain: dict = {}

    def kernel_consts(self, device):
        """(mds, rc_full, rc_part, qrow, qcol, mfinal) int32 tensors."""
        key = str(device)
        if key not in self._kernel:
            self._kernel[key] = tuple(
                fr.to_device(fr.from_u64(a.reshape(-1, 4)), device)
                for a in native.pack_params(self.spec_params))
        return self._kernel[key]

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


def permute(state: torch.Tensor, dp: DeviceParams) -> torch.Tensor:
    """Batched permutation: state [B, t, 8] Montgomery -> same shape."""
    if state.dtype != torch.int32 or state.dim() != 3 \
            or state.shape[1:] != (dp.t, fr.N):
        raise TypeError(f"poseidon permute: expected [B, {dp.t}, 8] int32, "
                        f"got {tuple(state.shape)} {state.dtype}")
    if not state.is_cuda:
        return permute_plain(state, dp)
    state = state.contiguous()
    out = torch.empty_like(state)
    B = int(state.shape[0])
    if B == 0:
        return out
    consts = dp.kernel_consts(state.device)
    lib = kernels.lib("poseidon_permute")
    rc = lib.poseidon_permute(
        state.data_ptr(), out.data_ptr(), B, dp.t, dp.rf, dp.rp,
        *[c.data_ptr() for c in consts], kernels.stream_ptr())
    kernels.check(rc, f"poseidon_permute t={dp.t}")
    kernels.launches[f"poseidon_permute_t{dp.t}"] += 1
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
