"""Radix-2 NTT / iNTT / LDE over Fr on the card.

Counterpart of `ops/ntt.py` and `ops/ntt_pallas.py` of the JAX package,
bit-exact against both.  Semantics: ntt(c)[j] = sum_i c_i omega^(ij) with
omega = get_root_of_unity(n) (the ark-ff FftField convention); the inverse
uses omega^-1 and scales by 1/n.  Vectors are `[n, 8]` Montgomery limb
tensors (or `[B, n, 8]`: B transforms down axis -2); n is a power of two.

Every transform on a CUDA tensor runs in K6 `fr_ntt_tiles`
(csrc/fr_ntt.cu), which replaces the Pallas kernel `_ntt_tiles` of the JAX
package: B transforms of one length L <= TILE_MAX, all butterfly stages in
shared memory, then an optional product with an epilogue table.  The kernel
takes `[..., L, 8]` VIEWS: it reads every transform where it lies (any
stride between its elements, any strides over the batch dimensions),
bit-reverses in the index of its load and writes through the strides of
`out`.  So the four-step recursion

    M = m1 * m2, i = i1*m2 + i2, X[j1 + m1*j2]:
    size-m1 transforms of the m2 columns, times omega_M^(i2*j1) in the
    epilogue; then size-m2 transforms of the m1 rows, recursing while m2
    is longer than a tile

is a sequence of launches over transposed views and no copy, gather or
transpose pass exists beside them: n = 2^22 is 2,048 x 2,048, two launches,
and a transform that fits one tile is one launch of the same code path.
The inverse's 1/M is applied once, at the outermost level: folded into the
step table where M recurses, a constant epilogue row where M fits a tile.

`ntt_tiles_plain` (a bit-reversal `index_select` and the stages with
`fr.mont_mul_plain`, `add_plain`, `sub_plain`) is the kernel's plain version:
the wrapper `ntt_tiles` takes it for a CPU tensor, so on the CPU the same
recursion runs on it.  `ntt_plain` is the flat transform through it, one
tile of length n, with no four-step index logic: the yardstick the
recursion is held against.

Constant tables are built on the device (`fr.powers`; a power table of a
vector of bases for the step twiddles) and cached per size, direction and
device: `stage_twiddles` (omega_L^j, j < L/2: stage with half h reads every
(L/2h)-th entry) and `step_twiddles` (omega_M^(i2*j1) as a full
`[m2, m1, 8]` table: 128 MiB at M = 2^22, read once by the first launch).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..spec.field import P, get_root_of_unity
from . import fr
from .fr import N

# Longest transform of one launch.  A tile of L elements takes 32*L bytes of
# a block's shared memory: at 2,048 that is 64 KB, so three blocks fit one SM
# (227 KB) and 2^22 = 2,048 x 2,048 is two launches.  The kernel itself takes
# up to TILE_CAP (128 KB, one block per SM).
TILE_MAX = 2048
TILE_CAP = 4096
# Elements a block holds when the transforms are short: 1024/L of them.
_BLOCK_ELEMS = 1024
_MAX_LEVELS = 8         # NTT_MAX_LEVELS of csrc/ntt.cuh


def _bit_reverse_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def _is_pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def _root(n: int, inverse: bool) -> int:
    omega = get_root_of_unity(n)
    return pow(omega, P - 2, P) if inverse else omega


# ---------------------------------------------------------------------------
# Constant tables, built on the device.
# ---------------------------------------------------------------------------

_TABLES: dict = {}


def clear_tables() -> None:
    """Drop the cached tables (they are rebuilt at the next use)."""
    _TABLES.clear()


def _cached(key, build):
    if key not in _TABLES:
        _TABLES[key] = build()
    return _TABLES[key]


def stage_twiddles(L: int, inverse: bool, device) -> torch.Tensor:
    """[max(L/2, 1), 8]: omega_L^j in Montgomery form.  The stage with half
    h multiplies the odd element j by entry j * L/(2h)."""
    if not _is_pow2(L) or L < 2:
        raise ValueError(f"stage_twiddles: length {L}")
    device = torch.device(device)
    return _cached(
        ("stage", L, inverse, str(device)),
        lambda: fr.powers(fr.const(_root(L, inverse), device, mont=True),
                          max(L // 2, 1)))


def step_twiddles(M: int, m1: int, m2: int, inverse: bool, scaled: bool,
                  device) -> torch.Tensor:
    """[m2, m1, 8]: entry (i2, j1) is omega_M^(i2*j1), times 1/M when
    `scaled` (the inverse transform's scale, folded in at the top level).
    Rows of geometric series, doubled along j1 on the device."""
    if m1 * m2 != M or not _is_pow2(m1) or not _is_pow2(m2):
        raise ValueError(f"step_twiddles: {M} != {m1} x {m2} in powers of "
                         f"two")
    device = torch.device(device)

    def build():
        bases = fr.powers(fr.const(_root(M, inverse), device, mont=True), m2)
        first = pow(M % P, P - 2, P) if scaled else 1
        out = fr.const(first, device, mont=True).expand(m2, 1, N)
        step = bases.reshape(m2, 1, N)
        while out.shape[1] < m1:
            out = torch.cat([out, fr.mont_mul(out, step)], dim=1)
            if out.shape[1] < m1:
                step = fr.mont_mul(step, step)
        return out.contiguous()

    return _cached(("step", M, m1, m2, inverse, scaled, str(device)), build)


def _scale_row(L: int, device) -> torch.Tensor:
    """[1, L, 8]: 1/L in every entry (the epilogue of an inverse transform
    that fits one tile)."""
    device = torch.device(device)
    return _cached(
        ("scale", L, str(device)),
        lambda: fr.const(pow(L % P, P - 2, P), device, mont=True)
        .expand(1, L, N).contiguous())


def _split(M: int, tile_max: int):
    """m1 (tile length of the column transforms) x m2 for the four-step of
    size M: the square root rounded up, capped by the tile."""
    k = M.bit_length() - 1
    m1 = min(tile_max, 1 << ((k + 1) // 2))
    return m1, M // m1


# ---------------------------------------------------------------------------
# The tile transform: plain version and kernel wrapper.
# ---------------------------------------------------------------------------

def ntt_tiles_plain(x: torch.Tensor, wt: torch.Tensor,
                    ep: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `ntt_tiles`: in-order transforms of length L down
    axis -2 of x `[..., L, 8]` with the stage twiddles `wt` `[L/2, 8]`, then
    the product with `ep` (broadcast against the result).  Returns a new
    contiguous tensor."""
    L = int(x.shape[-2])
    rev = torch.from_numpy(_bit_reverse_perm(L)).to(x.device)
    y = x.index_select(-2, rev)
    lead = tuple(y.shape[:-2])
    h = 1
    while h < L:
        g = 2 * h
        v = y.reshape(lead + (L // g, g, N))
        e, o = v[..., :h, :], v[..., h:, :]
        if h > 1:
            o = fr.mont_mul_plain(o, wt[::L // g][:h])
        y = torch.cat([fr.add_plain(e, o), fr.sub_plain(e, o)],
                      dim=-2).reshape(lead + (L, N))
        h = g
    if ep is not None:
        y = fr.mont_mul_plain(y, ep)
    return y


def _batch_levels(x: torch.Tensor, out: torch.Tensor):
    """The batch dimensions of two `[..., L, 8]` views as the kernel's
    levels, innermost first: (counts, strides in x, strides in out), in
    elements.  Dimensions of size 1 are dropped and neighbours that are
    contiguous in both views are merged."""
    cnt, ins, outs = [], [], []
    for d in range(x.dim() - 3, -1, -1):
        c = int(x.shape[d])
        if c == 1:
            continue
        si, so = x.stride(d) // N, out.stride(d) // N
        if cnt and si == ins[-1] * cnt[-1] and so == outs[-1] * cnt[-1]:
            cnt[-1] *= c
        else:
            cnt.append(c)
            ins.append(si)
            outs.append(so)
    if not cnt:
        cnt, ins, outs = [1], [0], [0]
    return cnt, ins, outs


def _check_view(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.int32 or x.dim() < 3 or x.shape[-1] != N:
        raise TypeError(f"{what}: expected [..., L, 8] int32 limbs with at "
                        f"least one batch dimension, got {tuple(x.shape)} "
                        f"{x.dtype}")
    if x.stride(-1) != 1 or x.storage_offset() % N \
            or any(s % N for s in x.stride()[:-1]):
        raise ValueError(f"{what}: elements must be whole and contiguous "
                         f"(strides {x.stride()})")


def _kernel_args(x, wt, ep, out) -> tuple:
    """The arguments of the C entry point `fr_ntt_tiles` up to the stream
    (and of its host replay `hc_ntt_tile`) for checked views."""
    L = int(x.shape[-2])
    cnt, ins, outs = _batch_levels(x, out)
    if len(cnt) > _MAX_LEVELS:
        raise ValueError(f"ntt_tiles: {len(cnt)} batch levels, the kernel "
                         f"takes {_MAX_LEVELS}")
    longs = ctypes.c_long * len(cnt)
    return (x.data_ptr(), out.data_ptr(), wt.data_ptr(),
            None if ep is None else ep.data_ptr(), x.numel() // (L * N),
            L.bit_length() - 1, max(1, _BLOCK_ELEMS // L),
            x.stride(-2) // N, out.stride(-2) // N,
            1 if ep is None else int(ep.shape[0]), len(cnt), longs(*cnt),
            longs(*ins), longs(*outs))


def ntt_tiles(x: torch.Tensor, wt: torch.Tensor,
              ep: torch.Tensor | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """In-order NTTs of length L down axis -2 of x `[..., L, 8]`, one per
    index of the batch dimensions, 2 <= L <= TILE_CAP.

    wt: `[L/2, 8]` stage twiddles (`stage_twiddles`).  ep: `[p, L, 8]`
    contiguous, p = 1 or the size of the innermost batch dimension; the
    transform at index b of that dimension is multiplied elementwise by
    row b % p.  x and out may be any views whose elements are whole
    (transposed, sliced, broadcast batch); out defaults to a new contiguous
    tensor and must not overlap x."""
    _check_view(x, "ntt_tiles")
    L = int(x.shape[-2])
    if not _is_pow2(L) or L < 2 or L > TILE_CAP:
        raise ValueError(f"ntt_tiles: length {L} is not a power of two in "
                         f"[2, {TILE_CAP}]")
    if wt.dtype != torch.int32 or tuple(wt.shape) != (max(L // 2, 1), N) \
            or not wt.is_contiguous() or wt.device != x.device:
        raise ValueError(f"ntt_tiles: stage twiddles {tuple(wt.shape)} on "
                         f"{wt.device} for length {L} on {x.device}")
    if ep is not None:
        if ep.dtype != torch.int32 or ep.dim() != 3 \
                or tuple(ep.shape[1:]) != (L, N) or not ep.is_contiguous() \
                or ep.shape[0] not in (1, x.shape[-3]) \
                or ep.device != x.device:
            raise ValueError(f"ntt_tiles: epilogue {tuple(ep.shape)} on "
                             f"{ep.device} for x {tuple(x.shape)} on "
                             f"{x.device}")
    if out is None:
        out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    else:
        _check_view(out, "ntt_tiles (out)")
        if out.shape != x.shape or out.device != x.device:
            raise ValueError(f"ntt_tiles: out {tuple(out.shape)} on "
                             f"{out.device} for x {tuple(x.shape)} on "
                             f"{x.device}")
    B = x.numel() // (L * N)
    if B == 0:
        return out
    if not x.is_cuda:
        out.copy_(ntt_tiles_plain(x, wt, ep))
        return out
    lib = kernels.lib("fr_ntt")
    rc = lib.fr_ntt_tiles(*_kernel_args(x, wt, ep, out),
                          kernels.stream_ptr())
    kernels.check(rc, f"fr_ntt_tiles L={L}")
    kernels.launches["fr_ntt_tiles"] += 1
    return out


# ---------------------------------------------------------------------------
# Transforms of any power-of-two length.
# ---------------------------------------------------------------------------

def _transform(x: torch.Tensor, out: torch.Tensor, inverse: bool,
               tile_max: int, scale_top: bool) -> None:
    """In-order size-M NTTs down axis -2 of the view x `[..., M, 8]` into
    the view out.  M <= tile_max is one launch; a longer M goes through the
    four-step with both transposes taken as views."""
    M = int(x.shape[-2])
    dev = x.device
    if M <= tile_max:
        ep = _scale_row(M, dev) if inverse and scale_top else None
        ntt_tiles(x, stage_twiddles(M, inverse, dev), ep, out=out)
        return
    m1, m2 = _split(M, tile_max)
    # columns: i = i1*m2 + i2 -> transform over i1 for each (batch, i2);
    # the result, times omega_M^(i2*j1), lands at tmp[batch, j1, i2]
    cols = x.unflatten(-2, (m1, m2)).transpose(-3, -2)
    tmp = torch.empty(tuple(x.shape[:-2]) + (m1, m2, N), dtype=torch.int32,
                      device=dev)
    ep = step_twiddles(M, m1, m2, inverse, inverse and scale_top, dev)
    ntt_tiles(cols, stage_twiddles(m1, inverse, dev), ep,
              out=tmp.transpose(-3, -2))
    # rows: transform over i2 for each (batch, j1) into X[j1 + m1*j2]
    _transform(tmp, out.unflatten(-2, (m2, m1)).transpose(-3, -2), inverse,
               tile_max, False)


def ntt(x: torch.Tensor, inverse: bool = False,
        tile_max: int = TILE_MAX) -> torch.Tensor:
    """In-order radix-2 NTT of x: `[n, 8]` Montgomery, or `[B, n, 8]` (B
    transforms; any view with whole elements).  With inverse=True computes
    the inverse transform including the 1/n scale.  `tile_max` is the
    longest transform given to one launch (a power of two in
    [2, TILE_CAP])."""
    if x.dtype != torch.int32 or x.dim() not in (2, 3) or x.shape[-1] != N:
        raise TypeError(f"ntt: expected [n, 8] or [B, n, 8] int32 limbs, "
                        f"got {tuple(x.shape)} {x.dtype}")
    n = int(x.shape[-2])
    if n == 1:
        return x
    if not _is_pow2(n):
        raise ValueError(f"ntt: length {n} is not a power of two")
    if not _is_pow2(tile_max) or not 2 <= tile_max <= TILE_CAP:
        raise ValueError(f"ntt: tile_max {tile_max} is not a power of two "
                         f"in [2, {TILE_CAP}]")
    xb = x if x.dim() == 3 else x.unsqueeze(0)
    out = torch.empty(xb.shape, dtype=torch.int32, device=x.device)
    _transform(xb, out, inverse, tile_max, True)
    return out if x.dim() == 3 else out[0]


def intt(x: torch.Tensor, tile_max: int = TILE_MAX) -> torch.Tensor:
    return ntt(x, inverse=True, tile_max=tile_max)


def ntt_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The flat transform of x `[n, 8]` through the plain tile transform
    (one tile of length n: bit-reversal, log2 n stages, the 1/n scale).
    Runs on any device; nothing on a path calls it when a card is present."""
    n = int(x.shape[0])
    if n == 1:
        return x
    if not _is_pow2(n):
        raise ValueError(f"ntt_plain: length {n} is not a power of two")
    ep = None
    if inverse:
        ep = fr.const(pow(n % P, P - 2, P), x.device, mont=True)
    return ntt_tiles_plain(x.unsqueeze(0),
                           stage_twiddles(n, inverse, x.device), ep)[0]


def lde(values: torch.Tensor, blowup: int,
        coset_shift: int | None = None) -> torch.Tensor:
    """Low-degree extension: evaluations on H (size n) -> evaluations on a
    (coset of a) domain of size n*blowup.

    coset_shift g rescales coefficient i by g^i (before the zero padding),
    so the output is p(g*x) on the larger subgroup, i.e. the evaluations on
    the coset gK.  The padding zeros are transformed like any value."""
    n = int(values.shape[0])
    if not _is_pow2(blowup):
        raise ValueError(f"lde: blowup {blowup} is not a power of two")
    coeffs = intt(values)
    if coset_shift is not None:
        sh = fr.powers(fr.const(coset_shift % P, values.device, mont=True), n)
        coeffs = fr.mont_mul(coeffs, sh)
    if blowup > 1:
        coeffs = torch.cat(
            [coeffs, torch.zeros(((blowup - 1) * n, N), dtype=torch.int32,
                                 device=values.device)], dim=0)
    return ntt(coeffs)


def ntt_four_step(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Single-device reference of the four-step NTT (the multi-device
    layout): x `[n1*n2, 8]` in order.

    X[j1 + n1*j2] = sum_i x[i] w^(i*(j1+n1*j2)) decomposed with
    i = i1*n2 + i2: NTTs of the n2 columns (size n1), twiddle by w^(i2*j1),
    then NTTs of the n1 rows (size n2).  A composition of two batched `ntt`
    calls and one `fr.mont_mul`."""
    n = n1 * n2
    if x.dim() != 2 or int(x.shape[0]) != n:
        raise ValueError(f"ntt_four_step: {tuple(x.shape)} is not "
                         f"[{n1}*{n2}, 8]")
    cols = ntt(x.reshape(n1, n2, N).transpose(0, 1))       # [n2, n1, 8]
    cols = fr.mont_mul(cols, step_twiddles(n, n1, n2, False, False, x.device))
    rows = ntt(cols.transpose(0, 1))                       # [n1, n2, 8]
    return rows.transpose(0, 1).reshape(n, N)
