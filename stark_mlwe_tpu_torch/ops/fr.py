"""Pallas-curve scalar field Fr on the card: 8x32-bit limb tensors.

Limb layout (used everywhere in the port): an element is `[..., 8] int32`,
eight 32-bit little-endian limbs - 32 bytes, the same bytes as four 64-bit
limbs, so the CUDA kernels read an element as `uint64_t[4]` and the host
engine takes a CPU tensor's numpy view as it is.  torch has no unsigned
32-bit type: a limb >= 2^31 shows as a negative int32, and nothing here
compares or shifts limb tensors without masking.

  - canonical form: value in [0, P)
  - Montgomery form: x_hat = x * 2^256 mod P (R = 2^256, the radix of the
    JAX package and of ark-ff, so Montgomery values are the same integers
    in both packages)

Every function returns fully reduced values (in [0, P)).

Kernels.  `mont_mul`, `add`, `sub` launch K2 `fr_elementwise`
(csrc/fr_elementwise.cu), `fold` launches K3 `fr_fold` (csrc/fr_fold.cu),
and `batch_inv` and `f0_quotient` launch the batch inversion `fr_batch_inv`
(csrc/fr_batch_inv.cu) on CUDA tensors; they replace the XLA-fused limb
graphs `fr.mont_mul`, `fr.add`, `fr.sub`, `fr.mat_apply` and `fr.batch_inv`
of the JAX package.  On a CPU tensor each takes its plain PyTorch version
(`*_plain`), which splits to 16-bit limbs in int64 because torch has no wide
multiply; the plain versions run on any device and are what the kernels are
held against.  `pow5`, `powers`, `reduce_add`, `to_mont`, `from_mont` are
compositions of those launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..spec.field import P

N = 8             # 32-bit limbs per element
_N16 = 16         # 16-bit limbs inside the plain versions
_MASK = 0xFFFF

R_MONT = (1 << 256) % P
R2_MONT = (R_MONT * R_MONT) % P
R_INV = pow(R_MONT, P - 2, P)

# Extended-REDC radix of the plain constant-matrix apply: divides by 2^272.
_NRED_MAT = _N16 + 1
MAT_SCALE = pow(2, 16 * _NRED_MAT, P)


def _limbs16_of(x: int) -> list:
    return [(x >> (16 * k)) & _MASK for k in range(_N16)]


# ---------------------------------------------------------------------------
# Host <-> device packing.
# ---------------------------------------------------------------------------

def pack_ints(xs, mont: bool = False) -> np.ndarray:
    """Canonical ints -> [n, 8] int32 limbs on the host (optionally
    Montgomery form; large batches scale in the native engine)."""
    if mont and len(xs) >= 1024:
        from .. import native
        buf = native.ints_to_mont_u64([int(x) % P for x in xs])
        return buf.view("<i4").reshape(len(xs), N)
    if mont:
        xs = [x * R_MONT % P for x in xs]
    buf = b"".join(int(x % P).to_bytes(32, "little") for x in xs)
    return np.frombuffer(buf, dtype="<i4").reshape(len(xs), N).copy()


def _host_array(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(arr, dtype="<i4").reshape(-1, N)


def unpack_ints(arr, mont: bool = False) -> list:
    """[..., 8] limbs (tensor or numpy) -> flat list of canonical ints."""
    a = _host_array(arr)
    buf = a.tobytes()
    out = [int.from_bytes(buf[32 * i:32 * i + 32], "little")
           for i in range(a.shape[0])]
    if mont:
        out = [x * R_INV % P for x in out]
    return out


def pack_int(x: int, mont: bool = False) -> np.ndarray:
    return pack_ints([x], mont=mont)[0]


def from_u64(a) -> np.ndarray:
    """[n, 4] uint64 limbs -> [n, 8] int32 limbs (a view: same bytes)."""
    a = np.ascontiguousarray(a, dtype="<u8")
    return a.view("<i4").reshape(a.shape[:-1] + (N,))


def to_u64(arr) -> np.ndarray:
    """[n, 8] int32 limbs (tensor or numpy) -> [n, 4] uint64 limbs."""
    return _host_array(arr).view("<u8")


def seeded_limbs(seed: int, n: int) -> np.ndarray:
    """n field elements from a numpy seed as [n, 8] int32 host limbs:
    uniform 32-bit limbs with the top one cut to 30 bits (values below
    2^254 < P).  Read as Montgomery form they are n uniform-looking field
    elements; the recorded NTT digests are taken on these inputs."""
    raw = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, N),
                                               dtype=np.uint64)
    raw[:, N - 1] &= 0x3FFFFFFF
    return raw.astype(np.uint32).view(np.int32)


def to_device(arr, device) -> torch.Tensor:
    """Host limbs -> int32 tensor on `device` (an explicit torch.device)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    return torch.from_numpy(np.ascontiguousarray(arr, dtype="<i4")).to(device)


def upload(arr, device) -> torch.Tensor:
    """Host limbs -> int32 tensor on `device` without a host sync: to a
    CUDA device the bytes go through pinned memory with `non_blocking=True`
    (a copy from pageable memory makes the host wait for the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype="<i4"))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


_CONSTS: dict = {}


def const(value: int, device, mont: bool = False) -> torch.Tensor:
    """A cached [8] limb tensor of one field constant on `device`."""
    key = (value, mont, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = upload(pack_int(value, mont=mont), device)
    return _CONSTS[key]


def mont_one(device) -> torch.Tensor:
    return const(1, device, mont=True)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (any device; 16-bit limbs in int64).
# ---------------------------------------------------------------------------

def _to16(x: torch.Tensor) -> torch.Tensor:
    v = x.to(torch.int64)
    lo = v & _MASK
    hi = (v >> 16) & _MASK
    return torch.stack([lo, hi], dim=-1).reshape(x.shape[:-1] + (_N16,))


def _from16(l: torch.Tensor) -> torch.Tensor:
    l = l.reshape(l.shape[:-1] + (N, 2))
    v = l[..., 0] | (l[..., 1] << 16)
    v = v - ((v >> 31) << 32)          # [0, 2^32) -> the int32 of those bits
    return v.to(torch.int32)


def _row16(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_limbs16_of(value), dtype=torch.int64,
                        device=like.device)


def _carry(T: torch.Tensor):
    """Carry-propagate relaxed 16-bit columns (entries may be negative:
    the arithmetic shift is a floor, so borrows ripple like carries).
    Returns (normalised columns, carry out)."""
    cols = []
    c = None
    for k in range(T.shape[-1]):
        s = T[..., k] if c is None else T[..., k] + c
        cols.append(s & _MASK)
        c = s >> 16
    return torch.stack(cols, dim=-1), c


def _cond_sub_p(x16: torch.Tensor) -> torch.Tensor:
    """Normalised columns, value in [0, 2P) -> canonical columns."""
    comp = _row16((1 << 256) - P, x16)
    d, carry = _carry(x16 + comp)      # carries out iff x >= P
    return torch.where((carry > 0)[..., None], d, x16)


def _redc16(T: torch.Tensor, nred: int) -> torch.Tensor:
    """REDC over 16-bit columns: T (relaxed, width nred + 17) is divided by
    2^(16*nred) mod P; returns canonical columns.  T is clobbered."""
    p_row = _row16(P, T)
    for i in range(nred):
        m = (T[..., i] * _MASK) & _MASK        # -P^-1 mod 2^16 == 0xFFFF
        T[..., i:i + _N16] += m[..., None] * p_row
        T[..., i + 1] += T[..., i] >> 16
    out, _ = _carry(T[..., nred:nred + _N16 + 1])
    return _cond_sub_p(out[..., :_N16])        # top column is zero: < 2P


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a16, b16 = torch.broadcast_tensors(_to16(a), _to16(b))
    T = torch.zeros(a16.shape[:-1] + (2 * _N16 + 1,), dtype=torch.int64,
                    device=a16.device)
    for i in range(_N16):
        T[..., i:i + _N16] += a16[..., i:i + 1] * b16
    return _from16(_redc16(T, _N16))


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s, _ = _carry(_to16(a) + _to16(b))
    return _from16(_cond_sub_p(s))


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a16 = _to16(a)
    s, _ = _carry(a16 + _row16(P, a16) - _to16(b))
    return _from16(_cond_sub_p(s))


def pow5_plain(a: torch.Tensor) -> torch.Tensor:
    a2 = mont_mul_plain(a, a)
    return mont_mul_plain(mont_mul_plain(a2, a2), a)


def fold_plain(f: torch.Tensor, zpow: torch.Tensor) -> torch.Tensor:
    m = zpow.shape[0]
    prod = mont_mul_plain(f.reshape(-1, m, N), zpow[None])
    acc = prod[:, 0]
    for t in range(1, m):
        acc = add_plain(acc, prod[:, t])
    return acc


class PlainMatrix:
    """A constant matrix prepared for `mat_apply_plain`: entries scaled by
    2^272 and laid out as a Toeplitz block so the whole limb convolution
    of the row sums is ONE float64 matmul (every partial sum is an integer
    below 2^41, exact in float64 in any summation order)."""

    def __init__(self, rows, device):
        to, ti = len(rows), len(rows[0])
        width = 2 * _N16
        buf = b"".join((v * MAT_SCALE % P).to_bytes(32, "little")
                       for row in rows for v in row)
        limbs = np.frombuffer(buf, dtype="<u2").reshape(to, ti, _N16)
        W = np.zeros((ti, _N16, to, width), dtype=np.float64)
        for mm in range(_N16):
            W[:, mm, :, mm:mm + _N16] = limbs.transpose(1, 0, 2)
        self.to, self.ti = to, ti
        self.W = torch.from_numpy(
            W.reshape(ti * _N16, to * width)).to(device)


def mat_apply_plain(A: PlainMatrix, s: torch.Tensor) -> torch.Tensor:
    """out[..., i, :] = sum_j A[i, j] * s[..., j, :] (Montgomery in and
    out): row sums accumulated unreduced, one 17-step REDC per output."""
    s16 = _to16(s)
    lead = s16.shape[:-2]
    flat = s16.reshape(-1, A.ti * _N16).to(torch.float64)
    T = (flat @ A.W).to(torch.int64).reshape(-1, A.to, 2 * _N16)
    T = torch.nn.functional.pad(T, (0, _NRED_MAT + _N16 + 1 - 2 * _N16))
    return _from16(_redc16(T, _NRED_MAT)).reshape(lead + (A.to, N))


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _check_limbs(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.int32 or x.shape[-1] != N:
        raise TypeError(f"{what}: expected [..., 8] int32 limbs, got "
                        f"{tuple(x.shape)} {x.dtype}")


def _elementwise(op: int, name: str, plain, a, b) -> torch.Tensor:
    _check_limbs(a, name)
    _check_limbs(b, name)
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if not a.is_cuda:
        return plain(a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    n = 1
    for d in shape[:-1]:
        n *= d
    steps = []
    ops = []
    for x in (a, b):
        if x.numel() == N and n > 1:
            steps.append(0)
            ops.append(x.contiguous())
        else:
            steps.append(1)
            ops.append(x.expand(shape).contiguous())
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    lib = kernels.lib("fr_elementwise")
    rc = lib.fr_elementwise(op, ops[0].data_ptr(), ops[1].data_ptr(),
                            out.data_ptr(), n, steps[0], steps[1],
                            kernels.stream_ptr())
    kernels.check(rc, name)
    kernels.launches[name] += 1
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * 2^-256 mod P."""
    return _elementwise(0, "fr_mont_mul", mont_mul_plain, a, b)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical modular addition."""
    return _elementwise(1, "fr_add", add_plain, a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical modular subtraction."""
    return _elementwise(2, "fr_sub", sub_plain, a, b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def fold(f: torch.Tensor, zpow: torch.Tensor) -> torch.Tensor:
    """m-ary fold out[b] = sum_t f[b*m + t] * zpow[t].

    f: [n, 8], zpow: [m, 8] powers of z, both Montgomery form; m divides n.
    One reduction per output (lazy accumulation in the kernel)."""
    _check_limbs(f, "fr_fold")
    _check_limbs(zpow, "fr_fold")
    m = int(zpow.shape[0])
    n = int(f.shape[0])
    if f.dim() != 2 or zpow.dim() != 2 or m < 1 or n % m:
        raise ValueError(f"fr_fold: bad shapes {tuple(f.shape)}, "
                         f"{tuple(zpow.shape)}")
    if f.device != zpow.device:
        raise ValueError("fr_fold: operands on different devices")
    if not f.is_cuda:
        return fold_plain(f, zpow)
    f = f.contiguous()
    zpow = zpow.contiguous()
    out = torch.empty((n // m, N), dtype=torch.int32, device=f.device)
    lib = kernels.lib("fr_fold")
    rc = lib.fr_fold(f.data_ptr(), zpow.data_ptr(), out.data_ptr(), n // m,
                     m, kernels.stream_ptr())
    kernels.check(rc, "fr_fold")
    kernels.launches["fr_fold"] += 1
    return out


# ---------------------------------------------------------------------------
# Compositions.
# ---------------------------------------------------------------------------

def pow5(a: torch.Tensor) -> torch.Tensor:
    """x^5 via 2 squarings + 1 multiply (the Poseidon S-box exponent)."""
    a2 = mont_mul(a, a)
    return mont_mul(mont_mul(a2, a2), a)


def to_mont(x: torch.Tensor) -> torch.Tensor:
    """Canonical limbs -> Montgomery limbs."""
    return mont_mul(x, const(R2_MONT, x.device))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    """Montgomery limbs -> canonical limbs."""
    return mont_mul(x, const(1, x.device))


def inv(x: torch.Tensor) -> torch.Tensor:
    """Elementwise Fermat inverse, Montgomery in and out, computed on the
    host with Python `pow` after a readback (0 gives 0): the last step of
    `batch_inv_plain`, on its single running total."""
    vals = unpack_ints(x, mont=True)
    out = pack_ints([pow(v, P - 2, P) for v in vals], mont=True)
    return to_device(out, x.device).reshape(x.shape)


def _split(n: int) -> int:
    """Rows of the blocked layout of `batch_inv_plain`: about sqrt(n)."""
    c = 1
    while c * c < n:
        c *= 2
    return c


def batch_inv_plain(x: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of x: [n, 8], Montgomery form (a zero anywhere
    gives all zeros).

    Blocked Montgomery trick: x is laid out as [C, W] with C ~ sqrt(n); a
    sequential prefix product over the C rows (each step one multiply over
    W elements) leaves W column totals, which are inverted by recursion
    down to ONE element that is inverted on the host; a sequential sweep
    back turns the totals' inverses into every element's."""
    n = int(x.shape[0])
    if n == 1:
        return inv(x)
    C = _split(n)
    W = -(-n // C)
    pad = C * W - n
    if pad:
        x = torch.cat([x, mont_one(x.device).expand(pad, N)], dim=0)
    rows = x.reshape(C, W, N)
    prefix = [rows[0]]
    for c in range(1, C):
        prefix.append(mont_mul_plain(prefix[-1], rows[c]))
    acc = batch_inv_plain(prefix[-1])
    out = [None] * C
    for c in range(C - 1, 0, -1):
        out[c] = mont_mul_plain(acc, prefix[c - 1])
        acc = mont_mul_plain(acc, rows[c])
    out[0] = acc
    return torch.stack(out, dim=0).reshape(C * W, N)[:n]


def f0_quotient_plain(phi: torch.Tensor, w: torch.Tensor,
                      z_m: torch.Tensor) -> torch.Tensor:
    return mont_mul_plain(phi, batch_inv_plain(sub_plain(w, z_m)))


BATCH_INV_THREADS = 128       # threads a block of the scan and the sweep
BATCH_INV_MAX_BLOCKS = 1024   # block totals the one total block takes


def batch_inv_layout(n: int, threads: int = BATCH_INV_THREADS,
                     per_thread: int | None = None) -> tuple:
    """(threads, per_thread, b_threads) of `fr_batch_inv` for n elements:
    blocks of `threads` threads with runs of one element while that needs
    at most `BATCH_INV_MAX_BLOCKS` blocks (65,536 elements: 512 blocks,
    about four warps a sub-partition of each of the 132 SMs), runs doubled
    beyond, unless `per_thread` is given; the total block of the fewest
    threads from 32 to 256 that covers the block totals."""
    T = threads
    E = per_thread or 1
    while per_thread is None and -(-n // (T * E)) > BATCH_INV_MAX_BLOCKS:
        E *= 2
    G = -(-n // (T * E))
    TB = 32
    while TB < min(G, 256):
        TB *= 2
    return T, E, TB


def batch_inv_scratch(n: int, layout: tuple) -> int:
    """Elements of scratch `fr_batch_inv` takes (`bi_scratch_elems` of
    csrc/batch_inv.cuh): the run products when runs are longer than one,
    a product per thread, and three per block."""
    T, E, _ = layout
    G = -(-n // (T * E))
    return (n if E > 1 else 0) + G * T + 3 * G


def _batch_inv(name, x, z, phi) -> torch.Tensor:
    """out = phi * (x - z)^-1 through the three launches of `fr_batch_inv`
    (z, phi: None when absent); x, phi [n, 8], z [8], all on one CUDA
    device."""
    n = int(x.shape[0])
    layout = batch_inv_layout(n)
    ops = [None if t is None else t.contiguous() for t in (x, z, phi)]
    out = torch.empty((n, N), dtype=torch.int32, device=x.device)
    scratch = torch.empty((batch_inv_scratch(n, layout), N),
                          dtype=torch.int32, device=x.device)
    lib = kernels.lib("fr_batch_inv")
    rc = lib.fr_batch_inv(*[None if t is None else t.data_ptr()
                            for t in ops],
                          out.data_ptr(), scratch.data_ptr(),
                          int(scratch.shape[0]), n, *layout, 7,
                          kernels.stream_ptr())
    kernels.check(rc, name)
    kernels.launches["fr_batch_inv"] += 3
    return out


def _check_batch(name, *xs) -> None:
    for x in xs:
        _check_limbs(x, name)
    if xs[0].dim() != 2 or xs[0].shape[0] < 1 or any(
            x.shape != xs[0].shape for x in xs[1:]):
        raise ValueError(f"{name}: expected [n, 8] operands of one shape, "
                         f"n >= 1; got {[tuple(x.shape) for x in xs]}")


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of x: [n, 8], Montgomery form; a zero anywhere
    gives all zeros (as the JAX package's `batch_inv`)."""
    _check_batch("fr_batch_inv", x)
    if not x.is_cuda:
        return batch_inv_plain(x)
    return _batch_inv("fr_batch_inv", x, None, None)


def f0_quotient(phi: torch.Tensor, w: torch.Tensor,
                z_m: torch.Tensor) -> torch.Tensor:
    """The DEEP-ALI quotient phi * (w - z)^-1: phi, w [n, 8], z_m [8], all
    Montgomery form, on one device; one `fr_batch_inv` call on the card."""
    _check_batch("f0_quotient", phi, w)
    _check_limbs(z_m, "f0_quotient")
    if z_m.numel() != N:
        raise ValueError(f"f0_quotient: z_m must be one element, got "
                         f"{tuple(z_m.shape)}")
    if not (phi.device == w.device == z_m.device):
        raise ValueError(f"f0_quotient: operands on {phi.device}, "
                         f"{w.device} and {z_m.device}")
    if not w.is_cuda:
        return f0_quotient_plain(phi, w, z_m)
    return _batch_inv("f0_quotient", w, z_m, phi)


def powers(base: torch.Tensor, n: int) -> torch.Tensor:
    """[1, base, ..., base^(n-1)] in Montgomery form; base: [8] Montgomery.
    Doubling: each step multiplies the table so far by base^len."""
    out = mont_one(base.device).reshape(1, N)
    step = base.reshape(1, N)
    while out.shape[0] < n:
        out = torch.cat([out, mont_mul(out, step)], dim=0)
        if out.shape[0] < n:
            step = mont_mul(step, step)
    return out[:n].contiguous()


def reduce_add(x: torch.Tensor) -> torch.Tensor:
    """Modular sum over axis 0 of x: [n, 8] -> [8] (halving tree)."""
    n = int(x.shape[0])
    m = 1
    while m < n:
        m *= 2
    if m != n:
        x = torch.cat([x, torch.zeros((m - n, N), dtype=torch.int32,
                                      device=x.device)], dim=0)
    while m > 1:
        m //= 2
        x = add(x[:m], x[m:])
    return x[0]
