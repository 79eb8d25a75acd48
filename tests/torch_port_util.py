"""Shared helpers of the test_torch_*.py files (not a test module).

Inputs are made with numpy from a seed and handed to both packages: to
the JAX package as [..., 16] uint32 16-bit limbs, to the port as
[..., 8] int32 CPU tensors.  All comparisons are exact.
"""

import ctypes
import os
import subprocess
import tempfile

import numpy as np
import torch

from stark_mlwe_tpu_torch import convert
from stark_mlwe_tpu_torch.ops import fr as tfr
from stark_mlwe_tpu_torch.spec.field import P

# The tensors here are tiny: more intra-op threads only fight the other
# test workers for cores.
torch.set_num_threads(1)

R = tfr.R_MONT
EDGE = [0, 1, P - 1, P - 2, R, tfr.R2_MONT, (1 << 254) - 1, (1 << 192) - 1,
        ((1 << 128) - 1) << 64, (1 << 64) - 1, 0xFFFFFFFF00000000FFFFFFFF,
        (0xFFFF << 240) % P, P - (1 << 64)]
EDGE = [x % P for x in EDGE]


def rand_ints(seed: int, n: int) -> list:
    """n uniform canonical field elements from a numpy seed."""
    g = np.random.default_rng(seed)
    words = g.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P
            for row in words]


def jax_limbs(xs, mont=False) -> np.ndarray:
    """Canonical ints -> the JAX package's [n, 16] uint32 layout."""
    return convert.to_jax_limbs(tfr.pack_ints(xs, mont=mont))


def port_tensor(xs, mont=False):
    return tfr.to_device(tfr.pack_ints(xs, mont=mont), "cpu")


def seeded_elems(seed: int, *shape):
    """Seeded field elements (`fr.seeded_limbs`) as a CPU limb tensor
    [*shape, 8]."""
    n = int(np.prod(shape))
    return tfr.to_device(tfr.seeded_limbs(seed, n), "cpu").reshape(*shape, 8)


def same(port_out, jax_out) -> bool:
    """Exact equality of a port tensor and a JAX-layout array."""
    return np.array_equal(convert.to_jax_limbs(port_out),
                          np.asarray(jax_out, dtype=np.uint32))


_HC = None


def host_check_lib():
    """The kernels' arithmetic (csrc/fr32.cuh, csrc/fold.cuh, csrc/ntt.cuh,
    csrc/poseidon.cuh, csrc/poseidon_chain.cuh, csrc/poseidon_group.cuh,
    csrc/batch_inv.cuh) compiled for the host with g++ from
    csrc/host_check.cpp."""
    global _HC
    if _HC is None:
        import stark_mlwe_tpu_torch
        src = os.path.join(os.path.dirname(stark_mlwe_tpu_torch.__file__),
                           "csrc", "host_check.cpp")
        so = os.path.join(tempfile.mkdtemp(prefix="hc_"), "libhc.so")
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", so, src],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.hc_elementwise.argtypes = [ctypes.c_int, u64p, u64p, u64p,
                                       ctypes.c_long, ctypes.c_int,
                                       ctypes.c_int]
        lib.hc_fold.argtypes = [u64p, u64p, u64p, ctypes.c_long,
                                ctypes.c_int]
        lib.hc_fold.restype = ctypes.c_int
        lib.hc_permute.argtypes = ([u64p, ctypes.c_long]
                                   + [ctypes.c_int] * 3 + [u64p] * 6)
        lib.hc_permute.restype = ctypes.c_int
        longp = ctypes.POINTER(ctypes.c_long)
        lib.hc_ntt_tile.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_long, ctypes.c_int,
                                     ctypes.c_int] + [ctypes.c_long] * 3
            + [ctypes.c_int, longp, longp, longp, ctypes.c_int])
        lib.hc_ntt_tile.restype = ctypes.c_int
        lib.hc_ntt_phys.argtypes = [ctypes.c_uint]
        lib.hc_ntt_phys.restype = ctypes.c_uint
        vp, c_int, c_long = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.hc_fr32_mont_mul.argtypes = [vp, vp, vp, c_long]
        lib.hc_fr32_mont_mul.restype = None
        lib.hc_fr32_sub.argtypes = [vp, vp, vp, c_long]
        lib.hc_fr32_sub.restype = None
        lib.hc_fr32_inv.argtypes = [vp, vp, c_long]
        lib.hc_fr32_inv.restype = None
        lib.hc_batch_inv.argtypes = ([vp] * 5 + [c_long, c_long]
                                     + [c_int] * 4)
        lib.hc_batch_inv.restype = c_int
        lib.hc_batch_inv_scratch.argtypes = [c_long, c_int, c_int]
        lib.hc_batch_inv_scratch.restype = c_long
        lib.hc_fr32_row_dot.argtypes = [vp, vp, vp, c_long, c_int]
        lib.hc_fr32_row_dot.restype = c_int
        lib.hc_absorb_chain.argtypes = ([vp, vp, vp, c_int, c_long, c_long,
                                         c_long, c_int, c_int, c_int]
                                        + [vp] * 6)
        lib.hc_absorb_chain.restype = c_int
        lib.hc_permute_warp.argtypes = ([vp, c_long, c_int, c_int, c_int]
                                        + [vp] * 6)
        lib.hc_permute_warp.restype = c_int
        lib.hc_permute_group.argtypes = ([vp, c_long] + [c_int] * 6
                                         + [vp] * 6)
        lib.hc_permute_group.restype = c_int
        ip = ctypes.POINTER(c_int)
        lib.hc_group_shape.argtypes = [c_int] * 4 + [ip, ip]
        lib.hc_group_shape.restype = c_int
        _HC = lib
    return _HC


def u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
