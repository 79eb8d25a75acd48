"""Build, load and count the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface and loaded with `ctypes`; all
compilers are started together.  Pointers cross as `tensor.data_ptr()`,
launches go to PyTorch's current stream, and every C entry point returns
`cudaGetLastError()`, which `check` turns into an exception.  Nothing here
runs when the module is imported, and nothing falls back: a build that
fails raises with the compiler's output.

`launches` counts kernel launches by name; a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time

from . import _build

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_HEADERS = ("fr.cuh", "poseidon.cuh", "poseidon_group.cuh", "ntt.cuh")

SOURCES = {
    "poseidon_permute": "poseidon_permute.cu",
    "fr_elementwise": "fr_elementwise.cu",
    "fr_fold": "fr_fold.cu",
    "poseidon_absorb_chain": "poseidon_absorb_chain.cu",
    "poseidon_permute_group": "poseidon_permute_group.cu",
    "fr_ntt": "fr_ntt.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = {
    "poseidon_permute_t17": 0,
    "poseidon_permute_t9": 0,
    "fr_mont_mul": 0,
    "fr_add": 0,
    "fr_sub": 0,
    "fr_fold": 0,
    "poseidon_absorb_chain": 0,
    "poseidon_permute_group_t17": 0,
    "poseidon_permute_group_t33": 0,
    "poseidon_permute_group_t65": 0,
    "poseidon_permute_group_t129": 0,
    "fr_ntt_tiles": 0,
}

_libs: dict = {}
_lock = threading.Lock()
build_log: dict = {}       # source name -> compiler output (ptxas -v)
build_seconds = 0.0


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def source_path(name: str) -> str:
    return os.path.join(_CSRC, SOURCES[name])


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ on the machine with the card")
    return exe


def _declare(name: str, lib) -> None:
    vp, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    if name == "poseidon_permute":
        lib.poseidon_permute.argtypes = [vp, vp, l, i, i, i,
                                         vp, vp, vp, vp, vp, vp, vp]
        lib.poseidon_permute.restype = i
    elif name == "fr_elementwise":
        lib.fr_elementwise.argtypes = [i, vp, vp, vp, l, i, i, vp]
        lib.fr_elementwise.restype = i
    elif name == "fr_fold":
        lib.fr_fold.argtypes = [vp, vp, vp, l, i, vp]
        lib.fr_fold.restype = i
    elif name == "poseidon_absorb_chain":
        lib.poseidon_absorb_chain.argtypes = [vp, vp, vp, i, l, l, l, i, i, i,
                                              vp, vp, vp, vp, vp, vp, vp]
        lib.poseidon_absorb_chain.restype = i
    elif name == "poseidon_permute_group":
        lib.poseidon_permute_group.argtypes = [vp, vp, l, i, i, i,
                                               vp, vp, vp, vp, vp, vp, vp]
        lib.poseidon_permute_group.restype = i
    elif name == "fr_ntt":
        lp = ctypes.POINTER(l)
        lib.fr_ntt_tiles.argtypes = [vp, vp, vp, vp, l, i, i, l, l, l, i,
                                     lp, lp, lp, vp]
        lib.fr_ntt_tiles.restype = i


def build_all() -> None:
    """Compile every stale kernel source (one nvcc each, all started
    together) and load the libraries."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return
        t0 = time.perf_counter()
        bdir = _build.build_dir()
        deps = [os.path.join(_CSRC, h) for h in _HEADERS]
        jobs = {}
        for name in SOURCES:
            so = os.path.join(bdir, f"lib{name}.so")
            src = source_path(name)
            if _build.stale(so, [src] + deps):
                jobs[name] = _build.start(
                    [_nvcc()] + NVCC_FLAGS + ["-o", so, src], so)
        for name, job in jobs.items():
            so = os.path.join(bdir, f"lib{name}.so")
            build_log[name] = _build.finish(job, so)
        for name in SOURCES:
            lib = ctypes.CDLL(os.path.join(bdir, f"lib{name}.so"))
            _declare(name, lib)
            _libs[name] = lib
        build_seconds = time.perf_counter() - t0


def lib(name: str):
    if name not in _libs:
        build_all()
    return _libs[name]


def stream_ptr() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
