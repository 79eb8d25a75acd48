"""PyTorch/CUDA port of the MLWE STARK prover and verifier.

Counterpart of the JAX package, module for module (`spec/`, `native/`,
`ops/fr.py`, `ops/poseidon.py`, `merkle/`, `fri/`, `stark/`,
`transcript.py`), written for one NVIDIA Hopper card: plain tensor code
is PyTorch, and the field and Poseidon kernels are hand-written CUDA C++
under `csrc/`.  This package imports torch and numpy only and keeps its
own copy of the pure-Python spec and of the host C++ engine.

Device rule: every entry point takes `device=None`.  None means the CUDA
device and raises where there is none; pass `device="cpu"` to run the
plain PyTorch versions of the kernels (what the CPU tests do).
"""

__all__ = ["spec", "native", "ops", "merkle", "fri", "stark", "transcript",
           "device", "convert"]
