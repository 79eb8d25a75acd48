// K5 poseidon_permute_group: batched Poseidon permutation at the wide widths
// t = 33, 65 and 129 (Merkle trees of arity 32, 64 and 128).
//
// Replaces the Pallas kernels `_permute_tiles` with its dense body at t = 33
// and t = 65 (ops/poseidon_pallas.py of the JAX package) and
// `_permute_tiles_wide` at t = 129 (ops/poseidon_wide.py).  Of those it keeps
// WHAT they compute; their lane-major tiles and nibble planes are shaped by
// the other machine and are not carried over.
//
// Design: one block per state, one thread per state element
// (`poseidon_group.cuh`).  A state is read once and written once (64*t bytes)
// against ~3e6 64-bit multiply-adds at t = 129, so the kernel is bound by
// integer operations.  Each block streams the dense matrix (532 KB at
// t = 129) nine times from L2; sharing one pass between several states of a
// block is the next step and is left to a later change.

#include <cuda_runtime.h>

#include "poseidon_group.cuh"

template <int T>
__global__ void __launch_bounds__(PG_THREADS(T))
poseidon_permute_group_kernel(const u64 *__restrict__ in,
                              u64 *__restrict__ out, PoseidonGroupConsts k) {
  __shared__ u64 sh[PG_SHARED_U64(T)];
  const int tid = threadIdx.x;
  const long base = ((long)blockIdx.x * T + tid) * 4;
  u64 x[4] = {0, 0, 0, 0};
  if (tid < T) {
#pragma unroll
    for (int l = 0; l < 4; ++l) x[l] = in[base + l];
  }
  poseidon_permute_group<T>(x, sh, k);
  if (tid < T) {
#pragma unroll
    for (int l = 0; l < 4; ++l) out[base + l] = x[l];
  }
}

template <int T>
static int launch(const void *in, void *out, long B,
                  const PoseidonGroupConsts &k, cudaStream_t s) {
  poseidon_permute_group_kernel<T><<<(unsigned)B, PG_THREADS(T), 0, s>>>(
      (const u64 *)in, (u64 *)out, k);
  return (int)cudaGetLastError();
}

extern "C" int poseidon_permute_group(const void *in, void *out, long B, int t,
                                      int rf, int rp, const void *mdsT,
                                      const void *rc_full, const void *rc_part,
                                      const void *qrow, const void *qcol,
                                      const void *mfinalT, void *stream) {
  PoseidonGroupConsts k{(const u64 *)mdsT, (const u64 *)rc_full,
                        (const u64 *)rc_part, (const u64 *)qrow,
                        (const u64 *)qcol, (const u64 *)mfinalT, rf, rp};
  if (B <= 0 || B > 0x7fffffffL || rp < 1 || (rf & 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (t) {
    case 33: return launch<33>(in, out, B, k, s);
    case 65: return launch<65>(in, out, B, k, s);
    case 129: return launch<129>(in, out, B, k, s);
  }
  return (int)cudaErrorInvalidValue;
}
