// K1 poseidon_permute: batched Poseidon permutation, widths t = 17 and t = 9.
//
// Replaces the Pallas kernel `_permute_tiles` (ops/poseidon_pallas.py of the
// JAX package).  What it keeps of that kernel is WHAT it computes and that a
// state never leaves the chip between rounds; what it drops is everything
// shaped by the other machine (nibble planes for the matrix unit, the
// batch-last tiling): here the card has a native 64x64->128 multiply, so an
// element is four 64-bit limbs and a row sum is a 576-bit accumulator.
//
// Design (first version, right before fast): one thread per state, the state
// and its scratch in thread-local memory, constants read through the
// read-only cache (every thread of a warp reads the same address, so a load
// is a broadcast).  Each state is read once and written once (64*t bytes in
// all), against ~1e5 64-bit multiply-adds per state, so the kernel is bound
// by integer operations, not bytes; the sparse partial rounds cut those
// operations about five-fold against a dense matrix every round.  A warp per
// block spreads small batches (tree tops) over many SMs.

#include <cuda_runtime.h>

#include "poseidon.cuh"

template <int T>
__global__ void __launch_bounds__(32)
poseidon_permute_kernel(const u64 *__restrict__ in, u64 *__restrict__ out,
                        long B, PoseidonConsts k) {
  long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  u64 cur[T * 4], nxt[T * 4];
  const u64 *src = in + b * T * 4;
  for (int i = 0; i < T * 4; ++i) cur[i] = src[i];
  poseidon_permute_one<T>(cur, nxt, k);
  u64 *dst = out + b * T * 4;
  for (int i = 0; i < T * 4; ++i) dst[i] = cur[i];
}

extern "C" int poseidon_permute(const void *in, void *out, long B, int t,
                                int rf, int rp, const void *mds,
                                const void *rc_full, const void *rc_part,
                                const void *qrow, const void *qcol,
                                const void *mfinal, void *stream) {
  PoseidonConsts k{(const u64 *)mds,  (const u64 *)rc_full,
                   (const u64 *)rc_part, (const u64 *)qrow,
                   (const u64 *)qcol, (const u64 *)mfinal, rf, rp};
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (t == 17)
    poseidon_permute_kernel<17><<<blocks, threads, 0, s>>>(
        (const u64 *)in, (u64 *)out, B, k);
  else if (t == 9)
    poseidon_permute_kernel<9><<<blocks, threads, 0, s>>>(
        (const u64 *)in, (u64 *)out, B, k);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
