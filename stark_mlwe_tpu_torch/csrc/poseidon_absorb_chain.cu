// K4 poseidon_absorb_chain: C independent sponge chains, each nb strictly
// sequential (add one rate block, permute) steps.
//
// Replaces BOTH chain kernels of the JAX package: `absorb_chain`
// (ops/poseidon_pallas.py; the state carried across sequential grid steps)
// and `absorb_chain_lanes` (ops/poseidon_chain.py; the same chain with the
// (chain, element) pairs across the lanes).  The two differ only in a layout
// of the other machine; here they are one kernel.  Blocks of a grid run in
// no order on this card, so the sequential grid dimension becomes a loop
// inside the block, and the state never leaves the block between steps.
//
// Design: one block per chain, one thread per state element, the
// permutation of `poseidon_group.cuh`.  The rate blocks are read straight
// from the stacked columns [C, n, 4] (chain c, rows off + b*rate ...): no
// transposed copy is made.  The element of block b+1 is loaded before block b
// permutes, so the load is hidden behind the permutation.  The kernel is
// bound by latency: nb * (rf + rp) dependent rounds on a handful of warps;
// what the design does about it is to cut the depth of a round (a row sum
// per thread in the full rounds, a tree sum in the partial rounds) - the
// card's other SMs stay idle, as the chain allows no more.

#include <cuda_runtime.h>

#include "poseidon_group.cuh"

template <int T>
__global__ void __launch_bounds__(PG_THREADS(T))
poseidon_absorb_chain_kernel(const u64 *__restrict__ state_in,
                             const u64 *__restrict__ cols,
                             u64 *__restrict__ state_out, long n, long off,
                             long nb, PoseidonGroupConsts k) {
  __shared__ u64 sh[PG_SHARED_U64(T)];
  constexpr int RATE = T - 1;
  const int tid = threadIdx.x;
  const long c = blockIdx.x;
  const bool on = tid < T, absorbs = tid < RATE;
  u64 x[4] = {0, 0, 0, 0};
  if (on) {
#pragma unroll
    for (int l = 0; l < 4; ++l) x[l] = state_in[(c * T + tid) * 4 + l];
  }
  const u64 *src = cols + (c * n + off + tid) * 4;
  u64 blk[4] = {0, 0, 0, 0};
  if (absorbs && nb > 0) fr_load(src, blk);
  for (long b = 0; b < nb; ++b) {
    if (absorbs) fr_add(x, blk, x);
    if (absorbs && b + 1 < nb) fr_load(src + (b + 1) * RATE * 4, blk);
    poseidon_permute_group<T>(x, sh, k);
  }
  if (on) {
#pragma unroll
    for (int l = 0; l < 4; ++l) state_out[(c * T + tid) * 4 + l] = x[l];
  }
}

template <int T>
static int launch(const void *state_in, const void *cols, void *state_out,
                  int C, long n, long off, long nb,
                  const PoseidonGroupConsts &k, cudaStream_t s) {
  poseidon_absorb_chain_kernel<T><<<(unsigned)C, PG_THREADS(T), 0, s>>>(
      (const u64 *)state_in, (const u64 *)cols, (u64 *)state_out, n, off, nb,
      k);
  return (int)cudaGetLastError();
}

// state_in, state_out: [C, t, 4]; cols: [C, n, 4]; absorbs rows
// off .. off + nb*(t-1) - 1 of every column.
extern "C" int poseidon_absorb_chain(const void *state_in, const void *cols,
                                     void *state_out, int C, long n, long off,
                                     long nb, int t, int rf, int rp,
                                     const void *mdsT, const void *rc_full,
                                     const void *rc_part, const void *qrow,
                                     const void *qcol, const void *mfinalT,
                                     void *stream) {
  PoseidonGroupConsts k{(const u64 *)mdsT, (const u64 *)rc_full,
                        (const u64 *)rc_part, (const u64 *)qrow,
                        (const u64 *)qcol, (const u64 *)mfinalT, rf, rp};
  if (C <= 0 || nb < 0 || off < 0 || off + nb * (t - 1) > n || rp < 1 ||
      (rf & 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (t) {
    case 9: return launch<9>(state_in, cols, state_out, C, n, off, nb, k, s);
    case 17: return launch<17>(state_in, cols, state_out, C, n, off, nb, k, s);
  }
  return (int)cudaErrorInvalidValue;
}
