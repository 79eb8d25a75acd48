// K4 poseidon_absorb_chain: C independent sponge chains, each nb strictly
// sequential (add one rate block, permute) steps.
//
// Replaces BOTH chain kernels of the JAX package: `absorb_chain`
// (ops/poseidon_pallas.py; the state carried across sequential grid steps)
// and `absorb_chain_lanes` (ops/poseidon_chain.py; the same chain with the
// (chain, element) pairs across the lanes).  The two differ only in a layout
// of the other machine; here they are one kernel.  Blocks of a grid run in
// no order on this card, so the sequential grid dimension becomes a loop
// inside the block, and the state never leaves the block's registers.
//
// What bounds it: one warp's instruction stream.  A chain allows no
// parallelism beyond its t elements, and the prover's chains are C = 4, so
// the card runs four warps and the time is nb times one permutation of one
// warp.  Measured on an H100 (`scripts/fr32_latency.py`), one warp overlaps
// no independent work: two independent field products take twice as long as
// one, so a permutation costs the sum of the instructions its warp issues,
// mostly 32-bit multiplies.  What the design does about it
// (`poseidon_chain.cuh`, `fr32.cuh`): one warp per chain with the state in
// registers and every exchange a shuffle (no shared memory, no barrier);
// field products as 32-bit PTX carry chains, the width of the card's integer
// multiplier, about two thirds of the time of the 64-bit compare-based ones;
// and the partial rounds' row dot formed beside lane 0's S-box, which leaves
// lane 0's dependent path at the S-box, one product and one reduction (on
// this card the warp still issues both).
//
// The rate blocks are read straight from the stacked columns [C, n, 8]
// (chain c, rows off + b*rate ...): no transposed copy is made.  Lane i loads
// its element of block b+1 before block b permutes, so the load is hidden
// behind the permutation.

#include <cuda_runtime.h>

#include "poseidon_chain.cuh"

template <int T>
__global__ void __launch_bounds__(32)
poseidon_absorb_chain_kernel(const u32 *__restrict__ state_in,
                             const u32 *__restrict__ cols,
                             u32 *__restrict__ state_out, long n, long off,
                             long nb, ChainConsts k) {
  constexpr int RATE = T - 1;
  const int lane = threadIdx.x;
  const PcWarp e{lane};
  const long c = blockIdx.x;
  u32 x[1][8] = {{0, 0, 0, 0, 0, 0, 0, 0}};
  if (lane < T) fr32_load(state_in + (c * T + lane) * 8, x[0]);
  const u32 *src = cols + (c * n + off + lane) * 8;
  u32 blk[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (lane < RATE && nb > 0) fr32_load(src, blk);
#pragma unroll 1
  for (long b = 0; b < nb; ++b) {
    if (lane < RATE) fr32_add(x[0], blk, x[0]);
    if (lane < RATE && b + 1 < nb) fr32_load(src + (b + 1) * RATE * 8, blk);
    poseidon_permute_warp<T>(x, e, k);
  }
  if (lane < T) {
#pragma unroll
    for (int l = 0; l < 8; ++l) state_out[(c * T + lane) * 8 + l] = x[0][l];
  }
}

template <int T>
static int launch(const void *state_in, const void *cols, void *state_out,
                  int C, long n, long off, long nb, const ChainConsts &k,
                  cudaStream_t s) {
  poseidon_absorb_chain_kernel<T><<<(unsigned)C, 32, 0, s>>>(
      (const u32 *)state_in, (const u32 *)cols, (u32 *)state_out, n, off, nb,
      k);
  return (int)cudaGetLastError();
}

// state_in, state_out: [C, t, 8]; cols: [C, n, 8]; absorbs rows
// off .. off + nb*(t-1) - 1 of every column.  The constants are those of
// `DeviceParams.group_consts` (dense matrices transposed).
extern "C" int poseidon_absorb_chain(const void *state_in, const void *cols,
                                     void *state_out, int C, long n, long off,
                                     long nb, int t, int rf, int rp,
                                     const void *mdsT, const void *rc_full,
                                     const void *rc_part, const void *qrow,
                                     const void *qcol, const void *mfinalT,
                                     void *stream) {
  ChainConsts k{(const u32 *)mdsT, (const u32 *)rc_full,
                (const u32 *)rc_part, (const u32 *)qrow,
                (const u32 *)qcol, (const u32 *)mfinalT, rf, rp};
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
