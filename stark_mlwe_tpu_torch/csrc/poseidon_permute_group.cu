// K5 poseidon_permute_group: batched Poseidon permutation at the wide widths
// t = 33, 65 and 129 (Merkle trees of arity 32, 64 and 128).
//
// Replaces the Pallas kernels `_permute_tiles` with its dense body at t = 33
// and t = 65 (ops/poseidon_pallas.py of the JAX package) and
// `_permute_tiles_wide` at t = 129 (ops/poseidon_wide.py).  Of those it keeps
// WHAT they compute; their lane-major tiles and nibble planes are shaped by
// the other machine and are not carried over.
//
// What bounds it: integer operations, not bytes (a state is read once and
// written once, 64*t bytes, against ~4e6 32-bit multiply-adds at t = 129);
// at the prover's batches, mostly tree levels of 1 to 2,048 states, also the
// latency of one permutation.  The design (`poseidon_group.cuh`, on the
// carry-chain arithmetic of `fr32.cuh`) answers both with one routine in
// layouts (S, K, C) that `ops/poseidon.py` `group_layout` picks by the batch:
//   - a block holds S states, its lanes packed across them (S T K threads
//     rounded up to whole warps once): no warp holds a lone capacity element
//     as a block per state does (33 of 64 lanes busy at t = 33);
//   - the dense matrices stream through shared memory in double-buffered
//     tiles fetched by `cp.async`, one pass feeding the S states;
//   - at small batches K threads split each dense row sum and add their
//     unreduced sums by shuffles, so a thread's chain is T / K products;
//   - at t = 65 and 129 a small batch also spreads each state over a
//     cluster of C blocks on C SMs, the rows written into every block's
//     shared memory, since the dense products of one state fill one SM's
//     issue.
// The dynamic shared memory of a layout (up to ~176 KB) is set for the kernel
// at each launch; a refusal comes back as the launch's error.

#include <cuda_runtime.h>

#include "poseidon_group.cuh"

template <int T, int S, int K, int C>
__global__ void __launch_bounds__(PgShape<T, S, K, C>::THREADS, 1)
poseidon_permute_group_kernel(const u32 *__restrict__ in,
                              u32 *__restrict__ out, long B, ChainConsts k) {
  using G = PgShape<T, S, K, C>;
  extern __shared__ __align__(16) u32 pg_shared[];
  const PgThread<C> e{(int)threadIdx.x};
  int s, row, kp;
  const bool on = pg_row<G>(e.g, e.rank(0), s, row, kp);
  const long b = (long)(blockIdx.x / C) * S + s;
  const bool mine = on && b < B;
  u32 x[1][8] = {{0, 0, 0, 0, 0, 0, 0, 0}};
  if (mine) fr32_load(in + (b * T + row) * 8, x[0]);
  poseidon_permute_group<G>(x, e, k, pg_shared);
  if (mine && kp == 0) {
#pragma unroll
    for (int l = 0; l < 8; ++l) out[(b * T + row) * 8 + l] = x[0][l];
  }
}

// One launch: the layout's dynamic shared memory set for the kernel (a size
// the card refuses comes back as the error), C blocks a cluster.
template <int T, int S, int K, int C>
static int launch(const void *in, void *out, long B, const ChainConsts &k,
                  cudaStream_t st) {
  using G = PgShape<T, S, K, C>;
  const auto kernel = poseidon_permute_group_kernel<T, S, K, C>;
  const int bytes = G::WORDS * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((B + S - 1) / S * C));
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, (const u32 *)in, (u32 *)out, B, k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// in, out: [B, t, 8]; the constants of `DeviceParams.group_consts` (dense
// matrices transposed); (S, K, C) one of PG_LAYOUTS at width t.
extern "C" int poseidon_permute_group(const void *in, void *out, long B, int t,
                                      int S, int K, int C, int rf, int rp,
                                      const void *mdsT, const void *rc_full,
                                      const void *rc_part, const void *qrow,
                                      const void *qcol, const void *mfinalT,
                                      void *stream) {
  ChainConsts k{(const u32 *)mdsT,    (const u32 *)rc_full,
                (const u32 *)rc_part, (const u32 *)qrow,
                (const u32 *)qcol,    (const u32 *)mfinalT, rf, rp};
  if (B <= 0 || S < 1 || C < 1 || (B + S - 1) / S * C > 0x7fffffffL ||
      rp < 1 || (rf & 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PG_LAUNCH(TT, SS, KK, CC)                  \
  if (t == TT && S == SS && K == KK && C == CC)    \
    return launch<TT, SS, KK, CC>(in, out, B, k, st);
  PG_LAYOUTS(PG_LAUNCH)
#undef PG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Threads and dynamic shared bytes of a layout; 1 if it is not built.
extern "C" int poseidon_permute_group_shape(int t, int S, int K, int C,
                                            int *threads, int *bytes) {
  return pg_shape(t, S, K, C, threads, bytes);
}
