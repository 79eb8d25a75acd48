// K3 fr_fold: the m-ary FRI fold out[b] = sum_t f[b*m + t] * z^t over Fr.
//
// Replaces `fold_layer_dev` of the JAX package (fri/__init__.py), which ran
// as one `fr.mat_apply` with a z-power row: a constant-row contraction with
// a single Montgomery reduction per output.  Same idea here on `fr32.cuh`,
// in the steps of `fold.cuh`.
//
// What bounds it on this card: neither bytes (32 (m + 1) per output, 2.2 MB
// at n = 65,536, m = 16: under a microsecond) nor products, but latency: a
// thread per output would run m dependent lazy products, and at the
// prover's n = 65,536, m = 16 that is 4,096 threads in 32 blocks on 32 of
// the 132 SMs.  So an output is spread over a group of G = min(m, 32) lanes
// (`fold_lanes`) that each take m/G terms and meet in a log2 G-step shuffle
// tree: at m = 16 that is 65,536 threads in 512 blocks of 128, one product
// each before the tree.  The z-powers are scaled by 2^320 per block, one
// product for each of the block's first m threads, so the one reduction of
// an output lands in Montgomery form.

#include <cuda_runtime.h>

#include "fold.cuh"

__global__ void __launch_bounds__(FOLD_THREADS)
fr_fold_kernel(const u32 *__restrict__ f, const u32 *__restrict__ zpow,
               u32 *__restrict__ out, long nout, int m) {
  extern __shared__ u32 zs[];  // m * 8
  fold_scale(zpow, m, zs, threadIdx.x, blockDim.x);
  __syncthreads();
  const FoldWarp e{(int)(threadIdx.x & 31)};
  fold_warp(f, zs, out, nout, m,
            fold_first(blockIdx.x, threadIdx.x >> 5, m), e);
}

extern "C" int fr_fold(const void *f, const void *zpow, void *out, long nout,
                       int m, void *stream) {
  if (nout <= 0 || m < 1 || m > FOLD_MAX_M) return (int)cudaErrorInvalidValue;
  const long blocks = fold_blocks(nout, m);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  fr_fold_kernel<<<(unsigned)blocks, FOLD_THREADS, (size_t)m * 32,
                   (cudaStream_t)stream>>>(
      (const u32 *)f, (const u32 *)zpow, (u32 *)out, nout, m);
  return (int)cudaGetLastError();
}
