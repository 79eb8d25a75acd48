// K3 fr_fold: the m-ary FRI fold out[b] = sum_t f[b*m + t] * z^t over Fr.
//
// Replaces `fold_layer_dev` of the JAX package (fri/__init__.py), which ran
// as one `fr.mat_apply` with a z-power row: a constant-row contraction with
// a single Montgomery reduction per output.  Same idea here in 64-bit limbs:
// each thread accumulates its m products unreduced in a 576-bit accumulator
// and reduces once.  The z-powers arrive in plain Montgomery form; each block
// first scales them by 2^320 into shared memory (m multiplies per block), so
// the one extended REDC lands back in Montgomery form.  Bound: bytes
// (32*(m+1) per output against 16*m 64-bit multiply-adds).

#include <cuda_runtime.h>

#include "fr.cuh"

// 2^320 mod P, plain integer limbs: mont_mul(z^t * R, K) = z^t * 2^320.
__device__ __constant__ u64 FR_K320[4] = {
    0x8c46eb2100000001ULL, 0xf12aec780994a8d9ULL, 0x76e59c0fd9ad5c89ULL,
    0x3fffffffffffffffULL};

__global__ void __launch_bounds__(128)
fr_fold_kernel(const u64 *__restrict__ f, const u64 *__restrict__ zpow,
               u64 *__restrict__ out, long nout, int m) {
  extern __shared__ u64 zs[];  // m * 4
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    u64 z[4], k[4] = {FR_K320[0], FR_K320[1], FR_K320[2], FR_K320[3]};
    fr_load(zpow + t * 4, z);
    fr_mont_mul(z, k, zs + t * 4);
  }
  __syncthreads();
  long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nout) return;
  u64 acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  const u64 *src = f + b * m * 4;
  for (int t = 0; t < m; ++t) {
    u64 x[4];
    fr_load(src + t * 4, x);
    fr_acc_mul(zs + t * 4, x, acc);
  }
  u64 r[4];
  fr_redc320(acc, r);
  for (int l = 0; l < 4; ++l) out[b * 4 + l] = r[l];
}

extern "C" int fr_fold(const void *f, const void *zpow, void *out, long nout,
                       int m, void *stream) {
  if (nout <= 0 || m < 1 || m > 1024) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((nout + threads - 1) / threads);
  fr_fold_kernel<<<blocks, threads, (size_t)m * 32, (cudaStream_t)stream>>>(
      (const u64 *)f, (const u64 *)zpow, (u64 *)out, nout, m);
  return (int)cudaGetLastError();
}
