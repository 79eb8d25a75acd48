// fr_batch_inv: out[i] = phi[i] * (x[i] - z)^-1 over Fr, Montgomery form, z
// and phi optional: the DEEP-ALI f0 quotient phi / (w - z), and `fr.batch_inv`.
//
// Replaces the XLA-fused `batch_inv` (ops/fr.py:479: two associative scans
// and a device Fermat `inv`) and `_f0_quotient` (fri/deep_ali.py:67) of the
// JAX package; in the port it replaces a Python loop of ~830 one-element-
// per-thread K2 launches and a readback of the one remaining total.
//
// What bounds it on this card: not bytes (~10 MiB at n = 65,536, ~3 us) nor
// products (~4n, sub-us at the operations bound) but latency: one dependent
// Montgomery product takes ~909 cycles in one warp (scripts/fr32_latency.py),
// and the one inversion of the grand total is a chain of 296 of them on one
// thread (stage B).  The design (batch_inv.cuh) keeps every other chain
// short and the card full: stage A and C give each thread E consecutive
// elements (E = 1 at 65,536 elements: 512 blocks of 128 threads, about four
// warps per SM sub-partition) and combine a block's threads by two
// log2(T)-step scans side by side; stage B is one block over the G block
// totals, one Fermat inversion, and a sweep back.  Three launches on the
// caller's stream, scratch allocated by the caller, nothing synchronised.

#include <cuda_runtime.h>

#include "fr32.cuh"
#include "batch_inv.cuh"

__global__ void __launch_bounds__(BI_MAX_THREADS)
fr_batch_inv_scan(BiArgs a) {
  extern __shared__ u32 sh[];
  const int j = threadIdx.x;
  const long g = blockIdx.x;
  bi_scan_load(a, sh, g, j);
  __syncthreads();
  for (int s = 0; (1 << s) < a.T; ++s) {
    bi_scan_step(sh, a.T, s, j);
    __syncthreads();
  }
  bi_scan_store(a, sh, g, j);
}

__global__ void __launch_bounds__(BI_MAX_THREADS)
fr_batch_inv_total(BiArgs a) {
  extern __shared__ u32 sh[];
  const int j = threadIdx.x;
  bi_total_load(a, sh, j);
  __syncthreads();
  for (int s = 0; (1 << s) < a.TB; ++s) {
    bi_scan_step(sh, a.TB, s, j);
    __syncthreads();
  }
  if (j == 0) bi_total_invert(a, sh);
  __syncthreads();
  bi_total_store(a, sh, j);
}

__global__ void __launch_bounds__(BI_MAX_THREADS)
fr_batch_inv_sweep(BiArgs a) {
  bi_sweep(a, blockIdx.x, threadIdx.x);
}

// x, phi, out: [n] elements; z: one element; z and phi may be null.
// scratch: scratch_elems elements (at least `bi_scratch_elems`).  threads (T)
// and b_threads (TB): powers of two from 2 to 256; per_thread (E) >= 1.
// stages: a mask of the launches to make, 1 scan, 2 total, 4 sweep.  The
// wrappers pass 7 (all); chip_smoke.py passes 2 on one element to time the
// one Fermat inversion alone (its `serial_floor_ms`).
extern "C" int fr_batch_inv(const void *x, const void *z, const void *phi,
                            void *out, void *scratch, long scratch_elems,
                            long n, int threads, int per_thread,
                            int b_threads, int stages, void *stream) {
  BiArgs a;
  if (!bi_args((const u32 *)x, (const u32 *)z, (const u32 *)phi, (u32 *)out,
               (u32 *)scratch, scratch_elems, n, threads, per_thread,
               b_threads, &a) ||
      stages < 1 || stages > 7 || a.G > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)a.G;
  if (stages & 1)
    fr_batch_inv_scan<<<grid, a.T, bi_shared_words(a.T) * 4, s>>>(a);
  if (stages & 2)
    fr_batch_inv_total<<<1, a.TB, bi_shared_words(a.TB) * 4, s>>>(a);
  if (stages & 4) fr_batch_inv_sweep<<<grid, a.T, 0, s>>>(a);
  return (int)cudaGetLastError();
}
