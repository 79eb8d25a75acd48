// K6 fr_ntt_tiles: B independent radix-2 decimation-in-time NTTs of length
// L = 2^logL over Fr (2 <= L <= 4096), each followed by an optional
// elementwise product with an epilogue table.
//
// Replaces the Pallas kernel `_ntt_tiles` (ops/ntt_pallas.py of the JAX
// package, body `_ntt_kernel`).  It keeps WHAT that kernel computes - every
// butterfly stage of a transform in fast memory, one launch, the four-step
// twiddle fused behind the last stage - and none of its shape: the batch-last
// [L, 16, 128] lane tiles, the gather that bit-reverses the input before the
// launch and the two transposes around every level of the four-step recursion
// exist there because that machine needs the batch in its lane dimension.
//
// Design: a block of 256 threads owns whole transforms in shared memory
// (`ntt.cuh`): one of L >= 1024, or 1024/L shorter ones.  It reads their
// elements where they lie - element stride and per-level batch strides are
// arguments, so a transform may be a column of a matrix - placing element i
// in slot bitrev(i); runs the log2 L stages there with one block barrier
// each; multiplies by the epilogue entry and writes with strides of its own.
// An element is 32 bytes, one DRAM sector, so a strided access wastes no
// memory traffic.  The stage twiddles w_L^j (L/2 elements, at most 64 KB) are
// read through the read-only path and stay in L1/L2.
//
// Bound: each element is read once and written once (64 bytes) against
// (log2 L)/2 + 1 Montgomery products of 36 64-bit multiply-adds, so the
// kernel is bound by integer operations from L = 4 on.  Shared memory holds
// elements as 4 x 64-bit words side by side, so at power-of-two strides the
// accesses of a warp fall on few banks; a layout against that is left to a
// later change.

#include <cuda_runtime.h>

#include "ntt.cuh"

#define NTT_THREADS 256
#define NTT_MAX_LOG_L 12

__global__ void __launch_bounds__(NTT_THREADS)
fr_ntt_tiles_kernel(const NttTileArgs a) {
  extern __shared__ __align__(16) u64 sh[];
  long *offs = (long *)(sh + ((size_t)a.tpb << a.logL) * 4);
  const unsigned tid = threadIdx.x, nthreads = blockDim.x;
  const long first = (long)blockIdx.x * a.tpb;
  const long left = a.B - first;
  const int nvalid = left < a.tpb ? (int)left : a.tpb;

  ntt_offsets_thread(a, first, nvalid, offs, tid, nthreads);
  __syncthreads();
  ntt_load_thread(a, nvalid, sh, offs, tid, nthreads);
  __syncthreads();
  for (int s = 0; s < a.logL; ++s) {
    ntt_stage_thread(a, nvalid, sh, s, tid, nthreads);
    __syncthreads();
  }
  ntt_store_thread(a, nvalid, sh, offs, tid, nthreads);
}

// Strides are in elements of 32 bytes.  `cnt`, `in_bs`, `out_bs` are host
// arrays of `nlev` entries, innermost level first.
extern "C" int fr_ntt_tiles(const void *in, void *out, const void *wt,
                            const void *ep, long B, int logL, int tpb,
                            long in_es, long out_es, long ep_period, int nlev,
                            const long *cnt, const long *in_bs,
                            const long *out_bs, void *stream) {
  if (B <= 0 || logL < 1 || logL > NTT_MAX_LOG_L || tpb < 1 || nlev < 1 ||
      nlev > NTT_MAX_LEVELS || (ep != nullptr && ep_period < 1))
    return (int)cudaErrorInvalidValue;
  const long blocks = (B + tpb - 1) / tpb;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  NttTileArgs a;
  a.in = (const u64 *)in;
  a.out = (u64 *)out;
  a.wt = (const u64 *)wt;
  a.ep = (const u64 *)ep;
  a.B = B;
  a.logL = logL;
  a.tpb = tpb;
  a.in_es = in_es;
  a.out_es = out_es;
  a.ep_period = ep_period;
  a.nlev = nlev;
  for (int k = 0; k < NTT_MAX_LEVELS; ++k) {
    a.cnt[k] = k < nlev ? cnt[k] : 1;
    a.in_bs[k] = k < nlev ? in_bs[k] : 0;
    a.out_bs[k] = k < nlev ? out_bs[k] : 0;
  }
  const size_t shared = ntt_shared_bytes(logL, tpb);
  // More than 48 KB of dynamic shared memory has to be asked for, once.
  static size_t allowed = 48 * 1024;
  if (shared > allowed) {
    cudaError_t rc = cudaFuncSetAttribute(
        fr_ntt_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (rc != cudaSuccess) return (int)rc;
    allowed = shared;
  }
  fr_ntt_tiles_kernel<<<(unsigned)blocks, NTT_THREADS, shared,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
