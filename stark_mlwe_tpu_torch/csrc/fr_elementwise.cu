// K2 fr_elementwise: out[i] = a[i] (*|+|-) b[i] over Fr, Montgomery form,
// either operand optionally one element broadcast over the batch.
//
// Replaces the XLA-fused `fr.mont_mul` / `fr.add` / `fr.sub` of the JAX
// package (ops/fr.py), which were limb-column graphs there; torch has no
// 256-bit modular arithmetic, and a limb-by-limb emulation costs hundreds of
// launches per multiply.  Bound: bytes (96 per element moved against one
// Montgomery product of 8x32-bit limbs), so the design is one thread per
// element with 16-byte loads and nothing kept; the element is `fr32.cuh`'s
// `fr32_binop`, the routine `host_check.cpp` runs under g++.

#include <cuda_runtime.h>

#include "fr32.cuh"

template <int OP>
__global__ void __launch_bounds__(256)
fr_elementwise_kernel(const u32 *__restrict__ a, const u32 *__restrict__ b,
                      u32 *__restrict__ out, long n, int a_step, int b_step) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 x[8], y[8], r[8];
  fr32_load_vec(a + i * 8 * a_step, x);
  fr32_load_vec(b + i * 8 * b_step, y);
  fr32_binop<OP>(x, y, r);
  fr32_store_vec(out + i * 8, r);
}

// op: 0 mont_mul, 1 add, 2 sub.  a_step / b_step: 1 for a full [n] operand,
// 0 for one broadcast element.
extern "C" int fr_elementwise(int op, const void *a, const void *b, void *out,
                              long n, int a_step, int b_step, void *stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const u32 *pa = (const u32 *)a, *pb = (const u32 *)b;
  u32 *po = (u32 *)out;
  if (op == 0)
    fr_elementwise_kernel<0><<<blocks, threads, 0, s>>>(pa, pb, po, n, a_step, b_step);
  else if (op == 1)
    fr_elementwise_kernel<1><<<blocks, threads, 0, s>>>(pa, pb, po, n, a_step, b_step);
  else if (op == 2)
    fr_elementwise_kernel<2><<<blocks, threads, 0, s>>>(pa, pb, po, n, a_step, b_step);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
