// K2 fr_elementwise: out[i] = a[i] (*|+|-) b[i] over Fr, Montgomery form,
// either operand optionally one element broadcast over the batch.
//
// Replaces the XLA-fused `fr.mont_mul` / `fr.add` / `fr.sub` of the JAX
// package (ops/fr.py), which were limb-column graphs there; torch has no
// 256-bit modular arithmetic, and a limb-by-limb emulation costs hundreds of
// launches per multiply.  Bound: bytes (96 per element moved, ~130 64-bit
// multiply-adds for a multiply), so the design is one thread per element
// with 16-byte loads and nothing kept.

#include <cuda_runtime.h>

#include "fr.cuh"

FR_FN void fr_load_vec(const u64 *p, u64 *x) {
  const ulonglong2 *q = reinterpret_cast<const ulonglong2 *>(p);
  ulonglong2 lo = __ldg(q), hi = __ldg(q + 1);
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}

template <int OP>
__global__ void __launch_bounds__(256)
fr_elementwise_kernel(const u64 *__restrict__ a, const u64 *__restrict__ b,
                      u64 *__restrict__ out, long n, int a_step, int b_step) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 x[4], y[4], r[4];
  fr_load_vec(a + i * 4 * a_step, x);
  fr_load_vec(b + i * 4 * b_step, y);
  if (OP == 0) fr_mont_mul(x, y, r);
  else if (OP == 1) fr_add(x, y, r);
  else fr_sub(x, y, r);
  ulonglong2 *o = reinterpret_cast<ulonglong2 *>(out + i * 4);
  o[0] = make_ulonglong2(r[0], r[1]);
  o[1] = make_ulonglong2(r[2], r[3]);
}

// op: 0 mont_mul, 1 add, 2 sub.  a_step / b_step: 1 for a full [n] operand,
// 0 for one broadcast element.
extern "C" int fr_elementwise(int op, const void *a, const void *b, void *out,
                              long n, int a_step, int b_step, void *stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const u64 *pa = (const u64 *)a, *pb = (const u64 *)b;
  u64 *po = (u64 *)out;
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
