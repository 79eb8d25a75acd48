// Latency of one field product on the card, for `scripts/fr32_latency.py`.
//
// One warp runs `iters` iterations of CHAINS independent dependent chains
// x_c <- x_c * y (Montgomery, fully reduced) and reads the SM clock around
// the loop.  With one chain the cycles per iteration are the latency of a
// product; with two, they show whether two independent products overlap
// (about the same cycles) or run one after the other (about twice).
// Variants:
//   0  fr32_mont_mul<true>   csrc/fr32.cuh: 32-bit limbs, PTX carry chains
//   1  u64_cios_mul          below: 32-bit limbs, 64-bit intermediates in
//                            plain C (the compiler allocates the carries)
//   2  fr32_acc_mul          csrc/fr32.cuh: one lazy product added into a
//                            17-limb row sum (the chain runs through the sum)
// Not part of the port: a measuring tool, built by the script that runs it.

#include <cuda_runtime.h>

#include "../stark_mlwe_tpu_torch/csrc/fr32.cuh"

// CIOS on 32-bit words with 64-bit intermediates: out = a*b*2^-256 mod P.
__device__ __forceinline__ void u64_cios_mul(const u32 *a, const u32 *b,
                                             u32 *out) {
  u32 t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      u64 s = (u64)a[i] * b[j] + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[8] + c;
    t[8] = (u32)s;
    t[9] = (u32)(s >> 32);
    const u32 m = t[0] * FR32_N0INV;
    c = ((u64)m * fr32_p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (u64)m * fr32_p(j) + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[8] + c;
    t[7] = (u32)s;
    t[8] = t[9] + (u32)(s >> 32);
    t[9] = 0;
  }
  fr32_reduce_once(t, out);
}

template <int V>
__device__ __forceinline__ void step(u32 *x, const u32 *y, u32 *acc) {
  if (V == 0) fr32_mont_mul<true>(x, y, x);
  if (V == 1) u64_cios_mul(x, y, x);
  if (V == 2) {
    fr32_acc_mul(x, y, acc);
    x[0] ^= acc[16];  // the next product waits for this one's sum
  }
}

template <int V, int CHAINS>
__global__ void __launch_bounds__(32)
latency_kernel(const u32 *in, u32 *out, long iters, long long *cycles) {
  const int lane = threadIdx.x;
  u32 x[CHAINS][8], y[8], acc[CHAINS][FR32_ACC];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    fr32_load(in + (lane * 3 + c) * 8, x[c]);
#pragma unroll
    for (int l = 0; l < FR32_ACC; ++l) acc[c][l] = 0;
  }
  fr32_load(in + (lane * 3 + 2) * 8, y);
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 1
  for (long it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) step<V>(x[c], y, acc[c]);
  }
  const long long t1 = clock64();
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
#pragma unroll
    for (int l = 0; l < 8; ++l)
      out[(lane * 2 + c) * 8 + l] = x[c][l] ^ (V == 2 ? acc[c][l] : 0u);
  }
  if (lane == 0) cycles[0] = t1 - t0;
}

// in: 96 elements (x0, x1, y for each lane); out: 64 elements.
extern "C" int fr32_latency(int variant, int chains, const void *in,
                            void *out, long iters, void *cycles) {
  const u32 *i = (const u32 *)in;
  u32 *o = (u32 *)out;
  long long *c = (long long *)cycles;
#define LAUNCH(V, C) latency_kernel<V, C><<<1, 32>>>(i, o, iters, c)
  switch (variant * 4 + chains) {
    case 1: LAUNCH(0, 1); break;
    case 2: LAUNCH(0, 2); break;
    case 5: LAUNCH(1, 1); break;
    case 6: LAUNCH(1, 2); break;
    case 9: LAUNCH(2, 1); break;
    case 10: LAUNCH(2, 2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
