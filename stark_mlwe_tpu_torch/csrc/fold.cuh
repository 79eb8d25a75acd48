// The m-ary FRI fold of K3 `fr_fold` on `fr32.cuh`, written as per-thread
// steps:
//
//   out[b] = sum_t f[b*m + t] * z^t      (Montgomery form, 1 <= m <= 1024)
//
// A block of FOLD_THREADS threads gives each output a group of G lanes of
// one warp (`fold_lanes`: the power of two at or below min(m, 32)), so a
// warp holds 32/G outputs and lane j of a group takes the terms t = j,
// j + G, ... below m.
//
//   scale  each thread scales its share of the m z-powers by 2^320 into
//          shared memory (z^t R -> z^t 2^320 by one Montgomery product with
//          2^320 mod P), then one block barrier
//   fold   each lane adds its terms' 512-bit products unreduced into a
//          17-limb sum (`fr32_acc_mul`); log2 G xor-shuffle steps add the
//          group's sums (`fr32_acc_add`); the group's lane 0 reduces once
//          with `fr32_redc320` and stores.  The 2^320 of the z-powers
//          cancels the reduction's 2^-320, so the result is in Montgomery
//          form.
//
// The REDC's input range: every product is of two canonical values, so the
// sum of an output's m products is below m P^2 < 2^10 * 2^510 = 2^520, which
// 17 limbs (544 bits) hold with room; and m P < 2^10 * 2^255 < 2^320 for
// every m the entry point takes (at most 1,024), so the sum is below
// 2^320 P, `fr32_redc320`'s bound, and its result below 2P is brought below P
// by its own final subtraction.  The prove paths fold by 8, 16, 32, 64 and
// 128.
//
// The fold step is written once for both compilers over an exchange policy
// E, as `poseidon_chain.cuh`'s warp routine: a thread runs E::N lane slots,
// slot i being lane e.lane(i) of the warp, and the shuffle tree goes through
// E::xor_swap.  On the card (`FoldWarp`) a thread is one lane and the swap is
// `__shfl_xor_sync`; `host_check.cpp` runs the 32 lanes of each warp in one
// thread (`PcLanes`), reading the other lanes' slots, so Tier-1 replays the
// kernel's own tree step by step.  Lanes whose output lies past the end add
// nothing and keep the shuffles company.

#pragma once

#include "fr32.cuh"

#ifdef __CUDACC__
#define FOLD_HD __host__ __device__ inline
#else
#define FOLD_HD static inline
#endif

#define FOLD_THREADS 128
#define FOLD_MAX_M 1024

// 2^320 mod P, plain integer limbs: fr32_mont_mul(z^t R, K) = z^t 2^320.
FR32_FN u32 fold_k320(int j) {
  return j == 0   ? 0x00000001u
         : j == 1 ? 0x8c46eb21u
         : j == 2 ? 0x0994a8d9u
         : j == 3 ? 0xf12aec78u
         : j == 4 ? 0xd9ad5c89u
         : j == 5 ? 0x76e59c0fu
         : j == 6 ? 0xffffffffu
                  : 0x3fffffffu;
}

// Lanes an output: the power of two at or below min(m, 32).
FOLD_HD int fold_lanes(int m) {
  int g = 1;
  while (2 * g <= m && g < 32) g *= 2;
  return g;
}

// Blocks of the grid for nout outputs.
FOLD_HD long fold_blocks(long nout, int m) {
  const long per_block = FOLD_THREADS / fold_lanes(m);
  return (nout + per_block - 1) / per_block;
}

// Step scale, thread `tid` of `nthreads`: zs[t] = z^t 2^320 for its t.
FR32_FN void fold_scale(const u32 *zpow, int m, u32 *zs, int tid,
                        int nthreads) {
  u32 k[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) k[j] = fold_k320(j);
  for (int t = tid; t < m; t += nthreads) {
    u32 z[8];
    fr32_load_vec(zpow + (long)t * 8, z);
    fr32_mont_mul<true>(z, k, zs + (long)t * 8);
  }
}

#ifdef __CUDACC__
// The card's policy: the warp's 32 threads are the lanes.
struct FoldWarp {
  static constexpr int N = 1;
  int l;
  __device__ int lane(int) const { return l; }
  __device__ static void xor_swap(u32 (*v)[FR32_ACC], int d,
                                  u32 (*o)[FR32_ACC]) {
#pragma unroll
    for (int w = 0; w < FR32_ACC; ++w)
      o[0][w] = __shfl_xor_sync(0xffffffffu, v[0][w], d);
  }
};
#endif

// Step fold for one warp whose lane 0 starts output `first`: each slot's
// lane sum, the group's shuffle tree, lane 0's one reduction and store.
// zs lies in shared memory (read by plain loads).
template <class E>
FR32_FN void fold_warp(const u32 *f, const u32 *zs, u32 *out, long nout,
                       int m, long first, const E &e) {
  const int G = fold_lanes(m);
  u32 acc[E::N][FR32_ACC];
#pragma unroll
  for (int i = 0; i < E::N; ++i) {
    const int lane = e.lane(i), j = lane & (G - 1);
    const long b = first + lane / G;
#pragma unroll
    for (int l = 0; l < FR32_ACC; ++l) acc[i][l] = 0;
    if (b < nout) {
#pragma unroll 1
      for (int t = j; t < m; t += G) {
        u32 x[8], z[8];
        fr32_load_vec(f + (b * m + t) * 8, x);
#pragma unroll
        for (int l = 0; l < 8; ++l) z[l] = zs[t * 8 + l];
        fr32_acc_mul(z, x, acc[i]);
      }
    }
  }
#pragma unroll 1
  for (int d = G / 2; d >= 1; d >>= 1) {
    u32 o[E::N][FR32_ACC];
    E::xor_swap(acc, d, o);
#pragma unroll
    for (int i = 0; i < E::N; ++i) fr32_acc_add(acc[i], o[i]);
  }
#pragma unroll
  for (int i = 0; i < E::N; ++i) {
    const int lane = e.lane(i);
    const long b = first + lane / G;
    if ((lane & (G - 1)) == 0 && b < nout) {
      u32 r[8];
      fr32_redc320(acc[i], r);
      fr32_store_vec(out + b * 8, r);
    }
  }
}

// The output that lane 0 of warp `w` of block `blk` starts.
FOLD_HD long fold_first(long blk, int w, int m) {
  return (blk * FOLD_THREADS + (long)w * 32) / fold_lanes(m);
}
