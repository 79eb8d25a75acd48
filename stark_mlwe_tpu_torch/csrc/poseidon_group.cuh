// One Poseidon x^5 permutation held by a GROUP of threads: thread i owns
// state element i, the state is published through shared memory.
//
// This is the layout of K5 `poseidon_permute_group` (widths 33, 65, 129: a
// state plus scratch no longer fits one thread).  K4 `poseidon_absorb_chain`
// no longer uses it: the chain kernel holds a state in one warp's registers
// (`poseidon_chain.cuh`, on the 32-bit arithmetic of `fr32.cuh`).  Same rounds, same sparse partial rounds, same
// lazy row sums with ONE 2^320 reduction per output as `poseidon.cuh`, so
// the result is bit-identical to K1 `poseidon_permute` and to the host engine.
//
// Per round:
//   full     every thread adds its round constant and takes its own x^5,
//            publishes the element, ONE block barrier, then forms its own
//            row of the MDS product from the shared state.
//   partial  the owner of element 0 takes the S-box.  The t-term row dot is
//            a PRODUCT PER THREAD AND A TREE SUM of the unreduced
//            accumulators (not thread 0's loop: at t = 129 that loop would be
//            2,064 dependent multiplies with 128 threads idle): a butterfly
//            of warp shuffles inside each warp, the warp totals through
//            shared memory, one block barrier, then thread 0 adds the totals
//            and reduces once while every other thread does its single
//            `qcol` multiply-add.  An integer sum without reduction is exact
//            in any order, so the tree changes no bit.
// The block is launched with a whole number of warps (PG_THREADS), so every
// lane of a full-mask shuffle exists; threads at or beyond T hold zero and
// only keep the barriers and shuffles company.  Shared buffers alternate by
// parity, which is why one barrier per round is enough.
//
// Constants: the packs of `native.pack_params`, with the two dense matrices
// TRANSPOSED (`mdsT[j][i] = mds[i][j]`): at step j of a row sum the threads
// of a warp then read neighbouring 32-byte elements (one 1 KB line per warp)
// instead of addresses a whole row apart.  At t = 129 a matrix is 532 KB, so
// it is read from global memory through L2; `qrow`, `qcol` and `rc_full` are
// indexed by the thread and coalesce as they are.
//
// The per-thread steps (`pg_*`) are plain functions of a thread index, so
// `host_check.cpp` replays the same steps in a loop over "threads" with g++;
// the barriers and shuffles themselves exist only on the card.

#pragma once

#include "fr.cuh"

struct PoseidonGroupConsts {
  const u64 *mdsT;     // t*t*4, transposed, 2^320-scaled
  const u64 *rc_full;  // rf*t*4
  const u64 *rc_part;  // rp*4
  const u64 *qrow;     // (rp-1)*t*4, 2^320-scaled
  const u64 *qcol;     // (rp-1)*(t-1)*4
  const u64 *mfinalT;  // t*t*4, transposed, 2^320-scaled
  int rf;
  int rp;
};

#define PG_WARPS(T) (((T) + 31) / 32)
#define PG_THREADS(T) (32 * PG_WARPS(T))
// u64 words of shared scratch: two state buffers, two sets of warp totals,
// two copies of the S-box output.
#define PG_SHARED_U64(T) (2 * (T) * 4 + 2 * PG_WARPS(T) * 9 + 2 * 4)

// x <- (x + rc)^5
FR_FN void pg_ark_sbox(const u64 *rc, u64 *x) {
  u64 c[4];
  fr_load(rc, c);
  fr_add(x, c, x);
  fr_pow5(x);
}

// out = sum_j mT[j][i] * st[j]: row i of the dense product, one reduction.
template <int T>
FR_FN void pg_row_dot(const u64 *mT, int i, const u64 *st, u64 *out) {
  u64 acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int j = 0; j < T; ++j) {
    u64 c[4];
    fr_load(mT + ((long)j * T + i) * 4, c);
    fr_acc_mul(c, st + j * 4, acc);
  }
  fr_redc320(acc, out);
}

// acc = q * x, unreduced (the thread's term of the sparse row dot).
FR_FN void pg_product(const u64 *q, const u64 *x, u64 *acc /*9*/) {
  u64 c[4];
  fr_load(q, c);
#pragma unroll
  for (int l = 0; l < 9; ++l) acc[l] = 0;
  fr_acc_mul(c, x, acc);
}

// acc += o over 9 limbs (a sum of at most 2^60 products cannot carry out).
FR_FN void pg_acc_add(u64 *acc, const u64 *o) {
  u64 carry = 0;
#pragma unroll
  for (int l = 0; l < 9; ++l) {
    u64 s = acc[l] + o[l];
    u64 c1 = (u64)(s < o[l]);
    u64 s2 = s + carry;
    u64 c2 = (u64)(s2 < s);
    acc[l] = s2;
    carry = c1 | c2;
  }
}

// x <- x + qc * s0 (the sparse column update of elements 1..t-1).
FR_FN void pg_col_update(const u64 *qc, const u64 *s0, u64 *x) {
  u64 c[4], tmp[4];
  fr_load(qc, c);
  fr_mont_mul(c, s0, tmp);
  fr_add(x, tmp, x);
}

#ifdef __CUDACC__

// Publish x into the state buffer `st`, one barrier, then x <- row
// `threadIdx.x` of mT . state.
template <int T>
__device__ __forceinline__ void pg_dense(const u64 *mT, u64 *st, u64 *x) {
  const int tid = threadIdx.x;
  if (tid < T) {
#pragma unroll
    for (int l = 0; l < 4; ++l) st[tid * 4 + l] = x[l];
  }
  __syncthreads();
  if (tid < T) pg_row_dot<T>(mT, tid, st, x);
}

// Permutes the state whose element `threadIdx.x` this thread holds in x[4]
// (threads at or beyond T pass anything and get it back).  Every thread of
// the block must call it; `sh` is PG_SHARED_U64(T) words of shared memory,
// free again on return.
template <int T>
__device__ void poseidon_permute_group(u64 *x, u64 *sh,
                                       const PoseidonGroupConsts &k) {
  constexpr int NW = PG_WARPS(T);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool on = tid < T;
  u64 *tot = sh + 2 * T * 4;
  u64 *s0 = tot + 2 * NW * 9;
  const int half = k.rf / 2;
  int p = 0;  // state buffer of the next dense step

  for (int r = 0; r < half; ++r) {
    if (on) pg_ark_sbox(k.rc_full + ((long)r * T + tid) * 4, x);
    pg_dense<T>(k.mdsT, sh + p * T * 4, x);
    p ^= 1;
  }

  for (int r = 0; r < k.rp; ++r) {
    if (tid == 0) pg_ark_sbox(k.rc_part + r * 4, x);
    if (r == k.rp - 1) break;
    u64 acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    if (on) pg_product(k.qrow + ((long)r * T + tid) * 4, x, acc);
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      u64 o[9];
#pragma unroll
      for (int l = 0; l < 9; ++l)
        o[l] = __shfl_xor_sync(0xffffffffu, acc[l], d);
      pg_acc_add(acc, o);
    }
    const int q = r & 1;
    u64 *tt = tot + q * NW * 9;
    u64 *ss = s0 + q * 4;
    if (lane == 0 && warp != 0) {
#pragma unroll
      for (int l = 0; l < 9; ++l) tt[warp * 9 + l] = acc[l];
    }
    if (tid == 0) {
#pragma unroll
      for (int l = 0; l < 4; ++l) ss[l] = x[l];
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < NW; ++w) pg_acc_add(acc, tt + w * 9);
      fr_redc320(acc, x);
    } else if (on) {
      pg_col_update(k.qcol + ((long)r * (T - 1) + tid - 1) * 4, ss, x);
    }
  }
  pg_dense<T>(k.mfinalT, sh + p * T * 4, x);
  p ^= 1;

  for (int r = half; r < k.rf; ++r) {
    if (on) pg_ark_sbox(k.rc_full + ((long)r * T + tid) * 4, x);
    pg_dense<T>(k.mdsT, sh + p * T * 4, x);
    p ^= 1;
  }
  // the next call starts again at buffer 0: nobody may still be reading it
  __syncthreads();
}

#endif  // __CUDACC__
