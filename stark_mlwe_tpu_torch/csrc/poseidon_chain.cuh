// One Poseidon x^5 permutation held by ONE WARP: lane i holds state element i
// (lanes 0..16 at t = 17, 0..8 at t = 9) in registers, on the carry-chain
// arithmetic of `fr32.cuh`.  Every exchange is a warp shuffle: no shared
// memory, no block barrier.  Used by K4 `poseidon_absorb_chain`.
//
// Same rounds, same sparse partial rounds, same constants (the packs of
// `native.pack_params`, dense matrices transposed as for the group kernels:
// `mT[j][i] = m[i][j]`, so the lanes' loads at step j are neighbours) and the
// same lazy row sums with one 2^320 reduction per output as `poseidon.cuh`.
// Field arithmetic with a canonical final reduction gives the same value in
// whatever order an integer sum is taken, so the result is bit-identical to
// K1, K5 and the host engine.
//
// Per round:
//   full     every lane adds its round constant and takes its x^5, then
//            forms its row of the dense product: at step j element j is
//            broadcast from lane j by shuffles and one lazy product is added.
//   partial  round r's S-box s_r = (x_0 + c_r)^5 is lane 0's.  The rest of
//            the row dot, S_r = sum_{j>=1} qrow[r][j] x_j, uses the x_j after
//            round r-1's column update, which needed only s_{r-1}; so every
//            lane forms its term and a shuffle butterfly sums them WHILE lane 0
//            computes s_r: the two are independent in the instruction stream
//            (one warp still issues both).  Then s_r is broadcast (one
//            shuffle per word) and the round ends with lane 0's
//            x_0 = REDC(qrow[r][0] s_r + S_r) and the other lanes'
//            x_j += qcol[r][j-1] s_r.
// Lane 0's dependent path per partial round is thus ARK, three products, the
// broadcast, one product, one 17-limb add and one reduction.  Both ends of a
// branch that depends on the lane are formed on every lane and one is kept by
// a select, so the warp never diverges around a shuffle or a carry chain;
// lanes at or beyond T read the constants of row 0, hold values nobody
// reads, and keep the shuffles company.
//
// The routine is written once for both compilers, over an exchange policy E:
// a thread runs E::N lane slots, slot i being lane e.lane(i), and every
// exchange goes through E::bcast (each slot reads lane `src`'s words) or
// E::xor_swap (each slot reads lane `lane ^ d`'s).  On the card (`PcWarp`)
// a thread is one lane, N = 1, and the two are `__shfl_sync` and
// `__shfl_xor_sync`; `host_check.cpp` runs all 32 lanes in one thread
// (N = 32) and reads the other lanes' slots, so Tier-1 replays this very
// loop, step by step in the kernel's order.

#pragma once

#include "fr32.cuh"

struct ChainConsts {
  const u32 *mdsT;     // t*t*8, transposed, 2^320-scaled
  const u32 *rc_full;  // rf*t*8
  const u32 *rc_part;  // rp*8
  const u32 *qrow;     // (rp-1)*t*8, 2^320-scaled
  const u32 *qcol;     // (rp-1)*(t-1)*8
  const u32 *mfinalT;  // t*t*8, transposed, 2^320-scaled
  int rf;
  int rp;
};

// Lanes that take part in the partial rounds' butterfly: the power of two at
// or above T (16 at t = 9, 32 at t = 17).
template <int T>
struct PcTree {
  static_assert(T >= 2 && T <= 32, "one warp holds at most 32 elements");
  static constexpr int W = T <= 8 ? 8 : (T <= 16 ? 16 : 32);
};

// The row a lane computes; lanes at or beyond T compute row 0 and drop it.
template <int T>
FR32_FN int pc_row(int lane) {
  return lane < T ? lane : 0;
}

// s = (x + rc)^5; s may alias x.
FR32_FN void pc_ark_sbox(const u32 *rc, const u32 *x, u32 *s) {
  u32 c[8], y[8];
  fr32_load(rc, c);
  fr32_add(x, c, y);
  fr32_pow5(y, s);
}

// acc += mT[j][row] * xj: step j of the lane's dense row sum.
template <int T>
FR32_FN void pc_dense_term(const u32 *mT, int lane, int j, const u32 *xj,
                           u32 *acc) {
  u32 c[8];
  fr32_load(mT + ((long)j * T + pc_row<T>(lane)) * 8, c);
  fr32_acc_mul(c, xj, acc);
}

// acc = qr[lane] * x on lanes 1..T-1 (the lane's term of S_r), zero on the
// others.
template <int T>
FR32_FN void pc_sparse_term(const u32 *qr, int lane, const u32 *x, u32 *acc) {
  u32 c[8];
  fr32_load(qr + pc_row<T>(lane) * 8, c);
#pragma unroll
  for (int l = 0; l < FR32_ACC; ++l) acc[l] = 0;
  fr32_acc_mul(c, x, acc);
  const u32 keep = (lane >= 1 && lane < T) ? ~0u : 0u;
#pragma unroll
  for (int l = 0; l < FR32_ACC; ++l) acc[l] &= keep;
}

// The end of partial round r, given S = S_r and s = s_r: lane 0 takes
// REDC(qr[0] s + S), lanes 1..T-1 take x + qc[lane-1] s.
template <int T>
FR32_FN void pc_sparse_update(const u32 *qr, const u32 *qc, int lane,
                              const u32 *S, const u32 *s, u32 *x) {
  u32 acc[FR32_ACC], c[8], n0[8], u[8];
#pragma unroll
  for (int l = 0; l < FR32_ACC; ++l) acc[l] = S[l];
  fr32_load(qr, c);
  fr32_acc_mul(c, s, acc);
  fr32_redc320(acc, n0);
  fr32_load(qc + (lane >= 1 && lane < T ? lane - 1 : 0) * 8, c);
  fr32_mont_mul<true>(c, s, u);
  fr32_add(x, u, u);
#pragma unroll
  for (int l = 0; l < 8; ++l) x[l] = lane == 0 ? n0[l] : u[l];
}

#ifdef __CUDACC__
#define PC_FN __device__

// The card's policy: the warp's 32 threads are the lanes.
struct PcWarp {
  static constexpr int N = 1;
  int l;
  __device__ int lane(int) const { return l; }
  template <int K>
  __device__ static void bcast(u32 (*v)[K], int src, u32 (*o)[K]) {
#pragma unroll
    for (int w = 0; w < K; ++w) o[0][w] = __shfl_sync(0xffffffffu, v[0][w], src);
  }
  template <int K>
  __device__ static void xor_swap(u32 (*v)[K], int d, u32 (*o)[K]) {
#pragma unroll
    for (int w = 0; w < K; ++w)
      o[0][w] = __shfl_xor_sync(0xffffffffu, v[0][w], d);
  }
};
#else
#define PC_FN static
#endif

// x <- row `lane` of mT . state, on every slot.
template <int T, class E>
FR32_FN void pc_dense(const u32 *mT, const E &e, u32 (*x)[8]) {
  u32 acc[E::N][FR32_ACC];
#pragma unroll
  for (int i = 0; i < E::N; ++i)
#pragma unroll
    for (int l = 0; l < FR32_ACC; ++l) acc[i][l] = 0;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    u32 xj[E::N][8];
    E::bcast(x, j, xj);
#pragma unroll
    for (int i = 0; i < E::N; ++i)
      pc_dense_term<T>(mT, e.lane(i), j, xj[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < E::N; ++i) fr32_redc320(acc[i], x[i]);
}

// The rp partial rounds; x_0 ends as the last S-box output.
template <int T, class E>
FR32_FN void pc_partial_rounds(u32 (*x)[8], const E &e,
                               const ChainConsts &k) {
  constexpr int W = PcTree<T>::W;
#pragma unroll 1
  for (int r = 0; r < k.rp; ++r) {
    u32 s[E::N][8];
#pragma unroll
    for (int i = 0; i < E::N; ++i) pc_ark_sbox(k.rc_part + r * 8, x[i], s[i]);
    if (r == k.rp - 1) {
#pragma unroll
      for (int i = 0; i < E::N; ++i)
#pragma unroll
        for (int l = 0; l < 8; ++l) x[i][l] = e.lane(i) == 0 ? s[i][l] : x[i][l];
      break;
    }
    const u32 *qr = k.qrow + (long)r * T * 8;
    u32 acc[E::N][FR32_ACC];
#pragma unroll
    for (int i = 0; i < E::N; ++i)
      pc_sparse_term<T>(qr, e.lane(i), x[i], acc[i]);
#pragma unroll
    for (int d = W / 2; d >= 1; d >>= 1) {
      u32 o[E::N][FR32_ACC];
      E::xor_swap(acc, d, o);
#pragma unroll
      for (int i = 0; i < E::N; ++i) fr32_acc_add(acc[i], o[i]);
    }
    u32 s0[E::N][8];
    E::bcast(s, 0, s0);
#pragma unroll
    for (int i = 0; i < E::N; ++i)
      pc_sparse_update<T>(qr, k.qcol + (long)r * (T - 1) * 8, e.lane(i),
                          acc[i], s0[i], x[i]);
  }
}

// Permutes the state whose element e.lane(i) slot i holds in x[i].  All 32
// lanes of the warp take part.  The rf + 1 dense products are one loop, the
// partial rounds run before product rf/2 (the one by `mfinal`), so each
// routine is instantiated once.
template <int T, class E>
PC_FN void poseidon_permute_warp(u32 (*x)[8], const E &e,
                                 const ChainConsts &k) {
  const int half = k.rf / 2;
#pragma unroll 1
  for (int d = 0; d <= k.rf; ++d) {
    if (d == half) {
      pc_partial_rounds<T>(x, e, k);
    } else {
      const int r = d < half ? d : d - 1;
#pragma unroll
      for (int i = 0; i < E::N; ++i)
        pc_ark_sbox(k.rc_full + ((long)r * T + pc_row<T>(e.lane(i))) * 8,
                    x[i], x[i]);
    }
    pc_dense<T>(d == half ? k.mfinalT : k.mdsT, e, x);
  }
}
