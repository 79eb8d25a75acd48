// One Poseidon x^5 permutation held by ONE THREAD, all values in Montgomery
// form, on the 32-bit carry-chain arithmetic of `fr32.cuh`.  The thread
// layout of K1 `poseidon_permute` (large batches; the warp layout of
// `poseidon_chain.cuh` takes the small ones).
//
// Round structure: rf/2 full rounds, rp partial rounds (S-box on element 0
// only), rf/2 full rounds; each round is ARK -> S-box -> MDS.  The partial
// rounds use the sparse factorization of `spec/poseidon_opt.py`: the first
// rp-1 of them apply Q_r = [[q00, w^T], [Mhat^-1 v, I]] (one t-term row dot
// plus t-1 single multiplies) instead of the dense matrix, and ONE dense
// `mfinal` lands after the last partial S-box.  The result is bit-identical
// to the dense form.
//
// Constant scales (packed by `native.pack_params`, matrices row-major): mds,
// qrow, mfinal are pre-scaled by 2^320 for fr32_acc_mul + fr32_redc320;
// rc_full, rc_part, qcol are plain Montgomery form.  Every thread of a warp
// reads the same constant, so a load is a broadcast.

#pragma once

#include "fr32.cuh"

struct PoseidonConsts {
  const u32 *mds;      // t*t*8
  const u32 *rc_full;  // rf*t*8
  const u32 *rc_part;  // rp*8
  const u32 *qrow;     // (rp-1)*t*8
  const u32 *qcol;     // (rp-1)*(t-1)*8
  const u32 *mfinal;   // t*t*8
  int rf;
  int rp;
};

// cur <- M . cur for a dense t x t matrix (lazy row sums, one REDC each).
template <int T>
FR32_FN void poseidon_mds(const u32 *m, u32 *cur, u32 *nxt) {
#pragma unroll 1
  for (int i = 0; i < T; ++i) {
    u32 acc[FR32_ACC];
#pragma unroll
    for (int l = 0; l < FR32_ACC; ++l) acc[l] = 0;
    for (int j = 0; j < T; ++j) {
      u32 c[8];
      fr32_load(m + ((long)i * T + j) * 8, c);
      fr32_acc_mul(c, cur + j * 8, acc);
    }
    fr32_redc320(acc, nxt + i * 8);
  }
  for (int k = 0; k < T * 8; ++k) cur[k] = nxt[k];
}

// x <- (x + rc)^5
FR32_FN void poseidon_ark_sbox(const u32 *rc, u32 *x) {
  u32 c[8];
  fr32_load(rc, c);
  fr32_add(x, c, x);
  fr32_pow5(x, x);
}

// cur: T*8 words, permuted in place; nxt: T*8 words of scratch.  The rf + 1
// dense products are one loop, the partial rounds run before product rf/2
// (the one by `mfinal`), so the dense product is instantiated once.
template <int T>
FR32_FN void poseidon_permute_one(u32 *cur, u32 *nxt,
                                  const PoseidonConsts &k) {
  const int half = k.rf / 2;
#pragma unroll 1
  for (int d = 0; d <= k.rf; ++d) {
    if (d == half) {
#pragma unroll 1
      for (int r = 0; r < k.rp; ++r) {
        poseidon_ark_sbox(k.rc_part + r * 8, cur);
        if (r == k.rp - 1) break;
        const u32 *qr = k.qrow + (long)r * T * 8;
        const u32 *qc = k.qcol + (long)r * (T - 1) * 8;
        u32 acc[FR32_ACC], c[8];
#pragma unroll
        for (int l = 0; l < FR32_ACC; ++l) acc[l] = 0;
        for (int j = 0; j < T; ++j) {
          fr32_load(qr + j * 8, c);
          fr32_acc_mul(c, cur + j * 8, acc);
        }
        // x_i += qcol[i-1] * s_r while cur[0] still holds s_r
#pragma unroll 1
        for (int i = 1; i < T; ++i) {
          u32 u[8];
          fr32_load(qc + (i - 1) * 8, c);
          fr32_mont_mul<true>(c, cur, u);
          fr32_add(cur + i * 8, u, cur + i * 8);
        }
        fr32_redc320(acc, cur);
      }
    } else {
      const int r = d < half ? d : d - 1;
#pragma unroll 1
      for (int i = 0; i < T; ++i)
        poseidon_ark_sbox(k.rc_full + ((long)r * T + i) * 8, cur + i * 8);
    }
    poseidon_mds<T>(d == half ? k.mfinal : k.mds, cur, nxt);
  }
}
