// One Poseidon x^5 permutation over Fr, all values in Montgomery form.
//
// Round structure: rf/2 full rounds, rp partial rounds (S-box on element 0
// only), rf/2 full rounds; each round is ARK -> S-box -> MDS.  The partial
// rounds use the sparse factorization of `spec/poseidon_opt.py`: the first
// rp-1 of them apply Q_r = [[q00, w^T], [Mhat^-1 v, I]] (one t-term row dot
// plus t-1 single multiplies) instead of the dense matrix, and ONE dense
// `mfinal` lands after the last partial S-box.  The result is bit-identical
// to the dense form.
//
// Constant scales (packed by `native.pack_params`): mds, qrow, mfinal are
// pre-scaled by 2^320 for fr_acc_mul + fr_redc320; rc_full, rc_part, qcol are
// plain Montgomery form.

#pragma once

#include "fr.cuh"

struct PoseidonConsts {
  const u64 *mds;      // t*t*4
  const u64 *rc_full;  // rf*t*4
  const u64 *rc_part;  // rp*4
  const u64 *qrow;     // (rp-1)*t*4
  const u64 *qcol;     // (rp-1)*(t-1)*4
  const u64 *mfinal;   // t*t*4
  int rf;
  int rp;
};

// cur <- M . cur for a dense t x t matrix (lazy row sums, one REDC each).
template <int T>
FR_FN void poseidon_mds(const u64 *m, u64 *cur, u64 *nxt) {
  for (int i = 0; i < T; ++i) {
    u64 acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int j = 0; j < T; ++j) {
      u64 c[4];
      fr_load(m + ((long)i * T + j) * 4, c);
      fr_acc_mul(c, cur + j * 4, acc);
    }
    fr_redc320(acc, nxt + i * 4);
  }
  for (int k = 0; k < T * 4; ++k) cur[k] = nxt[k];
}

template <int T>
FR_FN void poseidon_full_round(const u64 *rc, const u64 *mds, u64 *cur,
                               u64 *nxt) {
  for (int i = 0; i < T; ++i) {
    u64 c[4];
    fr_load(rc + i * 4, c);
    fr_add(cur + i * 4, c, cur + i * 4);
    fr_pow5(cur + i * 4);
  }
  poseidon_mds<T>(mds, cur, nxt);
}

// cur: T*4 limbs, permuted in place; nxt: T*4 limbs of scratch.
template <int T>
FR_FN void poseidon_permute_one(u64 *cur, u64 *nxt, const PoseidonConsts &k) {
  const int half = k.rf / 2;
  for (int r = 0; r < half; ++r)
    poseidon_full_round<T>(k.rc_full + (long)r * T * 4, k.mds, cur, nxt);

  for (int r = 0; r < k.rp; ++r) {
    u64 c[4];
    fr_load(k.rc_part + r * 4, c);
    fr_add(cur, c, cur);
    fr_pow5(cur);
    if (r == k.rp - 1) break;
    const u64 *qr = k.qrow + (long)r * T * 4;
    const u64 *qc = k.qcol + (long)r * (T - 1) * 4;
    u64 acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int j = 0; j < T; ++j) {
      fr_load(qr + j * 4, c);
      fr_acc_mul(c, cur + j * 4, acc);
    }
    u64 new0[4];
    fr_redc320(acc, new0);
    for (int i = 1; i < T; ++i) {
      u64 tmp[4];
      fr_load(qc + (i - 1) * 4, c);
      fr_mont_mul(c, cur, tmp);
      fr_add(cur + i * 4, tmp, cur + i * 4);
    }
    for (int l = 0; l < 4; ++l) cur[l] = new0[l];
  }
  poseidon_mds<T>(k.mfinal, cur, nxt);

  for (int r = half; r < k.rf; ++r)
    poseidon_full_round<T>(k.rc_full + (long)r * T * 4, k.mds, cur, nxt);
}
