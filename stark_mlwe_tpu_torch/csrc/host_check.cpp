// Host build of the kernels' arithmetic (g++, no CUDA): the same `fr.cuh` and
// `poseidon.cuh` the CUDA kernels include, behind a plain C interface, so the
// CPU tests can hold the device functions against the pure-Python spec where
// there is no card.  Not used by the prover.

#include "poseidon.cuh"

static const u64 K320[4] = {0x8c46eb2100000001ULL, 0xf12aec780994a8d9ULL,
                            0x76e59c0fd9ad5c89ULL, 0x3fffffffffffffffULL};

extern "C" {

void hc_elementwise(int op, const u64 *a, const u64 *b, u64 *out, long n,
                    int a_step, int b_step) {
  for (long i = 0; i < n; ++i) {
    const u64 *x = a + i * 4 * a_step, *y = b + i * 4 * b_step;
    if (op == 0) fr_mont_mul(x, y, out + i * 4);
    else if (op == 1) fr_add(x, y, out + i * 4);
    else fr_sub(x, y, out + i * 4);
  }
}

void hc_fold(const u64 *f, const u64 *zpow, u64 *out, long nout, int m) {
  u64 zs[1024 * 4];
  for (int t = 0; t < m; ++t) fr_mont_mul(zpow + t * 4, K320, zs + t * 4);
  for (long b = 0; b < nout; ++b) {
    u64 acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int t = 0; t < m; ++t)
      fr_acc_mul(zs + t * 4, f + (b * m + t) * 4, acc);
    fr_redc320(acc, out + b * 4);
  }
}

int hc_permute(u64 *states, long B, int t, int rf, int rp, const u64 *mds,
               const u64 *rc_full, const u64 *rc_part, const u64 *qrow,
               const u64 *qcol, const u64 *mfinal) {
  PoseidonConsts k{mds, rc_full, rc_part, qrow, qcol, mfinal, rf, rp};
  u64 nxt[17 * 4];
  for (long b = 0; b < B; ++b) {
    if (t == 17) poseidon_permute_one<17>(states + b * t * 4, nxt, k);
    else if (t == 9) poseidon_permute_one<9>(states + b * t * 4, nxt, k);
    else return 1;
  }
  return 0;
}

}  // extern "C"
