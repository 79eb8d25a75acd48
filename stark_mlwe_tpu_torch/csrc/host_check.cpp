// Host build of the kernels' arithmetic (g++, no CUDA): the same `fr.cuh`,
// `poseidon.cuh`, `poseidon_group.cuh` and `ntt.cuh` the CUDA kernels include,
// behind a plain C interface, so the CPU tests can hold the device functions against
// the pure-Python spec where there is no card.  Not used by the prover.

#include <vector>

#include "ntt.cuh"
#include "poseidon_group.cuh"

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

// The thread-group permutation of `poseidon_group.cuh` with its threads run
// one after another: each step between two barriers becomes a loop over the
// thread index, and the tree sum of the partial rounds a running sum (an
// unreduced integer sum is the same in any order).
template <int T>
static void permute_group_replay(u64 *state, const PoseidonGroupConsts &k) {
  u64 st[T * 4];
  u64(*x)[4] = (u64(*)[4])state;
  auto dense = [&](const u64 *mT) {
    for (int i = 0; i < T * 4; ++i) st[i] = state[i];
    for (int tid = 0; tid < T; ++tid) pg_row_dot<T>(mT, tid, st, x[tid]);
  };
  const int half = k.rf / 2;
  for (int r = 0; r < k.rf; ++r) {
    if (r == half) {
      for (int q = 0; q < k.rp; ++q) {
        pg_ark_sbox(k.rc_part + q * 4, x[0]);
        if (q == k.rp - 1) break;
        u64 acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, term[9];
        for (int tid = 0; tid < T; ++tid) {
          pg_product(k.qrow + ((long)q * T + tid) * 4, x[tid], term);
          pg_acc_add(acc, term);
        }
        u64 s0[4] = {x[0][0], x[0][1], x[0][2], x[0][3]};
        fr_redc320(acc, x[0]);
        for (int tid = 1; tid < T; ++tid)
          pg_col_update(k.qcol + ((long)q * (T - 1) + tid - 1) * 4, s0,
                        x[tid]);
      }
      dense(k.mfinalT);
    }
    for (int tid = 0; tid < T; ++tid)
      pg_ark_sbox(k.rc_full + ((long)r * T + tid) * 4, x[tid]);
    dense(k.mdsT);
  }
}

// The constants are those of the group kernels: `mdsT` and `mfinalT` are the
// transposed matrices.
extern "C" int hc_permute_group(u64 *states, long B, int t, int rf, int rp,
                                const u64 *mdsT, const u64 *rc_full,
                                const u64 *rc_part, const u64 *qrow,
                                const u64 *qcol, const u64 *mfinalT) {
  PoseidonGroupConsts k{mdsT, rc_full, rc_part, qrow, qcol, mfinalT, rf, rp};
  for (long b = 0; b < B; ++b) {
    u64 *s = states + b * t * 4;
    if (t == 9) permute_group_replay<9>(s, k);
    else if (t == 17) permute_group_replay<17>(s, k);
    else if (t == 33) permute_group_replay<33>(s, k);
    else if (t == 65) permute_group_replay<65>(s, k);
    else if (t == 129) permute_group_replay<129>(s, k);
    else return 1;
  }
  return 0;
}

// The NTT tile kernel of `fr_ntt.cu` with its blocks run one after another
// and, inside a block, each step between two barriers as a loop over the
// thread index.  The arguments are those of the CUDA entry point, with the
// number of threads of a block in place of the stream.
extern "C" int hc_ntt_tile(const u64 *in, u64 *out, const u64 *wt,
                           const u64 *ep, long B, int logL, int tpb,
                           long in_es, long out_es, long ep_period, int nlev,
                           const long *cnt, const long *in_bs,
                           const long *out_bs, int nthreads) {
  if (B <= 0 || logL < 1 || tpb < 1 || nlev < 1 || nlev > NTT_MAX_LEVELS ||
      nthreads < 1)
    return 1;
  NttTileArgs a{in, out, wt, ep, B, logL, tpb, in_es, out_es, ep_period, nlev,
                {}, {}, {}};
  for (int k = 0; k < nlev; ++k) {
    a.cnt[k] = cnt[k];
    a.in_bs[k] = in_bs[k];
    a.out_bs[k] = out_bs[k];
  }
  std::vector<u64> shared(ntt_shared_bytes(logL, tpb) / sizeof(u64));
  u64 *sh = shared.data();
  long *offs = (long *)(sh + ((size_t)tpb << logL) * 4);
  const unsigned nt = (unsigned)nthreads;
  for (long first = 0; first < B; first += tpb) {
    const int nvalid = B - first < tpb ? (int)(B - first) : tpb;
    for (unsigned tid = 0; tid < nt; ++tid)
      ntt_offsets_thread(a, first, nvalid, offs, tid, nt);
    for (unsigned tid = 0; tid < nt; ++tid)
      ntt_load_thread(a, nvalid, sh, offs, tid, nt);
    for (int s = 0; s < logL; ++s)
      for (unsigned tid = 0; tid < nt; ++tid)
        ntt_stage_thread(a, nvalid, sh, s, tid, nt);
    for (unsigned tid = 0; tid < nt; ++tid)
      ntt_store_thread(a, nvalid, sh, offs, tid, nt);
  }
  return 0;
}
