// Host build of the kernels' arithmetic (g++, no CUDA): the same
// `fr32.cuh`, `fold.cuh`, `ntt.cuh`, `poseidon.cuh`, `poseidon_chain.cuh`,
// `poseidon_group.cuh` and `batch_inv.cuh` the CUDA kernels include, behind
// a plain C interface, so the CPU tests can hold the device functions
// against the pure-Python spec where there is no card.  Not used by the
// prover.

#include <cstring>
#include <vector>

#include "batch_inv.cuh"
#include "fold.cuh"
#include "ntt.cuh"
#include "poseidon.cuh"
#include "poseidon_chain.cuh"
#include "poseidon_group.cuh"

extern "C" {

// K2 `fr_elementwise` (on `fr32.cuh`), one element after another.
void hc_elementwise(int op, const u64 *a, const u64 *b, u64 *out, long n,
                    int a_step, int b_step) {
  for (long i = 0; i < n; ++i) {
    const u32 *x = (const u32 *)(a + i * 4 * a_step);
    const u32 *y = (const u32 *)(b + i * 4 * b_step);
    u32 *o = (u32 *)(out + i * 4);
    if (op == 0) fr32_binop<0>(x, y, o);
    else if (op == 1) fr32_binop<1>(x, y, o);
    else fr32_binop<2>(x, y, o);
  }
}

// The thread layout of K1 (`poseidon.cuh`, on `fr32.cuh`), one state after
// another; the constants of `native.pack_params` (the bytes of u64[4] and
// u32[8] are the same).
int hc_permute(u64 *states, long B, int t, int rf, int rp, const u64 *mds,
               const u64 *rc_full, const u64 *rc_part, const u64 *qrow,
               const u64 *qcol, const u64 *mfinal) {
  PoseidonConsts k{(const u32 *)mds,  (const u32 *)rc_full,
                   (const u32 *)rc_part, (const u32 *)qrow,
                   (const u32 *)qcol, (const u32 *)mfinal, rf, rp};
  u32 nxt[17 * 8];
  for (long b = 0; b < B; ++b) {
    u32 *s = (u32 *)(states + b * t * 4);
    if (t == 17) poseidon_permute_one<17>(s, nxt, k);
    else if (t == 9) poseidon_permute_one<9>(s, nxt, k);
    else return 1;
  }
  return 0;
}

}  // extern "C"

// The NTT tile kernel of `fr_ntt.cu` with its blocks run one after another
// and, inside a block, each step between two barriers as a loop over the
// thread index.  The arguments are those of the CUDA entry point, with the
// number of threads of a block (any count: the steps are strided loops) in
// place of the stream.
extern "C" int hc_ntt_tile(const u64 *in, u64 *out, const u64 *wt,
                           const u64 *ep, long B, int logL, int tpb,
                           long in_es, long out_es, long ep_period, int nlev,
                           const long *cnt, const long *in_bs,
                           const long *out_bs, int nthreads) {
  NttTileArgs a;
  if (nthreads < 1 ||
      !ntt_args(&a, in, out, wt, ep, B, logL, tpb, in_es, out_es, ep_period,
                nlev, cnt, in_bs, out_bs, NTT_R))
    return 1;
  const unsigned sp = ntt_plane_words(logL, tpb);
  std::vector<u64> shared((ntt_shared_bytes(logL, tpb) + 7) / 8);
  u32 *sh = (u32 *)shared.data();
  long *offs = (long *)(sh + 8 * sp);
  const unsigned nt = (unsigned)nthreads;
  for (long first = 0; first < B; first += tpb) {
    const int nvalid = B - first < tpb ? (int)(B - first) : tpb;
    for (unsigned tid = 0; tid < nt; ++tid)
      ntt_offsets_thread(a, first, nvalid, offs, tid, nt);
    for (unsigned tid = 0; tid < nt; ++tid)
      ntt_load_thread(a, nvalid, sh, sp, offs, tid, nt);
    for (int s0 = 0, q = ntt_first_stages(logL, NTT_R); s0 < logL;
         s0 += q, q = NTT_R)
      for (unsigned tid = 0; tid < nt; ++tid)
        ntt_pass_thread<NTT_R>(a, nvalid, sh, sp, s0, q, tid, nt);
    for (unsigned tid = 0; tid < nt; ++tid)
      ntt_store_thread(a, nvalid, sh, sp, offs, tid, nt);
  }
  return 0;
}

// Where slot x of a block lies in each of its limb planes (`ntt_phys`).
extern "C" unsigned hc_ntt_phys(unsigned x) { return ntt_phys(x); }

// The 32-bit carry-chain arithmetic of `fr32.cuh` (K4's): n fully reduced
// Montgomery products, and B lazy row sums of `nterms` <= 17 products each
// (q pre-scaled by 2^320) with one fr32_redc320.
extern "C" void hc_fr32_mont_mul(const u32 *a, const u32 *b, u32 *out,
                                 long n) {
  for (long i = 0; i < n; ++i) fr32_mont_mul<true>(a + i * 8, b + i * 8,
                                                   out + i * 8);
}

extern "C" void hc_fr32_sub(const u32 *a, const u32 *b, u32 *out, long n) {
  for (long i = 0; i < n; ++i) fr32_sub(a + i * 8, b + i * 8, out + i * 8);
}

extern "C" void hc_fr32_inv(const u32 *x, u32 *out, long n) {
  for (long i = 0; i < n; ++i) fr32_inv(x + i * 8, out + i * 8);
}

extern "C" int hc_fr32_row_dot(const u32 *q, const u32 *x, u32 *out, long B,
                               int nterms) {
  if (nterms < 1 || nterms > 17) return 1;
  for (long b = 0; b < B; ++b) {
    u32 acc[FR32_ACC] = {0};
    for (int j = 0; j < nterms; ++j)
      fr32_acc_mul(q + (b * nterms + j) * 8, x + (b * nterms + j) * 8, acc);
    fr32_redc320(acc, out + b * 8);
  }
  return 0;
}

// The exchange policy of `poseidon_chain.cuh` for one thread that runs all
// 32 lanes of the warp one after another: slot i is lane i, and a shuffle is
// a read of the other lane's slot.  With it `poseidon_permute_warp` is the
// kernel's own routine, step by step in the kernel's order; the butterfly
// runs level by level over all 32 lanes.
struct PcLanes {
  static constexpr int N = 32;
  int lane(int i) const { return i; }
  template <int K>
  static void bcast(u32 (*v)[K], int src, u32 (*o)[K]) {
    for (int i = 0; i < N; ++i)
      for (int w = 0; w < K; ++w) o[i][w] = v[src][w];
  }
  template <int K>
  static void xor_swap(u32 (*v)[K], int d, u32 (*o)[K]) {
    for (int i = 0; i < N; ++i)
      for (int w = 0; w < K; ++w) o[i][w] = v[i ^ d][w];
  }
};

// K3 `fr_fold` (`fold.cuh`): the arguments of its entry point without the
// stream; block after block, the scale step over the block's threads, then
// each warp's fold step over its 32 lanes (`PcLanes`: the shuffle tree reads
// the other lanes' slots).
extern "C" int hc_fold(const u32 *f, const u32 *zpow, u32 *out, long nout,
                       int m) {
  if (nout <= 0 || m < 1 || m > FOLD_MAX_M) return 1;
  std::vector<u32> zs((size_t)m * 8);
  const long blocks = fold_blocks(nout, m);
  for (long blk = 0; blk < blocks; ++blk) {
    for (int tid = 0; tid < FOLD_THREADS; ++tid)
      fold_scale(zpow, m, zs.data(), tid, FOLD_THREADS);
    for (int w = 0; w < FOLD_THREADS / 32; ++w)
      fold_warp(f, zs.data(), out, nout, m, fold_first(blk, w, m),
                PcLanes{});
  }
  return 0;
}

template <int T>
static void absorb_chain_replay(const u32 *state_in, const u32 *cols,
                                u32 *state_out, long c, long n, long off,
                                long nb, const ChainConsts &k) {
  constexpr int RATE = T - 1;
  u32 x[32][8] = {};
  for (int lane = 0; lane < T; ++lane)
    fr32_load(state_in + (c * T + lane) * 8, x[lane]);
  for (long b = 0; b < nb; ++b) {
    const u32 *blk = cols + (c * n + off + b * RATE) * 8;
    for (int lane = 0; lane < RATE; ++lane)
      fr32_add(x[lane], blk + lane * 8, x[lane]);
    poseidon_permute_warp<T>(x, PcLanes{}, k);
  }
  for (int lane = 0; lane < T; ++lane)
    for (int l = 0; l < 8; ++l) state_out[(c * T + lane) * 8 + l] = x[lane][l];
}

// The arguments of the CUDA entry point `poseidon_absorb_chain`, without the
// stream; the chains run one after another.
extern "C" int hc_absorb_chain(const u32 *state_in, const u32 *cols,
                               u32 *state_out, int C, long n, long off,
                               long nb, int t, int rf, int rp,
                               const u32 *mdsT, const u32 *rc_full,
                               const u32 *rc_part, const u32 *qrow,
                               const u32 *qcol, const u32 *mfinalT) {
  ChainConsts k{mdsT, rc_full, rc_part, qrow, qcol, mfinalT, rf, rp};
  if (C <= 0 || nb < 0 || off < 0 || off + nb * (t - 1) > n || rp < 1 ||
      (rf & 1))
    return 1;
  for (long c = 0; c < C; ++c) {
    if (t == 9) absorb_chain_replay<9>(state_in, cols, state_out, c, n, off,
                                       nb, k);
    else if (t == 17) absorb_chain_replay<17>(state_in, cols, state_out, c, n,
                                              off, nb, k);
    else return 1;
  }
  return 0;
}

// The warp layout of K1: `poseidon_permute_warp` run over the 32 lanes of
// `PcLanes` for each state, lanes at or beyond t holding zeros as on the
// card.  The arguments of the CUDA entry point `poseidon_permute_warp`
// without the stream: the constants of `DeviceParams.group_consts`.
template <int T>
static void permute_warp_replay(u32 *state, const ChainConsts &k) {
  u32 x[32][8] = {};
  for (int lane = 0; lane < T; ++lane) fr32_load(state + lane * 8, x[lane]);
  poseidon_permute_warp<T>(x, PcLanes{}, k);
  for (int lane = 0; lane < T; ++lane)
    for (int l = 0; l < 8; ++l) state[lane * 8 + l] = x[lane][l];
}

extern "C" int hc_permute_warp(u32 *states, long B, int t, int rf, int rp,
                               const u32 *mdsT, const u32 *rc_full,
                               const u32 *rc_part, const u32 *qrow,
                               const u32 *qcol, const u32 *mfinalT) {
  ChainConsts k{mdsT, rc_full, rc_part, qrow, qcol, mfinalT, rf, rp};
  if (B <= 0 || rp < 1 || (rf & 1)) return 1;
  for (long b = 0; b < B; ++b) {
    if (t == 17) permute_warp_replay<17>(states + b * t * 8, k);
    else if (t == 9) permute_warp_replay<9>(states + b * t * 8, k);
    else return 1;
  }
  return 0;
}

// The exchange policy of `poseidon_group.cuh` for one thread that runs all
// NT threads of each of the C blocks of a cluster: slot i is thread i % NT
// of block i / NT, a barrier is the end of a step (each step runs over all
// slots before the next begins), a shuffle reads the other slot of the same
// warp, and a tile copy is a memcpy.  The cluster's blocks share one shared
// memory here: they hold the same state and compute the same partial rounds,
// so a store into every block is one store.  With it
// `poseidon_permute_group` is the kernel's own routine in the kernel's order.
template <int NT, int C>
struct PgSlots {
  static constexpr int N = NT * C;
  int slot(int i) const { return i % NT; }
  int rank(int i) const { return i / NT; }
  static void sync() {}
  static void sync_all() {}
  void store_all(u32 *p, const u32 *x) const { pg_sts(p, x); }
  template <int W>
  static void xor_swap(u32 (*v)[W], int d, u32 (*o)[W]) {
    for (int i = 0; i < N; ++i)
      for (int w = 0; w < W; ++w) o[i][w] = v[i ^ d][w];
  }
  void copy_tile(u32 *dst, const u32 *src, int words) const {
    std::memcpy(dst, src, sizeof(u32) * words);
  }
  static void wait_tiles() {}
};

// Cluster after cluster as the kernel's grid: the row slots load their row,
// the routine runs, part 0 of each row stores it; states past B hold zeros.
template <int T, int S, int K, int C>
static void permute_group_replay(u32 *states, long B, const ChainConsts &k) {
  using G = PgShape<T, S, K, C>;
  using E = PgSlots<G::THREADS, C>;
  const E e{};
  std::vector<u32> shared(G::WORDS);
  std::vector<u32> xs(E::N * 8);
  u32(*x)[8] = (u32(*)[8])xs.data();
  for (long b0 = 0; b0 < B; b0 += S) {
    for (int i = 0; i < E::N; ++i) {
      int s, row, kp;
      const bool mine = pg_row<G>(e.slot(i), e.rank(i), s, row, kp) &&
                        b0 + s < B;
      for (int l = 0; l < 8; ++l)
        x[i][l] = mine ? states[((b0 + s) * T + row) * 8 + l] : 0u;
    }
    poseidon_permute_group<G>(x, e, k, shared.data());
    for (int i = 0; i < E::N; ++i) {
      int s, row, kp;
      if (pg_row<G>(e.slot(i), e.rank(i), s, row, kp) && kp == 0 &&
          b0 + s < B)
        for (int l = 0; l < 8; ++l)
          states[((b0 + s) * T + row) * 8 + l] = x[i][l];
    }
  }
}

// The arguments of the CUDA entry point `poseidon_permute_group` without the
// stream, the states permuted in place; refuses what the entry point refuses.
extern "C" int hc_permute_group(u32 *states, long B, int t, int S, int K,
                                int C, int rf, int rp, const u32 *mdsT,
                                const u32 *rc_full, const u32 *rc_part,
                                const u32 *qrow, const u32 *qcol,
                                const u32 *mfinalT) {
  ChainConsts k{mdsT, rc_full, rc_part, qrow, qcol, mfinalT, rf, rp};
  if (B <= 0 || S < 1 || C < 1 || rp < 1 || (rf & 1)) return 1;
#define PG_REPLAY(TT, SS, KK, CC)                          \
  if (t == TT && S == SS && K == KK && C == CC) {          \
    permute_group_replay<TT, SS, KK, CC>(states, B, k);    \
    return 0;                                              \
  }
  PG_LAYOUTS(PG_REPLAY)
#undef PG_REPLAY
  return 1;
}

extern "C" int hc_group_shape(int t, int S, int K, int C, int *threads,
                              int *bytes) {
  return pg_shape(t, S, K, C, threads, bytes);
}

// The batch inversion of `fr_batch_inv.cu`: the arguments of its entry point
// without the stream, each launch's blocks one after another and, inside a
// block, each step between two barriers run over all its threads.
extern "C" int hc_batch_inv(const u32 *x, const u32 *z, const u32 *phi,
                            u32 *out, u32 *scratch, long scratch_elems,
                            long n, int threads, int per_thread,
                            int b_threads, int stages) {
  BiArgs a;
  if (!bi_args(x, z, phi, out, scratch, scratch_elems, n, threads,
               per_thread, b_threads, &a) ||
      stages < 1 || stages > 7)
    return 1;
  std::vector<u32> shared(bi_shared_words(BI_MAX_THREADS));
  u32 *sh = shared.data();
  if (stages & 1)
    for (long g = 0; g < a.G; ++g) {
      for (int j = 0; j < a.T; ++j) bi_scan_load(a, sh, g, j);
      for (int s = 0; (1 << s) < a.T; ++s)
        for (int j = 0; j < a.T; ++j) bi_scan_step(sh, a.T, s, j);
      for (int j = 0; j < a.T; ++j) bi_scan_store(a, sh, g, j);
    }
  if (stages & 2) {
    for (int j = 0; j < a.TB; ++j) bi_total_load(a, sh, j);
    for (int s = 0; (1 << s) < a.TB; ++s)
      for (int j = 0; j < a.TB; ++j) bi_scan_step(sh, a.TB, s, j);
    bi_total_invert(a, sh);
    for (int j = 0; j < a.TB; ++j) bi_total_store(a, sh, j);
  }
  if (stages & 4)
    for (long g = 0; g < a.G; ++g)
      for (int j = 0; j < a.T; ++j) bi_sweep(a, g, j);
  return 0;
}

extern "C" long hc_batch_inv_scratch(long n, int threads, int per_thread) {
  return bi_scratch_elems(n, threads, per_thread);
}
