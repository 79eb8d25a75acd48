// Poseidon x^5 permutations of S states held by ONE BLOCK, with the lanes
// packed across the states, or of one state held by a CLUSTER of C blocks:
// the routine of K5 `poseidon_permute_group` (widths t = 33, 65, 129), on the
// 32-bit carry-chain arithmetic of `fr32.cuh`.  Same rounds, same sparse
// partial rounds, same constants (the packs of `native.pack_params`, dense
// matrices transposed: `mT[j][i] = m[i][j]`) and the same lazy row sums with
// one 2^320 reduction per output as `poseidon.cuh` and `poseidon_chain.cuh`,
// so the result is bit-identical to K1, K4 and the host engine.
//
// Slots.  Thread g of block (cluster rank) c plays two parts:
//   row slot      (state g / (R K), row c R + (g / K) % R, part g % K) for
//                 g < S R K, R = ceil(T / C) rows a block.  The K threads of
//                 a row all hold the row's value; in a dense product part k
//                 takes the matrix rows j = k, k + K, ... of the row sum, and
//                 the K unreduced 17-limb sums are added by a shuffle
//                 butterfly before the one reduction (an integer sum is exact
//                 in any order).
//   element slot  in the partial rounds: lane s of warp 0 holds x_0 of state
//                 s (its owner, which takes the S-box), and from thread 32 on
//                 the elements 1..T-1 of the states one after another: T - 1
//                 = 32, 64, 128, so each state's fill whole warps.
// A block has the larger of S R K and 32 + S (T - 1) threads, rounded up to
// whole warps once, not once per state: no warp holds a lone capacity
// element.  Layouts: S > 1 (C = 1) lets one staged matrix tile feed S
// states; K > 1 shortens the dense chain of a thread from T to T / K products
// where the batch is too small to fill the card; C > 1 (S = 1) spreads the
// rows of one state over C SMs for the smallest batches, where one SM's issue
// bounds the dense products.
//
// Per dense product (rf + 1 of them): the row slots of part 0 publish their
// rows (after ARK and x^5 in a full round) into the state buffer of every
// block of the cluster, then the transposed matrix streams through shared
// memory in tiles of J rows, double-buffered: tile q + 1 is fetched
// (`cp.async` on the card) while tile q is used, so each constant read from
// L2 feeds the S states of the block.  One barrier per tile, the first of a
// product across the cluster; the state buffers alternate by product, so the
// next publication never overwrites a buffer still being read.
//
// Partial rounds (rp of them, before the product by `mfinal`): the element
// slots read the state from the shared buffer and run one barrier a round,
// the owners' S-box chain in warp 0 beside the other elements' column
// updates, terms and warp butterflies (`pg_partial_rounds`).  Every block of
// a cluster runs them on its own copy of the whole state, so they exchange
// nothing between blocks.  The elements go back into the shared buffer for
// the product by `mfinal`.
//
// Bounds: a row sum, dense or sparse, is at most T <= 129 products of values
// below P (`fr32.cuh`): below 129 P^2 < 2^516, so 17 limbs hold it, and
// 129 P < 2^320, so fr32_redc320 returns a value below 2P.
//
// The routine is written once for both compilers over an exchange policy E,
// as `poseidon_chain.cuh` is: a thread runs E::N slots, slot i being thread
// e.slot(i) of block e.rank(i); E::sync is the block barrier and E::sync_all
// the cluster's, e.store_all a store into every block's shared memory,
// E::xor_swap the warp shuffle, e.copy_tile / E::wait_tiles the tile copy.
// On the card (`PgThread`) a thread is one slot; `host_check.cpp` runs every
// slot of a cluster in one thread, each step over all slots before the next,
// with one shared memory for the cluster (its blocks hold the same state and
// compute the same partial rounds), so Tier-1 replays this very loop in the
// kernel's order.

#pragma once

#include "poseidon_chain.cuh"

// The layouts (T, S, K, C) the kernel is built for: a width's layout for
// small batches (rows split in one block at t = 33, a cluster per state at
// t = 65, 129) and its packing layout; `ops/poseidon.py` `GROUP_LAYOUTS`
// lists the same, and `group_layout` picks one by B.
#define PG_LAYOUTS(X)                                                   \
  X(33, 1, 4, 1) X(33, 16, 1, 1) X(65, 1, 8, 4) X(65, 8, 1, 1)          \
  X(129, 1, 8, 4) X(129, 4, 1, 1)

// Rows of the transposed matrix in one shared tile: all of it at t = 33
// (34.8 KB), 33 rows at t = 65 (two tiles), 17 at t = 129 (eight tiles).
template <int T_>
struct PgTile {
  static constexpr int J = T_ <= 33 ? T_ : (T_ <= 65 ? 33 : 17);
  static constexpr int N = (T_ + J - 1) / J;
};

template <int T_, int S_, int K_, int C_>
struct PgShape {
  static constexpr int T = T_, S = S_, K = K_, C = C_;
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0,
                "a row's K parts lie in one warp");
  static_assert((T - 1) % 32 == 0, "elements 1..T-1 fill whole warps");
  static_assert(C >= 1 && C <= 8 && (C == 1 || S == 1),
                "a cluster holds one state");
  static constexpr int R = (T + C - 1) / C;  // rows a block
  static constexpr int SLOTS = S * R * K;
  // the row slots, or the owners' warp and the other elements' warps
  static constexpr int THREADS = (SLOTS + 31) / 32 * 32 > 32 + S * (T - 1)
                                     ? (SLOTS + 31) / 32 * 32
                                     : 32 + S * (T - 1);
  static_assert(S <= 32 && THREADS <= 1024, "one block");
  // warps of one state's elements 1..T-1: the pieces of a sparse row sum
  static constexpr int PIECES = (T - 1) / 32;
  static constexpr int J = PgTile<T>::J, NTILE = PgTile<T>::N;
  static constexpr int TILE = J * T * 8;
  static constexpr int ST = S * T * 8;
  static constexpr int PART = S * PIECES * FR32_ACC;
  // shared words: two tiles, two state buffers, two sets of S-box outputs
  // and of piece sums (by the parity of the round); every 8-word element
  // starts on a 32-byte boundary (16-byte loads)
  static constexpr int WORDS = 2 * TILE + 2 * ST + 2 * S * 8 + 2 * PART;
};

// Threads and dynamic shared bytes of a built layout; 1 for any other.
static inline int pg_shape(int t, int S, int K, int C, int *threads,
                           int *bytes) {
#define PG_SHAPE_CASE(TT, SS, KK, CC)                    \
  if (t == TT && S == SS && K == KK && C == CC) {        \
    *threads = PgShape<TT, SS, KK, CC>::THREADS;         \
    *bytes = PgShape<TT, SS, KK, CC>::WORDS * 4;         \
    return 0;                                            \
  }
  PG_LAYOUTS(PG_SHAPE_CASE)
#undef PG_SHAPE_CASE
  return 1;
}

// x = 8 words of shared memory (16-byte aligned).
FR32_FN void pg_lds(const u32 *p, u32 *x) {
#ifdef __CUDACC__
  const uint4 a = reinterpret_cast<const uint4 *>(p)[0];
  const uint4 b = reinterpret_cast<const uint4 *>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
#else
  for (int l = 0; l < 8; ++l) x[l] = p[l];
#endif
}

FR32_FN void pg_sts(u32 *p, const u32 *x) {
#pragma unroll
  for (int l = 0; l < 8; ++l) p[l] = x[l];
}

// The row slot of thread g in block c; false for a thread past the last
// slot or a row past T, which shadows row 0 (it keeps the shuffles company
// and writes nothing).
template <class G>
FR32_FN bool pg_row(int g, int c, int &s, int &i, int &kp) {
  const bool on = g < G::SLOTS && c * G::R + (g / G::K) % G::R < G::T;
  const int h = on ? g : 0;
  s = h / (G::R * G::K);
  i = on ? c * G::R + (h / G::K) % G::R : 0;
  kp = h % G::K;
  return on;
}

// Starts the copy of tile q of the sequence (dense product q / N, rows
// (q % N) J ...) into its buffer.
template <class G, class E>
FR32_FN void pg_fetch(const E &e, const ChainConsts &k, int q, u32 *tiles) {
  const int d = q / G::NTILE, j0 = (q % G::NTILE) * G::J;
  const int rows = G::T - j0 < G::J ? G::T - j0 : G::J;
  const u32 *m = d == k.rf / 2 ? k.mfinalT : k.mdsT;
  e.copy_tile(tiles + (q & 1) * G::TILE, m + (long)j0 * G::T * 8,
              rows * G::T * 8);
}

// Row slots of part 0 write their value into the state buffer of every block
// of the cluster.
template <class G, class E>
FR32_FN void pg_publish(const u32 (*x)[8], const E &e, u32 *st) {
#pragma unroll
  for (int i = 0; i < E::N; ++i) {
    int s, row, kp;
    if (pg_row<G>(e.slot(i), e.rank(i), s, row, kp) && kp == 0)
      e.store_all(st + (s * G::T + row) * 8, x[i]);
  }
}

// The dense product of tiles q .. q + N - 1 on the published state `st`:
// x <- row i of mT . state on every row slot.  Fetches the tile after each.
// The first barrier is the cluster's: every block's rows are in.
template <class G, class E>
FR32_FN void pg_dense(u32 (*x)[8], const E &e, const ChainConsts &k, int q,
                      const u32 *st, u32 *tiles) {
  constexpr int T = G::T, K = G::K;
  const int last = (k.rf + 1) * G::NTILE;
  u32 acc[E::N][FR32_ACC];
#pragma unroll
  for (int i = 0; i < E::N; ++i)
#pragma unroll
    for (int l = 0; l < FR32_ACC; ++l) acc[i][l] = 0;
#pragma unroll 1
  for (int n = 0; n < G::NTILE; ++n, ++q) {
    E::wait_tiles();
    // tile q and the state are in; tile q - 1 is done with
    if (n == 0) E::sync_all();
    else E::sync();
    if (q + 1 < last) pg_fetch<G>(e, k, q + 1, tiles);
    const u32 *tq = tiles + (q & 1) * G::TILE;
    const int j0 = n * G::J, rows = T - j0 < G::J ? T - j0 : G::J;
#pragma unroll
    for (int i = 0; i < E::N; ++i) {
      int s, row, kp;
      pg_row<G>(e.slot(i), e.rank(i), s, row, kp);
#pragma unroll 1
      for (int jj = kp; jj < rows; jj += K) {
        u32 c[8], xj[8];
        pg_lds(tq + (jj * T + row) * 8, c);
        pg_lds(st + (s * T + j0 + jj) * 8, xj);
        fr32_acc_mul(c, xj, acc[i]);
      }
    }
  }
#pragma unroll
  for (int d = K / 2; d >= 1; d >>= 1) {
    u32 o[E::N][FR32_ACC];
    E::xor_swap(acc, d, o);
#pragma unroll
    for (int i = 0; i < E::N; ++i) fr32_acc_add(acc[i], o[i]);
  }
#pragma unroll
  for (int i = 0; i < E::N; ++i) fr32_redc320(acc[i], x[i]);
}

// The element a thread holds in the partial rounds: lane s < S of warp 0
// holds x_0 of state s (the owner; returns 0), thread 32 + s (T-1) + j - 1
// holds x_j for j >= 1 (returns j); -1 for a thread that holds none.
template <class G>
FR32_FN int pg_element(int g, int &s) {
  if (g < G::S) {
    s = g;
    return 0;
  }
  const int e = g - 32;
  s = e / (G::T - 1);
  return g >= 32 && e < G::S * (G::T - 1) ? 1 + e % (G::T - 1) : -1;
}

// The constants of round r for the element j a thread holds: the owner's
// a = rc_part[r] and b = qrow[r-1][0]; element j's a = qcol[r-1][j-1] and
// b = qrow[r][j].  Each is read where it exists.
template <int T>
FR32_FN void pg_round_consts(const ChainConsts &k, int r, int j, u32 *a,
                             u32 *b) {
  if (j == 0) {
    fr32_load(k.rc_part + r * 8, a);
    if (r > 0) fr32_load(k.qrow + (long)(r - 1) * T * 8, b);
  } else if (j > 0) {
    if (r > 0) fr32_load(k.qcol + ((long)(r - 1) * (T - 1) + j - 1) * 8, a);
    if (r + 1 < k.rp) fr32_load(k.qrow + ((long)r * T + j) * 8, b);
  }
}

// The rp partial rounds on the states in `st`; the result goes back there.
// Round r, after the barrier that ends round r - 1: the owner of state s
// finishes x_0 = REDC(sum of the pieces of round r - 1 + qrow[r-1][0] s_{r-1})
// and takes s_r = (x_0 + c_r)^5, while the threads of x_j, j >= 1, in other
// warps, finish round r - 1's x_j += qcol[r-1][j-1] s_{r-1} and form the term
// qrow[r][j] x_j of round r, sum the terms of their warp by a butterfly and
// write the warp's piece.  The next round's constants are read before the
// barrier.  So one barrier a round, and the owner's chain (three products of
// the S-box, one lazy product, one reduction) runs beside the others' work.
template <class G, class E>
FR32_FN void pg_partial_rounds(const E &e, const ChainConsts &k, u32 *st,
                               u32 *part, u32 *sr) {
  constexpr int T = G::T, S = G::S, W = G::PIECES;
  u32 y[E::N][8], ca[E::N][8], cb[E::N][8];
#pragma unroll
  for (int i = 0; i < E::N; ++i) {
    int s;
    const int j = pg_element<G>(e.slot(i), s);
    if (j >= 0) pg_lds(st + (s * T + j) * 8, y[i]);
    pg_round_consts<T>(k, 0, j, ca[i], cb[i]);
  }
#pragma unroll 1
  for (int r = 0; r < k.rp; ++r) {
    const bool more = r + 1 < k.rp;
    const u32 *pp = part + ((r + 1) & 1) * S * W * FR32_ACC;  // round r - 1
    const u32 *sp = sr + ((r + 1) & 1) * S * 8;
    u32 acc[E::N][FR32_ACC];
#pragma unroll
    for (int i = 0; i < E::N; ++i) {
      int s;
      const int j = pg_element<G>(e.slot(i), s);
#pragma unroll
      for (int l = 0; l < FR32_ACC; ++l) acc[i][l] = 0;
      if (j == 0) {
        if (r > 0) {
          for (int w = 0; w < W; ++w)
            fr32_acc_add(acc[i], pp + (s * W + w) * FR32_ACC);
          fr32_acc_mul(cb[i], y[i], acc[i]);
          fr32_redc320(acc[i], y[i]);
        }
        fr32_add(y[i], ca[i], y[i]);  // s_r = (x_0 + c_r)^5
        fr32_pow5(y[i], y[i]);
        if (more) pg_sts(sr + (r & 1) * S * 8 + s * 8, y[i]);
#pragma unroll
        for (int l = 0; l < FR32_ACC; ++l) acc[i][l] = 0;
      } else if (j > 0) {
        if (r > 0) {
          u32 s0[8], u[8];
          pg_lds(sp + s * 8, s0);
          fr32_mont_mul<true>(ca[i], s0, u);
          fr32_add(y[i], u, y[i]);
        }
        if (more) fr32_acc_mul(cb[i], y[i], acc[i]);
      }
      if (more) pg_round_consts<T>(k, r + 1, j, ca[i], cb[i]);
    }
    if (!more) break;
    // Warp 0 (the owners) takes no part; the host policy runs every slot.
    if (E::N > 1 || e.slot(0) >= 32) {
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
        u32 o[E::N][FR32_ACC];
        E::xor_swap(acc, d, o);
#pragma unroll
        for (int i = 0; i < E::N; ++i) fr32_acc_add(acc[i], o[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < E::N; ++i) {
      const int g = e.slot(i);
      int s;
      if (pg_element<G>(g, s) > 0 && (g & 31) == 0) {
        u32 *dst = part + ((r & 1) * S * W + s * W +
                           (g - 32 - s * (T - 1)) / 32) * FR32_ACC;
#pragma unroll
        for (int l = 0; l < FR32_ACC; ++l) dst[l] = acc[i][l];
      }
    }
    E::sync();
  }
#pragma unroll
  for (int i = 0; i < E::N; ++i) {
    int s;
    const int j = pg_element<G>(e.slot(i), s);
    if (j >= 0) pg_sts(st + (s * T + j) * 8, y[i]);
  }
}

// Permutes the S states whose rows the row slots hold in x (every part of a
// row holds the row's value; slots past the last, and states past the end
// of the batch, hold anything).  Every thread of the cluster calls it; `sh`
// is PgShape::WORDS words of shared memory, 16-byte aligned.
template <class G, class E>
PC_FN void poseidon_permute_group(u32 (*x)[8], const E &e,
                                  const ChainConsts &k, u32 *sh) {
  u32 *tiles = sh, *st = sh + 2 * G::TILE, *sr = st + 2 * G::ST;
  u32 *part = sr + 2 * G::S * 8;
  const int half = k.rf / 2;
  pg_fetch<G>(e, k, 0, tiles);
  E::sync_all();  // every block of the cluster runs before one writes to it
#pragma unroll 1
  for (int d = 0; d <= k.rf; ++d) {
    u32 *stp = st + (d & 1) * G::ST;
    if (d == half) {
      pg_publish<G>(x, e, stp);
      E::sync_all();
      pg_partial_rounds<G>(e, k, stp, part, sr);
    } else {
      const int r = d < half ? d : d - 1;
#pragma unroll
      for (int i = 0; i < E::N; ++i) {
        int s, row, kp;
        pg_row<G>(e.slot(i), e.rank(i), s, row, kp);
        pc_ark_sbox(k.rc_full + ((long)r * G::T + row) * 8, x[i], x[i]);
      }
      pg_publish<G>(x, e, stp);
    }
    pg_dense<G>(x, e, k, d * G::NTILE, stp, tiles);
  }
}

#ifdef __CUDACC__
#include <cooperative_groups.h>

// The card's policy: a thread is one slot; C blocks make a cluster.
template <int C>
struct PgThread {
  static constexpr int N = 1;
  int g;
  __device__ int slot(int) const { return g; }
  __device__ int rank(int) const {
    return C == 1 ? 0 : (int)cooperative_groups::this_cluster().block_rank();
  }
  __device__ static void sync() { __syncthreads(); }
  __device__ static void sync_all() {
    if (C == 1) __syncthreads();
    else cooperative_groups::this_cluster().sync();
  }
  // x into p and into the same place in every other block of the cluster
  __device__ void store_all(u32 *p, const u32 *x) const {
    if (C == 1) {
      pg_sts(p, x);
      return;
    }
    auto cl = cooperative_groups::this_cluster();
#pragma unroll
    for (int r = 0; r < C; ++r) pg_sts(cl.map_shared_rank(p, r), x);
  }
  template <int W>
  __device__ static void xor_swap(u32 (*v)[W], int d, u32 (*o)[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      o[0][w] = __shfl_xor_sync(0xffffffffu, v[0][w], d);
  }
  // The block copies `words` (a multiple of 4) in 16-byte pieces.
  __device__ void copy_tile(u32 *dst, const u32 *src, int words) const {
    for (int c = 4 * g; c < words; c += 4 * (int)blockDim.x) {
      const unsigned a = (unsigned)__cvta_generic_to_shared(dst + c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a),
                   "l"(src + c)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  __device__ static void wait_tiles() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
};
#endif  // __CUDACC__
