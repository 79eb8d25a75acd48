// Per-thread steps of the batched radix-2 NTT tile kernel (K6 `fr_ntt_tiles`)
// on `fr32.cuh`.
//
// A block owns `tpb` whole transforms of length L = 2^logL in shared memory:
// S = tpb * L slots of one element, stored as eight limb planes (limb l of
// slot x at sh[l * SP + ntt_phys(x)], SP = S rounded up to 32 words), then
// three longs per transform (input offset, output offset, epilogue row).
// Slot x = t * L + i holds element i of the block's transform t.  Its work
// is a sequence of steps with a block barrier between them:
//
//   offsets   one thread per transform: where it lies in `in` and `out`
//   load      element i of a transform goes to slot bitrev(i): the
//             bit-reversal is an index of the load, not a pass of its own;
//             slots of transforms past the batch's end get zeros
//   pass      the radix-2 decimation-in-time stages s = s0 .. s0+q-1 (half
//             h = 2^s; pairs (e, e+h), o' = o * w_L^(j L/2h) with
//             j = e mod h, (e, o) <- (e + o', e - o'); stage 0 skips the
//             multiply): a thread takes a group of 2^R slots that differ
//             only in the R slot bits s0 .. s0+R-1, loads them into
//             registers, runs the q <= R stages on them there and stores
//             them back.  So a barrier and a shared-memory round trip come
//             once every R stages: the first pass takes logL mod R stages
//             (R where that is 0, all logL where logL < R) and every later
//             pass R, e.g. 1 + 2 + 2 + 2 + 2 + 2 at L = 2,048, R = 2, or
//             2 + 3 + 3 + 3 at R = 3.  Where the
//             first pass takes fewer than R stages, the group's other bits
//             are independent butterflies; where logL < R they are slots of
//             the next transforms (so S is a multiple of 2^R).
//   store     slot i, times the epilogue entry where there is one, goes to
//             element i of the transform in `out`
//
// Each step here is ONE thread's share (`tid` of `nthreads`, a strided loop
// over elements or groups), so the CUDA kernel runs it for every thread of
// the block and the host check (`host_check.cpp`, g++) replays it thread by
// thread.  All strides are in elements.
//
// Banks.  The 32 lanes of a warp access one limb plane together: in the load
// they write the slots bitrev(i) of 32 consecutive i (slot bits logL-5 ..
// logL-1 vary), in the store they read 32 consecutive slots (bits 0..4), and
// in a pass at s0 they hold consecutive groups g, so for one register k they
// touch the slots whose bits outside the window [s0, s0+R) are the lane's:
// the five lowest bits outside the window vary.  A plain plane maps bank =
// slot mod 32, so wherever the varying bits include any at or above 5 the
// accesses pile onto few banks (a pass at s0 = 0 with R = 3: 8 lanes a
// bank).  `ntt_phys` flips the five bank bits of a slot by a linear function
// of its row (slot >> 5): row bit i flips the bits of NTT_SWZ[i].  The table
// was found by a search over all such functions for one under which every
// access pattern above (R = 2, 3, 4 at every window position s0 < 5, and
// the load at every logL from 5 to 12) sends the 32 lanes to 32 banks; for
// s0 >= 5 and in the store the lanes differ only in the bank bits, which
// any row flip permutes.  Flipping bank bits inside a row of 32 slots is a
// bijection on the row, so no slot collides.

#pragma once

#include <stddef.h>

#include "fr32.cuh"

#ifdef __CUDACC__
#define NTT_HD __host__ __device__ inline
#else
#define NTT_HD static inline
#endif

#define NTT_MAX_LEVELS 8
#define NTT_MAX_LOG_L 12
// K6's layout: the passes' radix (2^R elements a thread, R stages a pass),
// its `__launch_bounds__` (which caps a thread at 128 registers) and the
// threads a block it takes (two groups a thread at L = 2,048: 8 warps a
// block, two blocks an SM).  The fastest at the 2^22 columns and rows among
// the layouts of scripts/ntt_tile_sweep.py, which builds R = 3 and 4 from
// the same steps and prints each instance's registers and spills (PERF.md,
// section 6).
#define NTT_R 2
#define NTT_MAX_THREADS 512
#define NTT_THREADS 256

// The batch is a mixed-radix index: transform b has digit b % cnt[0] at
// level 0 (the innermost), then (b / cnt[0]) % cnt[1], ...; the last level
// takes what remains.  Each level has its own stride in `in` and in `out`,
// so a transform may be a row, a column or a column of a sub-matrix of the
// tensors, and the transposes of a four-step NTT are strides of this kernel.
struct NttTileArgs {
  const u32 *in;
  u32 *out;
  const u32 *wt;   // [L/2] stage twiddles w_L^j, Montgomery form
  const u32 *ep;   // [ep_period, L] epilogue multipliers, or null
  long B;          // transforms in all
  int logL;
  int tpb;         // transforms per block
  long in_es;      // stride between the elements of one transform
  long out_es;
  long ep_period;  // transform b takes epilogue row b % ep_period
  int nlev;
  long cnt[NTT_MAX_LEVELS];
  long in_bs[NTT_MAX_LEVELS];
  long out_bs[NTT_MAX_LEVELS];
};

// The arguments of the C entry point (`cnt`, `in_bs`, `out_bs`: host arrays
// of `nlev` entries, innermost level first) as the kernel takes them; false
// where it takes no such call: B < 1, 2^logL out of 2 .. 4,096, a block
// whose slots are no multiple of 2^R, a level count out of 1 .. 8 or an
// epilogue without rows.
NTT_HD bool ntt_args(NttTileArgs *a, const void *in, void *out,
                     const void *wt, const void *ep, long B, int logL,
                     int tpb, long in_es, long out_es, long ep_period,
                     int nlev, const long *cnt, const long *in_bs,
                     const long *out_bs, int R) {
  if (B < 1 || logL < 1 || logL > NTT_MAX_LOG_L || tpb < 1 || nlev < 1 ||
      nlev > NTT_MAX_LEVELS || (ep != nullptr && ep_period < 1) ||
      (((long)tpb << logL) & ((1L << R) - 1)) != 0)
    return false;
  *a = NttTileArgs{(const u32 *)in, (u32 *)out, (const u32 *)wt,
                   (const u32 *)ep, B, logL, tpb, in_es, out_es, ep_period,
                   nlev, {}, {}, {}};
  for (int k = 0; k < NTT_MAX_LEVELS; ++k) {
    a->cnt[k] = k < nlev ? cnt[k] : 1;
    a->in_bs[k] = k < nlev ? in_bs[k] : 0;
    a->out_bs[k] = k < nlev ? out_bs[k] : 0;
  }
  return true;
}

// 32-bit words of one limb plane: the block's slots rounded up to a row.
NTT_HD unsigned ntt_plane_words(int logL, int tpb) {
  return (((unsigned)tpb << logL) + 31u) & ~31u;
}

// Shared memory of a block, in bytes.
NTT_HD size_t ntt_shared_bytes(int logL, int tpb) {
  return (size_t)ntt_plane_words(logL, tpb) * 8 * 4 +
         (size_t)tpb * 3 * sizeof(long);
}

// Stages of the first pass.
NTT_HD int ntt_first_stages(int logL, int R) {
  const int q = logL % R;
  return q ? q : R;
}

// K6's threads a block: one a group of 2^NTT_R slots, at most NTT_THREADS.
NTT_HD int ntt_threads(int logL, int tpb) {
  const long groups = ((long)tpb << logL) >> NTT_R;
  return groups < NTT_THREADS ? (int)groups : NTT_THREADS;
}

FR32_FN unsigned ntt_bitrev(unsigned i, int logL) {
#ifdef __CUDACC__
  return __brev(i) >> (32 - logL);
#else
  unsigned r = 0;
  for (int b = 0; b < logL; ++b) r |= ((i >> b) & 1u) << (logL - 1 - b);
  return r;
#endif
}

// The bank bits that row bit i of a slot flips (see Banks above).
FR32_FN unsigned ntt_swz(int i) {
  return i == 0   ? 11u
         : i == 1 ? 21u
         : i == 2 ? 25u
         : i == 3 ? 17u
         : i == 4 ? 1u
         : i == 5 ? 2u
                  : 4u;
}

FR32_FN unsigned ntt_phys(unsigned x) {
  const unsigned row = x >> 5;
  unsigned h = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) h ^= ((row >> i) & 1u) ? ntt_swz(i) : 0u;
  return x ^ h;
}

// The element at plane position p (= ntt_phys of its slot).
FR32_FN void ntt_lds(const u32 *sh, unsigned sp, unsigned p, u32 *v) {
#pragma unroll
  for (int l = 0; l < 8; ++l) v[l] = sh[l * sp + p];
}

FR32_FN void ntt_sts(u32 *sh, unsigned sp, unsigned p, const u32 *v) {
#pragma unroll
  for (int l = 0; l < 8; ++l) sh[l * sp + p] = v[l];
}

// offs[0..2] of transform b: input offset, output offset, epilogue row.
FR32_FN void ntt_offsets(const NttTileArgs &a, long b, long *offs) {
  long io = 0, oo = 0, r = b;
  for (int k = 0; k < a.nlev; ++k) {
    long c = r;
    if (k < a.nlev - 1) {
      c = r % a.cnt[k];
      r /= a.cnt[k];
    }
    io += c * a.in_bs[k];
    oo += c * a.out_bs[k];
  }
  offs[0] = io;
  offs[1] = oo;
  offs[2] = a.ep ? b % a.ep_period : 0;
}

FR32_FN void ntt_offsets_thread(const NttTileArgs &a, long first, int nvalid,
                                long *offs, unsigned tid, unsigned nthreads) {
  for (unsigned t = tid; t < (unsigned)nvalid; t += nthreads)
    ntt_offsets(a, first + t, offs + 3 * t);
}

FR32_FN void ntt_load_thread(const NttTileArgs &a, int nvalid, u32 *sh,
                             unsigned sp, const long *offs, unsigned tid,
                             unsigned nthreads) {
  const unsigned mask = (1u << a.logL) - 1u;
  const unsigned total = (unsigned)a.tpb << a.logL;
  for (unsigned idx = tid; idx < total; idx += nthreads) {
    const unsigned t = idx >> a.logL, i = idx & mask;
    u32 x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (t < (unsigned)nvalid)
      fr32_load_vec(a.in + (offs[3 * t] + (long)i * a.in_es) * 8, x);
    ntt_sts(sh, sp, ntt_phys((t << a.logL) | ntt_bitrev(i, a.logL)), x);
  }
}

// One butterfly on the pair (e, o) in place; `w` is read only if `mul`.
FR32_FN void ntt_butterfly(u32 *e, u32 *o, const u32 *w, bool mul) {
  if (mul) fr32_mont_mul<true>(o, w, o);
  u32 d[8];
  fr32_sub(e, o, d);
  fr32_add(e, o, e);
#pragma unroll
  for (int l = 0; l < 8; ++l) o[l] = d[l];
}

// One pass: stages s0 .. s0+q-1 (q <= R) on groups of 2^R slots.  Group g
// holds the slots x0 | k << s0 (k < 2^R), x0 being g with a gap of R bits
// opened at s0.  At stage s = s0 + st the pairs are (k, k | 2^st) for k
// with bit st clear, and their twiddle index j = x mod 2^s is the group's
// bits below s0 and k's bits below st: one twiddle serves the 2^(R-1-st)
// pairs with the same k mod 2^st.  Groups wholly in transforms past the
// batch's end are skipped.  x0 and k << s0 have no bit in common and
// ntt_phys is linear over such a union (a bit flip of x and a function of
// x >> 5 that is an exclusive or of one mask per bit), so a slot's plane
// position is ntt_phys(x0) ^ ntt_phys(k << s0), the second the same for all
// groups of the pass.  PRODUCTS = false leaves the twiddle loads and
// products out (wrong results): scripts/ntt_tile_sweep.py times the rest of
// the kernel with it; K6 itself never does.
template <int R, bool PRODUCTS = true>
FR32_FN void ntt_pass_thread(const NttTileArgs &a, int nvalid, u32 *sh,
                             unsigned sp, int s0, int q, unsigned tid,
                             unsigned nthreads) {
  const unsigned groups = ((unsigned)a.tpb << a.logL) >> R;
  const unsigned low = (1u << s0) - 1u;
  unsigned kp[1 << R];
#pragma unroll
  for (int k = 0; k < (1 << R); ++k) kp[k] = ntt_phys((unsigned)k << s0);
  for (unsigned g = tid; g < groups; g += nthreads) {
    const unsigned x0 = ((g & ~low) << R) | (g & low);
    if ((x0 >> a.logL) >= (unsigned)nvalid) continue;
    const unsigned p0 = ntt_phys(x0);
    u32 v[1 << R][8];
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) ntt_lds(sh, sp, p0 ^ kp[k], v[k]);
#pragma unroll
    for (int st = 0; st < R; ++st) {
      if (st >= q) break;
      const int s = s0 + st;
#pragma unroll
      for (int m = 0; m < (1 << st); ++m) {
        u32 w[8];
        const bool mul = PRODUCTS && s > 0;
        if (mul) {
          const unsigned j = (x0 & low) | ((unsigned)m << s0);
          fr32_load_vec(a.wt + ((size_t)j << (a.logL - 1 - s)) * 8, w);
        }
#pragma unroll
        for (int hi = 0; hi < (1 << (R - 1 - st)); ++hi) {
          const int k = (hi << (st + 1)) | m;
          ntt_butterfly(v[k], v[k | (1 << st)], w, mul);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) ntt_sts(sh, sp, p0 ^ kp[k], v[k]);
  }
}

template <bool PRODUCTS = true>
FR32_FN void ntt_store_thread(const NttTileArgs &a, int nvalid,
                              const u32 *sh, unsigned sp, const long *offs,
                              unsigned tid, unsigned nthreads) {
  const unsigned mask = (1u << a.logL) - 1u;
  const unsigned total = (unsigned)nvalid << a.logL;
  for (unsigned idx = tid; idx < total; idx += nthreads) {
    const unsigned t = idx >> a.logL, i = idx & mask;
    u32 x[8];
    ntt_lds(sh, sp, ntt_phys(idx), x);
    if (a.ep) {
      u32 m[8];
      fr32_load_vec(a.ep + (((size_t)offs[3 * t + 2] << a.logL) + i) * 8, m);
      if (PRODUCTS) fr32_mont_mul<true>(x, m, x);
    }
    fr32_store_vec(a.out + (offs[3 * t + 1] + (long)i * a.out_es) * 8, x);
  }
}

#ifdef __CUDACC__
// One block's steps with a barrier between them: the body of K6
// (csrc/fr_ntt.cu) and of the layouts that scripts/ntt_tile_sweep.cu builds
// beside it.  `host_check.cpp` replays the same steps thread by thread.
template <int R, bool PRODUCTS = true>
__device__ inline void ntt_tile_block(const NttTileArgs &a) {
  extern __shared__ __align__(16) u32 sh[];
  const unsigned sp = ntt_plane_words(a.logL, a.tpb);
  long *offs = (long *)(sh + 8 * sp);
  const unsigned tid = threadIdx.x, nthreads = blockDim.x;
  const long first = (long)blockIdx.x * a.tpb;
  const long left = a.B - first;
  const int nvalid = left < a.tpb ? (int)left : a.tpb;

  ntt_offsets_thread(a, first, nvalid, offs, tid, nthreads);
  __syncthreads();
  ntt_load_thread(a, nvalid, sh, sp, offs, tid, nthreads);
  __syncthreads();
  for (int s0 = 0, q = ntt_first_stages(a.logL, R); s0 < a.logL;
       s0 += q, q = R) {
    ntt_pass_thread<R, PRODUCTS>(a, nvalid, sh, sp, s0, q, tid, nthreads);
    __syncthreads();
  }
  ntt_store_thread<PRODUCTS>(a, nvalid, sh, sp, offs, tid, nthreads);
}

// Launches `kernel` (a __global__ wrapper of ntt_tile_block) over the batch
// on `stream`.  More than 48 KB of dynamic shared memory has to be asked
// for: `allowed` holds what this kernel was granted so far (48 KB at first).
template <class Kernel>
inline int ntt_launch(Kernel kernel, const NttTileArgs &a, int threads,
                      cudaStream_t stream, size_t &allowed) {
  const long blocks = (a.B + a.tpb - 1) / a.tpb;
  if (threads < 1 || blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t shared = ntt_shared_bytes(a.logL, a.tpb);
  if (shared > allowed) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (rc != cudaSuccess) return (int)rc;
    allowed = shared;
  }
  kernel<<<(unsigned)blocks, threads, shared, stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
