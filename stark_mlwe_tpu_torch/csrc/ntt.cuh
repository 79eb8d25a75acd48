// Per-thread steps of the batched radix-2 NTT tile kernel (K6 `fr_ntt_tiles`)
// on top of `fr.cuh`.
//
// A block owns `tpb` whole transforms of length L = 2^logL in shared memory
// (`tpb << logL` elements of 32 bytes, then three longs per transform: input
// offset, output offset, epilogue row).  Its work is a sequence of steps with
// a block barrier between them:
//
//   offsets   one thread per transform: where it lies in `in` and `out`
//   load      element i of a transform goes to slot bitrev(i): the
//             bit-reversal is an index of the load, not a pass of its own
//   stage s   (s = 0 .. logL-1, half h = 2^s) butterflies on pairs (e, e+h):
//             o' = o * w_L^(j * L/2h), (e, o) <- (e + o', e - o'); stage 0
//             skips the multiply (its twiddle is 1)
//   store     slot i, times the epilogue entry where there is one, goes to
//             element i of the transform in `out`
//
// Each step here is ONE thread's share (`tid` of `nthreads`, a strided loop),
// so the CUDA kernel runs it for every thread of the block and the host check
// (`host_check.cpp`, g++) replays it thread by thread.  All strides are in
// elements.  The transforms of a block lie back to back in shared memory and
// L is a multiple of every stage's group, so a stage is one loop over
// `tpb * L / 2` butterflies with no notion of where a transform ends.

#pragma once

#include <stddef.h>

#include "fr.cuh"

#define NTT_MAX_LEVELS 8

// The batch is a mixed-radix index: transform b has digit b % cnt[0] at
// level 0 (the innermost), then (b / cnt[0]) % cnt[1], ...; the last level
// takes what remains.  Each level has its own stride in `in` and in `out`,
// so a transform may be a row, a column or a column of a sub-matrix of the
// tensors, and the transposes of a four-step NTT are strides of this kernel.
struct NttTileArgs {
  const u64 *in;
  u64 *out;
  const u64 *wt;   // [L/2] stage twiddles w_L^j, Montgomery form
  const u64 *ep;   // [ep_period, L] epilogue multipliers, or null
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

FR_FN unsigned ntt_bitrev(unsigned i, int logL) {
#ifdef __CUDACC__
  return __brev(i) >> (32 - logL);
#else
  unsigned r = 0;
  for (int b = 0; b < logL; ++b) r |= ((i >> b) & 1u) << (logL - 1 - b);
  return r;
#endif
}

// offs[0..2] of transform b: input offset, output offset, epilogue row.
FR_FN void ntt_offsets(const NttTileArgs &a, long b, long *offs) {
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

FR_FN void ntt_offsets_thread(const NttTileArgs &a, long first, int nvalid,
                              long *offs, unsigned tid, unsigned nthreads) {
  for (unsigned t = tid; t < (unsigned)nvalid; t += nthreads)
    ntt_offsets(a, first + t, offs + 3 * t);
}

FR_FN void ntt_load_thread(const NttTileArgs &a, int nvalid, u64 *sh,
                           const long *offs, unsigned tid, unsigned nthreads) {
  const unsigned mask = (1u << a.logL) - 1u;
  const unsigned total = (unsigned)nvalid << a.logL;
  for (unsigned idx = tid; idx < total; idx += nthreads) {
    const unsigned t = idx >> a.logL, i = idx & mask;
    const u64 *src = a.in + (offs[3 * t] + (long)i * a.in_es) * 4;
    u64 *dst = sh + (size_t)((t << a.logL) + ntt_bitrev(i, a.logL)) * 4;
#pragma unroll
    for (int l = 0; l < 4; ++l) dst[l] = src[l];
  }
}

// One butterfly on the pair (e, o) in place; `w` is read only if `mul`.
FR_FN void ntt_butterfly(u64 *e, u64 *o, const u64 *w, bool mul) {
  u64 x[4], y[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    x[l] = e[l];
    y[l] = o[l];
  }
  if (mul) {
    u64 tw[4];
    fr_load(w, tw);
    fr_mont_mul(y, tw, y);
  }
  fr_add(x, y, e);
  fr_sub(x, y, o);
}

// Stage s (half h = 2^s): butterfly k has j = k mod h, its even slot is
// (k div h) * 2h + j, its twiddle is entry j * L/2h of `wt`.
FR_FN void ntt_stage_thread(const NttTileArgs &a, int nvalid, u64 *sh, int s,
                            unsigned tid, unsigned nthreads) {
  const unsigned h = 1u << s;
  const unsigned nbf = ((unsigned)nvalid << a.logL) >> 1;
  for (unsigned k = tid; k < nbf; k += nthreads) {
    const unsigned j = k & (h - 1u);
    const unsigned e = ((k >> s) << (s + 1)) | j;
    u64 *pe = sh + (size_t)e * 4;
    ntt_butterfly(pe, pe + (size_t)h * 4,
                  a.wt + ((size_t)j << (a.logL - 1 - s)) * 4, s > 0);
  }
}

FR_FN void ntt_store_thread(const NttTileArgs &a, int nvalid, const u64 *sh,
                            const long *offs, unsigned tid,
                            unsigned nthreads) {
  const unsigned mask = (1u << a.logL) - 1u;
  const unsigned total = (unsigned)nvalid << a.logL;
  for (unsigned idx = tid; idx < total; idx += nthreads) {
    const unsigned t = idx >> a.logL, i = idx & mask;
    u64 x[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) x[l] = sh[(size_t)idx * 4 + l];
    if (a.ep) {
      u64 m[4];
      fr_load(a.ep + (((size_t)offs[3 * t + 2] << a.logL) + i) * 4, m);
      fr_mont_mul(x, m, x);
    }
    u64 *dst = a.out + (offs[3 * t + 1] + (long)i * a.out_es) * 4;
#pragma unroll
    for (int l = 0; l < 4; ++l) dst[l] = x[l];
  }
}

// Shared memory of a block, in bytes.
static inline size_t ntt_shared_bytes(int logL, int tpb) {
  return ((size_t)tpb << logL) * 32 + (size_t)tpb * 3 * sizeof(long);
}
