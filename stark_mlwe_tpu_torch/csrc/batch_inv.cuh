// The batch inversion of `fr_batch_inv.cu`: Montgomery's trick over Fr on
// `fr32.cuh`, in three launches with nothing read back,
//
//   out[i] = phi[i] * (x[i] - z)^-1     (Montgomery form; z and phi optional)
//
// written as per-thread steps: on the card each step is one thread's work
// between two barriers; under g++ `host_check.cpp` runs every thread of a
// block through a step before the next, block after block.
//
//   A  scan   block g holds T*E consecutive elements, thread j a run of E.
//             The thread forms d = x - z and the running products of its run
//             (all but the last kept in scratch `pre`) and puts the run's
//             total in shared memory; a prefix and a suffix scan over the T
//             totals (log2 T steps, one barrier each, both products of a step
//             independent) give every thread the product of the OTHER
//             threads' totals (`all_but`) and the block its total (`tot`).
//   B  total  one block of TB threads does the same over the G block totals
//             (runs of EB), thread 0 inverts the grand total with fr32_inv
//             (296 dependent products: the serial floor of the design), and
//             every thread sweeps its run back into the inverse of each
//             block's total (`tot_inv`).
//   C  sweep  block g: thread j's inverse of its own total is
//             tot_inv[g] * all_but[j]; the sweep back over its run gives each
//             element's inverse (times phi[i]).
//
// Elements past n, and threads without any, count as 1.  A zero anywhere
// makes the grand total 0, fr32_inv(0) = 0, and every output 0, as the JAX
// package's `batch_inv` gives.  Scratch is read by plain loads: stage B reads
// back what it wrote itself.

#pragma once

#include "fr32.cuh"

#ifdef __CUDACC__
#define BI_HD __host__ __device__ inline
#else
#define BI_HD static inline
#endif

#define BI_MAX_THREADS 256

struct BiArgs {
  const u32 *x, *z, *phi;  // x [n]; z one element, phi [n]; null when absent
  u32 *out;                // [n]
  u32 *pre;                // scratch [n] when E > 1: running products
  u32 *all_but;            // scratch [G * T]
  u32 *tot, *tot_pre, *tot_inv;  // scratch [G] each
  long n, G;
  int T, E, TB, EB;
};

BI_HD long bi_blocks(long n, int T, int E) {
  return (n + (long)T * E - 1) / ((long)T * E);
}

// Elements of scratch for n elements in blocks of T threads of E.
BI_HD long bi_scratch_elems(long n, int T, int E) {
  const long G = bi_blocks(n, T, E);
  return (E > 1 ? n : 0) + G * T + 3 * G;
}

// 32-bit words of shared memory for a block of T threads: two buffers of
// prefix and suffix products, then the inverse of stage B's grand total.
BI_HD int bi_shared_words(int T) { return 4 * T * 8 + 8; }

BI_HD bool bi_threads_ok(int T) {
  return T >= 2 && T <= BI_MAX_THREADS && (T & (T - 1)) == 0;
}

// The arguments of one call, scratch cut into its regions; false on a layout
// or a scratch size the kernels do not take.
BI_HD bool bi_args(const u32 *x, const u32 *z, const u32 *phi, u32 *out,
                   u32 *scratch, long scratch_elems, long n, int T, int E,
                   int TB, BiArgs *a) {
  if (n < 1 || E < 1 || !bi_threads_ok(T) || !bi_threads_ok(TB) ||
      scratch_elems < bi_scratch_elems(n, T, E))
    return false;
  a->x = x; a->z = z; a->phi = phi; a->out = out;
  a->n = n; a->T = T; a->E = E; a->TB = TB;
  a->G = bi_blocks(n, T, E);
  a->EB = (int)((a->G + TB - 1) / TB);
  u32 *p = scratch;
  a->pre = p;
  p += (E > 1 ? n : 0) * 8;
  a->all_but = p;
  p += a->G * T * 8;
  a->tot = p;
  a->tot_pre = p + a->G * 8;
  a->tot_inv = p + 2 * a->G * 8;
  return true;
}

FR32_FN void bi_copy(const u32 *p, u32 *x) {
#pragma unroll
  for (int l = 0; l < 8; ++l) x[l] = p[l];
}

FR32_FN void bi_one(u32 *x) {  // R mod P, the Montgomery form of 1
  const u32 one[8] = {0xfffffffdu, 0x5b2b3e9cu, 0xe3420567u, 0x992c350bu,
                      0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu};
#pragma unroll
  for (int l = 0; l < 8; ++l) x[l] = one[l];
}

// Shared element j of buffer b (0, 1), kind k (0 prefix, 1 suffix).
FR32_FN u32 *bi_sh(u32 *sh, int T, int b, int k, int j) {
  return sh + ((b * 2 + k) * T + j) * 8;
}

FR32_FN int bi_log2(int T) {
  int s = 0;
  while ((1 << s) < T) ++s;
  return s;
}

// d = x[i] - z (or x[i]).
FR32_FN void bi_input(const u32 *x, const u32 *z, long i, u32 *d) {
  bi_copy(x + i * 8, d);
  if (z) {
    u32 zz[8];
    bi_copy(z, zz);
    fr32_sub(d, zz, d);
  }
}

// The running products of the run [lo, hi) of x - z: all but the last into
// pre[lo .. hi - 2], the last (the run's total; 1 for an empty run) into the
// thread's slots of shared buffer 0.
FR32_FN void bi_run(const u32 *x, const u32 *z, u32 *pre, long lo, long hi,
                    u32 *sh, int T, int j) {
  u32 acc[8];
  bi_one(acc);
#pragma unroll 1
  for (long i = lo; i < hi; ++i) {
    u32 d[8];
    bi_input(x, z, i, d);
    if (i == lo) bi_copy(d, acc);
    else fr32_mont_mul<true>(acc, d, acc);
    if (i + 1 < hi) bi_copy(acc, pre + i * 8);
  }
  bi_copy(acc, bi_sh(sh, T, 0, 0, j));
  bi_copy(acc, bi_sh(sh, T, 0, 1, j));
}

// Scan step s (offset 2^s) over the T run totals: inclusive prefix and suffix
// products, from buffer s & 1 into the other.
FR32_FN void bi_scan_step(u32 *sh, int T, int s, int j) {
  const int o = 1 << s, src = s & 1, dst = src ^ 1;
  u32 p[8], q[8], y[8], w[8];
  bi_copy(bi_sh(sh, T, src, 0, j), p);
  bi_copy(bi_sh(sh, T, src, 1, j), q);
  if (j >= o) {
    bi_copy(bi_sh(sh, T, src, 0, j - o), y);
    fr32_mont_mul<true>(y, p, p);
  }
  if (j + o < T) {
    bi_copy(bi_sh(sh, T, src, 1, j + o), w);
    fr32_mont_mul<true>(q, w, q);
  }
  bi_copy(p, bi_sh(sh, T, dst, 0, j));
  bi_copy(q, bi_sh(sh, T, dst, 1, j));
}

// After the scan: the product of every run total of the block but thread j's
// own (the prefix before j times the suffix after it).
FR32_FN void bi_all_but(u32 *sh, int T, int j, u32 *out) {
  const int b = bi_log2(T) & 1;
  if (j == 0) bi_copy(bi_sh(sh, T, b, 1, 1), out);
  else if (j == T - 1) bi_copy(bi_sh(sh, T, b, 0, T - 2), out);
  else fr32_mont_mul<true>(bi_sh(sh, T, b, 0, j - 1),
                           bi_sh(sh, T, b, 1, j + 1), out);
}

FR32_FN u32 *bi_block_total(u32 *sh, int T) {
  return bi_sh(sh, T, bi_log2(T) & 1, 0, T - 1);
}

// From acc, the inverse of the run's total, back to each element's inverse
// (times phi[i] when phi is given) into out[lo .. hi - 1]; acc is clobbered.
FR32_FN void bi_sweep_run(const u32 *x, const u32 *z, const u32 *pre,
                          const u32 *phi, u32 *out, long lo, long hi,
                          u32 *acc) {
  u32 r[8], y[8];
#pragma unroll 1
  for (long i = hi - 1; i > lo; --i) {
    bi_copy(pre + (i - 1) * 8, y);
    fr32_mont_mul<true>(acc, y, r);
    if (phi) {
      bi_copy(phi + i * 8, y);
      fr32_mont_mul<true>(r, y, r);
    }
    bi_copy(r, out + i * 8);
    bi_input(x, z, i, y);
    fr32_mont_mul<true>(acc, y, acc);
  }
  if (phi) {
    bi_copy(phi + lo * 8, y);
    fr32_mont_mul<true>(acc, y, acc);
  }
  bi_copy(acc, out + lo * 8);
}

FR32_FN long bi_min(long a, long b) { return a < b ? a : b; }

// ---- stage A (grid G, T threads) ----
FR32_FN void bi_scan_load(const BiArgs &a, u32 *sh, long g, int j) {
  const long lo = (g * a.T + j) * (long)a.E;
  bi_run(a.x, a.z, a.pre, lo, bi_min(lo + a.E, a.n), sh, a.T, j);
}

FR32_FN void bi_scan_store(const BiArgs &a, u32 *sh, long g, int j) {
  u32 u[8];
  bi_all_but(sh, a.T, j, u);
  bi_copy(u, a.all_but + (g * a.T + j) * 8);
  if (j == 0) bi_copy(bi_block_total(sh, a.T), a.tot + g * 8);
}

// ---- stage B (one block, TB threads) ----
FR32_FN void bi_total_load(const BiArgs &a, u32 *sh, int j) {
  const long lo = (long)j * a.EB;
  bi_run(a.tot, nullptr, a.tot_pre, lo, bi_min(lo + a.EB, a.G), sh, a.TB, j);
}

FR32_FN void bi_total_invert(const BiArgs &a, u32 *sh) {  // thread 0
  fr32_inv(bi_block_total(sh, a.TB), sh + 4 * a.TB * 8);
}

FR32_FN void bi_total_store(const BiArgs &a, u32 *sh, int j) {
  const long lo = (long)j * a.EB, hi = bi_min(lo + a.EB, a.G);
  if (lo >= hi) return;
  u32 acc[8];
  bi_all_but(sh, a.TB, j, acc);
  fr32_mont_mul<true>(acc, sh + 4 * a.TB * 8, acc);
  bi_sweep_run(a.tot, nullptr, a.tot_pre, nullptr, a.tot_inv, lo, hi, acc);
}

// ---- stage C (grid G, T threads) ----
FR32_FN void bi_sweep(const BiArgs &a, long g, int j) {
  const long lo = (g * a.T + j) * (long)a.E, hi = bi_min(lo + a.E, a.n);
  if (lo >= hi) return;
  u32 acc[8], u[8];
  bi_copy(a.tot_inv + g * 8, acc);
  bi_copy(a.all_but + (g * a.T + j) * 8, u);
  fr32_mont_mul<true>(acc, u, acc);
  bi_sweep_run(a.x, a.z, a.pre, a.phi, a.out, lo, hi, acc);
}
