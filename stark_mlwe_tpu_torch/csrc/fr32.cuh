// Pallas scalar field Fr on 8x32-bit Montgomery limbs (R = 2^256), written as
// carry chains: the one Fr arithmetic of the port's kernels.  Included by K2
// `fr_elementwise`, the batch inversion `fr_batch_inv` (with
// `batch_inv.cuh`), K3 `fr_fold` (with `fold.cuh`), K4
// `poseidon_absorb_chain`, both layouts of K1 `poseidon_permute`, K5
// `poseidon_permute_group` (through `poseidon_chain.cuh`, `poseidon.cuh` and
// `poseidon_group.cuh`) and K6 `fr_ntt_tiles` (with `ntt.cuh`).
//
// An element is `u32[8]`, little-endian: the same bytes as the port's
// `[..., 8] int32` layout and as a `u64[4]`, so no tensor or constant is
// repacked and every result is the same canonical value.
//
// The card's integer multiplier is 32 bits wide.  On it every step below is
// ONE PTX instruction (`mad.lo.cc.u32`, `madc.hi.cc.u32`, `addc.cc.u32`, ...)
// with the carry in the condition-code flag, instead of compare-based
// carries on 64-bit limbs (about 15 dependent instructions per 64-bit
// multiply-add).  Without `__CUDACC__` the same steps are portable C++ with
// the flag held in a variable, one function per PTX instruction, so
// `host_check.cpp` runs exactly the kernel's limb schedule with g++.
//
// Algorithms (on 32-bit words):
//   fr32_mont_mul   CIOS, 9-limb accumulator: a*b*2^-256 mod P.
//   fr32_acc_mul    acc (17 limbs) += a*b, the 512-bit product unreduced:
//                   a row sum of Poseidon's constant matrices is a lazy sum
//                   of products with the constant pre-scaled by 2^320
//                   (`native.pack_params`), reduced ONCE by fr32_redc320.
//   fr32_redc320    T * 2^-320 mod P over a sliding 9-limb window.
//   fr32_sub        a - b mod P: a borrow chain, then P added under a mask.
//   fr32_inv        x^(P-2) on one thread, a fixed 4-bit window.
//
// Bounds.  P = 2^254 + 0x224698fc0994a8dd8c46eb2100000001 lies between 2^254
// and 2^255, so 2P < 2^256 fits in 8 limbs, but 4P > 2^256: the classic lazy
// invariant "inputs and outputs in [0, 2P)" does NOT hold for this prime
// (a product of two values below 2P can end up to 2^-125 * P above 2P).  So:
//   - every value that leaves a routine, is compared, or enters an addition
//     is fully reduced (< P);
//   - inside x^5 only x^2 and x^4 stay unreduced: x < P gives
//     x^2 = (x*x + mP)/R < (P^2 + RP)/R < 2P, then
//     x^4 < (4P^2 + RP)/R = P(1 + 4P/R) < 2.0000001 P < 2^256, and
//     x^5 = (x^4 * x + mP)/R < (2.0000001 P^2 + RP)/R < 1.6 P, which one
//     conditional subtraction brings below P;
//   - CIOS with a < 2^256 and b < 2.0000001 P keeps t < 3.1 P < 2^256
//     between steps and t + a_i*b + m*P < 2^288 inside one: 9 limbs;
//   - a row sum of at most 129 products of values below P (K5's widest
//     row, t = 129) is < 129 P^2 < 2^7.02 * 2^508.0001 < 2^516: 17 limbs
//     (544 bits) hold it with room; and 129 P < 2^262 < 2^320, so
//     129 P^2 < 2^320 P and fr32_redc320 returns a value below
//     (129 P^2 + 2^320 P) / 2^320 < 2P; one conditional subtraction
//     finishes it.

#pragma once

typedef unsigned int u32;
typedef unsigned long long u64;

#ifdef __CUDACC__
#define FR32_FN __device__ __forceinline__
#define FR32_LD(p) __ldg(p)
// The carry lives in the condition-code register; the argument only keeps
// one signature for both builds and compiles away.
struct Fr32Cc {};
#define FR32_ASM3(op, a, b)                                          \
  u32 r;                                                             \
  asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));        \
  return r
#define FR32_ASM4(op, a, b, c)                                       \
  u32 r;                                                             \
  asm volatile(op " %0, %1, %2, %3;"                                 \
               : "=r"(r)                                             \
               : "r"(a), "r"(b), "r"(c));                            \
  return r
FR32_FN u32 add_cc(u32 a, u32 b, Fr32Cc &) { FR32_ASM3("add.cc.u32", a, b); }
FR32_FN u32 addc_cc(u32 a, u32 b, Fr32Cc &) { FR32_ASM3("addc.cc.u32", a, b); }
FR32_FN u32 addc(u32 a, u32 b, Fr32Cc &) { FR32_ASM3("addc.u32", a, b); }
FR32_FN u32 sub_cc(u32 a, u32 b, Fr32Cc &) { FR32_ASM3("sub.cc.u32", a, b); }
FR32_FN u32 subc_cc(u32 a, u32 b, Fr32Cc &) { FR32_ASM3("subc.cc.u32", a, b); }
FR32_FN u32 subc(u32 a, u32 b, Fr32Cc &) { FR32_ASM3("subc.u32", a, b); }
FR32_FN u32 mad_lo_cc(u32 a, u32 b, u32 c, Fr32Cc &) {
  FR32_ASM4("mad.lo.cc.u32", a, b, c);
}
FR32_FN u32 madc_lo_cc(u32 a, u32 b, u32 c, Fr32Cc &) {
  FR32_ASM4("madc.lo.cc.u32", a, b, c);
}
FR32_FN u32 mad_hi_cc(u32 a, u32 b, u32 c, Fr32Cc &) {
  FR32_ASM4("mad.hi.cc.u32", a, b, c);
}
FR32_FN u32 madc_hi_cc(u32 a, u32 b, u32 c, Fr32Cc &) {
  FR32_ASM4("madc.hi.cc.u32", a, b, c);
}
FR32_FN u32 madc_hi(u32 a, u32 b, u32 c, Fr32Cc &) {
  FR32_ASM4("madc.hi.u32", a, b, c);
}
#undef FR32_ASM3
#undef FR32_ASM4
#else
#define FR32_FN static inline
#define FR32_LD(p) (*(p))
// The condition-code flag: 1 after a carry out of an add or a borrow out of
// a subtract, as PTX's CC.CF.
struct Fr32Cc {
  u32 cf = 0;
};
FR32_FN u32 add_cc(u32 a, u32 b, Fr32Cc &f) {
  u64 s = (u64)a + b;
  f.cf = (u32)(s >> 32);
  return (u32)s;
}
FR32_FN u32 addc_cc(u32 a, u32 b, Fr32Cc &f) {
  u64 s = (u64)a + b + f.cf;
  f.cf = (u32)(s >> 32);
  return (u32)s;
}
FR32_FN u32 addc(u32 a, u32 b, Fr32Cc &f) { return a + b + f.cf; }
FR32_FN u32 sub_cc(u32 a, u32 b, Fr32Cc &f) {
  u64 d = (u64)a - b;
  f.cf = (u32)(d >> 63);
  return (u32)d;
}
FR32_FN u32 subc_cc(u32 a, u32 b, Fr32Cc &f) {
  u64 d = (u64)a - b - f.cf;
  f.cf = (u32)(d >> 63);
  return (u32)d;
}
FR32_FN u32 subc(u32 a, u32 b, Fr32Cc &f) { return a - b - f.cf; }
FR32_FN u32 mad_lo_cc(u32 a, u32 b, u32 c, Fr32Cc &f) {
  return add_cc(a * b, c, f);
}
FR32_FN u32 madc_lo_cc(u32 a, u32 b, u32 c, Fr32Cc &f) {
  return addc_cc(a * b, c, f);
}
FR32_FN u32 mad_hi_cc(u32 a, u32 b, u32 c, Fr32Cc &f) {
  return add_cc((u32)(((u64)a * b) >> 32), c, f);
}
FR32_FN u32 madc_hi_cc(u32 a, u32 b, u32 c, Fr32Cc &f) {
  return addc_cc((u32)(((u64)a * b) >> 32), c, f);
}
FR32_FN u32 madc_hi(u32 a, u32 b, u32 c, Fr32Cc &f) {
  return addc((u32)(((u64)a * b) >> 32), c, f);
}
#endif

// P = 0x40000000000000000000000000000000224698fc0994a8dd8c46eb2100000001
FR32_FN u32 fr32_p(int j) {
  return j == 0   ? 0x00000001u
         : j == 1 ? 0x8c46eb21u
         : j == 2 ? 0x0994a8ddu
         : j == 3 ? 0x224698fcu
         : j == 7 ? 0x40000000u
                  : 0u;
}
#define FR32_N0INV 0xffffffffu  // -P^-1 mod 2^32 (P = 1 mod 2^32)
#define FR32_ACC 17             // limbs of a lazy row sum

FR32_FN void fr32_load(const u32 *p, u32 *x) {
#pragma unroll
  for (int l = 0; l < 8; ++l) x[l] = FR32_LD(p + l);
}

// out = v - P if v >= P else v, for v < 2P held in 8 limbs.
FR32_FN void fr32_reduce_once(const u32 *v, u32 *out) {
  u32 d[8];
  Fr32Cc f;
  d[0] = sub_cc(v[0], fr32_p(0), f);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(v[j], fr32_p(j), f);
  const u32 borrow = subc(0u, 0u, f);  // all ones when v < P
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = borrow ? v[j] : d[j];
}

// out = a + b mod P (a, b < P, so a + b < 2P < 2^256); out may alias.
FR32_FN void fr32_add(const u32 *a, const u32 *b, u32 *out) {
  u32 s[8];
  Fr32Cc f;
  s[0] = add_cc(a[0], b[0], f);
#pragma unroll
  for (int j = 1; j < 8; ++j) s[j] = addc_cc(a[j], b[j], f);
  fr32_reduce_once(s, out);
}

// out = a - b mod P (a, b < P): a - b + 2^256 after a borrow, so P is added
// under the borrow's mask and the carry out of the top word dropped; out may
// alias.
FR32_FN void fr32_sub(const u32 *a, const u32 *b, u32 *out) {
  u32 d[8];
  Fr32Cc f;
  d[0] = sub_cc(a[0], b[0], f);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(a[j], b[j], f);
  const u32 borrow = subc(0u, 0u, f);  // all ones when a < b
  Fr32Cc g;
  out[0] = add_cc(d[0], fr32_p(0) & borrow, g);
#pragma unroll
  for (int j = 1; j < 7; ++j) out[j] = addc_cc(d[j], fr32_p(j) & borrow, g);
  out[7] = addc(d[7], fr32_p(7) & borrow, g);
}

// t (9 limbs) += m * P, the low words at j and the high words at j + 1; the
// zero limbs of P become plain carry steps and P's low word (1) has no high
// word.  The caller's bounds keep t below 2^288.
FR32_FN void fr32_add_mp(u32 m, u32 *t) {
  Fr32Cc f;
  t[0] = mad_lo_cc(m, fr32_p(0), t[0], f);
#pragma unroll
  for (int j = 1; j < 8; ++j)
    t[j] = fr32_p(j) ? madc_lo_cc(m, fr32_p(j), t[j], f) : addc_cc(t[j], 0u, f);
  t[8] = addc(t[8], 0u, f);
  t[2] = mad_hi_cc(m, fr32_p(1), t[2], f);
#pragma unroll
  for (int j = 2; j < 7; ++j)
    t[j + 1] = fr32_p(j) ? madc_hi_cc(m, fr32_p(j), t[j + 1], f)
                         : addc_cc(t[j + 1], 0u, f);
  t[8] = madc_hi(m, fr32_p(7), t[8], f);
}

// CIOS Montgomery product: out = a*b*2^-256 mod P.  REDUCE = false leaves the
// value below (a*b + 2^256 P) / 2^256 (see the bounds at the top); true
// brings a value below 2P into [0, P).  out may alias a or b.
template <bool REDUCE>
FR32_FN void fr32_mont_mul(const u32 *a, const u32 *b, u32 *out) {
  u32 t[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    Fr32Cc f;
    const u32 ai = a[i];
    t[0] = mad_lo_cc(ai, b[0], t[0], f);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = madc_lo_cc(ai, b[j], t[j], f);
    t[8] = addc(t[8], 0u, f);
    t[1] = mad_hi_cc(ai, b[0], t[1], f);
#pragma unroll
    for (int j = 1; j < 7; ++j) t[j + 1] = madc_hi_cc(ai, b[j], t[j + 1], f);
    t[8] = madc_hi(ai, b[7], t[8], f);
    fr32_add_mp(t[0] * FR32_N0INV, t);  // t[0] becomes 0
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  if (REDUCE) {
    fr32_reduce_once(t, out);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = t[j];
  }
}

// x <- x^5 for x < P; x^2 and x^4 stay unreduced (bounds at the top).
FR32_FN void fr32_pow5(const u32 *x, u32 *out) {
  u32 x2[8], x4[8];
  fr32_mont_mul<false>(x, x, x2);
  fr32_mont_mul<false>(x2, x2, x4);
  fr32_mont_mul<true>(x4, x, out);
}

// p (16 limbs) = a * b, schoolbook.  For each word a_i: a chain of the low
// halves into p[i..i+7] whose carry starts p[i+8], then a chain of the high
// halves into p[i+1..i+8].  The partial sum (a_0..a_i) * b is below
// 2^(32(i+9)), so that second chain never carries out of p[i+8].
FR32_FN void fr32_mul_wide(const u32 *a, const u32 *b, u32 *p) {
#pragma unroll
  for (int l = 0; l < 8; ++l) p[l] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    Fr32Cc f;
    const u32 ai = a[i];
    p[i] = mad_lo_cc(ai, b[0], p[i], f);
#pragma unroll
    for (int j = 1; j < 8; ++j) p[i + j] = madc_lo_cc(ai, b[j], p[i + j], f);
    p[i + 8] = addc(0u, 0u, f);
    p[i + 1] = mad_hi_cc(ai, b[0], p[i + 1], f);
#pragma unroll
    for (int j = 1; j < 7; ++j)
      p[i + 1 + j] = madc_hi_cc(ai, b[j], p[i + 1 + j], f);
    p[i + 8] = madc_hi(ai, b[7], p[i + 8], f);
  }
}

// acc += o over FR32_ACC limbs (the sum stays below 2^516).
FR32_FN void fr32_acc_add(u32 *acc, const u32 *o) {
  Fr32Cc f;
  acc[0] = add_cc(acc[0], o[0], f);
#pragma unroll
  for (int l = 1; l < FR32_ACC - 1; ++l) acc[l] = addc_cc(acc[l], o[l], f);
  acc[FR32_ACC - 1] = addc(acc[FR32_ACC - 1], o[FR32_ACC - 1], f);
}

// acc (FR32_ACC limbs) += a * b, unreduced.
FR32_FN void fr32_acc_mul(const u32 *a, const u32 *b, u32 *acc) {
  u32 p[16];
  fr32_mul_wide(a, b, p);
  Fr32Cc f;
  acc[0] = add_cc(acc[0], p[0], f);
#pragma unroll
  for (int l = 1; l < 16; ++l) acc[l] = addc_cc(acc[l], p[l], f);
  acc[16] = addc(acc[16], 0u, f);
}

// out = T * 2^-320 mod P, fully reduced, for T (FR32_ACC limbs) < 2^320 P.
// Ten word steps over a sliding window t = T[i .. i+8]: m = -t[0], t += m*P,
// shift one word and take in T[i+9].  The carry out of the window's top word
// (at most 2) waits in `c` and enters the next step's low chain at the top.
FR32_FN void fr32_redc320(const u32 *T, u32 *out) {
  u32 t[9];
#pragma unroll
  for (int l = 0; l < 9; ++l) t[l] = T[l];
  u32 c = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    Fr32Cc f;
    const u32 m = t[0] * FR32_N0INV;
    t[0] = mad_lo_cc(m, fr32_p(0), t[0], f);  // 0
#pragma unroll
    for (int j = 1; j < 8; ++j)
      t[j] = fr32_p(j) ? madc_lo_cc(m, fr32_p(j), t[j], f)
                       : addc_cc(t[j], 0u, f);
    t[8] = addc_cc(t[8], c, f);
    c = addc(0u, 0u, f);
    t[2] = mad_hi_cc(m, fr32_p(1), t[2], f);
#pragma unroll
    for (int j = 2; j < 7; ++j)
      t[j + 1] = fr32_p(j) ? madc_hi_cc(m, fr32_p(j), t[j + 1], f)
                           : addc_cc(t[j + 1], 0u, f);
    t[8] = madc_hi_cc(m, fr32_p(7), t[8], f);
    c = addc(c, 0u, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = i + 9 < FR32_ACC ? T[i + 9] : 0u;
  }
  // the value t[0..7] + c * 2^256 is below 2P < 2^256, so c == 0 here
  fr32_reduce_once(t, out);
}

// 4-bit digit k (0 = lowest) of the exponent P - 2 of Fermat's inverse.
FR32_FN u32 fr32_inv_digit(int k) {
  const int j = k >> 3;
  const u32 w = j == 0 ? 0xffffffffu : j == 1 ? 0x8c46eb20u : fr32_p(j);
  return (w >> (4 * (k & 7))) & 15u;
}

// out = x^(P-2) = x^-1 mod P on one thread, Montgomery in and out (a power
// of x*R taken with Montgomery products is x^e * R); 0 gives 0.  A fixed
// 4-bit window over the constant exponent, top digit (4) first: a table of
// x^1 .. x^15 (14 products), then for each of the 63 lower digits four
// squarings and, where the digit is not 0, one product by the table entry.
// P - 2 has 30 nonzero digits below the top one: 14 + 252 + 30 = 296
// dependent products.  The table is indexed by a digit known only at run
// time, so on the card it lies in local memory (one thread runs this).
FR32_FN void fr32_inv(const u32 *x, u32 *out) {
  u32 tab[15][8];  // tab[i] = x^(i + 1)
#pragma unroll
  for (int l = 0; l < 8; ++l) tab[0][l] = x[l];
#pragma unroll 1
  for (int i = 1; i < 15; ++i) fr32_mont_mul<true>(tab[i - 1], x, tab[i]);
  u32 r[8];
  const u32 top = fr32_inv_digit(63);
#pragma unroll
  for (int l = 0; l < 8; ++l) r[l] = tab[top - 1][l];
#pragma unroll 1
  for (int k = 62; k >= 0; --k) {
#pragma unroll
    for (int s = 0; s < 4; ++s) fr32_mont_mul<true>(r, r, r);
    const u32 d = fr32_inv_digit(k);
    if (d) fr32_mont_mul<true>(r, tab[d - 1], r);
  }
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l] = r[l];
}

// One element of K2 `fr_elementwise`: OP 0 the Montgomery product a*b*2^-256,
// 1 a + b, 2 a - b, all mod P and fully reduced.
template <int OP>
FR32_FN void fr32_binop(const u32 *a, const u32 *b, u32 *out) {
  if (OP == 0) fr32_mont_mul<true>(a, b, out);
  else if (OP == 1) fr32_add(a, b, out);
  else fr32_sub(a, b, out);
}

// One element in or out of device memory as two 16-byte words (the port's
// tensors are 32-byte aligned per element); plain copies under g++.
#ifdef __CUDACC__
FR32_FN void fr32_load_vec(const u32 *p, u32 *x) {
  const uint4 lo = __ldg(reinterpret_cast<const uint4 *>(p));
  const uint4 hi = __ldg(reinterpret_cast<const uint4 *>(p) + 1);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}
FR32_FN void fr32_store_vec(u32 *p, const u32 *x) {
  uint4 *q = reinterpret_cast<uint4 *>(p);
  q[0] = make_uint4(x[0], x[1], x[2], x[3]);
  q[1] = make_uint4(x[4], x[5], x[6], x[7]);
}
#else
FR32_FN void fr32_load_vec(const u32 *p, u32 *x) {
  for (int l = 0; l < 8; ++l) x[l] = p[l];
}
FR32_FN void fr32_store_vec(u32 *p, const u32 *x) {
  for (int l = 0; l < 8; ++l) p[l] = x[l];
}
#endif
