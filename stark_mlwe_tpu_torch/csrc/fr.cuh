// Pallas scalar field Fr arithmetic on 4x64-bit Montgomery limbs (R = 2^256),
// of K3 `fr_fold` and K6 `fr_ntt` (through `ntt.cuh`); the other kernels are
// on `fr32.cuh`.
//
// An element is 32 bytes, little-endian: the port's `[..., 8] int32` tensor
// layout read as `u64[4]`.  The algorithms are those of the host engine
// (`native/poseidon.cpp`): no-carry CIOS multiply, and for constant-row
// contractions (Poseidon MDS, FRI fold) a lazy 576-bit accumulator with ONE
// extended REDC dividing by 2^320 per output, the constants pre-scaled by
// 2^320 so Montgomery form is preserved.  Carries are taken from unsigned
// compares, so the same source compiles with g++ (where the CPU tests hold
// it against the pure-Python spec) and with nvcc.

#pragma once

typedef unsigned long long u64;

#ifdef __CUDACC__
#define FR_FN __device__ __forceinline__
#define FR_LD(p) __ldg(p)
#else
#define FR_FN static inline
#define FR_LD(p) (*(p))
#endif

// P = 0x40000000000000000000000000000000224698fc0994a8dd8c46eb2100000001
#define FR_P0 0x8c46eb2100000001ULL
#define FR_P1 0x224698fc0994a8ddULL
#define FR_P2 0x0ULL
#define FR_P3 0x4000000000000000ULL
#define FR_N0INV 0x8c46eb20ffffffffULL  // -P^-1 mod 2^64

FR_FN u64 fr_pl(int j) {
  return j == 0 ? FR_P0 : (j == 1 ? FR_P1 : (j == 2 ? FR_P2 : FR_P3));
}

FR_FN u64 fr_mulhi(u64 a, u64 b) {
#ifdef __CUDACC__
  return __umul64hi(a, b);
#else
  return (u64)(((unsigned __int128)a * b) >> 64);
#endif
}

// (hi, lo) = a*b + c + d.  Cannot overflow 128 bits.
FR_FN void fr_mac(u64 a, u64 b, u64 c, u64 d, u64 &lo, u64 &hi) {
  u64 l = a * b;
  u64 h = fr_mulhi(a, b);
  l += c;
  h += (u64)(l < c);
  l += d;
  h += (u64)(l < d);
  lo = l;
  hi = h;
}

FR_FN bool fr_geq_p(const u64 *a) {
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    if (a[i] > fr_pl(i)) return true;
    if (a[i] < fr_pl(i)) return false;
  }
  return true;
}

FR_FN void fr_sub_p(u64 *a) {
  u64 borrow = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u64 p = fr_pl(i);
    u64 d = a[i] - p;
    u64 b1 = (u64)(a[i] < p);
    u64 d2 = d - borrow;
    u64 b2 = (u64)(d < borrow);
    a[i] = d2;
    borrow = b1 | b2;
  }
}

// out = a + b mod P (inputs in [0, P)); out may alias a or b.
FR_FN void fr_add(const u64 *a, const u64 *b, u64 *out) {
  u64 r[4];
  u64 carry = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u64 s = a[i] + b[i];
    u64 c1 = (u64)(s < a[i]);
    u64 s2 = s + carry;
    u64 c2 = (u64)(s2 < s);
    r[i] = s2;
    carry = c1 | c2;
  }
  if (carry || fr_geq_p(r)) fr_sub_p(r);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = r[i];
}

// out = a - b mod P (inputs in [0, P)); out may alias a or b.
FR_FN void fr_sub(const u64 *a, const u64 *b, u64 *out) {
  u64 r[4];
  u64 borrow = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u64 d = a[i] - b[i];
    u64 b1 = (u64)(a[i] < b[i]);
    u64 d2 = d - borrow;
    u64 b2 = (u64)(d < borrow);
    r[i] = d2;
    borrow = b1 | b2;
  }
  if (borrow) {
    u64 carry = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u64 p = fr_pl(i);
      u64 s = r[i] + p;
      u64 c1 = (u64)(s < p);
      u64 s2 = s + carry;
      u64 c2 = (u64)(s2 < s);
      r[i] = s2;
      carry = c1 | c2;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = r[i];
}

// CIOS Montgomery multiply, "no-carry" form: out = a*b*2^-256 mod P, fully
// reduced.  Valid because P < 2^255: the running value stays below 2^64*P,
// so the fifth accumulator limb of classic CIOS never carries.  out may
// alias a or b.
FR_FN void fr_mont_mul(const u64 *a, const u64 *b, u64 *out) {
  u64 t[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u64 A, C, lo, m, w;
    fr_mac(a[i], b[0], t[0], 0, lo, A);
    m = lo * FR_N0INV;
    fr_mac(m, FR_P0, lo, 0, w, C);  // w == 0 by construction of m
    (void)w;
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      fr_mac(a[i], b[j], t[j], A, lo, A);
      fr_mac(m, fr_pl(j), lo, C, t[j - 1], C);
    }
    t[3] = A + C;
  }
  if (fr_geq_p(t)) fr_sub_p(t);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = t[i];
}

// acc += a*b: 256x256 schoolbook product added into a 9-limb (576-bit)
// accumulator.  Room: a sum of up to 2^60 products of values < P fits.
FR_FN void fr_acc_mul(const u64 *a, const u64 *b, u64 *acc /*9*/) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      fr_mac(a[i], b[j], acc[i + j], c, acc[i + j], c);
#pragma unroll
    for (int k = i + 4; k < 9; ++k) {
      u64 s = acc[k] + c;
      c = (u64)(s < c);
      acc[k] = s;
    }
  }
}

// out = T * 2^-320 mod P, fully reduced, for a 9-limb accumulator
// T < 2^320 * P (any sum of fewer than 2^60 products with one factor
// pre-scaled by 2^320).  T is consumed.
FR_FN void fr_redc320(u64 *T9 /*9, clobbered*/, u64 *out) {
  u64 T[10];
#pragma unroll
  for (int i = 0; i < 9; ++i) T[i] = T9[i];
  T[9] = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    u64 m = T[i] * FR_N0INV;
    u64 c, lo;
    fr_mac(m, FR_P0, T[i], 0, lo, c);  // lo == 0
    (void)lo;
#pragma unroll
    for (int j = 1; j < 4; ++j)
      fr_mac(m, fr_pl(j), T[i + j], c, T[i + j], c);
#pragma unroll
    for (int k = i + 4; k < 10; ++k) {
      u64 s = T[k] + c;
      c = (u64)(s < c);
      T[k] = s;
    }
  }
  u64 r[4] = {T[5], T[6], T[7], T[8]};  // T[9] == 0: the value is < 2P
  if (fr_geq_p(r)) fr_sub_p(r);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = r[i];
}

// Load one element (4 limbs) through the read-only path.
FR_FN void fr_load(const u64 *p, u64 *x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = FR_LD(p + i);
}
