// Native host-side Poseidon for the sequential Fiat-Shamir transcript.
//
// The device side batches Poseidon over thousands of states; the
// transcript sponge, however, is a strictly sequential chain of t=17
// permutations (crates/transcript/src/lib.rs:79-101) that the prover and
// verifier replay step by step.  This engine runs those host-side
// permutations natively instead of in the pure-Python golden model, with
// bit-identical results (Montgomery 4x64 arithmetic, same as ark-ff).
//
// Build: g++ -O3 -fopenmp -shared -fPIC -o libposeidon.so poseidon.cpp

#include <cstdint>
#include <cstring>
#include <vector>

using u64 = uint64_t;
using u128 = unsigned __int128;

// Pallas scalar field modulus, little-endian u64 limbs.
static const u64 PL[4] = {0x8c46eb2100000001ULL, 0x224698fc0994a8ddULL,
                          0x0ULL, 0x4000000000000000ULL};
static const u64 N0INV = 0x8c46eb20ffffffffULL; // -p^{-1} mod 2^64

static inline bool geq_p(const u64 *a) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] > PL[i]) return true;
    if (a[i] < PL[i]) return false;
  }
  return true;
}

static inline void sub_p(u64 *a) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 cur = (u128)a[i] - PL[i] - borrow;
    a[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
}

static inline void fr_add(const u64 *a, const u64 *b, u64 *out) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 cur = (u128)a[i] + b[i] + carry;
    out[i] = (u64)cur;
    carry = cur >> 64;
  }
  if (carry || geq_p(out)) sub_p(out);
}

// CIOS Montgomery multiply (4x64), "no-carry" form: out = a*b*2^-256 mod p.
// Valid because p < 2^254 (top limb 2^62): the running value stays below
// 2^64*p, so the 5th accumulator limb of classic CIOS never carries and
// the interleaved multiply/reduce rows fold into two u128 chains per i
// (the ark-ff/gnark optimization; ~25% fewer carry ops).
static inline void fr_mul(const u64 *a, const u64 *b, u64 *out) {
  u64 t[4] = {0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 v = (u128)t[0] + (u128)a[i] * b[0];
    u64 A = (u64)(v >> 64);
    u64 t0 = (u64)v;
    u64 m = t0 * N0INV;
    u128 w = (u128)t0 + (u128)m * PL[0];
    u64 C = (u64)(w >> 64);
    for (int j = 1; j < 4; ++j) {
      v = (u128)t[j] + (u128)a[i] * b[j] + A;
      A = (u64)(v >> 64);
      w = (u128)(u64)v + (u128)m * PL[j] + C;
      C = (u64)(w >> 64);
      t[j - 1] = (u64)w;
    }
    t[3] = A + C;  // < 2^64: no-carry condition on p
  }
  if (geq_p(t)) sub_p(t);
  std::memcpy(out, t, 32);
}

static inline void sbox5(u64 *x) {
  u64 x2[4], x4[4];
  fr_mul(x, x, x2);
  fr_mul(x2, x2, x4);
  fr_mul(x4, x, x);
}

static inline void fr_sub(const u64 *a, const u64 *b, u64 *out) {
  u128 borrow = 0;
  u64 tmp[4];
  for (int i = 0; i < 4; ++i) {
    u128 cur = (u128)a[i] - b[i] - borrow;
    tmp[i] = (u64)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 cur = (u128)tmp[i] + PL[i] + carry;
      tmp[i] = (u64)cur;
      carry = cur >> 64;
    }
  }
  std::memcpy(out, tmp, 32);
}

// Montgomery inverse by exponentiation to p-2 (p prime).
static void fr_inv(const u64 *a, const u64 *mont_one, u64 *out) {
  static const u64 EXP[4] = {0x8c46eb20ffffffffULL, 0x224698fc0994a8ddULL,
                             0x0ULL, 0x4000000000000000ULL}; // p - 2
  u64 res[4], base[4];
  std::memcpy(res, mont_one, 32);
  std::memcpy(base, a, 32);
  for (int limb = 0; limb < 4; ++limb) {
    u64 e = EXP[limb];
    int top = (limb == 3) ? 63 : 64;
    for (int bit = 0; bit < top; ++bit) {
      if ((e >> bit) & 1) fr_mul(res, base, res);
      fr_mul(base, base, base);
    }
  }
  std::memcpy(out, res, 32);
}

// ---------------------------------------------------------------------------
// Lazy MDS: accumulate sum_j M_ij * s_j as a 576-bit integer, then ONE
// extended REDC (divide by 2^320) per output element.  The matrix must be
// pre-scaled by 2^320 (python side) so Montgomery form is preserved:
//   T = sum (M*2^320) * (s*2^256) = (sum M*s) * 2^576;  T * 2^-320 = mont.
// Bound: T < 17 p^2 < 2^320 * p.
// ---------------------------------------------------------------------------

static inline void acc_mul(const u64 *a, const u64 *b, u64 *acc /*9*/) {
  // acc += a*b (4x4 schoolbook, 512-bit product into 9-limb accumulator)
  u64 prod[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 c = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)prod[i + j] + (u128)a[i] * b[j] + c;
      prod[i + j] = (u64)cur;
      c = cur >> 64;
    }
    prod[i + 4] = (u64)c;
  }
  u128 carry = 0;
  for (int i = 0; i < 8; ++i) {
    u128 cur = (u128)acc[i] + prod[i] + carry;
    acc[i] = (u64)cur;
    carry = cur >> 64;
  }
  acc[8] += (u64)carry;
}

static inline void redc320(u64 *T /*10 limbs, in/out*/, u64 *out) {
  // divide by 2^320 mod p: 5 REDC iterations over 64-bit limbs
  for (int i = 0; i < 5; ++i) {
    u64 m = T[i] * N0INV;
    u128 c = ((u128)T[i] + (u128)m * PL[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 cur = (u128)T[i + j] + (u128)m * PL[j] + c;
      T[i + j] = (u64)cur;
      c = cur >> 64;
    }
    u128 cur = (u128)T[i + 4] + c;
    T[i + 4] = (u64)cur;
    c = cur >> 64;
    for (int j = i + 5; c && j < 10; ++j) {
      cur = (u128)T[j] + c;
      T[j] = (u64)cur;
      c = cur >> 64;
    }
  }
  u64 r[4] = {T[5], T[6], T[7], T[8]};
  // T[9] == 0: the reduced value is < 2p < 2^256
  if (geq_p(r)) sub_p(r);
  std::memcpy(out, r, 32);
}

// Optional sparse partial-round factors (spec/poseidon_opt.py): the first
// rp-1 partial rounds apply Q_r = [[q00, w^T], [Mhat^-1 v, I]] (a t-term
// row dot + (t-1) single-multiply column updates) instead of the dense
// MDS; ONE dense m_final lands after the last partial S-box.  Bit-exact.
struct OptFactors {
  const u64 *qrow;   // (rp-1)*t*4, pre-scaled by 2^320
  const u64 *qcol;   // (rp-1)*(t-1)*4, PLAIN Montgomery (2^256) scale:
                     // the column update uses one CIOS multiply per
                     // element instead of accumulate + extended REDC
  const u64 *mfinal; // t*t*4, pre-scaled by 2^320
};

// One full permutation.  All field values in Montgomery form.
// mds: t*t*4 PRE-SCALED by 2^320, rc_full: rf*t*4, rc_part: rp*4.
static void permute_one(u64 *state, int t, int rf, int rp, const u64 *mds,
                        const u64 *rc_full, const u64 *rc_part, u64 *cur,
                        u64 *nxt, const OptFactors *opt = nullptr) {
  std::memcpy(cur, state, (size_t)t * 32);
  int half = rf / 2;

  auto mds_mul = [&](const u64 *m) {
    for (int i = 0; i < t; ++i) {
      u64 T[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      for (int j = 0; j < t; ++j)
        acc_mul(m + ((size_t)i * t + j) * 4, cur + (size_t)j * 4, T);
      redc320(T, nxt + (size_t)i * 4);
    }
    std::memcpy(cur, nxt, (size_t)t * 32);
  };

  for (int r = 0; r < half; ++r) {
    for (int i = 0; i < t; ++i) {
      fr_add(cur + (size_t)i * 4, rc_full + ((size_t)r * t + i) * 4,
             cur + (size_t)i * 4);
      sbox5(cur + (size_t)i * 4);
    }
    mds_mul(mds);
  }
  if (opt) {
    for (int r = 0; r < rp; ++r) {
      fr_add(cur, rc_part + (size_t)r * 4, cur);
      sbox5(cur);
      if (r == rp - 1) break;
      const u64 *qr = opt->qrow + (size_t)r * t * 4;
      const u64 *qc = opt->qcol + (size_t)r * (t - 1) * 4;
      u64 T[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      for (int j = 0; j < t; ++j)
        acc_mul(qr + (size_t)j * 4, cur + (size_t)j * 4, T);
      u64 new0[4];
      redc320(T, new0);
      for (int i = 1; i < t; ++i) {
        u64 tmp[4];
        fr_mul(qc + (size_t)(i - 1) * 4, cur, tmp);
        fr_add(cur + (size_t)i * 4, tmp, cur + (size_t)i * 4);
      }
      std::memcpy(cur, new0, 32);
    }
    mds_mul(opt->mfinal);
  } else {
    for (int r = 0; r < rp; ++r) {
      fr_add(cur, rc_part + (size_t)r * 4, cur);
      sbox5(cur);
      mds_mul(mds);
    }
  }
  for (int r = half; r < rf; ++r) {
    for (int i = 0; i < t; ++i) {
      fr_add(cur + (size_t)i * 4, rc_full + ((size_t)r * t + i) * 4,
             cur + (size_t)i * 4);
      sbox5(cur + (size_t)i * 4);
    }
    mds_mul(mds);
  }
  std::memcpy(state, cur, (size_t)t * 32);
}

// Gauss-Jordan inverse of an n x n matrix, Montgomery form, mod p.
// Returns false if singular.
static bool mat_inv(const u64 *m, int n, const u64 *mont_one, u64 *out) {
  std::vector<u64> a((size_t)n * 2 * n * 4, 0);
  auto at = [&](int r, int c) { return a.data() + ((size_t)r * 2 * n + c) * 4; };
  for (int r = 0; r < n; ++r) {
    for (int c = 0; c < n; ++c)
      std::memcpy(at(r, c), m + ((size_t)r * n + c) * 4, 32);
    std::memcpy(at(r, n + r), mont_one, 32);
  }
  auto is_zero = [](const u64 *x) {
    return !(x[0] | x[1] | x[2] | x[3]);
  };
  for (int col = 0; col < n; ++col) {
    int piv = -1;
    for (int r = col; r < n; ++r)
      if (!is_zero(at(r, col))) { piv = r; break; }
    if (piv < 0) return false;
    if (piv != col)
      for (int c = 0; c < 2 * n; ++c) {
        u64 tmp[4];
        std::memcpy(tmp, at(col, c), 32);
        std::memcpy(at(col, c), at(piv, c), 32);
        std::memcpy(at(piv, c), tmp, 32);
      }
    u64 inv[4];
    fr_inv(at(col, col), mont_one, inv);
    for (int c = col; c < 2 * n; ++c) fr_mul(at(col, c), inv, at(col, c));
    for (int r = 0; r < n; ++r) {
      if (r == col || is_zero(at(r, col))) continue;
      u64 f[4];
      std::memcpy(f, at(r, col), 32);
      for (int c = col; c < 2 * n; ++c) {
        u64 prod[4];
        fr_mul(f, at(col, c), prod);
        fr_sub(at(r, c), prod, at(r, c));
      }
    }
  }
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c)
      std::memcpy(out + ((size_t)r * n + c) * 4, at(r, n + c), 32);
  return true;
}

extern "C" {

// Partial-round factorization (spec/poseidon_opt.py) computed natively:
// mds is t*t*4 in PLAIN Montgomery form (scale 2^256); outputs likewise.
// Returns 0 on success, 1 if a submatrix was singular.
int poseidon_factorize(const u64 *mds, int t, int rp, const u64 *mont_one,
                       u64 *qrow /* (rp-1)*t*4 */,
                       u64 *qcol /* (rp-1)*(t-1)*4 */,
                       u64 *mfinal /* t*t*4 */) {
  int n = t - 1;
  std::vector<u64> Mi(mds, mds + (size_t)t * t * 4);
  std::vector<u64> mhat((size_t)n * n * 4), mhat_inv((size_t)n * n * 4);
  std::vector<u64> next((size_t)t * t * 4);
  for (int it = 0; it < rp - 1; ++it) {
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c)
        std::memcpy(mhat.data() + ((size_t)r * n + c) * 4,
                    Mi.data() + ((size_t)(r + 1) * t + c + 1) * 4, 32);
    if (!mat_inv(mhat.data(), n, mont_one, mhat_inv.data())) return 1;
    // qrow[it] = Mi[0, :]
    std::memcpy(qrow + (size_t)it * t * 4, Mi.data(), (size_t)t * 32);
    // qcol[it] = mhat_inv @ Mi[1:, 0]
    for (int i = 0; i < n; ++i) {
      u64 acc[4] = {0, 0, 0, 0};
      for (int j = 0; j < n; ++j) {
        u64 prod[4];
        fr_mul(mhat_inv.data() + ((size_t)i * n + j) * 4,
               Mi.data() + ((size_t)(j + 1) * t) * 4, prod);
        fr_add(acc, prod, acc);
      }
      std::memcpy(qcol + ((size_t)it * n + i) * 4, acc, 32);
    }
    // Mi' = M @ blockdiag(1, mhat): col 0 = M[:,0]; cols 1.. = M[:,1:] @ mhat
#pragma omp parallel for schedule(static)
    for (int i = 0; i < t; ++i) {
      std::memcpy(next.data() + ((size_t)i * t) * 4,
                  mds + ((size_t)i * t) * 4, 32);
      for (int c = 0; c < n; ++c) {
        u64 acc[4] = {0, 0, 0, 0};
        for (int j = 0; j < n; ++j) {
          u64 prod[4];
          fr_mul(mds + ((size_t)i * t + j + 1) * 4,
                 mhat.data() + ((size_t)j * n + c) * 4, prod);
          fr_add(acc, prod, acc);
        }
        std::memcpy(next.data() + ((size_t)i * t + c + 1) * 4, acc, 32);
      }
    }
    Mi = next;
  }
  std::memcpy(mfinal, Mi.data(), (size_t)t * t * 32);
  return 0;
}

// states: B contiguous sponge states (t*4 u64 each), permuted in place.
void poseidon_permute_batch_opt(u64 *states, long B, int t, int rf, int rp,
                                const u64 *mds, const u64 *rc_full,
                                const u64 *rc_part, const u64 *qrow,
                                const u64 *qcol, const u64 *mfinal) {
  OptFactors fac{qrow, qcol, mfinal};
  const OptFactors *opt = qrow ? &fac : nullptr;
  std::vector<u64> cur((size_t)t * 4), nxt((size_t)t * 4);
  for (long b = 0; b < B; ++b) {
    permute_one(states + (size_t)b * t * 4, t, rf, rp, mds, rc_full, rc_part,
                cur.data(), nxt.data(), opt);
  }
}

void poseidon_permute_batch(u64 *states, long B, int t, int rf, int rp,
                            const u64 *mds, const u64 *rc_full,
                            const u64 *rc_part) {
  poseidon_permute_batch_opt(states, B, t, rf, rp, mds, rc_full, rc_part,
                             nullptr, nullptr, nullptr);
}

// Sponge with DS preamble + 10* padding (poseidon/src/lib.rs:288-312),
// B independent rows: inputs laid out [B, d+k] fields, digest out [B, 4].
void poseidon_hash_ds_dynamic_batch_opt(
    const u64 *rows, long B, int nfields, int t, int rf, int rp,
    const u64 *mds, const u64 *rc_full, const u64 *rc_part,
    const u64 *mont_one, u64 *digests, const u64 *qrow, const u64 *qcol,
    const u64 *mfinal) {
  OptFactors fac{qrow, qcol, mfinal};
  const OptFactors *opt = qrow ? &fac : nullptr;
  int rate = t - 1;
  std::vector<u64> state((size_t)t * 4), cur((size_t)t * 4),
      nxt((size_t)t * 4);
  for (long b = 0; b < B; ++b) {
    std::memset(state.data(), 0, (size_t)t * 32);
    int cursor = 0;
    auto absorb = [&](const u64 *x) {
      fr_add(state.data() + (size_t)cursor * 4, x,
             state.data() + (size_t)cursor * 4);
      if (++cursor == rate) {
        cursor = 0;
        permute_one(state.data(), t, rf, rp, mds, rc_full, rc_part,
                    cur.data(), nxt.data(), opt);
      }
    };
    const u64 *row = rows + (size_t)b * nfields * 4;
    for (int i = 0; i < nfields; ++i) absorb(row + (size_t)i * 4);
    absorb(mont_one);
    static const u64 zero[4] = {0, 0, 0, 0};
    while (cursor != 0) absorb(zero);
    std::memcpy(digests + (size_t)b * 4, state.data(), 32);
  }
}

void poseidon_hash_ds_dynamic_batch(const u64 *rows, long B, int nfields,
                                    int t, int rf, int rp, const u64 *mds,
                                    const u64 *rc_full, const u64 *rc_part,
                                    const u64 *mont_one, u64 *digests) {
  poseidon_hash_ds_dynamic_batch_opt(rows, B, nfields, t, rf, rp, mds,
                                     rc_full, rc_part, mont_one, digests,
                                     nullptr, nullptr, nullptr);
}

// Sequential sponge absorb chains (transcript absorb_fields semantics,
// transcript/src/lib.rs:79-88): C independent chains, each absorbing
// nfields elements rate-at-a-time into its own state.  The per-chain work
// is strictly sequential; chains run in parallel threads.
void poseidon_absorb_chains_opt(u64 *states /* C*t*4, in/out */,
                                const u64 *fields /* C*nfields*4 */, long C,
                                long nfields, int *pos_io /* C, in/out */,
                                int t, int rf, int rp, const u64 *mds,
                                const u64 *rc_full, const u64 *rc_part,
                                const u64 *qrow, const u64 *qcol,
                                const u64 *mfinal) {
  OptFactors fac{qrow, qcol, mfinal};
  const OptFactors *opt = qrow ? &fac : nullptr;
  int rate = t - 1;
#pragma omp parallel for schedule(static)
  for (long c = 0; c < C; ++c) {
    std::vector<u64> cur((size_t)t * 4), nxt((size_t)t * 4);
    u64 *state = states + (size_t)c * t * 4;
    const u64 *col = fields + (size_t)c * nfields * 4;
    int pos = pos_io[c];
    for (long i = 0; i < nfields; ++i) {
      if (pos == rate) {
        permute_one(state, t, rf, rp, mds, rc_full, rc_part, cur.data(),
                    nxt.data(), opt);
        pos = 0;
      }
      fr_add(state + (size_t)pos * 4, col + (size_t)i * 4,
             state + (size_t)pos * 4);
      ++pos;
    }
    pos_io[c] = pos;
  }
}

void poseidon_absorb_chains(u64 *states, const u64 *fields, long C,
                            long nfields, int *pos_io, int t, int rf, int rp,
                            const u64 *mds, const u64 *rc_full,
                            const u64 *rc_part) {
  poseidon_absorb_chains_opt(states, fields, C, nfields, pos_io, t, rf, rp,
                             mds, rc_full, rc_part, nullptr, nullptr,
                             nullptr);
}

// Batched domain conversion so the Python binding can ship canonical
// little-endian limb dumps (int.to_bytes) instead of doing a bigint
// modmul per value: to-mont multiplies by R^2 (passed in, Montgomery
// form), from-mont multiplies by one.
void fr_to_mont_batch(u64 *vals, long n, const u64 *r2) {
  for (long i = 0; i < n; ++i) fr_mul(vals + (size_t)i * 4, r2,
                                      vals + (size_t)i * 4);
}

void fr_from_mont_batch(u64 *vals, long n) {
  static const u64 ONE[4] = {1, 0, 0, 0};
  for (long i = 0; i < n; ++i) fr_mul(vals + (size_t)i * 4, ONE,
                                      vals + (size_t)i * 4);
}

// Fused DEEP-ALI witness merge, host side: out = a*s + e - t (Montgomery
// 4x64 limbs, canonical < p out).  Lets the prover upload ONE phi column
// instead of four witness columns.  Bit-exact with fri/deep_ali.phi_kernel.
void fr_phi_batch(const u64 *a, const u64 *s, const u64 *e, const u64 *t,
                  u64 *out, long n) {
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; ++i) {
    const size_t o = (size_t)i * 4;
    u64 m[4];
    fr_mul(a + o, s + o, m);
    fr_add(m, e + o, m);
    u64 nt[4];  // p - t (t canonical < p, so no borrow out)
    u128 borrow = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)PL[j] - (t + o)[j] - borrow;
      nt[j] = (u64)cur;
      borrow = (cur >> 64) ? 1 : 0;
    }
    fr_add(m, nt, out + o);
  }
}

} // extern "C"
