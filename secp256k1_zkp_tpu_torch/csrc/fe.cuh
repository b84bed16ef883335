// GF(p) arithmetic, p = 2^256 - 2^32 - 977, on eight 32-bit words.
//
// Device-library counterpart of the TPU kernels' _mul_limbs / _sqr_limbs /
// _reduce_cols / _canon_p and the fe_* helpers.  Every function returns a
// *weak* value (< 2^256, possibly >= p once); there are no lazy magnitudes:
// 32-bit words leave no headroom, so adds fold their carry at once.
//
// The core is the *_to family: force-inlined, by reference, writing into
// the caller's registers (the result may alias an operand: it is written
// last).  The product and every fold are carry chains of the primitives in
// common.cuh.  The by-value names below them (fe_mul, fe_sqr, fe_add, ...)
// are thin wrappers kept for the kernels that call them; fe_mul and fe_sqr
// stay __noinline__ there, which keeps those kernels' builds small.  Hot
// loops (ecmult_glv, msm_winreduce) call the core and pass no struct
// through a call, so nothing goes to the stack.
#pragma once
#include "consts.cuh"

typedef u256 fe;

// r = t mod p (weak) for a 512-bit t[16]: lo + hi * (2^32 + 977), then the
// top word of that once more, then a last carry (which leaves a value
// under 2^66, so the fold after it cannot carry).  hi * 977 runs as two
// chains of (lo, hi) pairs, even and odd words, as in the product.
SECP_INLINE void fe_reduce_to(fe& r, const uint32_t* t) {
    uint32_t l[8], h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) { l[i] = t[i]; h[i] = t[8 + i]; }
    // s = l + h * 977 + (h << 32), as l[0..7] + s8 * 2^256 + s9 * 2^288
    l[0] = mad_lo_cc(h[0], 977u, l[0]);
    l[1] = madc_hi_cc(h[0], 977u, l[1]);
#pragma unroll
    for (int i = 2; i < 8; i += 2) {
        l[i] = madc_lo_cc(h[i], 977u, l[i]);
        l[i + 1] = madc_hi_cc(h[i], 977u, l[i + 1]);
    }
    uint32_t s8 = addc(0, 0);
    l[1] = mad_lo_cc(h[1], 977u, l[1]);
    l[2] = madc_hi_cc(h[1], 977u, l[2]);
#pragma unroll
    for (int i = 3; i < 7; i += 2) {
        l[i] = madc_lo_cc(h[i], 977u, l[i]);
        l[i + 1] = madc_hi_cc(h[i], 977u, l[i + 1]);
    }
    l[7] = madc_lo_cc(h[7], 977u, l[7]);
    s8 = madc_hi_cc(h[7], 977u, s8);    // < 979: no carry-out
    l[1] = add_cc(l[1], h[0]);
#pragma unroll
    for (int i = 2; i < 8; ++i) l[i] = addc_cc(l[i], h[i - 1]);
    s8 = addc_cc(s8, h[7]);
    uint32_t s9 = addc(0, 0);
    // s < 2^256 * (2^32 + 978), so s9 = 1 forces s8 < 978 and
    // v = s8 + 977 * s9 fits a word.  Fold T = s8 + s9 * 2^32:
    // T * (2^32 + 977) = s8 * 977 + v * 2^32 + s9 * 2^64
    uint32_t v = s8 + 977u * s9;
    l[0] = mad_lo_cc(s8, 977u, l[0]);
    l[1] = madc_hi_cc(s8, 977u, l[1]);
#pragma unroll
    for (int i = 2; i < 8; ++i) l[i] = addc_cc(l[i], 0);
    uint32_t c = addc(0, 0);
    l[1] = add_cc(l[1], v);
    l[2] = addc_cc(l[2], s9);
#pragma unroll
    for (int i = 3; i < 8; ++i) l[i] = addc_cc(l[i], 0);
    c = addc(c, 0);                     // at most one of the two carried
    l[0] = mad_lo_cc(c, 977u, l[0]);
    l[1] = addc_cc(l[1], c);
#pragma unroll
    for (int i = 2; i < 7; ++i) l[i] = addc_cc(l[i], 0);
    l[7] = addc(l[7], 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = l[i];
}

// r = a * b.  The 8x8-word product in the even/odd shape: row i adds the
// pairs (lo, hi) of a_j * b_i for even j to e[i..i+7] and for odd j to
// o[i+1..i+8], one carry chain each, so the two chains of a row are
// independent; then e + o.  A row's top word is new: the even half of a
// times b's words up to i is under 2^(224 + 32(i+1)), so the sum so far
// fits e[0..i+7] and the chain has no carry-out (likewise o[1..i+8]).
SECP_INLINE void fe_mul_to(fe& r, const fe& a, const fe& b) {
    uint32_t e[15], o[16];
    const uint32_t b0 = b.v[0];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
        e[j] = a.v[j] * b0;
        e[j + 1] = mul_hi(a.v[j], b0);
        o[j + 1] = a.v[j + 1] * b0;
        o[j + 2] = mul_hi(a.v[j + 1], b0);
    }
#pragma unroll
    for (int i = 1; i < 8; ++i) {
        const uint32_t bi = b.v[i];
        e[i] = mad_lo_cc(a.v[0], bi, e[i]);
        e[i + 1] = madc_hi_cc(a.v[0], bi, e[i + 1]);
#pragma unroll
        for (int j = 2; j < 6; j += 2) {
            e[i + j] = madc_lo_cc(a.v[j], bi, e[i + j]);
            e[i + j + 1] = madc_hi_cc(a.v[j], bi, e[i + j + 1]);
        }
        e[i + 6] = madc_lo_cc(a.v[6], bi, e[i + 6]);
        e[i + 7] = madc_hi(a.v[6], bi, 0);
        o[i + 1] = mad_lo_cc(a.v[1], bi, o[i + 1]);
        o[i + 2] = madc_hi_cc(a.v[1], bi, o[i + 2]);
#pragma unroll
        for (int j = 3; j < 7; j += 2) {
            o[i + j] = madc_lo_cc(a.v[j], bi, o[i + j]);
            o[i + j + 1] = madc_hi_cc(a.v[j], bi, o[i + j + 1]);
        }
        o[i + 7] = madc_lo_cc(a.v[7], bi, o[i + 7]);
        o[i + 8] = madc_hi(a.v[7], bi, 0);
    }
    // e + o: the last carry is zero (a * b < 2^512)
    uint32_t t[16];
    t[0] = e[0];
    t[1] = add_cc(e[1], o[1]);
#pragma unroll
    for (int k = 2; k < 15; ++k) t[k] = addc_cc(e[k], o[k]);
    t[15] = addc(o[15], 0);
    fe_reduce_to(r, t);
}

// r = a^2: the off-diagonal products once (row i: a_i * a_{i+1..7}, a lo
// pass and a hi pass), doubled, plus the diagonal
SECP_INLINE void fe_sqr_to(fe& r, const fe& a) {
    const uint32_t* x = a.v;
    uint32_t t[16];
    t[0] = 0;
    t[15] = 0;
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = x[0] * x[j];
    t[2] = mad_hi_cc(x[0], x[1], t[2]);
#pragma unroll
    for (int j = 2; j < 7; ++j) t[j + 1] = madc_hi_cc(x[0], x[j], t[j + 1]);
    t[8] = madc_hi(x[0], x[7], 0);
#pragma unroll
    for (int i = 1; i < 7; ++i) {
        // lo pass: t[2i+1 .. i+7] += lo(x_i x_j), carry-out starts t[i+8]
        t[2 * i + 1] = mad_lo_cc(x[i], x[i + 1], t[2 * i + 1]);
#pragma unroll
        for (int j = i + 2; j < 8; ++j) t[i + j] = madc_lo_cc(x[i], x[j], t[i + j]);
        t[i + 8] = addc(0, 0);
        // hi pass: t[2i+2 .. i+8] += hi(x_i x_j); the row fits, no carry-out
        if (i == 6) {
            t[14] = mad_hi(x[6], x[7], t[14]);
        } else {
            t[2 * i + 2] = mad_hi_cc(x[i], x[i + 1], t[2 * i + 2]);
#pragma unroll
            for (int j = i + 2; j < 7; ++j)
                t[i + j + 1] = madc_hi_cc(x[i], x[j], t[i + j + 1]);
            t[i + 8] = madc_hi(x[i], x[7], t[i + 8]);
        }
    }
    // 2t + sum x_i^2 * 2^(64 i)
    uint32_t d[16], u[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        d[2 * i] = x[i] * x[i];
        d[2 * i + 1] = mul_hi(x[i], x[i]);
    }
#pragma unroll
    for (int k = 1; k < 16; ++k) u[k] = (t[k] << 1) | (t[k - 1] >> 31);
    d[1] = add_cc(d[1], u[1]);
#pragma unroll
    for (int k = 2; k < 15; ++k) d[k] = addc_cc(d[k], u[k]);
    d[15] = addc(d[15], u[15]);
    fe_reduce_to(r, d);
}

// r += c * (2^32 + 977) for a small c (c * 977 < 2^32), then the 0/1
// carry of that once more (it leaves r < 2^33: no further carry)
SECP_INLINE void fe_fold_small(uint32_t* r, uint32_t c) {
    r[0] = mad_lo_cc(c, 977u, r[0]);
    r[1] = addc_cc(r[1], c);
#pragma unroll
    for (int i = 2; i < 8; ++i) r[i] = addc_cc(r[i], 0);
    uint32_t c2 = addc(0, 0);
    r[0] = mad_lo_cc(c2, 977u, r[0]);
    r[1] = addc_cc(r[1], c2);
#pragma unroll
    for (int i = 2; i < 7; ++i) r[i] = addc_cc(r[i], 0);
    r[7] = addc(r[7], 0);
}

SECP_INLINE void fe_add_to(fe& r, const fe& a, const fe& b) {
    uint32_t s[8];
    s[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) s[i] = addc_cc(a.v[i], b.v[i]);
    uint32_t c = addc(0, 0);
    fe_fold_small(s, c);
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = s[i];
}

// r = a - b: a borrow means a - b + 2^256, so take 2^32 + 977 off (that is
// + p); a second borrow (b > a + p) takes it off once more (+ 2p)
SECP_INLINE void fe_sub_to(fe& r, const fe& a, const fe& b) {
    uint32_t s[8];
    s[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) s[i] = subc_cc(a.v[i], b.v[i]);
    uint32_t m = subc(0, 0);            // all-ones on a borrow
    s[0] = sub_cc(s[0], 977u & m);
    s[1] = subc_cc(s[1], 1u & m);
#pragma unroll
    for (int i = 2; i < 8; ++i) s[i] = subc_cc(s[i], 0);
    m = subc(0, 0);
    s[0] = sub_cc(s[0], 977u & m);
    s[1] = subc_cc(s[1], 1u & m);
#pragma unroll
    for (int i = 2; i < 7; ++i) s[i] = subc_cc(s[i], 0);
    s[7] = subc(s[7], 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = s[i];
}

// r = -a: p - a, plus p again where a > p (a weak), both mod 2^256; in
// [0, p]
SECP_INLINE void fe_neg_to(fe& r, const fe& a) {
    const uint32_t P[8] = SECP_P_WORDS;
    uint32_t s[8];
    s[0] = sub_cc(P[0], a.v[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) s[i] = subc_cc(P[i], a.v[i]);
    uint32_t m = subc(0, 0);
    s[0] = add_cc(s[0], P[0] & m);
#pragma unroll
    for (int i = 1; i < 7; ++i) s[i] = addc_cc(s[i], P[i] & m);
    s[7] = addc(s[7], P[7] & m);
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = s[i];
}

// r = a * k for a small constant k (k <= 8 here)
SECP_INLINE void fe_mul_int_to(fe& r, const fe& a, uint32_t k) {
    uint32_t s[8], h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        s[i] = a.v[i] * k;
        h[i] = mul_hi(a.v[i], k);
    }
    s[1] = add_cc(s[1], h[0]);
#pragma unroll
    for (int i = 2; i < 8; ++i) s[i] = addc_cc(s[i], h[i - 1]);
    uint32_t top = addc(h[7], 0);
    fe_fold_small(s, top);
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = s[i];
}

// r = a/2 mod p: (a + p*(a&1)) >> 1, exact; the carry of the +p is the
// top bit
SECP_INLINE void fe_half_to(fe& r, const fe& a) {
    const uint32_t P[8] = SECP_P_WORDS;
    uint32_t m = 0u - (a.v[0] & 1u);
    uint32_t t[9];
    t[0] = add_cc(a.v[0], P[0] & m);
#pragma unroll
    for (int i = 1; i < 8; ++i) t[i] = addc_cc(a.v[i], P[i] & m);
    t[8] = addc(0, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = (t[i] >> 1) | (t[i + 1] << 31);
}

// weak -> canonical: a >= p  <=>  a + (2^32 + 977) carries out
SECP_INLINE fe fe_canon(const fe& a) {
    fe t;
    t.v[0] = add_cc(a.v[0], 977u);
    t.v[1] = addc_cc(a.v[1], 1u);
#pragma unroll
    for (int i = 2; i < 8; ++i) t.v[i] = addc_cc(a.v[i], 0);
    uint32_t ge = addc(0, 0);
    return select256(ge, t, a);
}

// a == 0 mod p for a weak a: a is 0 or p
SECP_INLINE uint32_t fe_is_zero(const fe& a) {
    const uint32_t P[8] = SECP_P_WORDS;
    uint32_t z = 0, zp = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        z |= a.v[i];
        zp |= a.v[i] ^ P[i];
    }
    return (uint32_t)(z == 0) | (uint32_t)(zp == 0);   // no branch
}

// 8 words at rows row.. of a thread's word-major scratch column (row stride
// ld): one coalesced row segment a warp for each word
SECP_INLINE void col_store(uint32_t* s, size_t ld, int row, const fe& a) {
#pragma unroll
    for (int w = 0; w < 8; ++w) s[(size_t)(row + w) * ld] = a.v[w];
}

SECP_INLINE void col_load(const uint32_t* s, size_t ld, int row, fe& a) {
#pragma unroll
    for (int w = 0; w < 8; ++w) a.v[w] = s[(size_t)(row + w) * ld];
}

// --- by-value forms ------------------------------------------------------

SECP_NOINLINE fe fe_mul(fe a, fe b) {
    fe r;
    fe_mul_to(r, a, b);
    return r;
}

SECP_NOINLINE fe fe_sqr(fe a) {
    fe r;
    fe_sqr_to(r, a);
    return r;
}

SECP_INLINE fe fe_add(const fe& a, const fe& b) {
    fe r;
    fe_add_to(r, a, b);
    return r;
}

SECP_INLINE fe fe_neg(const fe& a) {
    fe r;
    fe_neg_to(r, a);
    return r;
}

SECP_INLINE fe fe_sub(const fe& a, const fe& b) {
    fe r;
    fe_sub_to(r, a, b);
    return r;
}

SECP_INLINE fe fe_mul_int(const fe& a, uint32_t k) {
    fe r;
    fe_mul_int_to(r, a, k);
    return r;
}

SECP_INLINE fe fe_half(const fe& a) {
    fe r;
    fe_half_to(r, a);
    return r;
}

SECP_INLINE fe fe_const(const uint32_t (&w)[8]) {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = w[i];
    return r;
}

SECP_INLINE fe fe_one() {
    fe r;
    r.v[0] = 1;
#pragma unroll
    for (int i = 1; i < 8; ++i) r.v[i] = 0;
    return r;
}

SECP_INLINE fe fe_zero() {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = 0;
    return r;
}

// a <- a^(2^n): n dependent squarings on the inlined core, in a loop that
// is not unrolled (one squaring's code a call site, nothing passed through
// a call)
SECP_INLINE void fe_sqr_n_to(fe& a, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) fe_sqr_to(a, a);
}

// r = a^((p+1)/4), a square root of a wherever one exists (p = 3 mod 4);
// the caller checks r^2 == a.  The fixed addition chain of the reference's
// secp256k1_fe_sqrt (field_impl.h): 253 squarings and 13 multiplies, by
// reference on the force-inlined core (r may alias a).  At most six
// elements are live (x2, x3, x22, x44, x88 and the running power).
SECP_INLINE void fe_pow_sqrt_to(fe& r, const fe& a) {
    fe x2, x3, x22, x44, x88, t;
    fe_sqr_to(x2, a);
    fe_mul_to(x2, x2, a);
    fe_sqr_to(x3, x2);
    fe_mul_to(x3, x3, a);
    t = x3;                                   // x6
    fe_sqr_n_to(t, 3);
    fe_mul_to(t, t, x3);
    fe_sqr_n_to(t, 3);                        // x9
    fe_mul_to(t, t, x3);
    fe_sqr_n_to(t, 2);                        // x11
    fe_mul_to(t, t, x2);
    x22 = t;
    fe_sqr_n_to(x22, 11);
    fe_mul_to(x22, x22, t);
    x44 = x22;
    fe_sqr_n_to(x44, 22);
    fe_mul_to(x44, x44, x22);
    x88 = x44;
    fe_sqr_n_to(x88, 44);
    fe_mul_to(x88, x88, x44);
    t = x88;                                  // x176
    fe_sqr_n_to(t, 88);
    fe_mul_to(t, t, x88);
    fe_sqr_n_to(t, 44);                       // x220
    fe_mul_to(t, t, x44);
    fe_sqr_n_to(t, 3);                        // x223
    fe_mul_to(t, t, x3);
    fe_sqr_n_to(t, 23);
    fe_mul_to(t, t, x22);
    fe_sqr_n_to(t, 6);
    fe_mul_to(t, t, x2);
    fe_sqr_n_to(t, 2);
    r = t;
}
