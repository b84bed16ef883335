// GF(p) arithmetic, p = 2^256 - 2^32 - 977, on eight 32-bit words.
//
// Device-library counterpart of the TPU kernels' _mul_limbs / _sqr_limbs /
// _reduce_cols / _canon_p and the fe_* helpers.  Every function returns a
// *weak* value (< 2^256, possibly >= p once); there are no lazy magnitudes:
// 32-bit words leave no headroom, so adds fold their carry at once.
#pragma once
#include "consts.cuh"

typedef u256 fe;

// r += h * (2^32 + 977) for h < 2^34 (that is h * 2^256 mod p); returns
// the carry out of word 7 (0/1)
SECP_INLINE uint32_t fe_fold(fe& r, u64 h) {
    u64 d = (u64)r.v[0] + h * 977u;
    r.v[0] = (uint32_t)d; d >>= 32;
    d += (u64)r.v[1] + (h & 0xFFFFFFFFu);
    r.v[1] = (uint32_t)d; d >>= 32;
    d += (u64)r.v[2] + (h >> 32);
    r.v[2] = (uint32_t)d; d >>= 32;
#pragma unroll
    for (int i = 3; i < 8; ++i) {
        d += r.v[i];
        r.v[i] = (uint32_t)d; d >>= 32;
    }
    return (uint32_t)d;
}

// 512-bit product t -> weak residue: lo + hi * (2^32 + 977), twice folded
SECP_INLINE fe fe_reduce512(const uint32_t* t) {
    fe r;
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)t[i] + (u64)t[8 + i] * 977u;
        if (i > 0) c += t[7 + i];           // the hi << 32 term
        r.v[i] = (uint32_t)c; c >>= 32;
    }
    c += t[15];                             // overflow word, < 2^33 + 980
    uint32_t c1 = fe_fold(r, c);
    // a second carry leaves a tiny remainder, so this fold cannot carry
    fe_fold(r, c1);
    return r;
}

SECP_NOINLINE fe fe_mul(fe a, fe b) {
    uint32_t t[16];
    bn_mul<8, 8>(t, a.v, b.v);
    return fe_reduce512(t);
}

// Squaring: off-diagonal products once, doubled, plus the diagonal.
SECP_NOINLINE fe fe_sqr(fe a) {
    uint32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
        u64 c = 0;
#pragma unroll
        for (int j = i + 1; j < 8; ++j) {
            c += (u64)a.v[i] * a.v[j] + t[i + j];
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        t[i + 8] = (uint32_t)c;
    }
    // t = 2*t + sum a_i^2 * 2^(64 i)
    u64 c = 0;
    uint32_t top = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u64 sq = (u64)a.v[i] * a.v[i];
        uint32_t lo = (t[2 * i] << 1) | top;
        uint32_t hi = (t[2 * i + 1] << 1) | (t[2 * i] >> 31);
        top = t[2 * i + 1] >> 31;
        c += (u64)lo + (uint32_t)sq;
        t[2 * i] = (uint32_t)c; c >>= 32;
        c += (u64)hi + (sq >> 32);
        t[2 * i + 1] = (uint32_t)c; c >>= 32;
    }
    return fe_reduce512(t);
}

SECP_INLINE fe fe_add(const fe& a, const fe& b) {
    fe r;
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)a.v[i] + b.v[i];
        r.v[i] = (uint32_t)c; c >>= 32;
    }
    uint32_t c1 = fe_fold(r, c);
    fe_fold(r, c1);
    return r;
}

// -a: p - a, plus p again where a > p (a weak), both mod 2^256; in [0, p]
SECP_INLINE fe fe_neg(const fe& a) {
    const uint32_t P[8] = SECP_P_WORDS;
    fe r;
    u64 d;
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        d = (u64)P[i] - a.v[i] - borrow;
        r.v[i] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
    }
    uint32_t mask = 0u - borrow;
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)r.v[i] + (P[i] & mask);
        r.v[i] = (uint32_t)c; c >>= 32;
    }
    return r;
}

SECP_INLINE fe fe_sub(const fe& a, const fe& b) { return fe_add(a, fe_neg(b)); }

// a * k for a small constant k (k <= 8 here)
SECP_INLINE fe fe_mul_int(const fe& a, uint32_t k) {
    fe r;
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)a.v[i] * k;
        r.v[i] = (uint32_t)c; c >>= 32;
    }
    uint32_t c1 = fe_fold(r, c);
    fe_fold(r, c1);
    return r;
}

// a/2 mod p: (a + p*(a&1)) >> 1, exact; the carry of the +p is the top bit
SECP_INLINE fe fe_half(const fe& a) {
    const uint32_t P[8] = SECP_P_WORDS;
    uint32_t mask = 0u - (a.v[0] & 1u);
    uint32_t t[9];
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)a.v[i] + (P[i] & mask);
        t[i] = (uint32_t)c; c >>= 32;
    }
    t[8] = (uint32_t)c;
    fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = (t[i] >> 1) | (t[i + 1] << 31);
    return r;
}

// weak -> canonical: a >= p  <=>  a + (2^32 + 977) carries out
SECP_INLINE fe fe_canon(const fe& a) {
    fe t = a;
    uint32_t ge = fe_fold(t, 1);
    return select256(ge, t, a);
}

SECP_INLINE uint32_t fe_is_zero(const fe& a) {
    fe c = fe_canon(a);
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc |= c.v[i];
    return acc == 0 ? 1u : 0u;
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

// a^(2^n): n dependent squarings
SECP_INLINE fe fe_sqr_n(fe a, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) a = fe_sqr(a);
    return a;
}

// a^((p+1)/4), a square root of a wherever one exists (p = 3 mod 4); the
// caller checks r^2 == a.  The fixed addition chain of the reference's
// secp256k1_fe_sqrt (field_impl.h): 253 squarings and 13 multiplies.
SECP_NOINLINE fe fe_pow_sqrt(fe a) {
    fe x2 = fe_mul(fe_sqr(a), a);
    fe x3 = fe_mul(fe_sqr(x2), a);
    fe x6 = fe_mul(fe_sqr_n(x3, 3), x3);
    fe x9 = fe_mul(fe_sqr_n(x6, 3), x3);
    fe x11 = fe_mul(fe_sqr_n(x9, 2), x2);
    fe x22 = fe_mul(fe_sqr_n(x11, 11), x11);
    fe x44 = fe_mul(fe_sqr_n(x22, 22), x22);
    fe x88 = fe_mul(fe_sqr_n(x44, 44), x44);
    fe x176 = fe_mul(fe_sqr_n(x88, 88), x88);
    fe x220 = fe_mul(fe_sqr_n(x176, 44), x44);
    fe x223 = fe_mul(fe_sqr_n(x220, 3), x3);
    fe t = fe_mul(fe_sqr_n(x223, 23), x22);
    t = fe_mul(fe_sqr_n(t, 6), x2);
    return fe_sqr_n(t, 2);
}
