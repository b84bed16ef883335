// GF(n) (group order) arithmetic on eight 32-bit words, the GLV lambda
// split and the signed-digit recodings.
//
// Device-library counterpart of the TPU kernels' _mul_limbs_n /
// _reduce_cols_n / _canon_n / _mul_shift384_round / _glv_split /
// recode_signed.  Reduction uses 2^256 === red (mod n), red = 2^256 - n
// (129 bits: five words, the top one 1), folded 512 -> 385 -> 259 -> 257
// bits as the reference's 4x64 scalar reduce does.
//
// As in fe.cuh, the core is force-inlined and by reference (sc_mul_to,
// sc_glv_split_to: nothing passes through a call, nothing goes to the
// stack); the by-value sc_mul and the pointer form of sc_glv_split are
// __noinline__ wrappers kept for the kernels that call them.
#pragma once
#include "consts.cuh"

typedef u256 sc;

// out[0..NO) = h[0..NH) * red + lo[0..8); the caller sizes NO so the
// value fits
template <int NH, int NO>
SECP_INLINE void sc_fold(uint32_t* out, const uint32_t* h, const uint32_t* lo) {
    const uint32_t RED[5] = SECP_RED_N_WORDS;
#pragma unroll
    for (int i = 0; i < NO; ++i) out[i] = i < 8 ? lo[i] : 0u;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
        u64 c = 0;
#pragma unroll
        for (int j = 0; j < 5; ++j) {
            c += (u64)h[i] * RED[j] + out[i + j];
            out[i + j] = (uint32_t)c;
            c >>= 32;
        }
#pragma unroll
        for (int k = i + 5; k < NO; ++k) {
            c += out[k];
            out[k] = (uint32_t)c;
            c >>= 32;
        }
    }
}

// weak -> canonical: a >= n  <=>  a + red carries out
SECP_INLINE sc sc_canon(const sc& a) {
    const uint32_t RED[5] = SECP_RED_N_WORDS;
    sc t;
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)a.v[i] + (i < 5 ? RED[i] : 0u);
        t.v[i] = (uint32_t)c; c >>= 32;
    }
    return select256((uint32_t)c, t, a);
}

// 512-bit value -> weak residue mod n
SECP_INLINE sc sc_reduce512(const uint32_t* t) {
    uint32_t y[13], z[10], w[9];
    sc_fold<8, 13>(y, t + 8, t);            // < 2^385 + 2^256
    sc_fold<5, 10>(z, y + 8, y);            // < 2^259
    sc_fold<1, 9>(w, z + 8, z);             // < 2^256 + 2^133
    // if w reached 2^256 the remainder is small: one more fold is exact
    uint32_t r[9];
    sc_fold<1, 9>(r, w + 8, w);
    sc out;
#pragma unroll
    for (int i = 0; i < 8; ++i) out.v[i] = r[i];
    return out;
}

// r = a * b (weak); r may alias an operand
SECP_INLINE void sc_mul_to(sc& r, const sc& a, const sc& b) {
    uint32_t t[16];
    bn_mul<8, 8>(t, a.v, b.v);
    r = sc_reduce512(t);
}

SECP_NOINLINE sc sc_mul(sc a, sc b) {
    sc r;
    sc_mul_to(r, a, b);
    return r;
}

// (a + b) mod n, canonical (a, b weak)
SECP_INLINE sc sc_add(const sc& a, const sc& b) {
    uint32_t s[9], r[9], r2[9];
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)a.v[i] + b.v[i];
        s[i] = (uint32_t)c; c >>= 32;
    }
    s[8] = (uint32_t)c;
    sc_fold<1, 9>(r, s + 8, s);
    sc_fold<1, 9>(r2, r + 8, r);
    sc out;
#pragma unroll
    for (int i = 0; i < 8; ++i) out.v[i] = r2[i];
    return sc_canon(out);
}

// n - a for canonical a (a == 0 -> n -> canonical 0)
SECP_INLINE sc sc_neg(const sc& a) {
    const uint32_t NW[8] = SECP_N_WORDS;
    sc r;
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u64 d = (u64)NW[i] - a.v[i] - borrow;
        r.v[i] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
    }
    return sc_canon(r);
}

// a > c for canonical a and a constant c
SECP_INLINE uint32_t sc_gt(const sc& a, const uint32_t (&cw)[8]) {
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u64 d = (u64)cw[i] - a.v[i] - borrow;
        borrow = (uint32_t)(d >> 63);
    }
    return borrow;
}

// round(k * g / 2^384) -> four words (k canonical)
SECP_INLINE void sc_mul_shift384_round(uint32_t* res, const sc& k,
                                       const uint32_t (&g)[8]) {
    uint32_t t[16];
    bn_mul<8, 8>(t, k.v, g);
    u64 c = t[11] >> 31;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        c += t[12 + i];
        res[i] = (uint32_t)c; c >>= 32;
    }
}

// k (canonical) -> a1, neg1, a2, neg2 with k === s1*a1 + lambda*s2*a2
// (mod n), s_i = (-1)^neg_i, a_i < 2^128 (four words each).  The
// algorithm of the reference's scalar_split_lambda.
SECP_INLINE void sc_glv_split_to(const sc& k, uint32_t (&a1)[4],
                                 uint32_t& neg1, uint32_t (&a2)[4],
                                 uint32_t& neg2) {
    const uint32_t G1[8] = SECP_G1_WORDS, G2[8] = SECP_G2_WORDS;
    const uint32_t MB1[4] = SECP_MINUS_B1_WORDS, MB2[8] = SECP_MINUS_B2_WORDS;
    const uint32_t LAM[8] = SECP_LAMBDA_WORDS, NH[8] = SECP_N_HALF_WORDS;
    uint32_t c1[4], c2[4], t[16];
    sc_mul_shift384_round(c1, k, G1);
    sc_mul_shift384_round(c2, k, G2);
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0;
    bn_mul<4, 4>(t, c1, MB1);
    sc t1 = sc_reduce512(t);
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0;
    bn_mul<4, 8>(t, c2, MB2);
    sc t2 = sc_reduce512(t);
    sc r2 = sc_add(t1, t2);
    sc lam;
#pragma unroll
    for (int i = 0; i < 8; ++i) lam.v[i] = LAM[i];
    sc lr2;
    sc_mul_to(lr2, r2, lam);
    sc r1 = sc_add(k, sc_neg(sc_canon(lr2)));   // k - lambda*r2
    neg1 = sc_gt(r1, NH);
    neg2 = sc_gt(r2, NH);
    sc m1 = select256(neg1, sc_neg(r1), r1);
    sc m2 = select256(neg2, sc_neg(r2), r2);
#pragma unroll
    for (int i = 0; i < 4; ++i) { a1[i] = m1.v[i]; a2[i] = m2.v[i]; }
}

SECP_NOINLINE void sc_glv_split(sc k, uint32_t* a1, uint32_t* neg1,
                                uint32_t* a2, uint32_t* neg2) {
    uint32_t b1[4], b2[4];
    sc_glv_split_to(k, b1, *neg1, b2, *neg2);
#pragma unroll
    for (int i = 0; i < 4; ++i) { a1[i] = b1[i]; a2[i] = b2[i]; }
}

// NWORDS 32-bit words (value < 2^NBITS) -> ceil((NBITS+1)/W) MSB-first
// signed W-bit digits, mag | sign<<8, written to rows out[row * B + lane].
// NBITS % W != 0, so the top digit absorbs the last carry.
template <int NWORDS, int NBITS, int W>
SECP_INLINE void sc_recode_signed(uint32_t* out, int B, int lane,
                                  const uint32_t* words) {
    const int nw = (NBITS + W) / W;
    const uint32_t half = 1u << (W - 1), full = 1u << W;
    uint32_t carry = 0;
#pragma unroll
    for (int i = 0; i < nw; ++i) {
        const int idx = (W * i) / 32, off = (W * i) % 32;
        uint32_t raw = 0;
        if (idx < NWORDS) {
            raw = words[idx] >> off;
            if (off + W > 32 && idx + 1 < NWORDS)
                raw |= words[idx + 1] << (32 - off);
            raw &= full - 1;
        }
        uint32_t d = raw + carry;
        carry = d > half ? 1u : 0u;
        uint32_t mag = carry ? full - d : d;
        out[(size_t)(nw - 1 - i) * B + lane] = mag | (carry << 8);
    }
}
