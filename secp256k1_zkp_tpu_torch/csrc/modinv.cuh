// Constant-time modular inverse by safegcd divsteps (Bernstein-Yang), in
// the shape of the reference C library's modinv32: 20 batches of 30
// divsteps on nine signed 30-bit limbs with 64-bit accumulators (600 >= the
// 590 divsteps proven sufficient for 256-bit inputs).
//
// Replaces the TPU kernels' inv_limbs16 (43 batches of 14 divsteps on
// 14-bit limbs, a shape forced by 32-bit vector lanes).  Same contract:
// canonical value in, canonical inverse out, inv(0) = 0; fixed dataflow,
// no branch on the data.
//
// Beside it, for PUBLIC values only, the Jacobi symbol by positive
// divsteps (jacobi30_var, the reference's jacobi32_maybe_var): the same
// batches and f, g update without the d, e half, in variable time.
#pragma once
#include "consts.cuh"

struct modinfo30 { int32_t m[9]; uint32_t inv30; };

#define SECP_M30 0x3FFFFFFF

struct trans30 { int32_t u, v, q, r; };

SECP_INLINE int32_t modinv_divsteps30(int32_t zeta, uint32_t f0, uint32_t g0,
                                      trans30& t) {
    uint32_t u = 1, v = 0, q = 0, r = 1;
    uint32_t f = f0, g = g0;
#pragma unroll 6
    for (int i = 0; i < 30; ++i) {
        uint32_t c1 = (uint32_t)(zeta >> 31);   // all-ones iff zeta < 0
        uint32_t c2 = 0u - (g & 1u);            // all-ones iff g odd
        uint32_t x = (f ^ c1) - c1;
        uint32_t y = (u ^ c1) - c1;
        uint32_t z = (v ^ c1) - c1;
        g += x & c2;
        q += y & c2;
        r += z & c2;
        c1 &= c2;
        zeta = (zeta ^ (int32_t)c1) - 1;
        f += g & c1;
        u += q & c1;
        v += r & c1;
        g >>= 1;
        u <<= 1;
        v <<= 1;
    }
    t.u = (int32_t)u; t.v = (int32_t)v; t.q = (int32_t)q; t.r = (int32_t)r;
    return zeta;
}

// (t * [d, e] + modulus * [md, me]) / 2^30, keeping d, e in (-2m, m)
SECP_INLINE void modinv_update_de(int32_t* d, int32_t* e, const trans30& t,
                                  const modinfo30& mi) {
    const int32_t u = t.u, v = t.v, q = t.q, r = t.r;
    int32_t sd = d[8] >> 31, se = e[8] >> 31;
    int32_t md = (u & sd) + (v & se);
    int32_t me = (q & sd) + (r & se);
    int32_t di = d[0], ei = e[0];
    int64_t cd = (int64_t)u * di + (int64_t)v * ei;
    int64_t ce = (int64_t)q * di + (int64_t)r * ei;
    // make the bottom 30 bits of t*[d,e] + modulus*[md,me] vanish
    md -= (int32_t)((mi.inv30 * (uint32_t)cd + (uint32_t)md) & SECP_M30);
    me -= (int32_t)((mi.inv30 * (uint32_t)ce + (uint32_t)me) & SECP_M30);
    cd += (int64_t)mi.m[0] * md;
    ce += (int64_t)mi.m[0] * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        di = d[i]; ei = e[i];
        cd += (int64_t)u * di + (int64_t)v * ei;
        ce += (int64_t)q * di + (int64_t)r * ei;
        cd += (int64_t)mi.m[i] * md;
        ce += (int64_t)mi.m[i] * me;
        d[i - 1] = (int32_t)cd & SECP_M30; cd >>= 30;
        e[i - 1] = (int32_t)ce & SECP_M30; ce >>= 30;
    }
    d[8] = (int32_t)cd;
    e[8] = (int32_t)ce;
}

// (t / 2^30) * [f, g]
SECP_INLINE void modinv_update_fg(int32_t* f, int32_t* g, const trans30& t) {
    const int32_t u = t.u, v = t.v, q = t.q, r = t.r;
    int32_t fi = f[0], gi = g[0];
    int64_t cf = (int64_t)u * fi + (int64_t)v * gi;
    int64_t cg = (int64_t)q * fi + (int64_t)r * gi;
    cf >>= 30;                                  // bottom 30 bits are zero
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        fi = f[i]; gi = g[i];
        cf += (int64_t)u * fi + (int64_t)v * gi;
        cg += (int64_t)q * fi + (int64_t)r * gi;
        f[i - 1] = (int32_t)cf & SECP_M30; cf >>= 30;
        g[i - 1] = (int32_t)cg & SECP_M30; cg >>= 30;
    }
    f[8] = (int32_t)cf;
    g[8] = (int32_t)cg;
}

// negate if sign < 0, then bring into [0, modulus) with limbs in [0, 2^30)
SECP_INLINE void modinv_normalize(int32_t* d, int32_t sign,
                                  const modinfo30& mi) {
    int32_t cond_add = d[8] >> 31;
    int32_t cond_neg = sign >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        d[i] += mi.m[i] & cond_add;
        d[i] = (d[i] ^ cond_neg) - cond_neg;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        d[i + 1] += d[i] >> 30;
        d[i] &= SECP_M30;
    }
    cond_add = d[8] >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) d[i] += mi.m[i] & cond_add;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        d[i + 1] += d[i] >> 30;
        d[i] &= SECP_M30;
    }
}

// eight 32-bit words -> nine 30-bit limbs
SECP_INLINE void limbs30_of(int32_t* g, const u256& x) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        const int idx = (30 * i) / 32, off = (30 * i) % 32;
        uint32_t w = x.v[idx] >> off;
        if (off > 2 && idx + 1 < 8) w |= x.v[idx + 1] << (32 - off);
        g[i] = (int32_t)(w & SECP_M30);
    }
}

SECP_INLINE u256 modinv30(const u256& x, const modinfo30& mi) {
    int32_t d[9], e[9], f[9], g[9];
    limbs30_of(g, x);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        f[i] = mi.m[i];
        d[i] = 0;
        e[i] = 0;
    }
    e[0] = 1;
    int32_t zeta = -1;
#pragma unroll 1
    for (int it = 0; it < 20; ++it) {
        trans30 t;
        zeta = modinv_divsteps30(zeta, (uint32_t)f[0] | ((uint32_t)f[1] << 30),
                                 (uint32_t)g[0] | ((uint32_t)g[1] << 30), t);
        modinv_update_de(d, e, t, mi);
        modinv_update_fg(f, g, t);
    }
    // f == +/- 1 now; its sign lives in the top limb
    modinv_normalize(d, f[8], mi);
    u256 r;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int idx = (32 * i) / 30, off = (32 * i) % 30;
        uint32_t w = (uint32_t)d[idx] >> off;
        if (idx + 1 < 9) w |= (uint32_t)d[idx + 1] << (30 - off);
        if (off > 28 && idx + 2 < 9) w |= (uint32_t)d[idx + 2] << (60 - off);
        r.v[i] = w;
    }
    return r;
}

// --- the Jacobi symbol of a public value ----------------------------------
//
// Positive divsteps (M. Hamburg, "Computing the Jacobi symbol using
// Bernstein-Yang"; the reference's posdivsteps_30_var): f, g >= 0 with f
// odd; where g is odd, g += f, swapping f and g first where eta < 0; then
// g /= 2.  f and g never grow, and jac's bit 0 holds the sign flips of
// (g | f): a halving flips it where f = 3 or 5 mod 8, a swap where f = g =
// 3 mod 4 (reciprocity for odd positive f, g), an add never.  The loop
// takes each run of zeros of g at once and cancels up to 4 low bits of g a
// step with a multiple w of f, so its trip count depends on the data: for
// public values only.  One call: 30 halvings, the transition matrix in t
// (nonnegative entries, at most 2^30, so modinv_update_fg applies).
SECP_INLINE int32_t jacobi_posdivsteps30_var(int32_t eta, uint32_t f,
                                             uint32_t g, trans30& t,
                                             uint32_t& jac) {
    uint32_t u = 1, v = 0, q = 0, r = 1;
    int i = 30;
    for (;;) {
        // the zeros of g, at most i of them (a sentinel bit at i)
        const uint32_t s = g | (0xFFFFFFFFu << i);
#ifdef __CUDACC__
        const int zeros = __ffs(s) - 1;
#else
        const int zeros = __builtin_ctz(s);
#endif
        g >>= zeros;
        u <<= zeros;
        v <<= zeros;
        eta -= zeros;
        i -= zeros;
        jac ^= (uint32_t)zeros & ((f >> 1) ^ (f >> 2));
        if (i == 0) break;
        // f and g odd: where eta < 0, negate it and swap the rows
        const uint32_t c = (uint32_t)(eta >> 31);
        eta = (eta ^ (int32_t)c) - (int32_t)c;
        jac ^= c & ((f & g) >> 1);
        uint32_t x = (f ^ g) & c;
        f ^= x;
        g ^= x;
        x = (u ^ q) & c;
        u ^= x;
        q ^= x;
        x = (v ^ r) & c;
        v ^= x;
        r ^= x;
        // g += w f cancels min(eta + 1, i, 4) low bits of g; w = -g / f
        // mod 16, with 1 / f = f (2 - f^2) mod 16
        const int limit = eta + 1 > i ? i : eta + 1;
        const uint32_t m = (0xFFFFFFFFu >> (32 - limit)) & 15u;
        const uint32_t w = (f * g * (f * f - 2u)) & m;
        g += f * w;
        q += u * w;
        r += v * w;
    }
    t.u = (int32_t)u; t.v = (int32_t)v; t.q = (int32_t)q; t.r = (int32_t)r;
    return eta;
}

// batches of 30 positive divsteps before a lane counts as undecided: the
// reference's cap (1,500 steps); random 256-bit inputs reach f = 1 after
// about 750-850
#define SECP_JACOBI_BATCHES 50

// (x | p) for a canonical, PUBLIC x != 0: 1 or -1; 0 where f has not
// reached 1 after SECP_JACOBI_BATCHES batches (the caller then decides by
// another route).  x = 0 never converges: callers test it first.
SECP_INLINE int jacobi30_var(const u256& x, const modinfo30& mi) {
    int32_t f[9], g[9];
    limbs30_of(g, x);
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = mi.m[i];
    int32_t eta = -1;
    uint32_t jac = 0;
#pragma unroll 1
    for (int it = 0; it < SECP_JACOBI_BATCHES; ++it) {
        trans30 t;
        eta = jacobi_posdivsteps30_var(
            eta, (uint32_t)f[0] | ((uint32_t)f[1] << 30),
            (uint32_t)g[0] | ((uint32_t)g[1] << 30), t, jac);
        modinv_update_fg(f, g, t);
        // f = gcd(x, p) = 1 ends it: (g | 1) = 1
        int32_t rest = f[0] ^ 1;
#pragma unroll
        for (int i = 1; i < 9; ++i) rest |= f[i];
        if (rest == 0) return 1 - 2 * (int)(jac & 1u);
    }
    return 0;
}

SECP_NOINLINE u256 modinv_p(u256 x) {
    const modinfo30 mi = { SECP_MODINV_P_LIMBS, SECP_MODINV_P_INV30 };
    return modinv30(x, mi);
}

SECP_NOINLINE u256 modinv_n(u256 x) {
    const modinfo30 mi = { SECP_MODINV_N_LIMBS, SECP_MODINV_N_INV30 };
    return modinv30(x, mi);
}
