// Complete, branch-free group formulas on jacobian points.
//
// Device-library counterpart of the TPU kernels' jp_double / jp_add_aff /
// jp_add / _add_aff_ratio: the same formulas (gej_double; the unified
// Brier-Joye addition with the degenerate-case select, the 7M+5S shape of
// gej_add_ge), so every coordinate is the same residue mod p.  Degenerate
// inputs (doubling inside an add, P + (-P), infinity operands) are handled
// by selects; nothing branches on the data.
#pragma once
#include "fe.cuh"

struct jp { fe x, y, z; uint32_t inf; };

SECP_INLINE jp jp_infinity() {
    jp r;
    r.x = fe_zero(); r.y = fe_one(); r.z = fe_one(); r.inf = 1;
    return r;
}

SECP_NOINLINE jp jp_double(jp a) {
    fe A = fe_sqr(a.x);
    fe Bq = fe_sqr(a.y);
    fe C = fe_sqr(Bq);
    fe t = fe_sqr(fe_add(a.x, Bq));
    fe D = fe_mul_int(fe_sub(fe_sub(t, A), C), 2);
    fe E = fe_mul_int(A, 3);
    fe Fq = fe_sqr(E);
    jp r;
    r.x = fe_sub(Fq, fe_mul_int(D, 2));
    r.y = fe_sub(fe_mul(E, fe_sub(D, r.x)), fe_mul_int(C, 8));
    r.z = fe_mul(fe_mul_int(a.y, 2), a.z);
    r.inf = a.inf;
    return r;
}

// Unified addition from the U/S pairs; Z3 = Zmul * m (m is the z-ratio).
SECP_NOINLINE void jp_add_core(fe U1, fe S1, fe U2, fe S2, fe Zmul,
                               fe* X3, fe* Y3, fe* Z3, fe* m_out) {
    fe T = fe_add(U1, U2);
    fe M = fe_add(S1, S2);
    fe m_alt = fe_neg(U2);
    fe rr = fe_add(fe_sqr(T), fe_mul(U1, m_alt));   // R = T^2 - U1*U2
    uint32_t deg = fe_is_zero(M);
    // If lambda = R/M degenerates (M == 0 but x1 != x2), the slope
    // (S1-S2)/(U1-U2) = 2*S1/(U1-U2) is used instead.
    fe rr_alt = fe_mul_int(S1, 2);
    m_alt = fe_add(m_alt, U1);                      // U1 - U2
    fe rr_f = select256(deg, rr_alt, rr);
    fe m_f = select256(deg, m_alt, M);
    fe n = fe_sqr(m_f);
    fe q = fe_mul(fe_neg(T), n);                    // Q = -T*Malt^2
    fe n2 = fe_sqr(n);
    fe n_f = select256(deg, M, n2);                 // M^3*Malt
    fe t2 = fe_sqr(rr_f);
    *Z3 = fe_mul(Zmul, m_f);
    fe x3 = fe_add(t2, q);
    fe t3 = fe_add(fe_mul_int(x3, 2), q);
    fe t4 = fe_mul(t3, rr_f);
    *Y3 = fe_half(fe_neg(fe_add(t4, n_f)));
    *X3 = x3;
    *m_out = m_f;
}

SECP_INLINE jp jp_add_finish(const jp& a, const fe& bx, const fe& by,
                             const fe& bz, uint32_t b_inf,
                             const fe& X3, const fe& Y3, const fe& Z3) {
    // Z3 == 0 covers a == -b and the y1 = -y2 completeness argument
    uint32_t inf3 = fe_is_zero(Z3);
    jp r;
    r.x = select256(a.inf, bx, select256(b_inf, a.x, X3));
    r.y = select256(a.inf, by, select256(b_inf, a.y, Y3));
    r.z = select256(a.inf, bz, select256(b_inf, a.z, Z3));
    r.inf = a.inf ? b_inf : (b_inf ? a.inf : inf3);
    return r;
}

// complete mixed addition a + (bx, by) affine
SECP_NOINLINE jp jp_add_aff(jp a, fe bx, fe by, uint32_t b_inf) {
    fe ZZ = fe_sqr(a.z);
    fe U2 = fe_mul(bx, ZZ);
    fe S2 = fe_mul(fe_mul(by, ZZ), a.z);
    fe X3, Y3, Z3, m;
    jp_add_core(a.x, a.y, U2, S2, a.z, &X3, &Y3, &Z3, &m);
    return jp_add_finish(a, bx, by, fe_one(), b_inf, X3, Y3, Z3);
}

// complete general addition (jacobian + jacobian)
SECP_NOINLINE jp jp_add(jp a, jp b) {
    fe Z11 = fe_sqr(a.z);
    fe Z22 = fe_sqr(b.z);
    fe U1 = fe_mul(a.x, Z22);
    fe U2 = fe_mul(b.x, Z11);
    fe S1 = fe_mul(fe_mul(a.y, Z22), b.z);
    fe S2 = fe_mul(fe_mul(b.y, Z11), a.z);
    fe Zc = fe_mul(a.z, b.z);
    fe X3, Y3, Z3, m;
    jp_add_core(U1, S1, U2, S2, Zc, &X3, &Y3, &Z3, &m);
    return jp_add_finish(a, b.x, b.y, b.z, b.inf, X3, Y3, Z3);
}

// complete mixed add for the table build (inputs never infinity); *m is
// the z-ratio Z3 / az that the global-Z pass needs
SECP_INLINE void jp_add_aff_ratio(const fe& ax, const fe& ay, const fe& az,
                                  const fe& bx, const fe& by,
                                  fe* X3, fe* Y3, fe* Z3, fe* m) {
    fe ZZ = fe_sqr(az);
    fe U2 = fe_mul(bx, ZZ);
    fe S2 = fe_mul(fe_mul(by, ZZ), az);
    jp_add_core(ax, ay, U2, S2, az, X3, Y3, Z3, m);
}
