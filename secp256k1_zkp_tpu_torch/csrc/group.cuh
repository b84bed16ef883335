// Complete, branch-free group formulas on jacobian points.
//
// Device-library counterpart of the TPU kernels' jp_double / jp_add_aff /
// jp_add / _add_aff_ratio: the same formulas (gej_double; the unified
// Brier-Joye addition with the degenerate-case select, the 7M+5S shape of
// gej_add_ge), so every coordinate is the same residue mod p.  Degenerate
// inputs (doubling inside an add, P + (-P), infinity operands) are handled
// by selects; nothing branches on the data.
//
// As in fe.cuh, the core is the force-inlined *_to family (by reference;
// the result may alias an operand), and jp_double / jp_add_aff / jp_add
// are __noinline__ by-value wrappers for the kernels outside the hot loops.
#pragma once
#include "fe.cuh"

struct jp { fe x, y, z; uint32_t inf; };

SECP_INLINE jp jp_infinity() {
    jp r;
    r.x = fe_zero(); r.y = fe_one(); r.z = fe_one(); r.inf = 1;
    return r;
}

SECP_INLINE void jp_double_to(jp& r, const jp& a) {
    fe A, Bq, C, t, D, E, x3, y3, z3;
    fe_sqr_to(A, a.x);
    fe_sqr_to(Bq, a.y);
    fe_sqr_to(C, Bq);
    fe_add_to(t, a.x, Bq);
    fe_sqr_to(t, t);
    fe_sub_to(t, t, A);
    fe_sub_to(t, t, C);
    fe_mul_int_to(D, t, 2);
    fe_mul_int_to(E, A, 3);
    fe_sqr_to(x3, E);                       // F = E^2
    fe_mul_int_to(t, D, 2);
    fe_sub_to(x3, x3, t);                   // X3 = F - 2D
    fe_sub_to(t, D, x3);
    fe_mul_to(y3, E, t);
    fe_mul_int_to(C, C, 8);
    fe_sub_to(y3, y3, C);                   // Y3 = E (D - X3) - 8C
    fe_mul_int_to(t, a.y, 2);
    fe_mul_to(z3, t, a.z);                  // Z3 = 2 Y Z
    r.inf = a.inf;
    r.x = x3; r.y = y3; r.z = z3;
}

// Unified addition from the U/S pairs; Z3 = Zmul * m (m is the z-ratio).
SECP_INLINE void jp_add_core_to(const fe& U1, const fe& S1, const fe& U2,
                                const fe& S2, const fe& Zmul, fe& X3, fe& Y3,
                                fe& Z3, fe& m_out) {
    fe T, M, m_alt, rr, t, n, q;
    fe_add_to(T, U1, U2);
    fe_add_to(M, S1, S2);
    fe_neg_to(m_alt, U2);
    fe_sqr_to(rr, T);
    fe_mul_to(t, U1, m_alt);
    fe_add_to(rr, rr, t);                   // R = T^2 - U1*U2
    uint32_t deg = fe_is_zero(M);
    // If lambda = R/M degenerates (M == 0 but x1 != x2), the slope
    // (S1-S2)/(U1-U2) = 2*S1/(U1-U2) is used instead.
    fe_mul_int_to(t, S1, 2);
    fe_add_to(m_alt, m_alt, U1);            // U1 - U2
    rr = select256(deg, t, rr);             // rr_f
    fe m_f = select256(deg, m_alt, M);
    fe_sqr_to(n, m_f);
    fe_neg_to(t, T);
    fe_mul_to(q, t, n);                     // Q = -T*Malt^2
    fe_sqr_to(n, n);
    n = select256(deg, M, n);               // n_f = M^3*Malt
    fe_sqr_to(t, rr);
    fe_mul_to(Z3, Zmul, m_f);
    fe_add_to(X3, t, q);
    fe_mul_int_to(t, X3, 2);
    fe_add_to(t, t, q);
    fe_mul_to(t, t, rr);
    fe_add_to(t, t, n);
    fe_neg_to(t, t);
    fe_half_to(Y3, t);
    m_out = m_f;
}

// Z3 == 0 covers a == -b and the y1 = -y2 completeness argument
SECP_INLINE void jp_add_finish_to(jp& r, const jp& a, const fe& bx,
                                  const fe& by, const fe& bz, uint32_t b_inf,
                                  const fe& X3, const fe& Y3, const fe& Z3) {
    uint32_t inf3 = fe_is_zero(Z3);
    uint32_t inf = a.inf ? b_inf : (b_inf ? a.inf : inf3);
    fe x = select256(a.inf, bx, select256(b_inf, a.x, X3));
    fe y = select256(a.inf, by, select256(b_inf, a.y, Y3));
    fe z = select256(a.inf, bz, select256(b_inf, a.z, Z3));
    r.x = x; r.y = y; r.z = z; r.inf = inf;
}

// complete mixed addition a + (bx, by) affine
SECP_INLINE void jp_add_aff_to(jp& r, const jp& a, const fe& bx,
                               const fe& by, uint32_t b_inf) {
    fe ZZ, U2, S2, X3, Y3, Z3, m;
    fe_sqr_to(ZZ, a.z);
    fe_mul_to(U2, bx, ZZ);
    fe_mul_to(S2, by, ZZ);
    fe_mul_to(S2, S2, a.z);
    jp_add_core_to(a.x, a.y, U2, S2, a.z, X3, Y3, Z3, m);
    jp_add_finish_to(r, a, bx, by, fe_one(), b_inf, X3, Y3, Z3);
}

// complete general addition (jacobian + jacobian)
SECP_INLINE void jp_add_to(jp& r, const jp& a, const jp& b) {
    fe Z11, Z22, U1, U2, S1, S2, Zc, X3, Y3, Z3, m;
    fe_sqr_to(Z11, a.z);
    fe_sqr_to(Z22, b.z);
    fe_mul_to(U1, a.x, Z22);
    fe_mul_to(U2, b.x, Z11);
    fe_mul_to(S1, a.y, Z22);
    fe_mul_to(S1, S1, b.z);
    fe_mul_to(S2, b.y, Z11);
    fe_mul_to(S2, S2, a.z);
    fe_mul_to(Zc, a.z, b.z);
    jp_add_core_to(U1, S1, U2, S2, Zc, X3, Y3, Z3, m);
    jp_add_finish_to(r, a, b.x, b.y, b.z, b.inf, X3, Y3, Z3);
}

// complete mixed add for the table builds (inputs never infinity); *m is
// the z-ratio Z3 / az that the global-Z pass needs
SECP_INLINE void jp_add_aff_ratio(const fe& ax, const fe& ay, const fe& az,
                                  const fe& bx, const fe& by,
                                  fe* X3, fe* Y3, fe* Z3, fe* m) {
    fe ZZ, U2, S2;
    fe_sqr_to(ZZ, az);
    fe_mul_to(U2, bx, ZZ);
    fe_mul_to(S2, by, ZZ);
    fe_mul_to(S2, S2, az);
    jp_add_core_to(ax, ay, U2, S2, az, *X3, *Y3, *Z3, *m);
}

// --- by-value forms ------------------------------------------------------

SECP_NOINLINE jp jp_double(jp a) {
    jp r;
    jp_double_to(r, a);
    return r;
}

SECP_NOINLINE jp jp_add_aff(jp a, fe bx, fe by, uint32_t b_inf) {
    jp r;
    jp_add_aff_to(r, a, bx, by, b_inf);
    return r;
}

SECP_NOINLINE jp jp_add(jp a, jp b) {
    jp r;
    jp_add_to(r, a, b);
    return r;
}
