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
// the result may alias an operand); no struct passes through a call, so
// nothing goes to the stack.  Below it, the sums of many points that the
// kernels share.
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

// A doubling by a pair of threads, both holding a: thread h runs the same
// instruction stream on its own operands, a square, a multiply and a
// square (h = 0: A = X^2, 2Y * Z, F = (3A)^2; h = 1: B = Y^2, X * B,
// C = B^2), the pair swaps the three (jp_double_pair_to), and each
// finishes X3 = F - 2D, Y3 = E (D - X3) - 8C with D = 4 X B and E = 3A:
// the residues of jp_double_to, with each thread issuing four of its
// seven field products.  The halves compile as plain C++ too.
SECP_INLINE void jp_double_half(fe* m, const jp& a, uint32_t h) {
    fe t;
    fe_sqr_to(m[0], select256(h, a.y, a.x));                 // A | B
    fe_mul_int_to(t, a.y, 2);
    fe_mul_to(m[1], select256(h, a.x, t),
              select256(h, m[0], a.z));                       // 2YZ | XB
    fe_mul_int_to(t, m[0], 3);
    fe_sqr_to(m[2], select256(h, m[0], t));                  // F | C
}

// m: this thread's three products, o: the other thread's
SECP_INLINE void jp_double_join(jp& r, const fe* m, const fe* o, uint32_t h,
                                uint32_t inf) {
    const fe A = select256(h, o[0], m[0]), F = select256(h, o[2], m[2]);
    const fe XB = select256(h, m[1], o[1]), C = select256(h, m[2], o[2]);
    fe D, t;
    r.z = select256(h, o[1], m[1]);                           // 2YZ
    fe_mul_int_to(D, XB, 4);
    fe_mul_int_to(t, D, 2);
    fe_sub_to(r.x, F, t);                                     // F - 2D
    fe_sub_to(t, D, r.x);
    fe_mul_int_to(r.y, A, 3);                                 // E
    fe_mul_to(r.y, r.y, t);
    fe_mul_int_to(t, C, 8);
    fe_sub_to(r.y, r.y, t);                                   // E(D-X3) - 8C
    r.inf = inf;
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

// --- lane sums: the trees of msm_winreduce, msm_finish, gej_sum and the
// comb's thread teams --------------------------------------------------
//
// A sum of many jacobian points on the card is a strided fold in each
// thread (jp_fold_cols), then a tree of complete adds across threads: a
// warp-shuffle tree (jp_warp_sum) and, across a block's warps, one more
// through shared memory (jp_block_sum).  The adds are complete, so a
// thread with nothing to add holds infinity and the tree needs no branch.
// The fold compiles as plain C++ too (the host harness runs it); the trees
// are shuffles and barriers, which the harness writes out as loops in the
// same order.

// the point at column col of limb-major x, y, z [16, ld] and flags inf
// [ld]; with CG through L2 only (load16_cg)
template <bool CG>
SECP_INLINE void jp_load_col(jp& p, const uint32_t* x, const uint32_t* y,
                             const uint32_t* z, const uint32_t* inf, int ld,
                             int col) {
    p.x = CG ? load16_cg(x, ld, col) : load16(x, ld, col);
    p.y = CG ? load16_cg(y, ld, col) : load16(y, ld, col);
    p.z = CG ? load16_cg(z, ld, col) : load16(z, ld, col);
    p.inf = (CG ? SECP_LDCG(inf + col) : inf[col]) & 1u;
}

// acc = the sum of columns i, i + step, ... < hi, added in that order
// (the first column is acc itself: infinity + p is p, word for word);
// each column's load is issued before the add of the one before it
template <bool CG = false>
SECP_INLINE void jp_fold_cols(jp& acc, const uint32_t* x, const uint32_t* y,
                              const uint32_t* z, const uint32_t* inf, int ld,
                              int i, int hi, int step) {
    acc = jp_infinity();
    if (i >= hi) return;
    jp_load_col<CG>(acc, x, y, z, inf, ld, i);
    jp p, q;
    i += step;
    if (i < hi) jp_load_col<CG>(p, x, y, z, inf, ld, i);
#pragma unroll 1
    while (i < hi) {
        const int j = i + step;
        if (j < hi) jp_load_col<CG>(q, x, y, z, inf, ld, j);   // in flight
        jp_add_to(acc, acc, p);
        p = q;
        i = j;
    }
}

SECP_INLINE void jp_store_col(uint32_t* x, uint32_t* y, uint32_t* z,
                              uint32_t* inf, int ld, int col, const jp& a) {
    store16(x, ld, col, fe_canon(a.x));
    store16(y, ld, col, fe_canon(a.y));
    store16(z, ld, col, fe_canon(a.z));
    inf[col] = a.inf;
}

// the least power of two >= n
SECP_INLINE int pow2_ceil(int n) {
    int w = 1;
    while (w < n) w <<= 1;
    return w;
}

#ifdef __CUDACC__
SECP_INLINE void jp_shfl_down(jp& o, const jp& a, int s, int width) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        o.x.v[i] = __shfl_down_sync(0xFFFFFFFFu, a.x.v[i], s, width);
        o.y.v[i] = __shfl_down_sync(0xFFFFFFFFu, a.y.v[i], s, width);
        o.z.v[i] = __shfl_down_sync(0xFFFFFFFFu, a.z.v[i], s, width);
    }
    o.inf = __shfl_down_sync(0xFFFFFFFFu, a.inf, s, width);
}

// jp_double_to(r, a) by the pair of threads (2k, 2k + 1) of a warp, both
// holding a (jp_double_half, jp_double_join); both threads of the pair
// take part, the rest of the warp need not
SECP_INLINE void jp_double_pair_to(jp& r, const jp& a) {
    const uint32_t h = threadIdx.x & 1u;
    const uint32_t pair = 3u << (threadIdx.x & 30u);
    fe m[3], o[3];
    jp_double_half(m, a, h);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < 8; ++i)
            o[k].v[i] = __shfl_xor_sync(pair, m[k].v[i], 1);
    jp_double_join(r, m, o, h, a.inf);
}

// each aligned run of `width` threads of the warp (a power of two up to
// 32) -> its first thread holds the run's sum: at the level s = width / 2,
// ..., 1, thread t adds what thread t + s holds (a thread whose t + s
// leaves the run adds its own value, which no one reads).  Every thread of
// the warp takes part.
SECP_INLINE void jp_warp_sum(jp& acc, int width) {
#pragma unroll 1
    for (int s = width >> 1; s > 0; s >>= 1) {
        jp o;
        jp_shfl_down(o, acc, s, width);
        jp_add_to(acc, acc, o);
    }
}

// the sum of acc over threads 0 .. n-1 of the block -> thread 0 (1 <= n
// <= blockDim.x; what threads n.. hold is not read).  Each warp's tree
// over pow2_ceil(min(n, 32)) threads, then warp 0's over the warps' sums
// in sh (blockDim.x / 32 points of shared memory).  Every thread of the
// block calls it (it holds barriers).
SECP_INLINE void jp_block_sum(jp& acc, int n, jp* sh) {
    const int t = threadIdx.x;
    if (t >= n) acc = jp_infinity();
    jp_warp_sum(acc, pow2_ceil(n < 32 ? n : 32));
    if (n <= 32) return;
    const int warps = (n + 31) >> 5;
    if ((t & 31) == 0 && (t >> 5) < warps) sh[t >> 5] = acc;
    __syncthreads();
    if (t < 32) {
        acc = t < warps ? sh[t] : jp_infinity();
        jp_warp_sum(acc, pow2_ceil(warps));
    }
    __syncthreads();                    // sh is free again
}
#endif
