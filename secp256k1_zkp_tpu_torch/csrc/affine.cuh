// Jacobian -> canonical affine for a group of K lanes a thread, with one
// safegcd inverse for the group (Montgomery's trick), and y's quadratic
// character: the shared device code of affine_xy.cu and affine_meta.cu.
//
// Thread t of S = ceil(B / K) takes the lanes t, t + S, ..., t + (K-1) S
// below B, so a warp's loads of one limb row stay one coalesced segment.
// Forward, it forms the prefix products c_i = Z_0 ... Z_i of the canonical
// Z values, a zero Z (0 or the weak zero p) entering as 1 through a
// select; it makes ONE inverse u = 1 / c_{n-1} (modinv30, modinv.cuh);
// backward, 1 / Z_i = c_{i-1} u and u <- u Z_i, a zero Z leaving 0 by a
// select.  3 (K - 1) products buy K - 1 inverses.  The prefix c_i waits in
// rows 0-7 of lane i's x output column, written forward and read once
// backward (lane i's own x overwrites it after its slot is done), so the
// group's state in registers does not grow with K.  K and the grouping
// depend only on B and the lane index: nothing branches on or addresses
// by X, Y or Z; the tail lanes >= B are skipped by index.  Everything runs
// on the force-inlined by-reference core: no call, no stack.
#pragma once
#include "fe.cuh"
#include "modinv.cuh"

// sq for a canonical PUBLIC y: 1 where y is a nonzero square.  The Jacobi
// symbol by positive divsteps (jacobi30_var); a lane it leaves undecided
// after the cap takes the reference's fixed sqrt chain (fe_pow_sqrt_to),
// as secp256k1_fe_is_square_var falls back to fe_sqrt, and adds one to
// *undecided.  Variable time in y alone.
SECP_INLINE uint32_t affine_y_is_square(const fe& y, uint32_t* undecided) {
    if (fe_is_zero(y)) return 0;
    const modinfo30 mi = { SECP_MODINV_P_LIMBS, SECP_MODINV_P_INV30 };
    const int j = jacobi30_var(y, mi);
    if (j != 0) return (uint32_t)(j > 0);
#ifdef __CUDACC__
    atomicAdd(undecided, 1u);
#else
    ++*undecided;
#endif
    fe r, c;
    fe_pow_sqrt_to(r, y);
    fe_sqr_to(c, r);
    fe_sub_to(c, c, y);
    return fe_is_zero(c);
}

// canonical Z with its zero flag; a zero enters the products as 1
SECP_INLINE fe affine_z(const uint32_t* z_in, int B, int lane,
                        uint32_t& zero) {
    fe z = fe_canon(load16(z_in, B, lane));
    zero = fe_is_zero(z);
    return select256(zero, fe_one(), z);
}

// thread t's group of K lanes (S threads in all): canonical affine x, y
// into ax, ay ([16, B] limbs, ax also the prefixes' scratch) and, with
// META, y's character into sq [B]
template <bool META>
SECP_INLINE void affine_group(const uint32_t* x_in, const uint32_t* y_in,
                              const uint32_t* z_in, uint32_t* ax,
                              uint32_t* ay, uint32_t* sq,
                              uint32_t* undecided, int B, int K, int S,
                              int t) {
    const modinfo30 mi = { SECP_MODINV_P_LIMBS, SECP_MODINV_P_INV30 };
    const size_t ld = (size_t)B;
    uint32_t zero;
    fe acc, z;
    int n = 0;                          // the group's lanes below B
#pragma unroll 1
    for (int lane = t; n < K && lane < B; ++n, lane += S) {
        z = affine_z(z_in, B, lane, zero);
        if (n == 0) acc = z;
        else fe_mul_to(acc, acc, z);
        // the next slot reads this prefix; the group's last one is unread
        if (n + 1 < K && lane + S < B) col_store(ax + lane, ld, 0, acc);
    }
    fe u = modinv30(fe_canon(acc), mi);
    fe inv, X, Y, zi2;
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {
        const int lane = t + i * S;
        z = affine_z(z_in, B, lane, zero);
        if (i > 0) {
            col_load(ax + lane - S, ld, 0, inv);
            fe_mul_to(inv, inv, u);
            fe_mul_to(u, u, z);
        } else {
            inv = u;
        }
        inv = select256(zero, fe_zero(), inv);
        X = load16(x_in, B, lane);
        Y = load16(y_in, B, lane);
        fe_sqr_to(zi2, inv);
        fe_mul_to(X, X, zi2);
        fe_mul_to(zi2, zi2, inv);
        fe_mul_to(Y, Y, zi2);
        X = fe_canon(X);
        Y = fe_canon(Y);
        store16(ax, B, lane, X);
        store16(ay, B, lane, Y);
        if (META) sq[lane] = affine_y_is_square(Y, undecided);
    }
}
