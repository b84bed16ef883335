// A batched inverse over p or over n (Montgomery's trick), for kernels
// that take K lanes a thread: the walk of affine.cuh, generic in the
// modulus, in steps that a kernel strings together so that it can run
// more than one chain in the same pass (ecdsa_finish.cu: Z mod p and k
// mod n; ecdsa_prep.cu: s mod n).
//
// Thread t of S = ceil(B / K) takes the lanes t, t + S, ..., t + (K-1) S
// below B, so a warp's loads of one limb row stay one coalesced segment.
// Forward (batch_forward), slot i forms the prefix product c_i = v_0 ...
// v_i of the canonical values, a zero value entering as 1 through a
// select (batch_enter); then ONE inverse u = 1 / c_{n-1} (batch_invert:
// modinv30, modinv.cuh); backward (batch_backward), 1 / v_i = c_{i-1} u
// and u <- u v_i, a zero value leaving 0 by a select.  3 (K - 1) products
// buy K - 1 inverses.  The prefix c_i waits in rows 0-7 (one 32-bit word
// a row) of lane i's column of an output of the kernel's own, written
// forward and read once backward, before lane i's own result overwrites
// it: the group's state in registers does not grow with K.  The group's
// last prefix is never read and never written (batch_keep).
//
// K and the grouping depend only on B and the lane index: nothing
// branches on or addresses by a value; the inverse is fixed-iteration, so
// the walk may carry secrets.  Everything is force-inlined and by
// reference: no call, no stack.
#pragma once
#include "fe.cuh"
#include "modinv.cuh"
#include "sc.cuh"

#define SECP_BATCH_THREADS 128      // threads a block of these kernels

// the two moduli: canonical form, product (weak) and safegcd constants
struct batch_mod_p {
    static SECP_INLINE u256 canon(const u256& a) { return fe_canon(a); }
    static SECP_INLINE void mul(u256& r, const u256& a, const u256& b) {
        fe_mul_to(r, a, b);
    }
    static SECP_INLINE modinfo30 info() {
        const modinfo30 mi = { SECP_MODINV_P_LIMBS, SECP_MODINV_P_INV30 };
        return mi;
    }
};

struct batch_mod_n {
    static SECP_INLINE u256 canon(const u256& a) { return sc_canon(a); }
    static SECP_INLINE void mul(u256& r, const u256& a, const u256& b) {
        sc_mul_to(r, a, b);
    }
    static SECP_INLINE modinfo30 info() {
        const modinfo30 mi = { SECP_MODINV_N_LIMBS, SECP_MODINV_N_INV30 };
        return mi;
    }
};

// whether slot n (lane) leaves its prefix for the slot after it
SECP_INLINE bool batch_keep(int n, int lane, int K, int S, int B) {
    return n + 1 < K && lane + S < B;
}

// v (< 2^256) canonical, with its zero flag; a zero enters as 1
template <class M>
SECP_INLINE u256 batch_enter(const u256& v, uint32_t& zero) {
    const u256 c = M::canon(v);
    uint32_t any = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) any |= c.v[i];
    zero = (uint32_t)(any == 0);
    return select256(zero, fe_one(), c);
}

// slot n: acc = v_0 ... v_n, kept in rows 0-7 of col (row stride ld)
// where `keep`
template <class M>
SECP_INLINE void batch_forward(u256& acc, const u256& v, int n, bool keep,
                               uint32_t* col, size_t ld) {
    if (n == 0) acc = v;
    else M::mul(acc, acc, v);
    if (keep) col_store(col, ld, 0, acc);
}

// u = 1 / acc, canonical
template <class M>
SECP_INLINE u256 batch_invert(const u256& acc) {
    return modinv30(M::canon(acc), M::info());
}

// slot i: inv = 1 / v_i (weak; 0 where v_i entered as a zero) from the
// prefix c_{i-1} in prev_col (rows 0-7, read where i > 0) and u = 1 /
// c_i; then u <- u v_i = 1 / c_{i-1}
template <class M>
SECP_INLINE void batch_backward(u256& inv, u256& u, const u256& v,
                                uint32_t zero, int i, const uint32_t* prev_col,
                                size_t ld) {
    if (i > 0) {
        col_load(prev_col, ld, 0, inv);
        M::mul(inv, inv, u);
        M::mul(u, u, v);
    } else {
        inv = u;
    }
    inv = select256(zero, fe_zero(), inv);
}
