// Host harness of the B0 field and group core (secp256k1_zkp_tpu_torch/
// csrc/fe.cuh, group.cuh), built with a plain C++ compiler: it runs the
// portable branch of the carry-chain primitives in common.cuh.
// tests/test_torch_kernels.py::test_cuda_constants_header builds it and
// calls it through ctypes.  Field elements are 8 little-endian 32-bit
// words; points 25 words (x, y, z, inf).  Every call writes its result over
// a copy of its first operand, as the kernels do (r aliases a).
//
// Beside the core, the host-compilable pieces of two kernels: the comb's
// T-thread sum (csrc/comb.cuh's comb_partial, joined by the tree of
// fixedbase.cu's shuffles, written out here over an array in the same
// order) and msm_table.cu's lane (csrc/msm.cuh's msm_table_lane).
#include <string.h>

#include "comb.cuh"
#include "msm.cuh"

static fe ld(const uint32_t* p) {
    fe r;
    memcpy(r.v, p, sizeof(r.v));
    return r;
}

static void st(uint32_t* p, const fe& a) { memcpy(p, a.v, sizeof(a.v)); }

static jp ldj(const uint32_t* p) {
    jp r;
    r.x = ld(p);
    r.y = ld(p + 8);
    r.z = ld(p + 16);
    r.inf = p[24];
    return r;
}

static void stj(uint32_t* p, const jp& a) {
    st(p, a.x);
    st(p + 8, a.y);
    st(p + 16, a.z);
    p[24] = a.inf;
}

extern "C" {

// op: 0 mul, 1 sqr, 2 add, 3 sub, 4 neg, 5 half, 6 mul_int(k), 7 canon;
// r[i] = op(a[i], b[i]) for i < n; z[i] = fe_is_zero(a[i])
void b0_fe(int op, const uint32_t* a, const uint32_t* b, uint32_t k,
           uint32_t* r, uint32_t* z, int n) {
    for (int i = 0; i < n; ++i) {
        fe x = ld(a + 8 * i), y = ld(b + 8 * i);
        switch (op) {
        case 0: fe_mul_to(x, x, y); break;
        case 1: fe_sqr_to(x, x); break;
        case 2: fe_add_to(x, x, y); break;
        case 3: fe_sub_to(x, x, y); break;
        case 4: fe_neg_to(x, x); break;
        case 5: fe_half_to(x, x); break;
        case 6: fe_mul_int_to(x, x, k); break;
        default: x = fe_canon(x); break;
        }
        st(r + 8 * i, x);
        z[i] = fe_is_zero(ld(a + 8 * i));
    }
}

// op: 0 double a, 1 a + (bx, by) with b's inf flag (mixed), 2 a + b
void b0_jp(int op, const uint32_t* a, const uint32_t* b, uint32_t* r,
           int n) {
    for (int i = 0; i < n; ++i) {
        jp p = ldj(a + 25 * i), q = ldj(b + 25 * i);
        if (op == 0) jp_double_to(p, p);
        else if (op == 1) jp_add_aff_to(p, p, q.x, q.y, q.inf);
        else jp_add_to(p, p, q);
        stj(r + 25 * i, p);
    }
}

// the comb of csrc/fixedbase.cu on n lanes, T threads a lane (mode:
// COMB_SCAN or COMB_GATHER of comb.cuh): gdigs [37, n] rows, table
// [37][64][16] words; out[25 * lane] the canonical x, y, z (z = 0 at
// infinity) and the infinity flag, as the kernel stores them
void b0_comb(const uint32_t* gdigs, const uint32_t* table, int n, int T,
             int mode, uint32_t* out) {
    for (int lane = 0; lane < n; ++lane) {
        jp part[8], next[8];
        for (int t = 0; t < T; ++t) {
            if (mode == COMB_GATHER)
                comb_partial<COMB_GATHER>(part[t], gdigs, table, n, lane, t,
                                          T);
            else
                comb_partial<COMB_SCAN>(part[t], gdigs, table, n, lane, t, T);
        }
        // the kernel's shuffle tree: at each level thread t adds what
        // thread t + s holds (its own value where t + s falls outside the
        // team, as __shfl_down_sync with width T gives)
        for (int s = T >> 1; s > 0; s >>= 1) {
            for (int t = 0; t < T; ++t)
                jp_add_to(next[t], part[t], part[t + s < T ? t + s : t]);
            for (int t = 0; t < T; ++t) part[t] = next[t];
        }
        jp r = part[0];
        r.x = fe_canon(r.x);
        r.y = fe_canon(r.y);
        r.z = select256(r.inf, fe_zero(), fe_canon(r.z));
        stj(out + 25 * lane, r);
    }
}

// msm_table.cu's lane for each of n points (px, py [16, n] limb-major,
// pinf [n]): tab [n][15][16] words, with the kernel's word-major scratch
void b0_msm_table(const uint32_t* px, const uint32_t* py,
                  const uint32_t* pinf, int n, uint32_t* tab,
                  uint32_t* scratch) {
    for (int lane = 0; lane < n; ++lane)
        msm_table_lane(px, py, pinf, tab, n, scratch, lane);
}

}
