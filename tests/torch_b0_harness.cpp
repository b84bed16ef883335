// Host harness of the B0 field and group core (secp256k1_zkp_tpu_torch/
// csrc/fe.cuh, group.cuh, with the halves of the pair doubling), built
// with a plain C++ compiler: it runs the
// portable branch of the carry-chain primitives in common.cuh.
// tests/test_torch_kernels.py::test_cuda_constants_header builds it and
// calls it through ctypes.  Field elements are 8 little-endian 32-bit
// words; points 25 words (x, y, z, inf).  Every call writes its result over
// a copy of its first operand, as the kernels do (r aliases a).
//
// Beside the core, the host-compilable pieces of four kernels: the comb's
// T-thread sum (csrc/comb.cuh's comb_partial, joined by the tree of
// fixedbase.cu's shuffles, written out here over an array in the same
// order), msm_table.cu's lane (csrc/msm.cuh's msm_table_lane), and the
// lane sums of msm_finish.cu and gej_add.cu's gej_sum: their threads'
// folds (jp_fold_cols of group.cuh, finish_fold of msm.cuh) and the
// finish's ladder of pair doublings, with group.cuh's shuffles,
// jp_warp_sum and jp_block_sum written out as loops over an array of
// threads in the same order.
#include <string.h>

#include <vector>

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

// jp_warp_sum over each aligned run of `width` of the threads v[0..n): at
// the level s, thread t adds what thread t + s holds, or its own value
// where t + s leaves the run (__shfl_down_sync with that width)
static void warp_tree(jp* v, int n, int width) {
    std::vector<jp> next(n);
    for (int s = width >> 1; s > 0; s >>= 1) {
        for (int t = 0; t < n; ++t)
            jp_add_to(next[t], v[t], v[t % width + s < width ? t + s : t]);
        for (int t = 0; t < n; ++t) v[t] = next[t];
    }
}

// jp_block_sum(acc, n) for a block of the threads v[0..T): v[0] gets it
static void block_tree(jp* v, int T, int n) {
    for (int t = n; t < T; ++t) v[t] = jp_infinity();
    warp_tree(v, T, pow2_ceil(n < 32 ? n : 32));
    if (n <= 32) return;
    const int warps = (n + 31) >> 5;
    jp w[32];
    for (int i = 0; i < 32; ++i) w[i] = i < warps ? v[32 * i] : jp_infinity();
    warp_tree(w, 32, pow2_ceil(warps));
    v[0] = w[0];
}

// the result as the kernels store it: canonical x, y, z and the flag
static void st_canon(uint32_t* p, const jp& a) {
    st(p, fe_canon(a.x));
    st(p + 8, fe_canon(a.y));
    st(p + 16, fe_canon(a.z));
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

// op: 0 double a, 1 a + (bx, by) with b's inf flag (mixed), 2 a + b;
// 3 and 4 double a as the pair of threads of jp_double_pair_to does, the
// result of thread 0 and of thread 1
void b0_jp(int op, const uint32_t* a, const uint32_t* b, uint32_t* r,
           int n) {
    for (int i = 0; i < n; ++i) {
        jp p = ldj(a + 25 * i), q = ldj(b + 25 * i);
        if (op == 0) jp_double_to(p, p);
        else if (op == 1) jp_add_aff_to(p, p, q.x, q.y, q.inf);
        else if (op == 2) jp_add_to(p, p, q);
        else {
            fe m[2][3];
            jp_double_half(m[0], p, 0);
            jp_double_half(m[1], p, 1);
            const int h = op - 3;
            jp_double_join(p, m[h], m[1 - h], h, p.inf);
        }
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

// msm_finish.cu's block on the partials px, py, pz [16, nwin * nblk] and
// pinf [nwin * nblk]: out the 25 words of the result
void b0_msm_finish(const uint32_t* px, const uint32_t* py,
                   const uint32_t* pz, const uint32_t* pinf, int nwin,
                   int nblk, uint32_t* out) {
    const int T = SECP_FIN_THREADS;
    std::vector<jp> v(T);
    for (int t = 0; t < T; ++t)
        finish_fold(v[t], px, py, pz, pinf, nwin, nblk, t);
    const int team = finish_team(nwin);
    warp_tree(v.data(), T, team);
    // the ladder of window w on the pair (2w, 2w + 1): thread 2w's view
    // of each jp_double_pair_to (both threads' halves, then its join)
    for (int w = 0; w < nwin; ++w) {
        jp a = v[w * team];
        for (int k = 0; k < 4 * w; ++k) {
            fe m[2][3];
            jp_double_half(m[0], a, 0);
            jp_double_half(m[1], a, 1);
            jp_double_join(a, m[0], m[1], 0, a.inf);
        }
        v[w * team] = a;
    }
    std::vector<jp> win(nwin);
    for (int w = 0; w < nwin; ++w) win[w] = v[w * team];
    for (int t = 0; t < nwin; ++t) v[t] = win[t];
    block_tree(v.data(), T, nwin);
    st_canon(out, v[0]);
}

// gej_add.cu's gej_sum on B lanes (x, y, z [16, B], inf [B]) in nb blocks
// of T threads: each block's sum through the scratch (limb-major, as the
// kernel stores it), then the last block's: out the 25 words
void b0_gej_sum(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                const uint32_t* inf, int B, int nb, int T, uint32_t* out) {
    std::vector<jp> v(T);
    std::vector<uint32_t> part(49 * nb);
    uint32_t *qx = part.data(), *qy = qx + 16 * nb, *qz = qx + 32 * nb,
             *qinf = qx + 48 * nb;
    for (int b = 0; b < nb; ++b) {
        const int first = b * T;
        for (int t = 0; t < T; ++t)
            jp_fold_cols(v[t], x, y, z, inf, B, first + t, B, nb * T);
        block_tree(v.data(), T, T < B - first ? T : B - first);
        if (nb == 1) {
            st_canon(out, v[0]);
            return;
        }
        jp_store_col(qx, qy, qz, qinf, nb, b, v[0]);
    }
    for (int t = 0; t < T; ++t)
        jp_fold_cols(v[t], qx, qy, qz, qinf, nb, t, nb, T);
    block_tree(v.data(), T, T < nb ? T : nb);
    st_canon(out, v[0]);
}

}
