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
//
// And the SHA-256 kernels of csrc/sha256.cu on csrc/sha256.cuh: sha256_msg
// (the staging of a block's rows through shared memory by its threads, the
// in-kernel padding, chunk by chunk), rfc6979's lane, and batch_digest (a
// block's leaves and its subtree, the blocks' roots through the scratch
// and the last block's levels); and lift_x.cu's lane on the inlined sqrt
// chain (fe_pow_sqrt_to of fe.cuh), compiled from the kernel's own file.
//
// And affine_xy.cu's and affine_meta.cu's thread groups (affine.cuh: K
// lanes a thread, one inverse for the group, the prefixes in the x
// output's rows), compiled from the kernels' own files and run for every
// thread of a launch, and modinv.cuh's Jacobi symbol alone.
//
// And ecdsa_finish.cu's and ecdsa_prep.cu's thread groups (batch_inv.cuh:
// K lanes a thread, one inverse over p and one over n for ecdsa_finish,
// one over n for ecdsa_prep, the prefixes in the outputs' rows), compiled
// from the kernels' own files and run for every thread of a launch.
#include <string.h>

#include <vector>

#include "affine_meta.cu"
#include "affine_xy.cu"
#include "comb.cuh"
#include "ecdsa_finish.cu"
#include "ecdsa_prep.cu"
#include "lift_x.cu"
#include "msm.cuh"
#include "sha256.cuh"

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

// sha256.cu's sha256_msg on B rows of L bytes (msg), blocks of T threads:
// start state st0 or lane_st [B, 8] (null: st0); out [B, 8] digest words.
// The shared rows start as junk: the padding must not read past L.
void b0_sha_msg(const uint8_t* msg, int L, int B, const uint32_t* st0,
                const uint32_t* lane_st, uint32_t len_hi, uint32_t len_lo,
                int T, int words, uint32_t* out) {
    const int S = sha_row_words(L);
    std::vector<uint32_t> sm(T * S, 0xA5C3E1F7u);
    const int nblk = sha_blocks_of(L);
    const int nchunk = (64 * nblk + SECP_SHA_CHUNK - 1) / SECP_SHA_CHUNK;
    for (int first = 0; first < B; first += T) {
        const int rows = T < B - first ? T : B - first;
        std::vector<uint32_t> st(8 * rows);
        for (int t = 0; t < rows; ++t)
            for (int i = 0; i < 8; ++i)
                st[8 * t + i] = lane_st ? lane_st[8 * (first + t) + i]
                                        : st0[i];
        for (int k = 0; k < nchunk; ++k) {
            const int c0 = k * SECP_SHA_CHUNK;
            const int clen = SECP_SHA_CHUNK < L - c0 ? SECP_SHA_CHUNK
                                                     : L - c0;
            for (int t = 0; t < T; ++t)
                sha_stage(sm.data(), S, msg + (size_t)first * L, L, c0, clen,
                          rows, words != 0, t, T);
            for (int t = 0; t < rows; ++t) {
                uint32_t s8[8];
                memcpy(s8, &st[8 * t], sizeof(s8));
                sha_msg_chunk(s8, sm.data() + t * S, L, k, nblk, len_hi,
                              len_lo);
                memcpy(&st[8 * t], s8, sizeof(s8));
            }
        }
        memcpy(out + 8 * first, st.data(), sizeof(uint32_t) * 8 * rows);
    }
}

// sha256.cu's rfc6979 on B lanes of kd [B, 64] bytes, blocks of T
// threads; k0 [16] the zero key's pad states; out [rounds, B, 8] words
void b0_rfc6979(const uint8_t* kd, int B, const uint32_t* k0, int rounds,
                int T, uint32_t* out) {
    sha_st i0, o0;
    for (int i = 0; i < 8; ++i) {
        i0.h[i] = k0[i];
        o0.h[i] = k0[8 + i];
    }
    std::vector<uint32_t> sm(T * 17);
    for (int first = 0; first < B; first += T) {
        const int rows = T < B - first ? T : B - first;
        for (int t = 0; t < T; ++t)
            sha_stage(sm.data(), 17, kd + (size_t)first * 64, 64, 0, 64,
                      rows, true, t, T);
        for (int t = 0; t < rows; ++t) {
            uint32_t w[16];
            for (int i = 0; i < 16; ++i) w[i] = bswap32(sm[17 * t + i]);
            const int lane = first + t;
            rfc6979_lane(w, i0, o0, rounds,
                         [&](int r, const uint32_t (&v)[8]) {
                memcpy(out + ((size_t)r * B + lane) * 8, v, sizeof(v));
            });
        }
    }
}

// sha256.cu's batch_digest on n leaves (px, msg [n, 32], sig [n, 64]) in
// blocks of T threads (a power of two; the kernel's is 256): mids [16] the
// leaf and node midstates; out [8] the root's words
void b0_batch_digest(const uint8_t* px, const uint8_t* msg,
                     const uint8_t* sig, int n, int T, const uint32_t* mids,
                     uint32_t* out) {
    sha_st leaf, node;
    for (int i = 0; i < 8; ++i) {
        leaf.h[i] = mids[i];
        node.h[i] = mids[8 + i];
    }
    int levels = 0;
    while ((1 << levels) < T) ++levels;
    const int row = 33, nb = (n + T - 1) / T;
    std::vector<uint32_t> part(8 * nb + 8 * ((nb + 1) / 2));
    std::vector<uint32_t> sm(T * row), h(8 * T);
    for (int blk = 0; blk < nb; ++blk) {
        const int first = blk * T, rows = T < n - first ? T : n - first;
        for (int t = 0; t < T; ++t) {
            sha_stage(sm.data(), row, px + (size_t)first * 32, 32, 0, 32,
                      rows, true, t, T);
            sha_stage(sm.data() + 8, row, msg + (size_t)first * 32, 32, 0,
                      32, rows, true, t, T);
            sha_stage(sm.data() + 16, row, sig + (size_t)first * 64, 64, 0,
                      64, rows, true, t, T);
        }
        for (int t = 0; t < rows; ++t) {
            uint32_t d[8];
            bd_leaf(d, sm.data() + row * t, leaf);
            memcpy(&h[8 * t], d, sizeof(d));
        }
        for (int t = 0; t < rows; ++t)
            memcpy(&sm[9 * t], &h[8 * t], 8 * sizeof(uint32_t));
        int cnt = rows;
        for (int lvl = 0; nb == 1 ? cnt > 1 : lvl < levels; ++lvl) {
            const int half = (cnt + 1) >> 1;
            for (int t = 0; t < half; ++t) {     // every read, then writes
                uint32_t d[8];
                bd_pair(d, sm.data(), 9, cnt, t, node);
                memcpy(&h[8 * t], d, sizeof(d));
            }
            for (int t = 0; t < half; ++t)
                memcpy(&sm[9 * t], &h[8 * t], 8 * sizeof(uint32_t));
            cnt = half;
        }
        if (nb == 1) {
            memcpy(out, sm.data(), 8 * sizeof(uint32_t));
            return;
        }
        memcpy(&part[8 * blk], sm.data(), 8 * sizeof(uint32_t));
    }
    // the last block: the roots a level at a time between two buffers,
    // thread t taking the nodes t, t + T, ...
    uint32_t *src = part.data(), *dst = part.data() + 8 * nb;
    int cnt = nb;
    while (cnt > 1) {
        const int half = (cnt + 1) >> 1;
        for (int t = 0; t < T; ++t)
            for (int i = t; i < half; i += T) {
                uint32_t d[8];
                bd_pair<true>(d, src, 8, cnt, i, node);
                memcpy(dst + 8 * i, d, sizeof(d));
            }
        uint32_t* tmp = src;
        src = dst;
        dst = tmp;
        cnt = half;
    }
    memcpy(out, src, 8 * sizeof(uint32_t));
}

// lift_x.cu's lane on x [16, n] limb-major: y [16, n], ok [n]; and its
// parity select alone on canonical y [n] (8 words each): r [n]
void b0_lift_x(const uint32_t* x, uint32_t* y, uint32_t* ok, int n) {
    for (int lane = 0; lane < n; ++lane) lift_x_lane(x, y, ok, n, lane);
}

void b0_even_root(const uint32_t* y, uint32_t* r, int n) {
    for (int i = 0; i < n; ++i) st(r + 8 * i, lift_x_even(ld(y + 8 * i)));
}

// a launch of affine_xy.cu (meta = 0) or affine_meta.cu (meta = 1) with K
// lanes a thread on x, y, z [16, B] limb-major: ax, ay [16, B], sq [B];
// returns the lanes the Jacobi left undecided
uint32_t b0_affine(int meta, const uint32_t* x, const uint32_t* y,
                   const uint32_t* z, uint32_t* ax, uint32_t* ay,
                   uint32_t* sq, int B, int K) {
    uint32_t undecided = 0;
    for (int t = 0; t < (B + K - 1) / K; ++t) {
        if (meta)
            affine_meta_group(x, y, z, ax, ay, sq, &undecided, B, K, t);
        else
            affine_xy_group(x, y, z, ax, ay, B, K, t);
    }
    return undecided;
}

// a launch of ecdsa_finish.cu with K lanes a thread on x, y, z, k, m, d
// [16, B] limb-major: r, s [16, B], meta [2, B]
void b0_ecdsa_finish(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                     const uint32_t* k, const uint32_t* m, const uint32_t* d,
                     uint32_t* r, uint32_t* s, uint32_t* meta, int B, int K) {
    for (int t = 0; t < (B + K - 1) / K; ++t)
        ecdsa_finish_group(x, y, z, k, m, d, r, s, meta, B, K, t);
}

// a launch of ecdsa_prep.cu with K lanes a thread on m, r, s [16, B]
// limb-major: digs [52, B], gdigs [37, B], flags [2, B]
void b0_ecdsa_prep(const uint32_t* m, const uint32_t* r, const uint32_t* s,
                   uint32_t* digs, uint32_t* gdigs, uint32_t* flags, int B,
                   int K) {
    for (int t = 0; t < (B + K - 1) / K; ++t)
        ecdsa_prep_group(m, r, s, digs, gdigs, flags, B, K, t);
}

// jacobi30_var of canonical x [n] (8 words each): 1, -1 or 0 (undecided)
void b0_jacobi(const uint32_t* x, int32_t* r, int n) {
    const modinfo30 mi = { SECP_MODINV_P_LIMBS, SECP_MODINV_P_INV30 };
    for (int i = 0; i < n; ++i) r[i] = jacobi30_var(ld(x + 8 * i), mi);
}

}
