// Shared pieces of the MSM engine kernels (msm_table, msm_winreduce,
// msm_finish).
//
// The per-point table is lane-major: tab[(lane * 15 + d - 1) * 16 + w]
// holds the 32-bit words of the TRUE-affine d*P, x in w = 0-7 and y in
// w = 8-15 (little-endian words), for d = 1..15.  One entry is 64
// contiguous bytes, so a lane reads the entry its digit names with four
// 16-byte loads.  (The TPU kernel keeps [15 * 32, B] base-2^16 limb rows
// because its gather is a select scan over all entries.)
#pragma once
#include "group.cuh"
#include "modinv.cuh"

#define SECP_MSM_NENT 15     // entries 1..15: unsigned 4-bit digits

SECP_INLINE void msm_entry_store(uint32_t* tab, size_t idx, const fe& x,
                                 const fe& y) {
    uint4* p = (uint4*)(tab + idx * 16);
    uint4 q;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t* s = k < 2 ? x.v + 4 * k : y.v + 4 * (k - 2);
        q.x = s[0]; q.y = s[1]; q.z = s[2]; q.w = s[3];
        p[k] = q;
    }
}

SECP_INLINE void msm_entry_load(const uint32_t* tab, size_t idx, fe& x,
                                fe& y) {
    const uint4* p = (const uint4*)(tab + idx * 16);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        uint4 q = p[k];
        uint32_t* d = k < 2 ? x.v + 4 * k : y.v + 4 * (k - 2);
        d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
    }
}

// --- msm_table's lane (csrc/msm_table.cu; also run by the host harness) --

// the word-major scratch: X, Y of entries 2..14, z-ratios of entries 3..14
#define SECP_MT_XY_ROW(d) (((d) - 2) * 16)
#define SECP_MT_RATIO_ROW(d) (13 * 16 + ((d) - 3) * 8)
#define SECP_MT_SCRATCH_ROWS (13 * 16 + 12 * 8)      // 304

// msm_table.cu's lane: the table of lane `lane` of B points (limb-major
// px, py [16, B], pinf [B]) into tab, with the word-major scratch of
// SECP_MT_SCRATCH_ROWS rows of row stride B
SECP_INLINE void msm_table_lane(const uint32_t* px_in, const uint32_t* py_in,
                                const uint32_t* pinf, uint32_t* tab, int B,
                                uint32_t* scratch, int lane) {
    const uint32_t GXW[8] = SECP_GX_WORDS, GYW[8] = SECP_GY_WORDS;
    const size_t ld = (size_t)B;
    uint32_t* sc = scratch + lane;
    uint32_t inf = pinf[lane] & 1u;
    fe px = select256(inf, fe_const(GXW), load16(px_in, B, lane));
    fe py = select256(inf, fe_const(GYW), load16(py_in, B, lane));

    // chain: 2P, then d*P = (d-1)*P + P with z-ratio m_d
    jp c;
    c.x = px; c.y = py; c.z = fe_one(); c.inf = 0;
    jp_double_to(c, c);
    col_store(sc, ld, SECP_MT_XY_ROW(2), c.x);
    col_store(sc, ld, SECP_MT_XY_ROW(2) + 8, c.y);
    fe m;
#pragma unroll 1
    for (int d = 3; d <= SECP_MSM_NENT; ++d) {
        fe nx, ny, nz;
        jp_add_aff_ratio(c.x, c.y, c.z, px, py, &nx, &ny, &nz, &m);
        c.x = nx; c.y = ny; c.z = nz;
        if (d < SECP_MSM_NENT) {
            col_store(sc, ld, SECP_MT_XY_ROW(d), c.x);
            col_store(sc, ld, SECP_MT_XY_ROW(d) + 8, c.y);
            col_store(sc, ld, SECP_MT_RATIO_ROW(d), m);
        }
    }

    // zi = 1 / z_15 (0 where z_15 is)
    const modinfo30 mi = { SECP_MODINV_P_LIMBS, SECP_MODINV_P_INV30 };
    fe zc = fe_canon(c.z);
    uint32_t zero = fe_is_zero(zc);
    fe zi = modinv30(zc, mi);

    // entry d = (X_d b^2, Y_d b^3) with b = 1 / z_d: zi for d = 15, then
    // b_d = b_{d+1} * ratio_{d+1}; entry 1 is P itself (P * (zi z_15)^k in
    // the plain version: 0 where z_15 is)
    const size_t base = (size_t)lane * SECP_MSM_NENT;
    fe b = zi, b2, ex, ey, t;
#pragma unroll 1
    for (int d = SECP_MSM_NENT; d >= 2; --d) {
        if (d < SECP_MSM_NENT) {
            if (d < SECP_MSM_NENT - 1)
                col_load(sc, ld, SECP_MT_RATIO_ROW(d + 1), t);
            else
                t = m;
            fe_mul_to(b, b, t);
            col_load(sc, ld, SECP_MT_XY_ROW(d), ex);
            col_load(sc, ld, SECP_MT_XY_ROW(d) + 8, ey);
        } else {
            ex = c.x;
            ey = c.y;
        }
        fe_sqr_to(b2, b);
        fe_mul_to(ex, ex, b2);
        fe_mul_to(b2, b2, b);
        fe_mul_to(ey, ey, b2);
        msm_entry_store(tab, base + d - 1, fe_canon(ex), fe_canon(ey));
    }
    msm_entry_store(tab, base, select256(zero, fe_zero(), fe_canon(px)),
                    select256(zero, fe_zero(), fe_canon(py)));
}

// --- msm_finish's threads (csrc/msm_finish.cu; also run by the host
// harness) ----------------------------------------------------------------

#define SECP_FIN_THREADS 256         // two threads a window in stage 2

// threads a window in stage 1: the most (a power of two, at most a warp)
// with team * nwin <= SECP_FIN_THREADS
SECP_INLINE int finish_team(int nwin) {
    int team = 1;
    while (team < 32 && 2 * team * nwin <= SECP_FIN_THREADS) team <<= 1;
    return team;
}

// stage 1 for thread t: its share of window t / team's partials
SECP_INLINE void finish_fold(jp& acc, const uint32_t* px, const uint32_t* py,
                             const uint32_t* pz, const uint32_t* pinf,
                             int nwin, int nblk, int t) {
    const int team = finish_team(nwin);
    const int w = t / team;
    if (w >= nwin) {
        acc = jp_infinity();
        return;
    }
    jp_fold_cols(acc, px, py, pz, pinf, nwin * nblk, w * nblk + t % team,
                 (w + 1) * nblk, team);
}
