// The fixed-base comb's per-thread sum (csrc/fixedbase.cu), in a header of
// its own so that the host harness (tests/torch_b0_harness.cpp) runs the
// same code as the kernel.
//
// k*G is the sum over the 37 signed-w7 digit rows of the entry |d| of that
// row's table, negated for a negative digit.  A team of T threads (a power
// of two up to 8) serves one lane: thread t sums the rows t, t + T,
// t + 2T, ... from infinity (comb_partial); the kernel joins the T partial
// sums by a shuffle tree of complete jacobian adds.  With T = 1 the one
// thread adds the rows in order, exactly as the plain version does.
//
// The table is [37][64][16 words]: entry d - 1 of position v holds x
// (words 0-7) and y (8-15) of (d * 2^(7v)) * G.  Row i (MSB-first) is
// position 36 - i.
#pragma once
#include "group.cuh"

#define SECP_NW7 37
#define SECP_COMB 64
#define SECP_COMB_WORDS (SECP_NW7 * SECP_COMB * 16)   // 151,552 bytes

// how an entry is found: a full scan of the row, or (public digits only)
// the four 16-byte loads of the named entry
enum { COMB_SCAN = 0, COMB_GATHER = 1 };

SECP_INLINE void comb_unpack(const uint4* q, fe& gx, fe& gy) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        uint32_t* d = k < 2 ? gx.v + 4 * k : gy.v + 4 * (k - 2);
        d[0] = q[k].x; d[1] = q[k].y; d[2] = q[k].z; d[3] = q[k].w;
    }
}

// entry mag (1..64) of one row by a full scan: all 64 entries are read and
// a mask keeps the named one (one LOP3 a word, sel_mask); mag == 0 leaves
// entry 1, whose add the caller masks.  No address and no branch depends
// on mag.
SECP_INLINE void comb_scan(const uint32_t* row, uint32_t mag, fe& gx,
                           fe& gy) {
    const uint4* wt = reinterpret_cast<const uint4*>(row);
    uint4 sel[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) sel[k] = SECP_LDG(wt + k);
#pragma unroll 4
    for (int e = 1; e < SECP_COMB; ++e) {
        uint32_t mask = 0u - (uint32_t)(mag == (uint32_t)(e + 1));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            uint4 w = SECP_LDG(wt + e * 4 + k);
            sel[k].x = sel_mask(w.x, sel[k].x, mask);
            sel[k].y = sel_mask(w.y, sel[k].y, mask);
            sel[k].z = sel_mask(w.z, sel[k].z, mask);
            sel[k].w = sel_mask(w.w, sel[k].w, mask);
        }
    }
    comb_unpack(sel, gx, gy);
}

// entry mag (1..64) of one row for a public digit: its 64 bytes only
SECP_INLINE void comb_gather(const uint32_t* row, uint32_t mag, fe& gx,
                             fe& gy) {
    const uint4* wt = reinterpret_cast<const uint4*>(row) +
                      (mag ? mag - 1 : 0) * 4;
    uint4 q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = SECP_LDG(wt + k);
    comb_unpack(q, gx, gy);
}

// thread t of a team of T: acc = the sum of rows t, t + T, ... of lane
// `lane` (digit rows [37, B], mag | sign << 8), from infinity
template <int MODE>
SECP_INLINE void comb_partial(jp& acc, const uint32_t* gdigs,
                              const uint32_t* table, int B, int lane, int t,
                              int T) {
    acc = jp_infinity();
#pragma unroll 1
    for (int i = t; i < SECP_NW7; i += T) {
        uint32_t d = gdigs[(size_t)i * B + lane];
        uint32_t mag = d & 0xFFu, sgn = (d >> 8) & 1u;
        const uint32_t* row =
            table + (size_t)(SECP_NW7 - 1 - i) * SECP_COMB * 16;
        fe gx, gy, ny;
        if (MODE == COMB_GATHER)
            comb_gather(row, mag, gx, gy);
        else
            comb_scan(row, mag, gx, gy);
        fe_neg_to(ny, gy);
        gy = select256(sgn, ny, gy);
        jp_add_aff_to(acc, acc, gx, gy, mag == 0 ? 1u : 0u);
    }
}
