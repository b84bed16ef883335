// Shared pieces of the MSM engine kernels (msm_table, msm_winreduce).
//
// The per-point table is lane-major: tab[(lane * 15 + d - 1) * 16 + w]
// holds the 32-bit words of the TRUE-affine d*P, x in w = 0-7 and y in
// w = 8-15 (little-endian words), for d = 1..15.  One entry is 64
// contiguous bytes, so a lane reads the entry its digit names with four
// 16-byte loads.  (The TPU kernel keeps [15 * 32, B] base-2^16 limb rows
// because its gather is a select scan over all entries.)
#pragma once
#include "group.cuh"

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
