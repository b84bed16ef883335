// fixedbase_digits: k*G from 37 signed-w7 comb digit rows.
//
// Replaces the TPU kernel _gen_kernel (ops/pallas_gen.py,
// fixedbase_digits_tpu / ecmult_gen_tpu): row i (MSB-first) is digit
// position v = 36 - i with its own table of d * 2^(7v) * G, d = 1..64, so
// k*G is 37 complete mixed adds and no doublings; y is negated on the
// digit's sign, a zero digit masks the add, and z = 0 marks an all-zero
// scalar (infinity).  Output canonical jacobian x, y, z.
//
// Blinded variant (the second entry point): the caller recodes k' = k + b
// mod n instead of k, and the kernel ends with one more complete mixed
// add of the affine point gb = -b*G (16 words: x then y, the same for
// every lane), so the result is k'*G - b*G = k*G, the scalar- and
// point-offset blinding of the reference's ecmult_gen.  gb is never
// infinity; an accumulator at infinity (k' = 0, i.e. k = n - b) is handled
// by the add's selects, so that lane gives gb itself.  The unblinded
// kernel is the same template without that add.
//
// k is secret when signing, so each entry is selected by a full scan of
// the 64-entry table: no address and no branch depends on a digit.  All
// lanes of a warp read the same table address, so the scan is broadcast
// loads (16 bytes each) from the 151 KB table in global memory, which
// stays in L2/L1; it is too large for __constant__.
// Bound on this card: operations — per row 64 x 16 selects plus a mixed
// add of 11 field multiplies; traffic is 37 + 48 words per lane (+ 16
// broadcast words of gb).
#include "group.cuh"

#define SECP_NW7 37
#define SECP_COMB 64

template <bool BLINDED>
SECP_DEV void fixedbase_lane(const uint32_t* gdigs, const uint32_t* table,
                             const uint32_t* gb, uint32_t* ox, uint32_t* oy,
                             uint32_t* oz, int B, int lane) {
    jp acc = jp_infinity();
#pragma unroll 1
    for (int i = 0; i < SECP_NW7; ++i) {
        uint32_t row = gdigs[(size_t)i * B + lane];
        uint32_t mag = row & 0xFFu, sgn = (row >> 8) & 1u;
        const uint4* wt = reinterpret_cast<const uint4*>(
            table + (size_t)(SECP_NW7 - 1 - i) * SECP_COMB * 16);
        uint4 sel[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) sel[k] = SECP_LDG(wt + k);
#pragma unroll 4
        for (int e = 1; e < SECP_COMB; ++e) {
            uint32_t mask = 0u - (uint32_t)(mag == (uint32_t)(e + 1));
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                uint4 w = SECP_LDG(wt + e * 4 + k);
                sel[k].x = (w.x & mask) | (sel[k].x & ~mask);
                sel[k].y = (w.y & mask) | (sel[k].y & ~mask);
                sel[k].z = (w.z & mask) | (sel[k].z & ~mask);
                sel[k].w = (w.w & mask) | (sel[k].w & ~mask);
            }
        }
        fe gx, gy;
        gx.v[0] = sel[0].x; gx.v[1] = sel[0].y; gx.v[2] = sel[0].z;
        gx.v[3] = sel[0].w; gx.v[4] = sel[1].x; gx.v[5] = sel[1].y;
        gx.v[6] = sel[1].z; gx.v[7] = sel[1].w;
        gy.v[0] = sel[2].x; gy.v[1] = sel[2].y; gy.v[2] = sel[2].z;
        gy.v[3] = sel[2].w; gy.v[4] = sel[3].x; gy.v[5] = sel[3].y;
        gy.v[6] = sel[3].z; gy.v[7] = sel[3].w;
        gy = select256(sgn, fe_neg(gy), gy);
        acc = jp_add_aff(acc, gx, gy, mag == 0 ? 1u : 0u);
    }
    if (BLINDED) {
        fe bx, by;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            bx.v[k] = SECP_LDG(gb + k);
            by.v[k] = SECP_LDG(gb + 8 + k);
        }
        acc = jp_add_aff(acc, bx, by, 0u);
    }
    store16(ox, B, lane, fe_canon(acc.x));
    store16(oy, B, lane, fe_canon(acc.y));
    store16(oz, B, lane, select256(acc.inf, fe_zero(), fe_canon(acc.z)));
}

#ifdef __CUDACC__
template <bool BLINDED>
__global__ void fixedbase_kernel(const uint32_t* gdigs, const uint32_t* table,
                                 const uint32_t* gb, uint32_t* ox,
                                 uint32_t* oy, uint32_t* oz, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B)
        fixedbase_lane<BLINDED>(gdigs, table, gb, ox, oy, oz, B, lane);
}

extern "C" int secp_fixedbase_digits(const uint32_t* gdigs,
                                     const uint32_t* table, uint32_t* ox,
                                     uint32_t* oy, uint32_t* oz, int B,
                                     void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    fixedbase_kernel<false><<<(B + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(gdigs, table, nullptr,
                                                      ox, oy, oz, B);
    return (int)cudaGetLastError();
}

extern "C" int secp_fixedbase_digits_blinded(const uint32_t* gdigs,
                                             const uint32_t* table,
                                             const uint32_t* gb,
                                             uint32_t* ox, uint32_t* oy,
                                             uint32_t* oz, int B,
                                             void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    fixedbase_kernel<true><<<(B + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(gdigs, table, gb, ox,
                                                     oy, oz, B);
    return (int)cudaGetLastError();
}
#endif
