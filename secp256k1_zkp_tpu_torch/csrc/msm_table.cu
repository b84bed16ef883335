// msm_table: per point, the TRUE-affine table d*P for d = 1..15.
//
// Replaces the TPU kernel _table_kernel (ops/pallas_msm.py, msm_windowed_tpu).
// Per lane: 2P by a doubling, 3P..15P by mixed adds that also return the
// z-ratio (z_d = z_{d-1} * ratio_d); one safegcd inverse of the last Z;
// a backward pass that carries the product of the ratios brings every
// entry to affine with that one inverse (ge_table_set_globalz in the
// reference).  Infinity lanes are seeded with G, as the JAX body does:
// their table is valid and never read, the window sums mask them.  The
// entries are canonical, so this kernel and its plain version agree word
// for word.  Layout: msm.cuh.
//
// The chain's jacobian entries are written to the output table and read
// back by the same thread in the backward pass, so nothing but the 13
// z-ratios (per-thread local memory) is kept beside them.
//
// Bound on this card: operations — 1 doubling, 13 mixed adds, one inverse
// and ~60 multiplies of the global-Z pass a lane (~1,900 field-multiply
// equivalents is far more than the 33 words in and 240 words out).
#include "msm.cuh"
#include "modinv.cuh"

SECP_DEV void msm_table_lane(const uint32_t* px_in, const uint32_t* py_in,
                             const uint32_t* pinf, uint32_t* tab, int B,
                             int lane) {
    const uint32_t GXW[8] = SECP_GX_WORDS, GYW[8] = SECP_GY_WORDS;
    uint32_t inf = pinf[lane] & 1u;
    fe px = select256(inf, fe_const(GXW), load16(px_in, B, lane));
    fe py = select256(inf, fe_const(GYW), load16(py_in, B, lane));
    const size_t base = (size_t)lane * SECP_MSM_NENT;

    fe ratio[SECP_MSM_NENT + 1];            // z_d = z_{d-1} * ratio[d]
    jp p1;
    p1.x = px; p1.y = py; p1.z = fe_one(); p1.inf = 0;
    jp d2 = jp_double(p1);
    msm_entry_store(tab, base + 1, d2.x, d2.y);
    fe cx = d2.x, cy = d2.y, pz = d2.z;
    ratio[2] = pz;
#pragma unroll 1
    for (int d = 3; d <= SECP_MSM_NENT; ++d) {
        fe nx, ny, nz, m;
        jp_add_aff_ratio(cx, cy, pz, px, py, &nx, &ny, &nz, &m);
        cx = nx; cy = ny; pz = nz;
        ratio[d] = m;
        if (d < SECP_MSM_NENT) msm_entry_store(tab, base + d - 1, cx, cy);
    }

    // global Z: one inverse, then entry d = (X_d * a^2, Y_d * a^3) / Z^(2,3)
    // with a = z_15 / z_d, the product of the ratios above d
    fe zi = modinv_p(fe_canon(pz));
    fe zi2 = fe_sqr(zi);
    fe zi3 = fe_mul(zi2, zi);
    msm_entry_store(tab, base + SECP_MSM_NENT - 1,
                    fe_canon(fe_mul(cx, zi2)), fe_canon(fe_mul(cy, zi3)));
    fe acc = ratio[SECP_MSM_NENT];
#pragma unroll 1
    for (int d = SECP_MSM_NENT - 1; d >= 1; --d) {
        if (d < SECP_MSM_NENT - 1) acc = fe_mul(acc, ratio[d + 1]);
        fe a2 = fe_sqr(acc);
        fe ex = px, ey = py;
        if (d > 1) msm_entry_load(tab, base + d - 1, ex, ey);
        ex = fe_mul(fe_mul(ex, a2), zi2);
        ey = fe_mul(fe_mul(ey, fe_mul(a2, acc)), zi3);
        msm_entry_store(tab, base + d - 1, fe_canon(ex), fe_canon(ey));
    }
}

#ifdef __CUDACC__
__global__ void msm_table_kernel(const uint32_t* px, const uint32_t* py,
                                 const uint32_t* pinf, uint32_t* tab,
                                 int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) msm_table_lane(px, py, pinf, tab, B, lane);
}

extern "C" int secp_msm_table(const uint32_t* px, const uint32_t* py,
                              const uint32_t* pinf, uint32_t* tab, int B,
                              void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    msm_table_kernel<<<(B + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(px, py, pinf, tab, B);
    return (int)cudaGetLastError();
}
#endif
