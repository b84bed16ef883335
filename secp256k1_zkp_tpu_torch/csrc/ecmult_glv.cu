// ecmult_glv: R = u1*G + u2*P by GLV Strauss, with the fused ECDSA check
// x(R) === r (mod n).
//
// Replaces the TPU kernel _ecmult_glv_kernel (ops/pallas_group.py,
// ecmult_glv_tpu).  Per lane: fold the a1 sign into P (G stands in for an
// infinite P, whose adds are masked); build 1..16 * P in jacobian form with
// z-ratios; one safegcd inverse of the last Z brings the whole table to
// TRUE affine, so every window add is a mixed add; 26 windows of 5
// doublings and 2 masked mixed adds (|a1| against the table, |a2| against
// the same table with x scaled by beta, y re-flipped where the two signs
// differ); one complete add with the jacobian u1*G of the comb kernel
// (z == 0 -> infinity); then X == r*Z^2 or, where r < p - n, X == (r+n)*Z^2,
// and R not infinity.  Outputs canonical x, y, z, inf, ok.
//
// Bound on this card: operations — about 1,850 field multiplies per lane
// (64 multiply-adds each) against ~1 KB of traffic per lane.
//
// The per-lane table (16 entries x (x, y) x 32 bytes = 1 KiB) is far beyond
// registers.  It lives in dynamic shared memory, laid out
// [entry][word][thread] so the 32 threads of a warp touch 32 consecutive
// banks at every access.  The beta-scaled x table of the TPU kernel is
// dropped: one multiply by the constant beta per window costs 26 field
// multiplies per lane and saves 512 bytes of shared memory per lane.
// With 64 threads a block takes 64 KiB, so three blocks (6 warps) fit an
// SM's 227 KiB.  The 15 z-ratios are needed only between the table build
// and the global-Z pass and sit in per-thread local memory.
// Table entries are chosen by a full scan with selects, one code shape
// with the comb kernel; no branch or address depends on a digit.
#include "group.cuh"
#include "modinv.cuh"

#define SECP_NW5 26
#define SECP_TAB 16          // entries 1..16

// table accessors: tab points at this thread's column, ts is the stride
SECP_INLINE void tab_store(uint32_t* tab, int ts, int entry, const fe& x,
                           const fe& y) {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        tab[(size_t)(entry * 16 + w) * ts] = x.v[w];
        tab[(size_t)(entry * 16 + 8 + w) * ts] = y.v[w];
    }
}

SECP_INLINE void tab_load(const uint32_t* tab, int ts, int entry, fe& x,
                          fe& y) {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        x.v[w] = tab[(size_t)(entry * 16 + w) * ts];
        y.v[w] = tab[(size_t)(entry * 16 + 8 + w) * ts];
    }
}

// entry mag (1..16) by a full scan; mag == 0 is masked by the caller
SECP_INLINE void tab_gather(const uint32_t* tab, int ts, uint32_t mag, fe& x,
                            fe& y) {
    tab_load(tab, ts, 0, x, y);
#pragma unroll 1
    for (int e = 1; e < SECP_TAB; ++e) {
        uint32_t mask = 0u - (uint32_t)(mag == (uint32_t)(e + 1));
#pragma unroll
        for (int w = 0; w < 8; ++w) {
            uint32_t xv = tab[(size_t)(e * 16 + w) * ts];
            uint32_t yv = tab[(size_t)(e * 16 + 8 + w) * ts];
            x.v[w] = (xv & mask) | (x.v[w] & ~mask);
            y.v[w] = (yv & mask) | (y.v[w] & ~mask);
        }
    }
}

SECP_DEV void ecmult_glv_lane(const uint32_t* digs, const uint32_t* px_in,
                              const uint32_t* py_in, const uint32_t* misc,
                              const uint32_t* rx, const uint32_t* gx_in,
                              const uint32_t* gy_in, const uint32_t* gz_in,
                              uint32_t* ox, uint32_t* oy, uint32_t* oz,
                              uint32_t* oinf, uint32_t* ok, int B, int check,
                              int lane, uint32_t* tab, int ts) {
    const uint32_t GXW[8] = SECP_GX_WORDS, GYW[8] = SECP_GY_WORDS;
    const uint32_t BETAW[8] = SECP_BETA_WORDS;
    uint32_t pinf = misc[lane] & 1u;
    uint32_t neg1 = misc[(size_t)B + lane] & 1u;
    uint32_t neg2 = misc[(size_t)2 * B + lane] & 1u;
    uint32_t flip = neg1 ^ neg2;

    // infinity lanes: substitute G so the table build stays on the curve
    fe px = select256(pinf, fe_const(GXW), load16(px_in, B, lane));
    fe py = select256(pinf, fe_const(GYW), load16(py_in, B, lane));
    // fold the a1 sign into the table's y
    fe pyc = select256(neg1, fe_neg(py), py);

    // --- P table 1..16: jacobian build with z-ratio tracking -------------
    fe ratio[SECP_TAB + 1];                 // z_d = z_{d-1} * ratio[d]
    tab_store(tab, ts, 0, px, pyc);
    jp p1;
    p1.x = px; p1.y = pyc; p1.z = fe_one(); p1.inf = 0;
    jp d2 = jp_double(p1);
    tab_store(tab, ts, 1, d2.x, d2.y);
    fe cx = d2.x, cy = d2.y, pz = d2.z;
    ratio[2] = pz;
#pragma unroll 1
    for (int d = 3; d <= SECP_TAB; ++d) {
        fe nx, ny, nz, m;
        jp_add_aff_ratio(cx, cy, pz, px, pyc, &nx, &ny, &nz, &m);
        cx = nx; cy = ny; pz = nz;
        ratio[d] = m;
        tab_store(tab, ts, d - 1, cx, cy);
    }

    // --- global-Z pass + one inverse -> TRUE affine ------------------------
    fe zi = modinv_p(fe_canon(pz));
    fe zi2 = fe_sqr(zi);
    fe zi3 = fe_mul(zi2, zi);
    tab_store(tab, ts, SECP_TAB - 1, fe_mul(cx, zi2), fe_mul(cy, zi3));
    fe acc = ratio[SECP_TAB];
#pragma unroll 1
    for (int d = SECP_TAB - 1; d >= 1; --d) {
        if (d < SECP_TAB - 1) acc = fe_mul(acc, ratio[d + 1]);
        fe a2c = fe_sqr(acc);
        fe ex, ey;
        tab_load(tab, ts, d - 1, ex, ey);
        ex = fe_mul(fe_mul(ex, a2c), zi2);
        ey = fe_mul(fe_mul(ey, fe_mul(a2c, acc)), zi3);
        tab_store(tab, ts, d - 1, ex, ey);
    }

    // --- 26 windows: 5 doublings + 2 masked mixed adds ---------------------
    const fe beta = fe_const(BETAW);
    jp r = jp_infinity();
#pragma unroll 1
    for (int w = 0; w < SECP_NW5; ++w) {
#pragma unroll 1
        for (int k = 0; k < 5; ++k) r = jp_double(r);
#pragma unroll 1
        for (int st = 0; st < 2; ++st) {
            uint32_t row = digs[(size_t)(w + st * SECP_NW5) * B + lane];
            uint32_t mag = row & 0xFFu, sgn = (row >> 8) & 1u;
            fe gx, gy;
            tab_gather(tab, ts, mag, gx, gy);
            // second stream: lambda * P' = (beta * x, y), sign re-flipped
            if (st) {                       // st is the loop index
                gx = fe_mul(gx, beta);
                sgn ^= flip;
            }
            gy = select256(sgn, fe_neg(gy), gy);
            r = jp_add_aff(r, gx, gy, (mag == 0 ? 1u : 0u) | pinf);
        }
    }

    // --- join with u1*G (z == 0 marks infinity) ---------------------------
    jp g;
    g.x = load16(gx_in, B, lane);
    g.y = load16(gy_in, B, lane);
    g.z = load16(gz_in, B, lane);
    g.inf = fe_is_zero(g.z);
    r = jp_add(r, g);

    store16(ox, B, lane, fe_canon(r.x));
    store16(oy, B, lane, fe_canon(r.y));
    store16(oz, B, lane, fe_canon(r.z));
    oinf[lane] = r.inf;

    uint32_t okv = 0;
    if (check) {
        // x(R) === r (mod n) without an inverse: X == r*Z^2, or
        // X == (r+n)*Z^2 where r < p - n
        const uint32_t NW[8] = SECP_N_WORDS, PMN[8] = SECP_P_MINUS_N_WORDS;
        fe xr = load16(rx, B, lane);
        fe zz = fe_sqr(r.z);
        uint32_t eq1 = fe_is_zero(fe_sub(fe_mul(xr, zz), r.x));
        uint32_t borrow = 0;                // r < p - n  <=>  r - (p-n) borrows
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            u64 d = (u64)xr.v[i] - PMN[i] - borrow;
            borrow = (uint32_t)(d >> 63);
        }
        fe xr2 = fe_add(xr, fe_const(NW));
        uint32_t eq2 = fe_is_zero(fe_sub(fe_mul(xr2, zz), r.x));
        okv = (eq1 | (eq2 & borrow)) & (r.inf ^ 1u);
    }
    ok[lane] = okv;
}

#ifdef __CUDACC__
__global__ void ecmult_glv_kernel(const uint32_t* digs, const uint32_t* px,
                                  const uint32_t* py, const uint32_t* misc,
                                  const uint32_t* rx, const uint32_t* gx,
                                  const uint32_t* gy, const uint32_t* gz,
                                  uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                  uint32_t* oinf, uint32_t* ok, int B,
                                  int check) {
    extern __shared__ uint32_t smem[];
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B)
        ecmult_glv_lane(digs, px, py, misc, rx, gx, gy, gz, ox, oy, oz, oinf,
                        ok, B, check, lane, smem + threadIdx.x,
                        (int)blockDim.x);
}

extern "C" int secp_ecmult_glv(const uint32_t* digs, const uint32_t* px,
                               const uint32_t* py, const uint32_t* misc,
                               const uint32_t* rx, const uint32_t* gx,
                               const uint32_t* gy, const uint32_t* gz,
                               uint32_t* ox, uint32_t* oy, uint32_t* oz,
                               uint32_t* oinf, uint32_t* ok, int B, int check,
                               void* stream) {
    if (B <= 0) return 0;
    const int threads = 64;      // 64 KiB of table a block, three blocks an SM
    size_t smem = (size_t)threads * SECP_TAB * 16 * sizeof(uint32_t);
    cudaError_t e = cudaFuncSetAttribute(
        ecmult_glv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    ecmult_glv_kernel<<<(B + threads - 1) / threads, threads, smem,
                        (cudaStream_t)stream>>>(digs, px, py, misc, rx, gx,
                                                gy, gz, ox, oy, oz, oinf, ok,
                                                B, check);
    return (int)cudaGetLastError();
}
#endif
