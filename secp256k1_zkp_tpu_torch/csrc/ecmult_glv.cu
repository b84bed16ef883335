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
// Design for Hopper: the whole lane runs on the force-inlined, by-reference
// field and group core (fe.cuh, group.cuh: PTX carry chains), so no struct
// passes through a call and the kernel has no stack.  Its two memory
// needs are the per-lane table (16 entries x (x, y) x 32 bytes = 1 KiB)
// and the 15 z-ratios that link the table build to the global-Z pass:
//   - the ratios go to a scratch [15 * 8, B] of 32-bit words that the
//     wrapper allocates: written once, read once, coalesced across a warp;
//   - the table sits in dynamic shared memory, [entry][word][lane], so the
//     32 threads of a warp touch 32 consecutive words at every access, in
//     one block of up to 224 threads an SM (224 KiB of table: the most
//     lanes 227 KiB holds, 7 warps).  A table in a global scratch, where
//     registers alone limit the warps per SM, was measured and lost (PERF.md).
// The beta-scaled x table of the TPU kernel is dropped: one multiply by the
// constant beta per window costs 26 field multiplies per lane and saves 512
// bytes of table per lane.
// Table entries are chosen by a full scan with selects, one code shape
// with the comb kernel; no branch or address depends on a digit or on a
// secret.
#include "group.cuh"
#include "modinv.cuh"

#define SECP_NW5 26
#define SECP_TAB 16                  // entries 1..16
#define SECP_GLV_RATIO_ROWS (15 * 8) // z-ratios of entries 2..16
#define SECP_GLV_TAB_ROWS (SECP_TAB * 16)
#define SECP_GLV_SMEM_THREADS 224    // 224 KiB of table a block

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

// z-ratio k (of entry k + 2) in this lane's column of the scratch
SECP_INLINE void ratio_store(uint32_t* zr, int B, int k, const fe& m) {
#pragma unroll
    for (int w = 0; w < 8; ++w) zr[(size_t)(k * 8 + w) * B] = m.v[w];
}

SECP_INLINE void ratio_load(const uint32_t* zr, int B, int k, fe& m) {
#pragma unroll
    for (int w = 0; w < 8; ++w) m.v[w] = zr[(size_t)(k * 8 + w) * B];
}

SECP_INLINE void ecmult_glv_lane(const uint32_t* digs, const uint32_t* px_in,
                                 const uint32_t* py_in, const uint32_t* misc,
                                 const uint32_t* rx, const uint32_t* gx_in,
                                 const uint32_t* gy_in, const uint32_t* gz_in,
                                 uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                 uint32_t* oinf, uint32_t* ok, int B,
                                 int check, int lane, uint32_t* tab, int ts,
                                 uint32_t* zr) {
    const uint32_t GXW[8] = SECP_GX_WORDS, GYW[8] = SECP_GY_WORDS;
    const uint32_t BETAW[8] = SECP_BETA_WORDS;
    const uint32_t pinf = misc[lane] & 1u;
    const uint32_t neg1 = misc[(size_t)B + lane] & 1u;
    const uint32_t neg2 = misc[(size_t)2 * B + lane] & 1u;
    const uint32_t flip = neg1 ^ neg2;

    // infinity lanes: substitute G so the table build stays on the curve
    fe px = select256(pinf, fe_const(GXW), load16(px_in, B, lane));
    fe py = select256(pinf, fe_const(GYW), load16(py_in, B, lane));
    // fold the a1 sign into the table's y
    fe pyc;
    fe_neg_to(pyc, py);
    pyc = select256(neg1, pyc, py);

    // --- P table 1..16: jacobian build with z-ratio tracking -------------
    // z_d = z_{d-1} * ratio_d; ratio_d sits at scratch row group d - 2
    tab_store(tab, ts, 0, px, pyc);
    jp cur;
    cur.x = px; cur.y = pyc; cur.z = fe_one(); cur.inf = 0;
    jp_double_to(cur, cur);
    tab_store(tab, ts, 1, cur.x, cur.y);
    ratio_store(zr, B, 0, cur.z);
#pragma unroll 1
    for (int d = 3; d <= SECP_TAB; ++d) {
        fe nx, ny, nz, m;
        jp_add_aff_ratio(cur.x, cur.y, cur.z, px, pyc, &nx, &ny, &nz, &m);
        cur.x = nx; cur.y = ny; cur.z = nz;
        ratio_store(zr, B, d - 2, m);
        tab_store(tab, ts, d - 1, cur.x, cur.y);
    }

    // --- global-Z pass + one inverse -> TRUE affine ------------------------
    const modinfo30 mi = { SECP_MODINV_P_LIMBS, SECP_MODINV_P_INV30 };
    fe zi = modinv30(fe_canon(cur.z), mi);
    fe zi2, zi3, acc, a2c, t, ex, ey;
    fe_sqr_to(zi2, zi);
    fe_mul_to(zi3, zi2, zi);
    fe_mul_to(ex, cur.x, zi2);
    fe_mul_to(ey, cur.y, zi3);
    tab_store(tab, ts, SECP_TAB - 1, ex, ey);
    ratio_load(zr, B, SECP_TAB - 2, acc);
#pragma unroll 1
    for (int d = SECP_TAB - 1; d >= 1; --d) {
        if (d < SECP_TAB - 1) {
            ratio_load(zr, B, d - 1, t);
            fe_mul_to(acc, acc, t);
        }
        fe_sqr_to(a2c, acc);
        tab_load(tab, ts, d - 1, ex, ey);
        fe_mul_to(ex, ex, a2c);
        fe_mul_to(ex, ex, zi2);
        fe_mul_to(t, a2c, acc);
        fe_mul_to(ey, ey, t);
        fe_mul_to(ey, ey, zi3);
        tab_store(tab, ts, d - 1, ex, ey);
    }

    // --- 26 windows: 5 doublings + 2 masked mixed adds ---------------------
    const fe beta = fe_const(BETAW);
    jp r = jp_infinity();
#pragma unroll 1
    for (int w = 0; w < SECP_NW5; ++w) {
#pragma unroll 1
        for (int k = 0; k < 5; ++k) jp_double_to(r, r);
#pragma unroll 1
        for (int st = 0; st < 2; ++st) {
            uint32_t row = digs[(size_t)(w + st * SECP_NW5) * B + lane];
            uint32_t mag = row & 0xFFu, sgn = (row >> 8) & 1u;
            fe gx, gy;
            tab_gather(tab, ts, mag, gx, gy);
            // second stream: lambda * P' = (beta * x, y), sign re-flipped
            if (st) {                       // st is the loop index
                fe_mul_to(gx, gx, beta);
                sgn ^= flip;
            }
            fe_neg_to(t, gy);
            gy = select256(sgn, t, gy);
            jp_add_aff_to(r, r, gx, gy, (mag == 0 ? 1u : 0u) | pinf);
        }
    }

    // --- join with u1*G (z == 0 marks infinity) ---------------------------
    jp g;
    g.x = load16(gx_in, B, lane);
    g.y = load16(gy_in, B, lane);
    g.z = load16(gz_in, B, lane);
    g.inf = fe_is_zero(g.z);
    jp_add_to(r, r, g);

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
        fe zz;
        fe_sqr_to(zz, r.z);
        fe_mul_to(t, xr, zz);
        fe_sub_to(t, t, r.x);
        uint32_t eq1 = fe_is_zero(t);
        uint32_t borrow = 0;                // r < p - n  <=>  r - (p-n) borrows
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            u64 d = (u64)xr.v[i] - PMN[i] - borrow;
            borrow = (uint32_t)(d >> 63);
        }
        fe_add_to(xr, xr, fe_const(NW));
        fe_mul_to(t, xr, zz);
        fe_sub_to(t, t, r.x);
        uint32_t eq2 = fe_is_zero(t);
        okv = (eq1 | (eq2 & borrow)) & (r.inf ^ 1u);
    }
    ok[lane] = okv;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SECP_GLV_SMEM_THREADS, 1)
ecmult_glv_kernel(const uint32_t* digs, const uint32_t* px,
                  const uint32_t* py, const uint32_t* misc,
                  const uint32_t* rx, const uint32_t* gx, const uint32_t* gy,
                  const uint32_t* gz, uint32_t* ox, uint32_t* oy,
                  uint32_t* oz, uint32_t* oinf, uint32_t* ok, int B,
                  int check, uint32_t* scratch) {
    extern __shared__ uint32_t smem[];
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B)
        ecmult_glv_lane(digs, px, py, misc, rx, gx, gy, gz, ox, oy, oz, oinf,
                        ok, B, check, lane, smem + threadIdx.x,
                        (int)blockDim.x, scratch + lane);
}

// launch shape at B lanes: blocks are sized so that every SM gets work at
// small B (at most 224 threads, whole warps)
static int glv_config(int B, int* threads, size_t* smem) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    int per_sm = (B + sms - 1) / sms;
    int t = (per_sm + 31) / 32 * 32;
    *threads = t < 32 ? 32 : t > SECP_GLV_SMEM_THREADS ? SECP_GLV_SMEM_THREADS
                                                       : t;
    *smem = (size_t)*threads * SECP_GLV_TAB_ROWS * sizeof(uint32_t);
    return (int)cudaFuncSetAttribute(
        ecmult_glv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)*smem);
}

// scratch: [120, B] int32 words (the z-ratios)
extern "C" int secp_ecmult_glv(const uint32_t* digs, const uint32_t* px,
                               const uint32_t* py, const uint32_t* misc,
                               const uint32_t* rx, const uint32_t* gx,
                               const uint32_t* gy, const uint32_t* gz,
                               uint32_t* ox, uint32_t* oy, uint32_t* oz,
                               uint32_t* oinf, uint32_t* ok, int B, int check,
                               uint32_t* scratch, void* stream) {
    if (B <= 0) return 0;
    int threads;
    size_t smem;
    int e = glv_config(B, &threads, &smem);
    if (e) return e;
    dim3 grid((B + threads - 1) / threads);
    ecmult_glv_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        digs, px, py, misc, rx, gx, gy, gz, ox, oy, oz, oinf, ok, B, check,
        scratch);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for the launch secp_ecmult_glv makes at B
// lanes (cudaOccupancyMaxActiveBlocksPerMultiprocessor); < 0: -(error)
extern "C" int secp_ecmult_glv_warps(int B) {
    int threads, blocks = 0;
    size_t smem;
    int e = glv_config(B, &threads, &smem);
    if (!e)
        e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, (const void*)ecmult_glv_kernel, threads, smem);
    return e ? -e : blocks * threads / 32;
}
#endif
