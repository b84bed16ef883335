// msm_finish: the window partials of msm_winreduce -> L jacobian lanes
// whose sum is sum_w 16^w * S_w.
//
// Replaces the TPU kernel _finish_kernel (ops/pallas_msm.py,
// msm_windowed_tpu), which folds each window's accumulator lanes to 128
// and runs the Horner recurrence R = 16*R + S_w, most significant window
// first, on a 128-lane accumulator.  Here lane l runs that recurrence on
// the partials l, l + L, l + 2L, ... of every window (the collapse and the
// Horner weights commute: everything is lane-wise), so the kernel takes
// the partials straight from msm_winreduce.  The L lanes are then summed
// by log2(L) levels of the gej_add kernel, as _collapse128 does.
//
// One thread per lane.  Bound on this card: the latency of one lane —
// nwin * (4 doublings + ceil(nblk / L) complete adds) in sequence; the
// operations and bytes are tiny next to msm_winreduce.
#include "group.cuh"

SECP_DEV void msm_finish_lane(const uint32_t* px, const uint32_t* py,
                              const uint32_t* pz, const uint32_t* pinf,
                              uint32_t* ox, uint32_t* oy, uint32_t* oz,
                              uint32_t* oinf, int nwin, int nblk, int L,
                              int lane) {
    const int M = nwin * nblk;
    jp r = jp_infinity();
#pragma unroll 1
    for (int w = nwin - 1; w >= 0; --w) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) r = jp_double(r);
#pragma unroll 1
        for (int j = lane; j < nblk; j += L) {
            const int col = w * nblk + j;
            jp p;
            p.x = load16(px, M, col); p.y = load16(py, M, col);
            p.z = load16(pz, M, col); p.inf = pinf[col] & 1u;
            r = jp_add(r, p);
        }
    }
    store16(ox, L, lane, fe_canon(r.x));
    store16(oy, L, lane, fe_canon(r.y));
    store16(oz, L, lane, fe_canon(r.z));
    oinf[lane] = r.inf;
}

#ifdef __CUDACC__
__global__ void msm_finish_kernel(const uint32_t* px, const uint32_t* py,
                                  const uint32_t* pz, const uint32_t* pinf,
                                  uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                  uint32_t* oinf, int nwin, int nblk, int L) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < L)
        msm_finish_lane(px, py, pz, pinf, ox, oy, oz, oinf, nwin, nblk, L,
                        lane);
}

extern "C" int secp_msm_finish(const uint32_t* px, const uint32_t* py,
                               const uint32_t* pz, const uint32_t* pinf,
                               uint32_t* ox, uint32_t* oy, uint32_t* oz,
                               uint32_t* oinf, int nwin, int nblk, int L,
                               void* stream) {
    if (nwin <= 0 || nblk <= 0 || L <= 0) return 0;
    // one warp a block: the L lanes spread over L / 32 SMs
    const int threads = 32;
    msm_finish_kernel<<<(L + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(px, py, pz, pinf, ox, oy, oz,
                                                oinf, nwin, nblk, L);
    return (int)cudaGetLastError();
}
#endif
