// msm_winreduce: per 4-bit window w, partial sums of d_{i,w} * P_i over
// chunks of lanes.
//
// Replaces the TPU kernel _winreduce_kernel (ops/pallas_msm.py,
// msm_windowed_tpu).  The TPU runs a grid (window, block) whose block axis
// is sequential and carries a per-lane accumulator in VMEM.  Blocks on
// this card run in parallel and in no order, so the shape is different:
// grid (lane chunk, window); each thread folds a strided run of its
// chunk's lanes into a jacobian accumulator with complete mixed adds; a
// shared-memory tree of complete jacobian adds reduces the block's 128
// accumulators; one partial point per (window, chunk) goes out, canonical,
// at column w * nblk + chunk of [16, nwin * nblk].  msm_finish sums them.
//
// The scalars of every caller are public (batch verification and the
// verifiers of the protocols built on ecmult_multi; the reference's
// counterpart, secp256k1_ecmult_multi_var, is variable-time), so the digit
// indexes the table directly — a 64-byte load, where the TPU body's
// select scan reads all 15 entries — and a zero digit or an infinite point
// skips its add.  The fixed-base comb multiplies secrets and keeps its
// select scan.
//
// Bound on this card: operations — one mixed add (7M + 5S) per lane and
// window against 64 bytes of table and 8 bytes of digit and flag.
#include "msm.cuh"

#define SECP_WR_THREADS 128

// this thread's share of lanes [lo, hi): lo + start, lo + start + step, ...
SECP_DEV jp msm_winreduce_fold(const uint32_t* digs, const uint32_t* tab,
                               const uint32_t* pinf, int N, int w, int lo,
                               int hi, int start, int step) {
    jp acc = jp_infinity();
#pragma unroll 1
    for (int i = lo + start; i < hi; i += step) {
        uint32_t d = digs[(size_t)w * N + i] & 15u;
        if (d == 0 || (pinf[i] & 1u)) continue;
        fe x, y;
        msm_entry_load(tab, (size_t)i * SECP_MSM_NENT + d - 1, x, y);
        acc = jp_add_aff(acc, x, y, 0);
    }
    return acc;
}

SECP_DEV void msm_partial_store(uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                uint32_t* oinf, int M, int col, const jp& r) {
    store16(ox, M, col, fe_canon(r.x));
    store16(oy, M, col, fe_canon(r.y));
    store16(oz, M, col, fe_canon(r.z));
    oinf[col] = r.inf;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SECP_WR_THREADS)
msm_winreduce_kernel(const uint32_t* digs, const uint32_t* tab,
                     const uint32_t* pinf, uint32_t* ox, uint32_t* oy,
                     uint32_t* oz, uint32_t* oinf, int N, int nblk,
                     int chunk) {
    __shared__ jp sh[SECP_WR_THREADS];
    const int b = blockIdx.x, w = blockIdx.y, t = threadIdx.x;
    const int lo = b * chunk;
    const int hi = min(N, lo + chunk);
    sh[t] = msm_winreduce_fold(digs, tab, pinf, N, w, lo, hi, t,
                               SECP_WR_THREADS);
    __syncthreads();
#pragma unroll 1
    for (int s = SECP_WR_THREADS / 2; s > 0; s >>= 1) {
        if (t < s) sh[t] = jp_add(sh[t], sh[t + s]);
        __syncthreads();
    }
    if (t == 0)
        msm_partial_store(ox, oy, oz, oinf, gridDim.y * nblk, w * nblk + b,
                          sh[0]);
}

extern "C" int secp_msm_winreduce(const uint32_t* digs, const uint32_t* tab,
                                  const uint32_t* pinf, uint32_t* ox,
                                  uint32_t* oy, uint32_t* oz, uint32_t* oinf,
                                  int N, int nwin, int nblk, int chunk,
                                  void* stream) {
    if (N <= 0 || nwin <= 0 || nblk <= 0) return 0;
    dim3 grid(nblk, nwin);
    msm_winreduce_kernel<<<grid, SECP_WR_THREADS, 0,
                           (cudaStream_t)stream>>>(digs, tab, pinf, ox, oy,
                                                   oz, oinf, N, nblk, chunk);
    return (int)cudaGetLastError();
}
#endif
