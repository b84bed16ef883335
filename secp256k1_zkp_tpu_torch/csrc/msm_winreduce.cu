// msm_winreduce: per 4-bit window w, partial sums of d_{i,w} * P_i over
// chunks of lanes.
//
// Replaces the TPU kernel _winreduce_kernel (ops/pallas_msm.py,
// msm_windowed_tpu).  The TPU runs a grid (window, block) whose block axis
// is sequential and carries a per-lane accumulator in VMEM.  Blocks on
// this card run in parallel and in no order, so the shape is different:
// each partial (window w, lane chunk c) is one warp's.  Its 32 threads fold
// strided runs of the chunk's lanes (lo + t, lo + t + 32, ...) into
// jacobian accumulators in registers with complete mixed adds, then a
// 5-level warp-shuffle tree of complete jacobian adds (jp_warp_sum of
// group.cuh) leaves the sum in thread 0, which writes it canonical at
// column w * nblk + c of [16, nwin * nblk].  No shared memory, no block
// barrier.  msm_finish sums the partials.
//
// Reuse across windows: a block is SECP_WR_WARPS consecutive windows of
// one chunk, and the grid runs the windows fastest, so the warps that run
// at one time walk the same few chunks in step and read the same 960-byte
// table rows (and the same flags) within a short time: after the first
// window's read a row comes from L1 or L2, not from device memory (the
// table is 960 MiB at 2^20 points, the L2 50 MB).  Each thread issues the
// loads of its next lane's entry before the add of the current one.
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
// window against 64 bytes of table and 8 bytes of digit and flag.  The
// whole fold runs on the force-inlined core of group.cuh: no stack.
#include "msm.cuh"

#define SECP_WR_WARPS 4              // windows (warps) per block
// at most 168 registers; at 4 blocks (128) ptxas spills.  The wrapper's
// chunking (ops/cuda_msm.py, WR_PARTIALS) runs two blocks an SM.
#define SECP_WR_MIN_BLOCKS 3

// the first lane at or after i (stepping by 32) whose digit is nonzero and
// whose point is finite; hi if none.  *d gets its digit.
SECP_INLINE int wr_next(const uint32_t* dw, const uint32_t* pinf, int i,
                        int hi, uint32_t* d) {
    for (; i < hi; i += 32) {
        *d = dw[i] & 15u;
        if (*d != 0 && !(pinf[i] & 1u)) break;
    }
    return i;
}

// this thread's run of lanes i, i + 32, ... < hi of window digits dw
SECP_INLINE void msm_winreduce_fold(jp& acc, const uint32_t* dw,
                                    const uint32_t* tab,
                                    const uint32_t* pinf, int i, int hi) {
    acc = jp_infinity();
    uint32_t d = 0, dn = 0;
    fe x, y, nx, ny;
    i = wr_next(dw, pinf, i, hi, &d);
    if (i < hi) msm_entry_load(tab, (size_t)i * SECP_MSM_NENT + d - 1, x, y);
    while (i < hi) {
        int j = wr_next(dw, pinf, i + 32, hi, &dn);
        if (j < hi)                     // in flight during the add below
            msm_entry_load(tab, (size_t)j * SECP_MSM_NENT + dn - 1, nx, ny);
        jp_add_aff_to(acc, acc, x, y, 0);
        x = nx;
        y = ny;
        i = j;
    }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SECP_WR_WARPS * 32, SECP_WR_MIN_BLOCKS)
msm_winreduce_kernel(const uint32_t* digs, const uint32_t* tab,
                     const uint32_t* pinf, uint32_t* ox, uint32_t* oy,
                     uint32_t* oz, uint32_t* oinf, int N, int nwin, int nblk,
                     int chunk) {
    const int t = threadIdx.x & 31;
    const int w = blockIdx.x * SECP_WR_WARPS + (threadIdx.x >> 5);
    const int c = blockIdx.y;
    if (w >= nwin) return;              // whole warps only
    const int lo = c * chunk;
    const int hi = min(N, lo + chunk);
    jp acc;
    msm_winreduce_fold(acc, digs + (size_t)w * N, tab, pinf, lo + t, hi);
    jp_warp_sum(acc, 32);
    if (t == 0) jp_store_col(ox, oy, oz, oinf, nwin * nblk, w * nblk + c,
                             acc);
}

extern "C" int secp_msm_winreduce(const uint32_t* digs, const uint32_t* tab,
                                  const uint32_t* pinf, uint32_t* ox,
                                  uint32_t* oy, uint32_t* oz, uint32_t* oinf,
                                  int N, int nwin, int nblk, int chunk,
                                  void* stream) {
    if (N <= 0 || nwin <= 0 || nblk <= 0) return 0;
    dim3 grid((nwin + SECP_WR_WARPS - 1) / SECP_WR_WARPS, nblk);
    msm_winreduce_kernel<<<grid, SECP_WR_WARPS * 32, 0,
                           (cudaStream_t)stream>>>(digs, tab, pinf, ox, oy,
                                                   oz, oinf, N, nwin, nblk,
                                                   chunk);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for this kernel's launches
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); < 0: -(error)
extern "C" int secp_msm_winreduce_warps(void) {
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, msm_winreduce_kernel, SECP_WR_WARPS * 32, 0);
    return e ? -(int)e : blocks * SECP_WR_WARPS;
}
#endif
