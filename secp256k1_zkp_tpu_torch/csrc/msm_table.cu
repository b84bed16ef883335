// msm_table: per point, the TRUE-affine table d*P for d = 1..15.
//
// Replaces the TPU kernel _table_kernel (ops/pallas_msm.py, msm_windowed_tpu).
// Per lane: 2P by a doubling, 3P..15P by mixed adds that also return the
// z-ratio (z_d = z_{d-1} * ratio_d); one safegcd inverse of the last Z; a
// backward pass that carries the product of the ratios brings every entry
// to affine with that one inverse (ge_table_set_globalz in the reference).
// Infinity lanes are seeded with G, as the JAX body does: their table is
// valid and never read, the window sums mask them.  The entries are
// canonical, so this kernel and its plain version agree word for word.
// Layout: msm.cuh.
//
// Design for Hopper:
//   - the chain's X, Y (entries 2..14) and z-ratios (entries 3..14) go to a
//     word-major scratch [304, B] that the wrapper allocates: written once
//     and read once, each access one coalesced 128-byte row segment a
//     warp.  The whole lane runs on
//     the force-inlined core of group.cuh and modinv.cuh: no stack.
//   - each table entry is written once, in the lane-major layout that
//     msm_winreduce reads.
//   - the backward pass steps 1 / z_d = (1 / z_{d+1}) * ratio_{d+1}: four
//     multiplies and a squaring an entry.
//   - each lane inverts its own Z.  Montgomery's trick over a warp saves no
//     issue slot (the 32 lanes' inverses are already one instruction
//     stream); shared by a block of 128 lanes (prefix and suffix products
//     by shuffles, one inverse by warp 0) it measured slower on an H100,
//     5.98 against 5.41 ms at 2^20 points, its barrier idling three warps
//     of four through the inverse (PERF.md).
//
// Bound on this card: operations — 1 doubling, 13 mixed adds, the
// inverse and ~65 multiplies of the global-Z pass a lane, against 33 words
// in and 240 words out.
#include "msm.cuh"

#define SECP_MT_THREADS 128
#define SECP_MT_MIN_BLOCKS 3         // at most 170 registers

#ifdef __CUDACC__
__global__ void __launch_bounds__(SECP_MT_THREADS, SECP_MT_MIN_BLOCKS)
msm_table_kernel(const uint32_t* px, const uint32_t* py,
                 const uint32_t* pinf, uint32_t* tab, int B,
                 uint32_t* scratch) {
    const int lane = blockIdx.x * SECP_MT_THREADS + threadIdx.x;
    if (lane < B) msm_table_lane(px, py, pinf, tab, B, scratch, lane);
}

// scratch: [304, B] int32 words
extern "C" int secp_msm_table(const uint32_t* px, const uint32_t* py,
                              const uint32_t* pinf, uint32_t* tab,
                              uint32_t* scratch, int B, void* stream) {
    if (B <= 0) return 0;
    int blocks = (B + SECP_MT_THREADS - 1) / SECP_MT_THREADS;
    msm_table_kernel<<<blocks, SECP_MT_THREADS, 0, (cudaStream_t)stream>>>(
        px, py, pinf, tab, B, scratch);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for this kernel's launches
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); < 0: -(error)
extern "C" int secp_msm_table_warps(void) {
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, msm_table_kernel, SECP_MT_THREADS, 0);
    return e ? -(int)e : blocks * SECP_MT_THREADS / 32;
}
#endif
