// msm_finish: the window partials of msm_winreduce -> the MSM's result,
// sum_w 16^w * S_w (S_w the sum of window w's nblk partials), as one
// jacobian point.  One launch, one block.
//
// Replaces the TPU kernel _finish_kernel (ops/pallas_msm.py,
// msm_windowed_tpu), which folds each window's accumulator lanes to 128
// and runs the Horner recurrence R = 16*R + S_w on 128 lanes, together
// with _collapse128, which sums those 128 lanes by seven launches of the
// add kernel.
//
// The function needs 4(nwin - 1) doublings of one point in sequence,
// whatever the design: its bound on this card is that latency, not its
// bytes or operations (PERF.md, bound_lat_ms).  So the design shortens
// the chain around those doublings and spends the block's idle threads on
// everything else:
//   - stage 1: a team of `team` threads a window (finish_team, msm.cuh: 4
//     at 64 windows, 8 at 32), all windows at once.  Thread r of window w's
//     team folds the partials r, r + team, ... (jp_fold_cols), and a
//     shuffle tree of log2(team) complete adds leaves S_w in the team's
//     first thread, which puts it in shared memory;
//   - stage 2: the pair of threads (2w, 2w + 1) doubles S_w 4w times (a
//     16^w ladder; the longest, the top window's, is the 4(nwin - 1) of
//     the bound), then the block's tree (jp_block_sum: a warp's five
//     levels and one across two warps at 64 windows) adds the nwin terms.
// A pair runs each doubling (jp_double_pair_to, group.cuh): a thread's
// field products cannot overlap (each is a carry chain through the one
// carry flag), so one thread's doubling takes the sum of its seven
// products' latencies; split over two threads it takes four.  On an H100
// that measured 1.73 us a doubling against 2.10 (PERF.md).
// A tree of windows (lo + 2^(4 * 2^l) hi at level l) has the same
// critical path, 4(nwin - 1) doublings and log2(nwin) adds, and a barrier
// a level; the ladder needs none and reuses the block's tree.  At 256-bit
// scalars the chain is 252 doublings and 3 + 2 + 6 adds, where the kernel
// it replaces ran 256 doublings and 64 adds in sequence and seven more
// launches.  Everything runs on the force-inlined core (group.cuh): no
// stack.  The result is another jacobian representative of the point the
// TPU kernel and its collapse give (another order of additions).
#include "msm.cuh"

#ifdef __CUDACC__
__global__ void __launch_bounds__(SECP_FIN_THREADS, 1)
msm_finish_kernel(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                  const uint32_t* pinf, uint32_t* ox, uint32_t* oy,
                  uint32_t* oz, uint32_t* oinf, int nwin, int nblk) {
    __shared__ jp win[SECP_FIN_THREADS / 2];
    __shared__ jp warps[SECP_FIN_THREADS / 32];
    const int t = threadIdx.x;
    const int team = finish_team(nwin);
    const int w = t >> 1;
    jp acc;
    // stage 1: S_w in win[w]
    finish_fold(acc, px, py, pz, pinf, nwin, nblk, t);
    jp_warp_sum(acc, team);
    if (t % team == 0 && t / team < nwin) win[t / team] = acc;
    __syncthreads();
    // stage 2: 16^w S_w on the pair (2w, 2w + 1), then the block's sum
    if (w < nwin) {
        acc = win[w];
#pragma unroll 1
        for (int k = 0; k < 4 * w; ++k) jp_double_pair_to(acc, acc);
    }
    __syncthreads();
    if ((t & 1) == 0 && w < nwin) win[w] = acc;
    __syncthreads();
    if (t < nwin) acc = win[t];
    jp_block_sum(acc, nwin, warps);
    if (t == 0) jp_store_col(ox, oy, oz, oinf, 1, 0, acc);
}

extern "C" int secp_msm_finish(const uint32_t* px, const uint32_t* py,
                               const uint32_t* pz, const uint32_t* pinf,
                               uint32_t* ox, uint32_t* oy, uint32_t* oz,
                               uint32_t* oinf, int nwin, int nblk,
                               void* stream) {
    if (nwin <= 0 || nblk <= 0 || 2 * nwin > SECP_FIN_THREADS)
        return (int)cudaErrorInvalidValue;
    msm_finish_kernel<<<1, SECP_FIN_THREADS, 0, (cudaStream_t)stream>>>(
        px, py, pz, pinf, ox, oy, oz, oinf, nwin, nblk);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for this kernel's launches
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); < 0: -(error)
extern "C" int secp_msm_finish_warps(void) {
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, msm_finish_kernel, SECP_FIN_THREADS, 0);
    return e ? -(int)e : blocks * (SECP_FIN_THREADS / 32);
}

// The latency floor of msm_finish and gej_sum (chip_smoke.py,
// bound_lat_ms): one warp runs, all threads alike, a chain of n
// operations in sequence on the point in io (25 words: x, y, z, inf) on
// the inlined core, and thread 0 writes the result back.  op 0: doublings
// (jp_double_to); 1: complete adds of 2a; 2: doublings by a pair of
// threads (jp_double_pair_to); 3: field squarings of x; 4: field
// multiplies of x by y; 5: safegcd inverses of x (modinv30); 6: Jacobi
// symbols of x (jacobi30_var; x's low bit takes the result, so the next
// one waits on it: x stays nonzero and below p from G's x).
__global__ void latency_probe_kernel(uint32_t* io, int op, int n) {
    const modinfo30 mi = { SECP_MODINV_P_LIMBS, SECP_MODINV_P_INV30 };
    jp a, b;
    for (int i = 0; i < 8; ++i) {
        a.x.v[i] = io[i];
        a.y.v[i] = io[8 + i];
        a.z.v[i] = io[16 + i];
    }
    a.inf = io[24];
    jp_double_to(b, a);                 // a second point: 2a
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
        if (op == 0) jp_double_to(a, a);
        else if (op == 1) jp_add_to(a, a, b);
        else if (op == 2) jp_double_pair_to(a, a);
        else if (op == 3) fe_sqr_to(a.x, a.x);
        else if (op == 4) fe_mul_to(a.x, a.x, a.y);
        else if (op == 5) a.x = modinv30(a.x, mi);
        else a.x.v[0] ^= (uint32_t)(jacobi30_var(a.x, mi) > 0);
    }
    if (threadIdx.x != 0) return;
    for (int i = 0; i < 8; ++i) {
        io[i] = a.x.v[i];
        io[8 + i] = a.y.v[i];
        io[16 + i] = a.z.v[i];
    }
    io[24] = a.inf;
}

extern "C" int secp_latency_probe(uint32_t* io, int op, int n,
                                  void* stream) {
    latency_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(io, op, n);
    return (int)cudaGetLastError();
}
#endif
