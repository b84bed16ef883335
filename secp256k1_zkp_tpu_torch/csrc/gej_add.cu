// gej_add: batched complete jacobian + jacobian addition with infinity
// flags; gej_sum: the sum of B jacobian lanes, one point, in one launch.
//
// Both replace the TPU kernel _gej_add_kernel (ops/pallas_group.py,
// gej_add_tpu): gej_add lane by lane, as it is (the generator's two
// full-width adds, batch verify's sum of its two MSMs); gej_sum where the
// JAX package sums a batch by a tree of its launches (ops/msm.py
// _tree_reduce: the Pedersen tally's two sides).
//
// gej_add: one thread a lane, jp_add_to of group.cuh (the complete formula
// with the degenerate-case select, so P + P, P + (-P) and infinity
// operands need no branch), canonical x, y, z and the inf flag out.
// Bound: operations at large B (17 field multiplies a lane against 50
// words in and 49 out); at one lane, the latency of one add.
//
// gej_sum: a sum of B points is ceil(log2 B) adds in sequence at the
// least, and on one card ceil(B / threads) + log2(threads) of them; the
// tree of gej_add launches it replaces paid a launch and a wrapper a
// level.  Here the grid is at most one block an SM (SECP_GS_THREADS
// threads; the wrapper picks the count): thread g folds the lanes g,
// g + threads, ... in registers (jp_fold_cols of group.cuh, loading the
// next lane before each add, as msm_winreduce does), the block's tree
// (jp_block_sum: warp shuffles, then one warp over the warps' sums in
// shared memory) leaves the block's sum in its thread 0, which writes it
// to the scratch and counts itself done (__threadfence, then an atomic
// counter).  The block that counts last folds and sums the blocks' sums
// the same way and writes the result: no second launch, no host round
// trip.  The wrapper's scratch is 49 * blocks + 1 words: the blocks'
// sums, limb-major like the lanes, and the counter, which the entry point
// clears before the launch.
#include "group.cuh"

#define SECP_GA_THREADS 64
#define SECP_GS_THREADS 256

#ifdef __CUDACC__
__global__ void __launch_bounds__(SECP_GA_THREADS)
gej_add_kernel(const uint32_t* ax, const uint32_t* ay, const uint32_t* az,
               const uint32_t* ainf, const uint32_t* bx, const uint32_t* by,
               const uint32_t* bz, const uint32_t* binf, uint32_t* ox,
               uint32_t* oy, uint32_t* oz, uint32_t* oinf, int B) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    jp a, b;
    jp_load_col<false>(a, ax, ay, az, ainf, B, lane);
    jp_load_col<false>(b, bx, by, bz, binf, B, lane);
    jp_add_to(a, a, b);
    jp_store_col(ox, oy, oz, oinf, B, lane, a);
}

extern "C" int secp_gej_add(const uint32_t* ax, const uint32_t* ay,
                            const uint32_t* az, const uint32_t* ainf,
                            const uint32_t* bx, const uint32_t* by,
                            const uint32_t* bz, const uint32_t* binf,
                            uint32_t* ox, uint32_t* oy, uint32_t* oz,
                            uint32_t* oinf, int B, void* stream) {
    if (B <= 0) return 0;
    gej_add_kernel<<<(B + SECP_GA_THREADS - 1) / SECP_GA_THREADS,
                     SECP_GA_THREADS, 0, (cudaStream_t)stream>>>(
        ax, ay, az, ainf, bx, by, bz, binf, ox, oy, oz, oinf, B);
    return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(SECP_GS_THREADS, 1)
gej_sum_kernel(const uint32_t* x, const uint32_t* y, const uint32_t* z,
               const uint32_t* inf, uint32_t* ox, uint32_t* oy, uint32_t* oz,
               uint32_t* oinf, uint32_t* part, int B) {
    __shared__ jp warps[SECP_GS_THREADS / 32];
    __shared__ int last;
    const int t = threadIdx.x;
    const int nb = gridDim.x;
    const int first = blockIdx.x * SECP_GS_THREADS;
    jp acc;
    jp_fold_cols(acc, x, y, z, inf, B, first + t, B, nb * SECP_GS_THREADS);
    // threads past the last lane folded nothing
    jp_block_sum(acc, min(SECP_GS_THREADS, B - first), warps);
    if (nb == 1) {
        if (t == 0) jp_store_col(ox, oy, oz, oinf, 1, 0, acc);
        return;
    }
    uint32_t* px = part;
    uint32_t* py = part + 16 * nb;
    uint32_t* pz = part + 32 * nb;
    uint32_t* pinf = part + 48 * nb;
    uint32_t* count = part + 49 * nb;
    if (t == 0) {
        jp_store_col(px, py, pz, pinf, nb, blockIdx.x, acc);
        __threadfence();                // the sum before the count
        last = atomicAdd(count, 1u) == (uint32_t)(nb - 1);
    }
    __syncthreads();
    if (!last) return;                  // the whole block leaves
    __threadfence();
    jp_fold_cols<true>(acc, px, py, pz, pinf, nb, t, nb, SECP_GS_THREADS);
    jp_block_sum(acc, min(SECP_GS_THREADS, nb), warps);
    if (t == 0) jp_store_col(ox, oy, oz, oinf, 1, 0, acc);
}

// part: [49 * nb + 1] words of scratch (unused when nb = 1)
extern "C" int secp_gej_sum(const uint32_t* x, const uint32_t* y,
                            const uint32_t* z, const uint32_t* inf,
                            uint32_t* ox, uint32_t* oy, uint32_t* oz,
                            uint32_t* oinf, uint32_t* part, int B, int nb,
                            void* stream) {
    if (B <= 0 || nb <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (nb > 1) {
        cudaError_t e = cudaMemsetAsync(part + 49 * nb, 0, sizeof(uint32_t),
                                        s);
        if (e) return (int)e;
    }
    gej_sum_kernel<<<nb, SECP_GS_THREADS, 0, s>>>(x, y, z, inf, ox, oy, oz,
                                                  oinf, part, B);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for gej_add's (op 0) or gej_sum's (op 1)
// launches (cudaOccupancyMaxActiveBlocksPerMultiprocessor); < 0: -(error)
extern "C" int secp_gej_warps(int op) {
    int blocks = 0;
    const int threads = op ? SECP_GS_THREADS : SECP_GA_THREADS;
    cudaError_t e = op
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, gej_sum_kernel, threads, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, gej_add_kernel, threads, 0);
    return e ? -(int)e : blocks * (threads / 32);
}
#endif
