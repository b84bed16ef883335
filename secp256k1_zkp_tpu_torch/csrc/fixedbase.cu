// fixedbase: k*G from 37 signed-w7 comb digit rows.
//
// Replaces the TPU kernel _gen_kernel (ops/pallas_gen.py,
// fixedbase_digits_tpu / ecmult_gen_tpu): row i (MSB-first) is digit
// position v = 36 - i with its own table of d * 2^(7v) * G, d = 1..64, so
// k*G is 37 complete mixed adds and no doublings; y is negated on the
// digit's sign, a zero digit masks the add, and z = 0 marks an all-zero
// scalar (infinity).  Output canonical jacobian x, y, z.
//
// Three entry kernels, one body (comb.cuh):
//   - fixedbase_kernel: secret k (signing's nonce and key, Pedersen's and
//     the generator's blinds).  Every entry is chosen by a full scan of its
//     row's 64 entries: no address and no branch depends on a digit.
//   - fixedbase_blinded_kernel: the same scan; the caller recodes
//     k' = k + b mod n and the kernel ends with one more complete mixed
//     add of the affine point gb = -b*G (16 words, the same for every
//     lane): k'*G - b*G = k*G, the blinding of the reference's ecmult_gen.
//     gb is never infinity; an accumulator at infinity (k' = 0) is handled
//     by the add's selects, so that lane gives gb itself.
//   - fixedbase_public_kernel: public scalars (the u1 of ECDSA verify and
//     recovery, BIP-340's s, batch verification's sum of z*s).  The digit
//     names the entry, which is read with four 16-byte loads: no scan, as
//     the reference's verification ecmult reads its G tables by public
//     wNAF digits and only ecmult_gen scans.
//
// Design for Hopper.  The lane runs on the force-inlined core of group.cuh
// (no stack).  A team of T threads serves one lane (comb.cuh): each thread
// sums every T-th row from infinity, and a shuffle tree of complete
// jacobian adds (B13's shape) leaves the sum in the team's thread 0; the
// wrapper picks T from B and the card's SM count, so that a small batch
// still gives each SM's schedulers warps enough (T = 1 once B alone does).
// The 151 KB table stays in global memory, in L2/L1: the lanes of a warp
// read the same T rows, so the scan's 256 loads a row are broadcasts.  The
// same scan from the table staged in shared memory by each block (one
// block an SM) was measured: faster at 16,384 lanes, slower at 262,144,
// no faster in all (PERF.md); the simpler code stays.  With
// T > 1 the jacobian form of the result depends on the order of the
// additions; the point does not (chip_smoke.py compares the points, and
// the words where T = 1).
//
// Bound on this card: operations — 37 mixed adds of 7M + 5S per lane (and
// for the scan, 64 x 16 word selects a row, not counted in the bound);
// traffic is 37 + 48 words per lane (+ 16 broadcast words of gb).
#include "comb.cuh"

#define SECP_FB_THREADS 128
#define SECP_FB_MIN_BLOCKS 3         // at most 170 registers

#ifdef __CUDACC__
// thread g of the launch: lane g / T, team thread g % T; threads past the
// last lane run lane B - 1 (the tree's shuffles take whole warps) and
// store nothing
template <int MODE, bool BLINDED>
SECP_INLINE void fixedbase_thread(const uint32_t* gdigs,
                                  const uint32_t* table, const uint32_t* gb,
                                  uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                  int B, int T) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = g / T, t = g & (T - 1);
    if ((g & ~31) / T >= B) return;     // whole warps only
    jp acc;
    comb_partial<MODE>(acc, gdigs, table, B, lane < B ? lane : B - 1, t, T);
    jp_warp_sum(acc, T);                // the team's tree (group.cuh)
    if (t != 0 || lane >= B) return;
    if (BLINDED) {
        fe bx, by;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            bx.v[k] = SECP_LDG(gb + k);
            by.v[k] = SECP_LDG(gb + 8 + k);
        }
        jp_add_aff_to(acc, acc, bx, by, 0u);
    }
    store16(ox, B, lane, fe_canon(acc.x));
    store16(oy, B, lane, fe_canon(acc.y));
    store16(oz, B, lane, select256(acc.inf, fe_zero(), fe_canon(acc.z)));
}

__global__ void __launch_bounds__(SECP_FB_THREADS, SECP_FB_MIN_BLOCKS)
fixedbase_kernel(const uint32_t* gdigs, const uint32_t* table,
                 const uint32_t* gb, uint32_t* ox, uint32_t* oy,
                 uint32_t* oz, int B, int T) {
    fixedbase_thread<COMB_SCAN, false>(gdigs, table, gb, ox, oy, oz, B, T);
}

__global__ void __launch_bounds__(SECP_FB_THREADS, SECP_FB_MIN_BLOCKS)
fixedbase_blinded_kernel(const uint32_t* gdigs, const uint32_t* table,
                         const uint32_t* gb, uint32_t* ox, uint32_t* oy,
                         uint32_t* oz, int B, int T) {
    fixedbase_thread<COMB_SCAN, true>(gdigs, table, gb, ox, oy, oz, B, T);
}

__global__ void __launch_bounds__(SECP_FB_THREADS, SECP_FB_MIN_BLOCKS)
fixedbase_public_kernel(const uint32_t* gdigs, const uint32_t* table,
                        const uint32_t* gb, uint32_t* ox, uint32_t* oy,
                        uint32_t* oz, int B, int T) {
    fixedbase_thread<COMB_GATHER, false>(gdigs, table, gb, ox, oy, oz, B, T);
}

typedef void (*fb_kernel_t)(const uint32_t*, const uint32_t*,
                            const uint32_t*, uint32_t*, uint32_t*,
                            uint32_t*, int, int);

static fb_kernel_t fb_kernel(int gather, int blinded) {
    return gather ? fixedbase_public_kernel
           : blinded ? fixedbase_blinded_kernel : fixedbase_kernel;
}

// k*G for B lanes, T threads a lane (1, 2, 4 or 8): the scan (gb null:
// unblinded) or, with gather, the public entry
extern "C" int secp_fixedbase(const uint32_t* gdigs, const uint32_t* table,
                              const uint32_t* gb, uint32_t* ox, uint32_t* oy,
                              uint32_t* oz, int B, int T, int gather,
                              void* stream) {
    if (B <= 0) return 0;
    if (T < 1 || T > 8 || (T & (T - 1)) || (gather && gb))
        return (int)cudaErrorInvalidValue;
    long long total = (long long)B * T;
    fb_kernel(gather, gb != nullptr)<<<
        (unsigned)((total + SECP_FB_THREADS - 1) / SECP_FB_THREADS),
        SECP_FB_THREADS, 0, (cudaStream_t)stream>>>(gdigs, table, gb, ox, oy,
                                                    oz, B, T);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for the launches of secp_fixedbase
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); < 0: -(error)
extern "C" int secp_fixedbase_warps(int gather, int blinded) {
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, (const void*)fb_kernel(gather, blinded), SECP_FB_THREADS, 0);
    return e ? -(int)e : blocks * SECP_FB_THREADS / 32;
}
#endif
