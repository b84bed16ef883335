// affine_meta: jacobian (X, Y, Z) -> canonical affine (x, y) and whether
// y is a nonzero square, the serialization step of Pedersen commitments
// and generators (the prefix bit of their 33-byte form).
//
// Replaces the TPU kernel _affine_meta_kernel (ops/pallas_field.py,
// affine_meta_tpu), which reads the character of t = Y Z^3 by powering it
// to (p-1)/2.  Here x, y are affine_xy.cu's (affine.cuh: K lanes a thread,
// one inverse for the group), and the character is read from the
// canonical affine y the kernel has just written, which equals t's for
// every Z != 0 (they differ by the square Z^6).  Where Z is zero (0 or the
// weak zero p) y is 0, and y = 0 gives sq = 0, as t = 0 does on the TPU.
//
// The character is the Jacobi symbol (y | p) by positive divsteps
// (modinv.cuh jacobi30_var), the reference's route: secp256k1_fe_is_square_var
// over jacobi32_maybe_var, posdivsteps_30_var.  Form: a cap of 50 batches
// of 30 steps, and on a lane still undecided after it the reference's
// fixed sqrt chain (fe_pow_sqrt_to: r = y^((p+1)/4), a square iff r^2 ==
// y), as the reference falls back to fe_sqrt; the wrapper counts those
// lanes (0 on random data: they reach f = 1 after 750-850 steps).  Both
// routes give the exact character, so the result is the same bit either
// way.  The Jacobi's trip count, and the fallback, depend on y: this is
// the kernel's one variable-time step, and it reads only the PUBLIC affine
// y, which every caller publishes as the point's serialization.  Z and t
// belong to a commitment's secret blind: the inverse, its group and every
// select before y exists are fixed dataflow, nothing branches on or
// addresses by X, Y, Z or t.
//
// Bound on this card: operations — affine_xy.cu's a lane and a Jacobi
// symbol (the divsteps and the f, g half of the limb updates), against 48
// words in and 33 out a lane.  On the inlined core: 0 B stack.
#include "affine.cuh"

#define SECP_AFFINE_THREADS 128

SECP_DEV void affine_meta_group(const uint32_t* x, const uint32_t* y,
                                const uint32_t* z, uint32_t* ax,
                                uint32_t* ay, uint32_t* sq,
                                uint32_t* undecided, int B, int K, int t) {
    affine_group<true>(x, y, z, ax, ay, sq, undecided, B, K,
                       (B + K - 1) / K, t);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SECP_AFFINE_THREADS)
affine_meta_kernel(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                   uint32_t* ax, uint32_t* ay, uint32_t* sq,
                   uint32_t* undecided, int B, int K) {
    const int t = blockIdx.x * SECP_AFFINE_THREADS + threadIdx.x;
    if (t < (B + K - 1) / K)
        affine_meta_group(x, y, z, ax, ay, sq, undecided, B, K, t);
}

// undecided: one uint32 that each lane the Jacobi leaves undecided adds 1 to
extern "C" int secp_affine_meta(const uint32_t* x, const uint32_t* y,
                                const uint32_t* z, uint32_t* ax, uint32_t* ay,
                                uint32_t* sq, uint32_t* undecided, int B,
                                int K, void* stream) {
    if (B <= 0 || K <= 0) return 0;
    const int threads = (B + K - 1) / K;
    affine_meta_kernel<<<(threads + SECP_AFFINE_THREADS - 1)
                             / SECP_AFFINE_THREADS,
                         SECP_AFFINE_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, z, ax, ay, sq, undecided, B, K);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for this kernel's launches; < 0: -(error)
extern "C" int secp_affine_meta_warps(void) {
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, affine_meta_kernel, SECP_AFFINE_THREADS, 0);
    return e ? -(int)e : blocks * (SECP_AFFINE_THREADS / 32);
}
#endif
