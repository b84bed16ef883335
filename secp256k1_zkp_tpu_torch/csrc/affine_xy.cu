// affine_xy: jacobian (X, Y, Z) -> canonical affine (x, y).
//
// Replaces the TPU kernel _affine_xy_kernel (ops/pallas_gen.py,
// affine_xy_tpu): x = X Z^-2, y = Y Z^-3 from one safegcd inverse of Z
// (canonicalised first).  Infinity lanes (Z = 0, or the weak zero Z = p)
// give zeros.  The sign paths serialize the public key and the nonce point
// R with it and read y's parity; recovery makes its key affine.
//
// The point is d*G or k*G for a secret d or k: the inverse is the
// fixed-iteration divsteps of modinv.cuh, a zero Z is a select, and
// nothing branches on or addresses by the data.
//
// Design for Hopper (affine.cuh): a thread takes a group of K lanes
// strided by the thread count and inverts their product once
// (Montgomery's trick), which cuts the instructions a thread issues; the
// wrapper picks K from the batch and the SM count (cuda_field.affine_group,
// K = 1 until the batch fills the card).  On the inlined core: 0 B stack.
// Bound on this card: bytes — 48 words in and 32 out a lane outweigh the
// function's least arithmetic (~650 multiply-adds a lane: an inverse
// shared by 32 lanes, the trick's 3 products, a squaring and 3
// multiplies); the kernel's inverse is shared by K <= 8 lanes only.
#include "affine.cuh"

#define SECP_AFFINE_THREADS 128

SECP_DEV void affine_xy_group(const uint32_t* x, const uint32_t* y,
                              const uint32_t* z, uint32_t* ax, uint32_t* ay,
                              int B, int K, int t) {
    affine_group<false>(x, y, z, ax, ay, nullptr, nullptr, B, K,
                        (B + K - 1) / K, t);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SECP_AFFINE_THREADS)
affine_xy_kernel(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                 uint32_t* ax, uint32_t* ay, int B, int K) {
    const int t = blockIdx.x * SECP_AFFINE_THREADS + threadIdx.x;
    if (t < (B + K - 1) / K) affine_xy_group(x, y, z, ax, ay, B, K, t);
}

extern "C" int secp_affine_xy(const uint32_t* x, const uint32_t* y,
                              const uint32_t* z, uint32_t* ax, uint32_t* ay,
                              int B, int K, void* stream) {
    if (B <= 0 || K <= 0) return 0;
    const int threads = (B + K - 1) / K;
    affine_xy_kernel<<<(threads + SECP_AFFINE_THREADS - 1)
                           / SECP_AFFINE_THREADS,
                       SECP_AFFINE_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, z, ax, ay, B, K);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for this kernel's launches; < 0: -(error)
extern "C" int secp_affine_xy_warps(void) {
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, affine_xy_kernel, SECP_AFFINE_THREADS, 0);
    return e ? -(int)e : blocks * (SECP_AFFINE_THREADS / 32);
}
#endif
