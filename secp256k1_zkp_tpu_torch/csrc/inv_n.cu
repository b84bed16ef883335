// inv_n: x^-1 mod n on scalars (n the group order); inv(0) = 0.
//
// Replaces the TPU kernel _inv_kernel (ops/pallas_scalar.py, inv_n_tpu):
// one safegcd inverse a lane, modinv_n of modinv.cuh (20 batches of 30
// divsteps on nine signed 30-bit limbs; the TPU kernel runs 43 batches of
// 14 on 14-bit limbs because its lanes are 32 bits wide).  The input is
// canonicalised first (x < 2^256 < 2n: one conditional subtract), the
// output is canonical where the TPU kernel's is weak.  ECDSA public-key
// recovery takes r^-1 with it.
//
// The scalar may be secret in other callers: the divsteps run a fixed
// number of iterations and nothing branches on the data.
// Bound on this card: operations — 600 divsteps and 20 limb updates
// (~2,100 32-bit multiply-adds) against 32 words of traffic a lane.  One
// thread per lane, all in registers.
#include "modinv.cuh"
#include "sc.cuh"

SECP_DEV void inv_n_lane(const uint32_t* x_in, uint32_t* o_out, int B,
                         int lane) {
    sc x = load16(x_in, B, lane);
    store16(o_out, B, lane, modinv_n(sc_canon(x)));
}

#ifdef __CUDACC__
__global__ void inv_n_kernel(const uint32_t* x, uint32_t* o, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) inv_n_lane(x, o, B, lane);
}

extern "C" int secp_inv_n(const uint32_t* x, uint32_t* o, int B,
                          void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    inv_n_kernel<<<(B + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>(x, o, B);
    return (int)cudaGetLastError();
}
#endif
