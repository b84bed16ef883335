// lift_x: BIP-340 x -> the even square root y of x^3 + 7, and a validity
// mask.
//
// Replaces the TPU kernel _lift_x_kernel (ops/pallas_field.py, lift_x_tpu).
// y2 = x^3 + 7, y = y2^((p+1)/4), ok = (y^2 == y2), and y is replaced by
// p - y where it is odd; out: canonical y and ok.  The TPU kernel powers by
// 64 4-bit windows read from scalar memory; the exponent is a constant, so
// here it is the reference's fixed sqrt chain (fe_pow_sqrt_to, fe.cuh): the
// same canonical value with 269 field operations instead of 320.  Lanes
// that are no square (or x >= p, which the caller parses as x - p) still
// return the even-selected y2^((p+1)/4); the caller masks them.
//
// The lane runs on the force-inlined by-reference core: every product a
// carry chain in registers, no call and no stack.  Batch verification
// lifts its P and R lanes in one launch over both.
//
// Bound on this card: operations — 255 squarings and 14 multiplies a lane
// (~12,000 32-bit multiply-adds) against 33 words of traffic.  One thread
// per lane; the chain is one dependent sequence, so at small batches its
// latency (255 squarings and 14 multiplies in a row) is the floor, hidden
// only by other warps.
#include "fe.cuh"

// y or p - y, whichever is even (y canonical: y = 0 stays 0)
SECP_INLINE fe lift_x_even(const fe& y) {
    fe ny;
    fe_neg_to(ny, y);
    return select256(y.v[0] & 1u, fe_canon(ny), y);
}

SECP_INLINE void lift_x_lane(const uint32_t* x_in, uint32_t* y_out,
                             uint32_t* ok_out, int B, int lane) {
    const fe x = load16(x_in, B, lane);
    fe y2, y, c;
    fe_sqr_to(y2, x);
    fe_mul_to(y2, y2, x);
    fe seven = fe_zero();
    seven.v[0] = 7;
    fe_add_to(y2, y2, seven);
    fe_pow_sqrt_to(y, y2);
    y = fe_canon(y);
    fe_sqr_to(c, y);
    fe_sub_to(c, c, y2);
    ok_out[lane] = fe_is_zero(c);
    store16(y_out, B, lane, lift_x_even(y));
}

#ifdef __CUDACC__
__global__ void lift_x_kernel(const uint32_t* x, uint32_t* y, uint32_t* ok,
                              int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) lift_x_lane(x, y, ok, B, lane);
}

// warps an SM holds at once for lift_x's launches; < 0: -(error)
extern "C" int secp_lift_x_warps() {
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, lift_x_kernel, 128, 0);
    return e ? -(int)e : blocks * 4;
}

extern "C" int secp_lift_x(const uint32_t* x, uint32_t* y, uint32_t* ok,
                           int B, void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    lift_x_kernel<<<(B + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(x, y, ok, B);
    return (int)cudaGetLastError();
}
#endif
