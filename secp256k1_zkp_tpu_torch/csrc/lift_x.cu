// lift_x: BIP-340 x -> the even square root y of x^3 + 7, and a validity
// mask.
//
// Replaces the TPU kernel _lift_x_kernel (ops/pallas_field.py, lift_x_tpu).
// y2 = x^3 + 7, y = y2^((p+1)/4), ok = (y^2 == y2), and y is replaced by
// p - y where it is odd; out: canonical y and ok.  The TPU kernel powers by
// 64 4-bit windows read from scalar memory; the exponent is a constant, so
// here it is the reference's fixed sqrt chain (fe_pow_sqrt, fe.cuh): the
// same canonical value with 266 field operations instead of 320.  Lanes
// that are no square (or x >= p, which the caller parses as x - p) still
// return the even-selected y2^((p+1)/4); the caller masks them.
//
// Bound on this card: operations — 255 squarings and 14 multiplies a lane
// (~12,000 32-bit multiply-adds) against 33 words of traffic.  One thread
// per lane, everything in registers; the chain is one dependent sequence,
// so the latency of a squaring is hidden only by other warps.
#include "fe.cuh"

SECP_DEV void lift_x_lane(const uint32_t* x_in, uint32_t* y_out,
                          uint32_t* ok_out, int B, int lane) {
    fe x = load16(x_in, B, lane);
    fe seven = fe_zero();
    seven.v[0] = 7;
    fe y2 = fe_add(fe_mul(fe_sqr(x), x), seven);
    fe y = fe_canon(fe_pow_sqrt(y2));
    uint32_t ok = fe_is_zero(fe_sub(fe_sqr(y), y2));
    // p - y for odd y (y canonical, so y = 0 is even and never negated)
    fe ny = fe_canon(fe_neg(y));
    store16(y_out, B, lane, select256(y.v[0] & 1u, ny, y));
    ok_out[lane] = ok;
}

#ifdef __CUDACC__
__global__ void lift_x_kernel(const uint32_t* x, uint32_t* y, uint32_t* ok,
                              int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) lift_x_lane(x, y, ok, B, lane);
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
