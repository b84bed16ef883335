// affine_xy: jacobian (X, Y, Z) -> canonical affine (x, y).
//
// Replaces the TPU kernel _affine_xy_kernel (ops/pallas_gen.py,
// affine_xy_tpu): one safegcd inverse of Z (canonicalised first), then
// x = X Z^-2, y = Y Z^-3.  Infinity lanes (Z = 0) give zeros, because
// modinv_p(0) = 0; they run the same code.  The sign paths serialize the
// public key and the nonce point R with it and read y's parity.
//
// The point is d*G or k*G for a secret d or k: the inverse is the
// fixed-iteration divsteps of modinv.cuh and nothing branches on the data.
// Bound on this card: operations — the inverse (600 divsteps and 20 limb
// updates) and 4 field multiplies against 48 words in and 32 out a lane.
// One thread per lane, all in registers.
#include "modinv.cuh"
#include "fe.cuh"

SECP_DEV void affine_xy_lane(const uint32_t* x_in, const uint32_t* y_in,
                             const uint32_t* z_in, uint32_t* ax_out,
                             uint32_t* ay_out, int B, int lane) {
    fe X = load16(x_in, B, lane);
    fe Y = load16(y_in, B, lane);
    fe Z = load16(z_in, B, lane);
    fe zinv = modinv_p(fe_canon(Z));
    fe zi2 = fe_sqr(zinv);
    fe zi3 = fe_mul(zi2, zinv);
    store16(ax_out, B, lane, fe_canon(fe_mul(X, zi2)));
    store16(ay_out, B, lane, fe_canon(fe_mul(Y, zi3)));
}

#ifdef __CUDACC__
__global__ void affine_xy_kernel(const uint32_t* x, const uint32_t* y,
                                 const uint32_t* z, uint32_t* ax,
                                 uint32_t* ay, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) affine_xy_lane(x, y, z, ax, ay, B, lane);
}

extern "C" int secp_affine_xy(const uint32_t* x, const uint32_t* y,
                              const uint32_t* z, uint32_t* ax, uint32_t* ay,
                              int B, void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    affine_xy_kernel<<<(B + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(x, y, z, ax, ay, B);
    return (int)cudaGetLastError();
}
#endif
