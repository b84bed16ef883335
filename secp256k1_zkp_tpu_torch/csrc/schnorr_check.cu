// schnorr_check: BIP-340 acceptance of a jacobian R = (X, Y, Z) against r.
//
// Replaces the TPU kernel _schnorr_check_kernel (ops/pallas_field.py,
// schnorr_check_tpu): ok = not infinity, X == r * Z^2 (x(R) == r without
// an inverse; r is a field element, so there is no r + n candidate), and
// the affine y = Y * Z^-3 even, which needs the one inverse: safegcd
// modinv_p (modinv.cuh), with inv(0) = 0 so infinity lanes (z = 0) run the
// same code and are masked by inf.
//
// Bound on this card: operations — the inverse (600 divsteps and 20 limb
// updates) and 5 field multiplies against 65 words of traffic a lane.
// One thread per lane, everything in registers, no branch on the data.
#include "modinv.cuh"
#include "fe.cuh"

SECP_DEV void schnorr_check_lane(const uint32_t* x_in, const uint32_t* y_in,
                                 const uint32_t* z_in, const uint32_t* inf_in,
                                 const uint32_t* rx_in, uint32_t* ok_out,
                                 int B, int lane) {
    fe X = load16(x_in, B, lane);
    fe Y = load16(y_in, B, lane);
    fe Z = load16(z_in, B, lane);
    fe xr = load16(rx_in, B, lane);
    uint32_t inf = inf_in[lane] & 1u;
    uint32_t eq = fe_is_zero(fe_sub(fe_mul(xr, fe_sqr(Z)), X));
    fe w = modinv_p(fe_canon(Z));
    fe w3 = fe_mul(fe_sqr(w), w);
    fe yaff = fe_canon(fe_mul(Y, w3));
    uint32_t even = (yaff.v[0] & 1u) ^ 1u;
    ok_out[lane] = eq & even & (inf ^ 1u);
}

#ifdef __CUDACC__
__global__ void schnorr_check_kernel(const uint32_t* x, const uint32_t* y,
                                     const uint32_t* z, const uint32_t* inf,
                                     const uint32_t* rx, uint32_t* ok,
                                     int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) schnorr_check_lane(x, y, z, inf, rx, ok, B, lane);
}

extern "C" int secp_schnorr_check(const uint32_t* x, const uint32_t* y,
                                  const uint32_t* z, const uint32_t* inf,
                                  const uint32_t* rx, uint32_t* ok, int B,
                                  void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    schnorr_check_kernel<<<(B + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(x, y, z, inf, rx, ok, B);
    return (int)cudaGetLastError();
}
#endif
