// affine_meta: jacobian (X, Y, Z) -> canonical affine (x, y) and whether
// y is a square, the serialization step of Pedersen commitments and
// generators (the prefix bit of their 33-byte form).
//
// Replaces the TPU kernel _affine_meta_kernel (ops/pallas_field.py,
// affine_meta_tpu): one safegcd inverse of Z (canonicalised first), x =
// X Z^-2, y = Y Z^-3 — the code of affine_xy.cu — and the quadratic
// character of t = Y Z^3, which is y's (they differ by the square Z^6).
// The TPU kernel powers t by (p-1)/2 from a 4-bit digit schedule held in
// scalar memory, a Mosaic artefact; here the character comes from the
// reference's fixed sqrt chain (fe_pow_sqrt, fe.cuh): r = t^((p+1)/4) and
// t is a nonzero square iff r^2 == t.  A root check alone would call
// t = 0 a square; the TPU kernel's character there is 0, not 1, so the
// check is ANDed with t != 0: infinity lanes (Z = 0) and the weak zero
// Z = p give zeros and sq = 0, as on the TPU.
//
// Z belongs to a commitment of a secret blind: the inverse and the chain
// are fixed dataflow, nothing branches on the data.
// Bound on this card: operations — the inverse (600 divsteps and 20 limb
// updates), the chain (253 squarings and 13 multiplies) and 8 more field
// operations (~14,000 32-bit multiply-adds) against 48 words in and 33 out
// a lane.  One thread per lane, all in registers.
#include "modinv.cuh"
#include "fe.cuh"

SECP_DEV void affine_meta_lane(const uint32_t* x_in, const uint32_t* y_in,
                               const uint32_t* z_in, uint32_t* ax_out,
                               uint32_t* ay_out, uint32_t* sq_out, int B,
                               int lane) {
    fe X = load16(x_in, B, lane);
    fe Y = load16(y_in, B, lane);
    fe Z = load16(z_in, B, lane);
    fe zinv = modinv_p(fe_canon(Z));
    fe zi2 = fe_sqr(zinv);
    fe zi3 = fe_mul(zi2, zinv);
    store16(ax_out, B, lane, fe_canon(fe_mul(X, zi2)));
    store16(ay_out, B, lane, fe_canon(fe_mul(Y, zi3)));
    fe t = fe_mul(Y, fe_mul(fe_sqr(Z), Z));
    fe r = fe_pow_sqrt(t);
    uint32_t root = fe_is_zero(fe_sub(fe_sqr(r), t));
    sq_out[lane] = root & (fe_is_zero(t) ^ 1u);
}

#ifdef __CUDACC__
__global__ void affine_meta_kernel(const uint32_t* x, const uint32_t* y,
                                   const uint32_t* z, uint32_t* ax,
                                   uint32_t* ay, uint32_t* sq, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) affine_meta_lane(x, y, z, ax, ay, sq, B, lane);
}

extern "C" int secp_affine_meta(const uint32_t* x, const uint32_t* y,
                                const uint32_t* z, uint32_t* ax, uint32_t* ay,
                                uint32_t* sq, int B, void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    affine_meta_kernel<<<(B + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(x, y, z, ax, ay, sq, B);
    return (int)cudaGetLastError();
}
#endif
