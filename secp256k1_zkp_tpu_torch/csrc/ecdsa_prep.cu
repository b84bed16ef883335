// ecdsa_prep: m, r, s (canonical scalars) -> the digit streams of verify.
//
// Replaces the TPU kernel _ecdsa_prep_kernel (ops/pallas_scalar.py,
// ecdsa_prep_tpu): s^-1 mod n by safegcd divsteps, u1 = m/s, u2 = r/s, the
// GLV lambda split of u2, signed-w5 rows of |a1|, |a2| (rows 0-25, 26-51 of
// digs, MSB-first, mag | sign<<8), signed-w7 comb rows of u1 (gdigs) and the
// split's sign flags.  s = 0 gives s^-1 = 0 and all-zero digits.
//
// Bound on this card: operations.  600 divsteps of ~20 integer
// instructions and 20 limb updates of ~150 multiply-adds dominate; the
// traffic is 3 x 64 bytes in and 91 words out per lane.  One thread per
// lane, everything in registers, no branch on the data; rows are written
// with the lane innermost so a warp's stores are contiguous.
#include "modinv.cuh"
#include "sc.cuh"

SECP_DEV void ecdsa_prep_lane(const uint32_t* m_in, const uint32_t* r_in,
                              const uint32_t* s_in, uint32_t* digs,
                              uint32_t* gdigs, uint32_t* flags, int B,
                              int lane) {
    sc m = load16(m_in, B, lane);
    sc r = load16(r_in, B, lane);
    sc s = load16(s_in, B, lane);
    sc sinv = modinv_n(s);
    sc u1 = sc_canon(sc_mul(m, sinv));
    sc u2 = sc_canon(sc_mul(r, sinv));
    uint32_t a1[4], a2[4], neg1, neg2;
    sc_glv_split(u2, a1, &neg1, a2, &neg2);
    sc_recode_signed<4, 128, 5>(digs, B, lane, a1);
    sc_recode_signed<4, 128, 5>(digs + (size_t)26 * B, B, lane, a2);
    sc_recode_signed<8, 256, 7>(gdigs, B, lane, u1.v);
    flags[lane] = neg1;
    flags[(size_t)B + lane] = neg2;
}

#ifdef __CUDACC__
__global__ void ecdsa_prep_kernel(const uint32_t* m, const uint32_t* r,
                                  const uint32_t* s, uint32_t* digs,
                                  uint32_t* gdigs, uint32_t* flags, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) ecdsa_prep_lane(m, r, s, digs, gdigs, flags, B, lane);
}

extern "C" int secp_ecdsa_prep(const uint32_t* m, const uint32_t* r,
                               const uint32_t* s, uint32_t* digs,
                               uint32_t* gdigs, uint32_t* flags, int B,
                               void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    ecdsa_prep_kernel<<<(B + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(m, r, s, digs, gdigs, flags,
                                                B);
    return (int)cudaGetLastError();
}
#endif
