// glv_only: canonical scalar k -> the GLV digit streams of ecmult_glv.
//
// Replaces the TPU kernel _glv_only_kernel (ops/pallas_scalar.py,
// glv_split_tpu): the lambda split of k into |a1|, |a2| < 2^128 with signs
// (k === (-1)^neg1 a1 + lambda (-1)^neg2 a2 mod n), the signed-w5 rows of
// |a1| (digs rows 0-25) and |a2| (rows 26-51), MSB-first, mag | sign<<8,
// and the flags (neg1, neg2).  It is ecdsa_prep.cu without the inverse and
// the u1/u2 products; the Schnorr path runs it on the challenge e.
//
// Bound on this card: bytes, nearly — about 600 32-bit multiply-adds a
// lane (two 8x8 products with the g constants, two short products with
// the lattice vectors, one modular multiply by lambda) against 16 words in
// and 54 words out.  One thread per lane; rows are written with the lane
// innermost so a warp's stores are contiguous.
#include "sc.cuh"

SECP_DEV void glv_only_lane(const uint32_t* k_in, uint32_t* digs,
                            uint32_t* flags, int B, int lane) {
    sc k = load16(k_in, B, lane);
    uint32_t a1[4], a2[4], neg1, neg2;
    sc_glv_split(k, a1, &neg1, a2, &neg2);
    sc_recode_signed<4, 128, 5>(digs, B, lane, a1);
    sc_recode_signed<4, 128, 5>(digs + (size_t)26 * B, B, lane, a2);
    flags[lane] = neg1;
    flags[(size_t)B + lane] = neg2;
}

#ifdef __CUDACC__
__global__ void glv_only_kernel(const uint32_t* k, uint32_t* digs,
                                uint32_t* flags, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) glv_only_lane(k, digs, flags, B, lane);
}

extern "C" int secp_glv_only(const uint32_t* k, uint32_t* digs,
                             uint32_t* flags, int B, void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    glv_only_kernel<<<(B + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(k, digs, flags, B);
    return (int)cudaGetLastError();
}
#endif
