// muladd_n: s = (neg ? n - k : k) + e*d mod n on canonical scalars.
//
// Replaces the TPU kernel _muladd_n_kernel (ops/pallas_gen.py,
// muladd_n_tpu): the BIP-340 signature's s = k + e*d, with the nonce k
// negated where its point R has odd y (neg is R's parity).  Output:
// canonical s limbs.
//
// k and d are secrets: the negation is a select, the product and sum are
// fixed-dataflow, nothing branches on the data.
// Bound on this card: bytes — one 8x8-word product with its reduction
// and two short add chains (~200 32-bit multiply-adds) against 3 x 16
// words and a flag in and 16 words out a lane.  One thread per lane.
#include "sc.cuh"

SECP_DEV void muladd_n_lane(const uint32_t* k_in, const uint32_t* e_in,
                            const uint32_t* d_in, const uint32_t* neg_in,
                            uint32_t* s_out, int B, int lane) {
    sc k = load16(k_in, B, lane);
    sc e = load16(e_in, B, lane);
    sc d = load16(d_in, B, lane);
    uint32_t neg = neg_in[lane] & 1u;
    k = select256(neg, sc_neg(k), k);
    store16(s_out, B, lane, sc_add(k, sc_canon(sc_mul(e, d))));
}

#ifdef __CUDACC__
__global__ void muladd_n_kernel(const uint32_t* k, const uint32_t* e,
                                const uint32_t* d, const uint32_t* neg,
                                uint32_t* s, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) muladd_n_lane(k, e, d, neg, s, B, lane);
}

extern "C" int secp_muladd_n(const uint32_t* k, const uint32_t* e,
                             const uint32_t* d, const uint32_t* neg,
                             uint32_t* s, int B, void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    muladd_n_kernel<<<(B + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(k, e, d, neg, s, B);
    return (int)cudaGetLastError();
}
#endif
