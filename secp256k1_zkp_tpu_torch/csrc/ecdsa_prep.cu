// ecdsa_prep: m, r, s (canonical scalars) -> the digit streams of verify.
//
// Replaces the TPU kernel _ecdsa_prep_kernel (ops/pallas_scalar.py,
// ecdsa_prep_tpu): s^-1 mod n, u1 = m/s, u2 = r/s, the GLV lambda split of
// u2, signed-w5 rows of |a1|, |a2| (rows 0-25, 26-51 of digs, MSB-first,
// mag | sign<<8), signed-w7 comb rows of u1 (gdigs) and the split's sign
// flags.  s = 0 gives s^-1 = 0 and all-zero digits.
//
// Design for Hopper (batch_inv.cuh): a thread takes K lanes strided by
// the thread count and inverts the product of their s once (Montgomery's
// trick over n), the prefixes waiting in rows 0-7 of digs; the wrapper
// picks K from the batch and the SM count (cuda_scalar.prep_group: K = 1
// until the batch fills the card).  The inverse is the fixed-iteration
// divsteps of modinv.cuh, a zero s is a select, and nothing branches on or
// addresses by the data.  Rows are written with the lane innermost, so a
// warp's stores are contiguous.  On the inlined core: 0 B stack.
//
// Bound on this card: operations — the function's least work a lane is
// an inverse by Montgomery's trick over 32 lanes (1/32 of a safegcd and 3
// products), 2 scalar multiplies and the GLV split, against 3 x 16 words
// in and 91 words out; the kernel's inverse is shared by K <= 8 lanes
// only.
#include "batch_inv.cuh"

// lane's digit rows and flags from sinv = 1 / s (weak)
SECP_INLINE void ecdsa_prep_out(const uint32_t* m_in, const uint32_t* r_in,
                                const sc& sinv, uint32_t* digs,
                                uint32_t* gdigs, uint32_t* flags, int B,
                                int lane) {
    sc u1 = load16(m_in, B, lane), u2 = load16(r_in, B, lane);
    sc_mul_to(u1, u1, sinv);
    sc_mul_to(u2, u2, sinv);
    u1 = sc_canon(u1);
    uint32_t a1[4], a2[4], neg1, neg2;
    sc_glv_split_to(sc_canon(u2), a1, neg1, a2, neg2);
    sc_recode_signed<4, 128, 5>(digs, B, lane, a1);
    sc_recode_signed<4, 128, 5>(digs + (size_t)26 * B, B, lane, a2);
    sc_recode_signed<8, 256, 7>(gdigs, B, lane, u1.v);
    flags[lane] = neg1;
    flags[(size_t)B + lane] = neg2;
}

// thread t's group of K lanes: s forward, one inverse, s backward with
// each lane's rows
SECP_DEV void ecdsa_prep_group(const uint32_t* m_in, const uint32_t* r_in,
                               const uint32_t* s_in, uint32_t* digs,
                               uint32_t* gdigs, uint32_t* flags, int B,
                               int K, int t) {
    const int S = (B + K - 1) / K;
    const size_t ld = (size_t)B;
    uint32_t zero;
    sc acc, s;
    int n = 0;                          // the group's lanes below B
#pragma unroll 1
    for (int lane = t; n < K && lane < B; ++n, lane += S) {
        s = batch_enter<batch_mod_n>(load16(s_in, B, lane), zero);
        batch_forward<batch_mod_n>(acc, s, n, batch_keep(n, lane, K, S, B),
                                   digs + lane, ld);
    }
    sc u = batch_invert<batch_mod_n>(acc);
    sc sinv;
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {
        const int lane = t + i * S;
        s = batch_enter<batch_mod_n>(load16(s_in, B, lane), zero);
        batch_backward<batch_mod_n>(sinv, u, s, zero, i, digs + lane - S, ld);
        ecdsa_prep_out(m_in, r_in, sinv, digs, gdigs, flags, B, lane);
    }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SECP_BATCH_THREADS)
ecdsa_prep_kernel(const uint32_t* m, const uint32_t* r, const uint32_t* s,
                  uint32_t* digs, uint32_t* gdigs, uint32_t* flags, int B,
                  int K) {
    const int t = blockIdx.x * SECP_BATCH_THREADS + threadIdx.x;
    if (t < (B + K - 1) / K)
        ecdsa_prep_group(m, r, s, digs, gdigs, flags, B, K, t);
}

extern "C" int secp_ecdsa_prep(const uint32_t* m, const uint32_t* r,
                               const uint32_t* s, uint32_t* digs,
                               uint32_t* gdigs, uint32_t* flags, int B, int K,
                               void* stream) {
    if (B <= 0 || K <= 0) return 0;
    const int threads = (B + K - 1) / K;
    ecdsa_prep_kernel<<<(threads + SECP_BATCH_THREADS - 1)
                            / SECP_BATCH_THREADS,
                        SECP_BATCH_THREADS, 0, (cudaStream_t)stream>>>(
        m, r, s, digs, gdigs, flags, B, K);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for this kernel's launches; < 0: -(error)
extern "C" int secp_ecdsa_prep_warps(void) {
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ecdsa_prep_kernel, SECP_BATCH_THREADS, 0);
    return e ? -(int)e : blocks * (SECP_BATCH_THREADS / 32);
}
#endif
