// ecdsa_finish: jacobian R = k*G and the canonical scalars k, m, d -> the
// ECDSA signature (r, s), its recovery id and a validity flag.
//
// Replaces the TPU kernel _ecdsa_finish_kernel (ops/pallas_gen.py,
// ecdsa_sign_finish_tpu), everything after R = k*G in the reference's
// ecdsa_sig_sign: affine x, y from the inverse of Z (canonicalised here
// first: inputs may be weak), r = x mod n — x < p < 2n, so one
// conditional subtract whose carry is the reference's overflow flag —,
// s = k^-1 (m + r d) with the inverse of k mod n, the low-S rule s -> n - s
// where s > (n-1)/2, recid = ((overflow ? 2 : 0) | y odd) ^ high and ok =
// (r != 0) & (s != 0).  Outputs: canonical r, s limbs and meta rows
// (recid, ok).  Z = 0 (or the weak zero p) and k = 0 invert to 0.
//
// Design for Hopper (batch_inv.cuh): a thread takes K lanes strided by
// the thread count and runs both inverses of a lane as two chains of
// Montgomery's trick in one forward and one backward pass — two
// accumulators, Z's products mod p and k's mod n, two modinv30 calls for
// the K lanes, Z's prefixes waiting in r's rows and k's in s's rows.  The
// wrapper picks K from the batch and the SM count (cuda_gen.finish_group:
// K = 1 until the batch fills the card).  On the inlined core: 0 B stack.
//
// Secrets: k and d are secret, and one inverse of k's products serves the
// K lanes of a thread.  The inverse is the fixed-iteration divsteps of
// modinv.cuh; a zero Z or k enters the products as 1 and leaves as 0 by a
// select; every other choice is a select too; K and the grouping depend
// only on B and the lane index, and nothing branches on or addresses by a
// value.  k's prefix products live only in registers and in the s rows of
// this launch, which each lane's own s overwrites before the kernel ends.
//
// Bound on this card: operations — the function's least work a lane is
// two inverses by Montgomery's trick over 32 lanes (1/32 of a safegcd and
// 3 products each), a squaring and 3 field multiplies, 2 scalar
// multiplies, against 6 x 16 words in and 34 words out; the kernel's
// inverses are shared by K <= 8 lanes only.
#include "batch_inv.cuh"

// lane's r, s, meta from its inverses zinv = 1 / Z, kinv = 1 / k (weak)
SECP_INLINE void ecdsa_finish_out(const uint32_t* x_in, const uint32_t* y_in,
                                  const uint32_t* m_in, const uint32_t* d_in,
                                  const fe& zinv, const sc& kinv,
                                  uint32_t* r_out, uint32_t* s_out,
                                  uint32_t* meta, int B, int lane) {
    const uint32_t RED[5] = SECP_RED_N_WORDS;
    const uint32_t NH[8] = SECP_N_HALF_WORDS;
    fe X = load16(x_in, B, lane);
    fe Y = load16(y_in, B, lane);
    fe zi2;
    fe_sqr_to(zi2, zinv);
    fe_mul_to(X, X, zi2);
    fe_mul_to(zi2, zi2, zinv);
    fe_mul_to(Y, Y, zi2);
    X = fe_canon(X);
    const uint32_t y_odd = fe_canon(Y).v[0] & 1u;

    // r = x mod n: x >= n  <=>  x + (2^256 - n) carries out
    sc t;
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)X.v[i] + (i < 5 ? RED[i] : 0u);
        t.v[i] = (uint32_t)c; c >>= 32;
    }
    const uint32_t ovf = (uint32_t)c;
    const sc r = select256(ovf, t, X);

    sc u = load16(d_in, B, lane);
    sc_mul_to(u, r, u);
    u = sc_add(load16(m_in, B, lane), sc_canon(u));
    sc s;
    sc_mul_to(s, kinv, u);
    s = sc_canon(s);
    const uint32_t high = sc_gt(s, NH);
    s = select256(high, sc_neg(s), s);

    uint32_t rnz = 0, snz = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) { rnz |= r.v[i]; snz |= s.v[i]; }
    store16(r_out, B, lane, r);
    store16(s_out, B, lane, s);
    meta[lane] = ((ovf << 1) | y_odd) ^ high;
    meta[(size_t)B + lane] = (uint32_t)(rnz != 0) & (uint32_t)(snz != 0);
}

// thread t's group of K lanes: both chains forward, their two inverses,
// both chains backward with each lane's r, s, meta
SECP_DEV void ecdsa_finish_group(const uint32_t* x_in, const uint32_t* y_in,
                                 const uint32_t* z_in, const uint32_t* k_in,
                                 const uint32_t* m_in, const uint32_t* d_in,
                                 uint32_t* r_out, uint32_t* s_out,
                                 uint32_t* meta, int B, int K, int t) {
    const int S = (B + K - 1) / K;
    const size_t ld = (size_t)B;
    uint32_t zz, zk;
    fe accz, z;
    sc acck, k;
    int n = 0;                          // the group's lanes below B
#pragma unroll 1
    for (int lane = t; n < K && lane < B; ++n, lane += S) {
        const bool keep = batch_keep(n, lane, K, S, B);
        z = batch_enter<batch_mod_p>(load16(z_in, B, lane), zz);
        batch_forward<batch_mod_p>(accz, z, n, keep, r_out + lane, ld);
        k = batch_enter<batch_mod_n>(load16(k_in, B, lane), zk);
        batch_forward<batch_mod_n>(acck, k, n, keep, s_out + lane, ld);
    }
    fe uz = batch_invert<batch_mod_p>(accz);
    sc uk = batch_invert<batch_mod_n>(acck);
    fe zinv;
    sc kinv;
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {
        const int lane = t + i * S;
        z = batch_enter<batch_mod_p>(load16(z_in, B, lane), zz);
        batch_backward<batch_mod_p>(zinv, uz, z, zz, i, r_out + lane - S,
                                    ld);
        k = batch_enter<batch_mod_n>(load16(k_in, B, lane), zk);
        batch_backward<batch_mod_n>(kinv, uk, k, zk, i, s_out + lane - S,
                                    ld);
        ecdsa_finish_out(x_in, y_in, m_in, d_in, zinv, kinv, r_out, s_out,
                         meta, B, lane);
    }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SECP_BATCH_THREADS)
ecdsa_finish_kernel(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                    const uint32_t* k, const uint32_t* m, const uint32_t* d,
                    uint32_t* r, uint32_t* s, uint32_t* meta, int B, int K) {
    const int t = blockIdx.x * SECP_BATCH_THREADS + threadIdx.x;
    if (t < (B + K - 1) / K)
        ecdsa_finish_group(x, y, z, k, m, d, r, s, meta, B, K, t);
}

extern "C" int secp_ecdsa_finish(const uint32_t* x, const uint32_t* y,
                                 const uint32_t* z, const uint32_t* k,
                                 const uint32_t* m, const uint32_t* d,
                                 uint32_t* r, uint32_t* s, uint32_t* meta,
                                 int B, int K, void* stream) {
    if (B <= 0 || K <= 0) return 0;
    const int threads = (B + K - 1) / K;
    ecdsa_finish_kernel<<<(threads + SECP_BATCH_THREADS - 1)
                              / SECP_BATCH_THREADS,
                          SECP_BATCH_THREADS, 0, (cudaStream_t)stream>>>(
        x, y, z, k, m, d, r, s, meta, B, K);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for this kernel's launches; < 0: -(error)
extern "C" int secp_ecdsa_finish_warps(void) {
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ecdsa_finish_kernel, SECP_BATCH_THREADS, 0);
    return e ? -(int)e : blocks * (SECP_BATCH_THREADS / 32);
}
#endif
