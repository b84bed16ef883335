// ecdsa_finish: jacobian R = k*G and the canonical scalars k, m, d -> the
// ECDSA signature (r, s), its recovery id and a validity flag.
//
// Replaces the TPU kernel _ecdsa_finish_kernel (ops/pallas_gen.py,
// ecdsa_sign_finish_tpu), everything after R = k*G in the reference's
// ecdsa_sig_sign: affine x, y from one safegcd inverse of Z (canonicalised
// here first: inputs may be weak), r = x mod n — x < p < 2n, so one
// conditional subtract whose carry is the reference's overflow flag —,
// s = k^-1 (m + r d) with the second safegcd inverse (mod n), the low-S
// rule s -> n - s where s > (n-1)/2, recid = ((overflow ? 2 : 0) | y odd)
// ^ high and ok = (r != 0) & (s != 0).  Outputs: canonical r, s limbs and
// meta rows (recid, ok).
//
// k and d are secrets: both inverses are the fixed-iteration divsteps of
// modinv.cuh, every choice is a select, and nothing branches on the data
// or addresses by it.
// Bound on this card: operations — two inverses (600 divsteps and 20 limb
// updates each) and 4 field plus 2 scalar multiplies against 6 x 16 words
// in and 34 words out a lane.  One thread per lane, all in registers.
#include "modinv.cuh"
#include "fe.cuh"
#include "sc.cuh"

SECP_DEV void ecdsa_finish_lane(const uint32_t* x_in, const uint32_t* y_in,
                                const uint32_t* z_in, const uint32_t* k_in,
                                const uint32_t* m_in, const uint32_t* d_in,
                                uint32_t* r_out, uint32_t* s_out,
                                uint32_t* meta, int B, int lane) {
    const uint32_t RED[5] = SECP_RED_N_WORDS;
    const uint32_t NH[8] = SECP_N_HALF_WORDS;
    fe X = load16(x_in, B, lane);
    fe Y = load16(y_in, B, lane);
    fe Z = load16(z_in, B, lane);
    fe zinv = modinv_p(fe_canon(Z));
    fe zi2 = fe_sqr(zinv);
    fe zi3 = fe_mul(zi2, zinv);
    fe xa = fe_canon(fe_mul(X, zi2));
    fe ya = fe_canon(fe_mul(Y, zi3));
    uint32_t y_odd = ya.v[0] & 1u;

    // r = x mod n: x >= n  <=>  x + (2^256 - n) carries out
    sc t;
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (u64)xa.v[i] + (i < 5 ? RED[i] : 0u);
        t.v[i] = (uint32_t)c; c >>= 32;
    }
    uint32_t ovf = (uint32_t)c;
    sc r = select256(ovf, t, xa);

    sc k = load16(k_in, B, lane);
    sc m = load16(m_in, B, lane);
    sc d = load16(d_in, B, lane);
    sc kinv = modinv_n(k);
    sc u = sc_add(m, sc_canon(sc_mul(r, d)));
    sc s = sc_canon(sc_mul(kinv, u));
    uint32_t high = sc_gt(s, NH);
    s = select256(high, sc_neg(s), s);

    uint32_t rnz = 0, snz = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) { rnz |= r.v[i]; snz |= s.v[i]; }
    store16(r_out, B, lane, r);
    store16(s_out, B, lane, s);
    meta[lane] = ((ovf << 1) | y_odd) ^ high;
    meta[(size_t)B + lane] = (uint32_t)(rnz != 0) & (uint32_t)(snz != 0);
}

#ifdef __CUDACC__
__global__ void ecdsa_finish_kernel(const uint32_t* x, const uint32_t* y,
                                    const uint32_t* z, const uint32_t* k,
                                    const uint32_t* m, const uint32_t* d,
                                    uint32_t* r, uint32_t* s, uint32_t* meta,
                                    int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) ecdsa_finish_lane(x, y, z, k, m, d, r, s, meta, B, lane);
}

extern "C" int secp_ecdsa_finish(const uint32_t* x, const uint32_t* y,
                                 const uint32_t* z, const uint32_t* k,
                                 const uint32_t* m, const uint32_t* d,
                                 uint32_t* r, uint32_t* s, uint32_t* meta,
                                 int B, void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    ecdsa_finish_kernel<<<(B + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(x, y, z, k, m, d, r, s,
                                                  meta, B);
    return (int)cudaGetLastError();
}
#endif
