// sha256: k SHA-256 compressions a lane, all blocks of a message in one
// launch.
//
// No TPU kernel behind it: on the TPU the compression is XLA glue
// (ops/sha256.py _compress_scan), which XLA fuses into a loop.  Eager
// PyTorch would launch each of the ~3,800 elementwise operations of a
// compression on its own (40-75 ms of host time per hash whatever the
// batch), so the port's compression is this kernel; its plain version is
// ops/sha256.py compress_plain, block by block.
//
// Operands: state [8, B] and blocks [16k, B], 32-bit big-endian message
// words as SHA-256 reads them, lane innermost; out: state [8, B].
//
// Bound on this card: operations — 2,296 32-bit logic and add operations
// a block (64 rounds of 26, 48 schedule words of 13, 8 final adds)
// against 16 words of message a block and 16 words of state.  One thread
// per lane; the rounds are unrolled, so the 16-word schedule window and
// the eight working words stay in registers and K is immediate operands.
#include "common.cuh"

#ifdef __CUDACC__
#define SECP_SHA_CONST static __constant__ const
#else
#define SECP_SHA_CONST static const
#endif

SECP_SHA_CONST uint32_t SHA256_K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

SECP_INLINE uint32_t rotr32(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

SECP_DEV void sha256_lane(const uint32_t* st_in, const uint32_t* blocks,
                          uint32_t* st_out, int nblk, int B, int lane) {
    uint32_t s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = st_in[(size_t)i * B + lane];
#pragma unroll 1
    for (int blk = 0; blk < nblk; ++blk) {
        uint32_t w[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
            w[i] = blocks[(size_t)(16 * blk + i) * B + lane];
        uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
        uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
        for (int t = 0; t < 64; ++t) {
            uint32_t wt;
            if (t < 16) {
                wt = w[t];
            } else {
                // w[t & 15] still holds w[t - 16]
                uint32_t x = w[(t - 15) & 15], y = w[(t - 2) & 15];
                uint32_t s0 = rotr32(x, 7) ^ rotr32(x, 18) ^ (x >> 3);
                uint32_t s1 = rotr32(y, 17) ^ rotr32(y, 19) ^ (y >> 10);
                wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
                w[t & 15] = wt;
            }
            uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = h + S1 + ch + SHA256_K[t] + wt;
            uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + maj;
            h = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        s[0] += a; s[1] += b; s[2] += c; s[3] += d;
        s[4] += e; s[5] += f; s[6] += g; s[7] += h;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) st_out[(size_t)i * B + lane] = s[i];
}

#ifdef __CUDACC__
__global__ void sha256_kernel(const uint32_t* state, const uint32_t* blocks,
                              uint32_t* out, int nblk, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) sha256_lane(state, blocks, out, nblk, B, lane);
}

extern "C" int secp_sha256(const uint32_t* state, const uint32_t* blocks,
                           uint32_t* out, int nblk, int B, void* stream) {
    if (B <= 0 || nblk <= 0) return 0;
    const int threads = 128;
    sha256_kernel<<<(B + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(state, blocks, out, nblk, B);
    return (int)cudaGetLastError();
}
#endif
