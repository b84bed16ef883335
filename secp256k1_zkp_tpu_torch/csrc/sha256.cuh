// SHA-256 on the card: the compression, the in-kernel padding of a byte
// message, the coalesced staging of byte rows through shared memory, the
// RFC6979 HMAC-DRBG lane and the BIP-340 batch tree's hashes.
//
// Shared by the four kernels of sha256.cu (sha256_blocks, sha256_msg,
// rfc6979, batch_digest).  Like the field library it compiles as plain C++
// too, so tests/torch_b0_harness.cpp runs every piece here on the host
// (the block-level loops of the kernels written out over their threads).
//
// A digest or a state is eight 32-bit words, SHA-256's own big-endian
// words; a byte message is read as SHA-256 reads it: byte 4j is the top
// byte of word j.  Every lane runs a fixed sequence of compressions that
// depends on the lengths alone, never on the data (RFC6979's key material
// is secret).
#pragma once
#include "common.cuh"

#ifdef __CUDACC__
#define SECP_SHA_CONST static __constant__ const
#define SECP_SHA_HD __host__ __device__ __forceinline__
#else
#define SECP_SHA_CONST static const
#define SECP_SHA_HD inline
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

#define SECP_SHA_IV {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au, \
                     0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u}

// a start state (the IV, a tag's midstate, an HMAC key's pad state),
// passed to a kernel by value
struct sha_st { uint32_t h[8]; };

SECP_INLINE uint32_t rotr32(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

// the word of four bytes as stored (little-endian) <-> SHA-256's
// big-endian word
SECP_INLINE uint32_t bswap32(uint32_t x) {
#ifdef __CUDACC__
    return __byte_perm(x, 0, 0x0123);
#else
    return __builtin_bswap32(x);
#endif
}

// floor(a * m / 2^32)
SECP_INLINE uint32_t umulhi32(uint32_t a, uint32_t m) {
#ifdef __CUDACC__
    return __umulhi(a, m);
#else
    return (uint32_t)(((u64)a * m) >> 32);
#endif
}

// a / d for a * d < 2^32 by a multiply-high with m = sha_magic(d), the
// least m >= 2^32 / d (d = 1 has no such 32-bit m)
SECP_INLINE uint32_t sha_magic(uint32_t d) { return 0xFFFFFFFFu / d + 1u; }

SECP_INLINE int sha_div(int a, int d, uint32_t m) {
    return d == 1 ? a : (int)umulhi32((uint32_t)a, m);
}

// s <- the compression of the block w into s (w is the schedule window and
// is clobbered).  Unrolled: the window and the eight working words stay in
// registers and K is immediate operands.
SECP_INLINE void sha256_block(uint32_t (&s)[8], uint32_t (&w)[16]) {
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

// --- byte messages ---------------------------------------------------------

// Bytes of a message are staged a chunk at a time: up to SECP_SHA_CHUNK
// bytes (four blocks) of each of a block's rows, row r at word r * S of
// shared memory.  S (words a row) is odd, so the lanes' reads of one word
// of their rows fall in different banks.
#define SECP_SHA_CHUNK 256

// words a row of shared memory for messages of L bytes (the entry point
// sizes the launch's shared memory by it)
SECP_SHA_HD int sha_row_words(int L) {
    int w = (L < SECP_SHA_CHUNK ? L + 3 : SECP_SHA_CHUNK) >> 2;
    return w | 1;
}

// Thread t of T stages the bytes [c0, c0 + clen) of the rows [0, rows) of
// a row-major byte matrix g (rows of L bytes) into sm (row r's byte c at
// byte 4 * S * r + c - c0): thread t takes the t-th, (t + T)-th, ... byte
// (or word) of the rows' run, so neighbouring threads read neighbouring
// addresses.  words: whole words move (L, c0, clen multiples of 4 and g
// word-aligned); else bytes.  The row and column of an index come from a
// multiply-high by sha_magic, not a division.
SECP_INLINE void sha_stage(uint32_t* sm, int S, const uint8_t* g, int L,
                           int c0, int clen, int rows, bool words, int t,
                           int T) {
    if (clen <= 0) return;
    if (words) {
        const int W = clen >> 2;
        const uint32_t m = sha_magic((uint32_t)W);
        const int n = rows * W;
        for (int i = t; i < n; i += T) {
            const int r = sha_div(i, W, m);
            const int c = i - r * W;
            sm[r * S + c] = *(const uint32_t*)(g + (size_t)r * L + c0 + 4 * c);
        }
    } else {
        const uint32_t m = sha_magic((uint32_t)clen);
        const int n = rows * clen;
        uint8_t* smb = (uint8_t*)sm;
        for (int i = t; i < n; i += T) {
            const int r = sha_div(i, clen, m);
            const int c = i - r * clen;
            smb[4 * S * r + c] = g[(size_t)r * L + c0 + c];
        }
    }
}

// The padded message's word at byte offset o (a multiple of 4) of the
// message: data below L, then 0x80, then zeros; raw is the four bytes at o
// as staged (read only where o < L).  The length words are the caller's.
SECP_INLINE uint32_t sha_pad_word(uint32_t raw, int o, int L) {
    const int k = L - o;                  // data bytes in this word
    if (k >= 4) return bswap32(raw);
    if (k < 0) return 0;
    const uint32_t w = k ? bswap32(raw) & (0xFFFFFFFFu << (32 - 8 * k)) : 0;
    return w | (0x80u << (24 - 8 * k));
}

// Absorb the blocks of chunk k of one lane's message (L bytes, its chunk
// staged at row, bitlen the length field of the whole hash) into s.
SECP_INLINE void sha_msg_chunk(uint32_t (&s)[8], const uint32_t* row, int L,
                               int k, int nblk, uint32_t len_hi,
                               uint32_t len_lo) {
    const int b0 = k * (SECP_SHA_CHUNK / 64);
    int b1 = b0 + SECP_SHA_CHUNK / 64;
    if (b1 > nblk) b1 = nblk;
#pragma unroll 1
    for (int b = b0; b < b1; ++b) {
        uint32_t w[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int o = 64 * b + 4 * i;
            const uint32_t raw = o < L ? row[16 * (b - b0) + i] : 0u;
            w[i] = sha_pad_word(raw, o, L);
        }
        if (b == nblk - 1) {
            w[14] = len_hi;
            w[15] = len_lo;
        }
        sha256_block(s, w);
    }
}

// blocks of a hash of L bytes after the start state (padding included)
SECP_INLINE int sha_blocks_of(int L) { return (L + 9 + 63) >> 6; }

// --- RFC6979 ---------------------------------------------------------------
//
// The reference's nonce_function_rfc6979 DRBG (rfc6979_hmac_sha256_*,
// src/hash_impl.h:255-318, with key material kd = seckey || msg32) as one
// fixed program of compressions on the registers of one lane:
//   Ki, Ko  the current key's inner and outer pad states (those of K = 0
//           are the host's constants),
//   V       the DRBG's v, T the working digest (and a new key),
// each step one compression of a start state and a block, its result to
// one of them.  The steps depend on their index alone: a branch on the
// step is the same for every lane.
enum {
    RFC_INNER1,        // T = c(Ki, V || sep || kd bytes 0..30)
    RFC_INNER2,        // T = c(T, kd bytes 31..63 || padding of 97 bytes)
    RFC_OUTER_T,       // T = c(Ko, T || padding): a new key
    RFC_OUTER_V,       // V = c(Ko, T || padding)
    RFC_KEY_I,         // Ki = c(IV, T ^ ipad)
    RFC_KEY_O,         // Ko = c(IV, T ^ opad)
    RFC_INNER_V,       // T = c(Ki, V || padding of 32 bytes)
    RFC_INNER_V0,      // T = c(Ki, V || 0x00 || padding of 33 bytes)
};

// construction (k = HMAC(k, v || 0x00 || kd), v = HMAC(k, v), then again
// with 0x01), then per candidate v = HMAC(k, v) and, before the next,
// k = HMAC(k, v || 0x00), v = HMAC(k, v)
#define SECP_RFC_INIT_STEPS 14
#define SECP_RFC_ROUND_STEPS 8

SECP_INLINE int rfc_steps(int rounds) {
    return SECP_RFC_INIT_STEPS + SECP_RFC_ROUND_STEPS * (rounds - 1) + 2;
}

// the op of step i, and the separator byte where it is RFC_INNER1
SECP_INLINE int rfc_op(int i, uint32_t& sep) {
    sep = i < 7 ? 0u : 1u;
    if (i < SECP_RFC_INIT_STEPS) {
        switch (i % 7) {
        case 0: return RFC_INNER1;
        case 1: return RFC_INNER2;
        case 2: return RFC_OUTER_T;
        case 3: return RFC_KEY_I;
        case 4: return RFC_KEY_O;
        case 5: return RFC_INNER_V;
        default: return RFC_OUTER_V;
        }
    }
    switch ((i - SECP_RFC_INIT_STEPS) % SECP_RFC_ROUND_STEPS) {
    case 0: return RFC_INNER_V;
    case 1: return RFC_OUTER_V;            // a candidate
    case 2: return RFC_INNER_V0;
    case 3: return RFC_OUTER_T;
    case 4: return RFC_KEY_I;
    case 5: return RFC_KEY_O;
    case 6: return RFC_INNER_V;
    default: return RFC_OUTER_V;
    }
}

// the candidate that step i leaves in V, or -1
SECP_INLINE int rfc_emits(int i) {
    if (i < SECP_RFC_INIT_STEPS) return -1;
    const int j = i - SECP_RFC_INIT_STEPS;
    return j % SECP_RFC_ROUND_STEPS == 1 ? j / SECP_RFC_ROUND_STEPS : -1;
}

// The lane: kd the 16 big-endian words of seckey || msg32, k0 the inner
// and outer pad states of the all-zero key; out(r, V) takes candidate r.
template <typename Out>
SECP_INLINE void rfc6979_lane(const uint32_t (&kd)[16], const sha_st& k0i,
                              const sha_st& k0o, int rounds, Out out) {
    const uint32_t IV[8] = SECP_SHA_IV;
    uint32_t Ki[8], Ko[8], V[8], T[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        Ki[i] = k0i.h[i];
        Ko[i] = k0o.h[i];
        V[i] = 0x01010101u;
        T[i] = 0;
    }
    const int steps = rfc_steps(rounds);
#pragma unroll 1
    for (int step = 0; step < steps; ++step) {
        uint32_t sep;
        const int op = rfc_op(step, sep);
        uint32_t s[8], w[16];
        // the start state
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            s[i] = op == RFC_INNER2 ? T[i]
                 : (op == RFC_OUTER_T || op == RFC_OUTER_V) ? Ko[i]
                 : (op == RFC_KEY_I || op == RFC_KEY_O) ? IV[i] : Ki[i];
        }
        // the block
        if (op == RFC_INNER1) {
#pragma unroll
            for (int i = 0; i < 8; ++i) w[i] = V[i];
            w[8] = (sep << 24) | (kd[0] >> 8);
#pragma unroll
            for (int i = 9; i < 16; ++i)
                w[i] = (kd[i - 9] << 24) | (kd[i - 8] >> 8);
        } else if (op == RFC_INNER2) {
            // bytes 31..63 of kd, 0x80, zeros, (64 + 97) * 8 bits
#pragma unroll
            for (int i = 0; i < 8; ++i)
                w[i] = (kd[i + 7] << 24) | (kd[i + 8] >> 8);
            w[8] = (kd[15] << 24) | 0x00800000u;
#pragma unroll
            for (int i = 9; i < 15; ++i) w[i] = 0;
            w[15] = (64 + 97) * 8;
        } else if (op == RFC_KEY_I || op == RFC_KEY_O) {
            const uint32_t pad = op == RFC_KEY_I ? 0x36363636u : 0x5C5C5C5Cu;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                w[i] = T[i] ^ pad;
                w[8 + i] = pad;
            }
        } else {
            // 32 bytes (a digest or V), or V || 0x00
            const bool sep0 = op == RFC_INNER_V0;
            const bool of_t = op == RFC_OUTER_T || op == RFC_OUTER_V;
#pragma unroll
            for (int i = 0; i < 8; ++i) w[i] = of_t ? T[i] : V[i];
            w[8] = sep0 ? 0x00800000u : 0x80000000u;
#pragma unroll
            for (int i = 9; i < 15; ++i) w[i] = 0;
            w[15] = sep0 ? (64 + 33) * 8 : (64 + 32) * 8;
        }
        sha256_block(s, w);
        // the result
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            if (op == RFC_KEY_I) Ki[i] = s[i];
            else if (op == RFC_KEY_O) Ko[i] = s[i];
            else if (op == RFC_OUTER_V) V[i] = s[i];
            else T[i] = s[i];
        }
        const int r = rfc_emits(step);
        if (r >= 0) out(r, V);
    }
}

// --- the BIP-340 batch tree ------------------------------------------------
//
// Leaves: H_tag("BIP0340/batch/leaf", px || msg || sig), 128 bytes after
// the tag's midstate, three blocks; nodes: H_tag("BIP0340/batch/node",
// a || b), two blocks; a zero node pads each odd level.

// the leaf hash of one staged 128-byte row (32 words as stored)
SECP_INLINE void bd_leaf(uint32_t (&h)[8], const uint32_t* row,
                         const sha_st& mid) {
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = mid.h[i];
#pragma unroll 1
    for (int b = 0; b < 3; ++b) {
        uint32_t w[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
            w[i] = b < 2 ? bswap32(row[16 * b + i]) : 0u;
        if (b == 2) {
            w[0] = 0x80000000u;
            w[15] = (64 + 128) * 8;
        }
        sha256_block(h, w);
    }
}

// h = the node hash of a || b (b null: the zero node); CG: a and b were
// written by other blocks of the launch, so they are read through L2
template <bool CG = false>
SECP_INLINE void bd_node(uint32_t (&h)[8], const uint32_t* a,
                         const uint32_t* b, const sha_st& mid) {
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = mid.h[i];
#pragma unroll 1
    for (int blk = 0; blk < 2; ++blk) {
        uint32_t w[16];
        if (blk == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                w[i] = CG ? SECP_LDCG(a + i) : a[i];
                w[8 + i] = b ? (CG ? SECP_LDCG(b + i) : b[i]) : 0u;
            }
        } else {
#pragma unroll
            for (int i = 1; i < 15; ++i) w[i] = 0;
            w[0] = 0x80000000u;
            w[15] = (64 + 64) * 8;
        }
        sha256_block(h, w);
    }
}

// the node words of a level of cnt nodes (a node i at src + st * i): node
// i of the next level, i < (cnt + 1) / 2, hashes nodes 2i and 2i + 1, the
// zero node where 2i + 1 = cnt
template <bool CG = false>
SECP_INLINE void bd_pair(uint32_t (&h)[8], const uint32_t* src, int st,
                         int cnt, int i, const sha_st& mid) {
    bd_node<CG>(h, src + (size_t)st * (2 * i),
                2 * i + 1 < cnt ? src + (size_t)st * (2 * i + 1) : nullptr,
                mid);
}
