// SHA-256 kernels: four entries on one compression core (sha256.cuh).
//
// No TPU kernel behind them: on the TPU SHA-256 is XLA glue
// (ops/sha256.py _compress_scan), which XLA fuses into a loop.  Eager
// PyTorch would launch each of the ~3,800 elementwise operations of a
// compression on its own, and the padding, the byte-to-word assembly, the
// HMAC chains and the batch tree around them are hundreds more; so:
//
// sha256_blocks: k compressions a lane, word-major [8, B] state and
//   [16k, B] blocks (ops/sha256.compress and the selftest's known answer).
// sha256_msg: a whole hash of a byte message [B, L] in one launch: the
//   block stages its lanes' bytes through shared memory (coalesced), each
//   lane pads and assembles its words in the kernel and absorbs its blocks
//   from a start state (the IV or a tag's midstate, by value, or a lane's
//   own [B, 8] state: HMAC), and writes its digest as [B, 32] bytes.
// rfc6979: the reference's RFC6979 DRBG (ECDSA signing's nonces) from
//   seckey || msg32 [B, 64] to the first `rounds` candidates [rounds, B, 8]
//   in one launch: every HMAC state in registers, each key's pad states
//   computed once, the all-zero key's from the host; 14 + 2 rounds +
//   6 (rounds - 1) compressions a lane (24 for two candidates; the eager
//   chain ran 42).
// batch_digest: BIP-340 batch verification's digest, the root of the
//   tagged leaf hashes of px || msg || sig and the node levels above them,
//   a zero node padding each odd level.  A block hashes its 256 leaves and
//   reduces their subtree in shared memory; with more than one block, each
//   block's root goes to a scratch and the block counts itself done
//   (__threadfence, then an atomic counter the entry point clears); the
//   block that counts last reduces the roots (L2-only loads of what the
//   other blocks wrote), so the whole tree is one launch.  A block's chunk
//   of 256 leaves starts at a multiple of 256, so its subtree is the
//   tree's: the padding of a level falls on the last chunk alone, whose
//   reduction runs all eight levels (a lone node is hashed with the zero
//   node, as the level above it is odd).
//
// Bound on this card: operations — 2,296 32-bit logic and add operations
// a compression against 4 bytes a message word; one thread a lane.
#include "sha256.cuh"

#define SECP_SHA_THREADS 128
#define SECP_BD_THREADS 256       // = the leaves of a block's chunk
#define SECP_BD_LEVELS 8          // log2(SECP_BD_THREADS)
#define SECP_BD_ROW 33            // words a staged leaf row (128 bytes + 1)

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
        sha256_block(s, w);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) st_out[(size_t)i * B + lane] = s[i];
}

// eight words at p (16-byte aligned) <-> registers, two 16-byte accesses
SECP_INLINE void ld8(uint32_t (&s)[8], const uint32_t* p) {
    const uint4 a = ((const uint4*)p)[0], b = ((const uint4*)p)[1];
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

SECP_INLINE void st8(uint32_t* p, const uint32_t (&s)[8], bool be) {
    uint4 a, b;
    a.x = be ? bswap32(s[0]) : s[0]; a.y = be ? bswap32(s[1]) : s[1];
    a.z = be ? bswap32(s[2]) : s[2]; a.w = be ? bswap32(s[3]) : s[3];
    b.x = be ? bswap32(s[4]) : s[4]; b.y = be ? bswap32(s[5]) : s[5];
    b.z = be ? bswap32(s[6]) : s[6]; b.w = be ? bswap32(s[7]) : s[7];
    ((uint4*)p)[0] = a;
    ((uint4*)p)[1] = b;
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

// msg [B, L] bytes; st0 the start state (lane_st null) or lane_st [B, 8];
// out [B, 32] bytes; len the hash's length field (consumed + L bytes, in
// bits); words: msg word-aligned and L a multiple of 4
__global__ void __launch_bounds__(SECP_SHA_THREADS)
sha256_msg_kernel(const uint8_t* msg, int L, sha_st st0,
                  const uint32_t* lane_st, uint32_t len_hi, uint32_t len_lo,
                  uint32_t* out, int B, int words) {
    extern __shared__ uint32_t sm[];
    const int t = threadIdx.x;
    const int first = blockIdx.x * SECP_SHA_THREADS;
    const int rows = min(SECP_SHA_THREADS, B - first);
    const int S = sha_row_words(L);
    const int lane = first + t;
    const bool active = t < rows;
    uint32_t s[8];
    if (lane_st && active) {
        ld8(s, lane_st + (size_t)8 * lane);
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = st0.h[i];
    }
    const int nblk = sha_blocks_of(L);
    const int nchunk = (64 * nblk + SECP_SHA_CHUNK - 1) / SECP_SHA_CHUNK;
    const uint8_t* g = msg + (size_t)first * L;
    for (int k = 0; k < nchunk; ++k) {
        const int c0 = k * SECP_SHA_CHUNK;
        const int clen = min(SECP_SHA_CHUNK, L - c0);
        if (k) __syncthreads();         // the last chunk's reads are done
        sha_stage(sm, S, g, L, c0, clen, rows, words != 0, t,
                  SECP_SHA_THREADS);
        __syncthreads();
        if (active)
            sha_msg_chunk(s, sm + t * S, L, k, nblk, len_hi, len_lo);
    }
    if (active) st8(out + (size_t)8 * lane, s, true);
}

extern "C" int secp_sha256_msg(const uint8_t* msg, int L,
                               const uint32_t* st0, const uint32_t* lane_st,
                               uint32_t len_hi, uint32_t len_lo,
                               uint32_t* out, int B, int words,
                               void* stream) {
    if (B <= 0 || L < 0) return 0;
    sha_st s0;
    for (int i = 0; i < 8; ++i) s0.h[i] = st0[i];
    const size_t shm = sizeof(uint32_t) * SECP_SHA_THREADS * sha_row_words(L);
    sha256_msg_kernel<<<(B + SECP_SHA_THREADS - 1) / SECP_SHA_THREADS,
                        SECP_SHA_THREADS, shm, (cudaStream_t)stream>>>(
        msg, L, s0, lane_st, len_hi, len_lo, out, B, words);
    return (int)cudaGetLastError();
}

// kd [B, 64] bytes (seckey || msg32, word-aligned); k0 [16]: the inner and
// outer pad states of the all-zero key; out [rounds, B, 8] words
__global__ void __launch_bounds__(SECP_SHA_THREADS)
rfc6979_kernel(const uint8_t* kd, sha_st k0i, sha_st k0o, uint32_t* out,
               int rounds, int B) {
    __shared__ uint32_t sm[SECP_SHA_THREADS * 17];
    const int t = threadIdx.x;
    const int first = blockIdx.x * SECP_SHA_THREADS;
    const int rows = min(SECP_SHA_THREADS, B - first);
    const int lane = first + t;
    sha_stage(sm, 17, kd + (size_t)first * 64, 64, 0, 64, rows, true, t,
              SECP_SHA_THREADS);
    __syncthreads();
    if (t >= rows) return;
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = bswap32(sm[17 * t + i]);
    rfc6979_lane(w, k0i, k0o, rounds, [&](int r, const uint32_t (&v)[8]) {
        st8(out + ((size_t)r * B + lane) * 8, v, false);
    });
}

extern "C" int secp_rfc6979(const uint8_t* kd, const uint32_t* k0,
                            uint32_t* out, int rounds, int B, void* stream) {
    if (B <= 0 || rounds <= 0) return 0;
    sha_st i0, o0;
    for (int i = 0; i < 8; ++i) {
        i0.h[i] = k0[i];
        o0.h[i] = k0[8 + i];
    }
    rfc6979_kernel<<<(B + SECP_SHA_THREADS - 1) / SECP_SHA_THREADS,
                     SECP_SHA_THREADS, 0, (cudaStream_t)stream>>>(
        kd, i0, o0, out, rounds, B);
    return (int)cudaGetLastError();
}

// px, msg [n, 32], sig [n, 64] bytes (word-aligned); mids [16]: the leaf
// and node tags' midstates; part: 8 * nb + 8 * ceil(nb / 2) + 1 words of
// scratch (the blocks' roots, the last block's second level buffer and the
// counter), unused with one block; root [8] words, the digest's bytes
__global__ void __launch_bounds__(SECP_BD_THREADS)
batch_digest_kernel(const uint8_t* px, const uint8_t* msg, const uint8_t* sig,
                    sha_st leaf, sha_st node, uint32_t* part, uint32_t* root,
                    int n) {
    __shared__ uint32_t sm[SECP_BD_THREADS * SECP_BD_ROW];
    __shared__ int last;
    const int t = threadIdx.x;
    const int nb = gridDim.x;
    const int first = blockIdx.x * SECP_BD_THREADS;
    const int rows = min(SECP_BD_THREADS, n - first);
    sha_stage(sm, SECP_BD_ROW, px + (size_t)first * 32, 32, 0, 32, rows,
              true, t, SECP_BD_THREADS);
    sha_stage(sm + 8, SECP_BD_ROW, msg + (size_t)first * 32, 32, 0, 32, rows,
              true, t, SECP_BD_THREADS);
    sha_stage(sm + 16, SECP_BD_ROW, sig + (size_t)first * 64, 64, 0, 64,
              rows, true, t, SECP_BD_THREADS);
    __syncthreads();
    uint32_t h[8];
    if (t < rows) bd_leaf(h, sm + SECP_BD_ROW * t, leaf);
    __syncthreads();                    // every row read: nodes overwrite
    if (t < rows) {
#pragma unroll
        for (int i = 0; i < 8; ++i) sm[9 * t + i] = h[i];
    }
    // the chunk's subtree: to one node (one block), else all its levels
    int cnt = rows;
    for (int lvl = 0; nb == 1 ? cnt > 1 : lvl < SECP_BD_LEVELS; ++lvl) {
        const int half = (cnt + 1) >> 1;
        __syncthreads();
        if (t < half) bd_pair(h, sm, 9, cnt, t, node);
        __syncthreads();
        if (t < half) {
#pragma unroll
            for (int i = 0; i < 8; ++i) sm[9 * t + i] = h[i];
        }
        cnt = half;
    }
    __syncthreads();
    if (nb == 1) {
        if (t == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i) h[i] = sm[i];
            st8(root, h, true);
        }
        return;
    }
    uint32_t* count = part + 8 * nb + 8 * ((nb + 1) >> 1);
    if (t == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) part[8 * blockIdx.x + i] = sm[i];
        __threadfence();                // the root before the count
        last = atomicAdd(count, 1u) == (uint32_t)(nb - 1);
    }
    __syncthreads();
    if (!last) return;                  // the whole block leaves
    __threadfence();
    // the blocks' roots, a level at a time between the two buffers
    uint32_t* src = part;
    uint32_t* dst = part + 8 * nb;
    cnt = nb;
    while (cnt > 1) {
        const int half = (cnt + 1) >> 1;
        for (int i = t; i < half; i += SECP_BD_THREADS) {
            bd_pair<true>(h, src, 8, cnt, i, node);
#pragma unroll
            for (int j = 0; j < 8; ++j) dst[8 * i + j] = h[j];
        }
        __threadfence();                // the level in L2, where it is read
        __syncthreads();
        uint32_t* tmp = src;
        src = dst;
        dst = tmp;
        cnt = half;
    }
    if (t == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) h[i] = SECP_LDCG(src + i);
        st8(root, h, true);
    }
}

extern "C" int secp_batch_digest(const uint8_t* px, const uint8_t* msg,
                                 const uint8_t* sig, const uint32_t* mids,
                                 uint32_t* part, uint32_t* root, int n,
                                 void* stream) {
    if (n <= 0) return 0;
    const int nb = (n + SECP_BD_THREADS - 1) / SECP_BD_THREADS;
    cudaStream_t s = (cudaStream_t)stream;
    if (nb > 1) {
        cudaError_t e = cudaMemsetAsync(
            part + 8 * nb + 8 * ((nb + 1) >> 1), 0, sizeof(uint32_t), s);
        if (e) return (int)e;
    }
    sha_st leaf, node;
    for (int i = 0; i < 8; ++i) {
        leaf.h[i] = mids[i];
        node.h[i] = mids[8 + i];
    }
    batch_digest_kernel<<<nb, SECP_BD_THREADS, 0, s>>>(px, msg, sig, leaf,
                                                       node, part, root, n);
    return (int)cudaGetLastError();
}

// warps an SM holds at once for each entry's launches (op 0 sha256_msg at
// L = 96, 1 rfc6979, 2 batch_digest); < 0: -(error)
extern "C" int secp_sha256_warps(int op) {
    int blocks = 0;
    cudaError_t e;
    if (op == 0)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, sha256_msg_kernel, SECP_SHA_THREADS,
            sizeof(uint32_t) * SECP_SHA_THREADS * sha_row_words(96));
    else if (op == 1)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, rfc6979_kernel, SECP_SHA_THREADS, 0);
    else
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, batch_digest_kernel, SECP_BD_THREADS, 0);
    const int threads = op == 2 ? SECP_BD_THREADS : SECP_SHA_THREADS;
    return e ? -(int)e : blocks * (threads / 32);
}
#endif
