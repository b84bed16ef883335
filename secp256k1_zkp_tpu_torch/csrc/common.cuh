// Shared definitions of the secp256k1 kernel library.
//
// A 256-bit value lives in a thread as eight 32-bit words (little-endian);
// the card's 32x32->64 multiply-add takes the place of the 16-bit limbs
// with split lo/hi columns of the TPU kernels, which exist only because
// that vector unit has no wide multiply.  At the tensor boundary values
// are limb-major [16, B] base-2^16 limbs (one 32-bit element per limb,
// lane innermost), so neighbouring threads read neighbouring addresses.
//
// The device functions compile as plain C++ too (the macros below fall
// away), which lets a host harness exercise the arithmetic without a card.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define SECP_DEV static __device__
#define SECP_INLINE __device__ __forceinline__
#define SECP_NOINLINE static __device__ __noinline__
#define SECP_LDG(p) __ldg(p)
#else
#define SECP_DEV static
#define SECP_INLINE inline
#define SECP_NOINLINE static
#define SECP_LDG(p) (*(p))
struct uint4 { uint32_t x, y, z, w; };
#endif

typedef unsigned long long u64;

struct u256 { uint32_t v[8]; };

// limb-major [16, B] base-2^16 tensor <-> eight 32-bit words
SECP_INLINE u256 load16(const uint32_t* base, int B, int lane) {
    u256 r;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint32_t lo = base[(size_t)(2 * i) * B + lane];
        uint32_t hi = base[(size_t)(2 * i + 1) * B + lane];
        r.v[i] = (lo & 0xFFFFu) | (hi << 16);
    }
    return r;
}

SECP_INLINE void store16(uint32_t* base, int B, int lane, const u256& a) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        base[(size_t)(2 * i) * B + lane] = a.v[i] & 0xFFFFu;
        base[(size_t)(2 * i + 1) * B + lane] = a.v[i] >> 16;
    }
}

// m ? a : b per word, m a 0/1 flag; no branch
SECP_INLINE u256 select256(uint32_t m, const u256& a, const u256& b) {
    uint32_t mask = 0u - (m & 1u);
    u256 r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = (a.v[i] & mask) | (b.v[i] & ~mask);
    return r;
}

// t[0..NA+NB) = a[0..NA) * b[0..NB), operand scanning with 64-bit sums
template <int NA, int NB>
SECP_INLINE void bn_mul(uint32_t* t, const uint32_t* a, const uint32_t* b) {
#pragma unroll
    for (int i = 0; i < NA + NB; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
        u64 c = 0;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            c += (u64)a[i] * b[j] + t[i + j];
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        t[i + NB] = (uint32_t)c;
    }
}

#ifdef __CUDACC__
extern "C" const char* secp_cuda_error_string(int code);
#endif
