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
// away), which lets a host harness exercise the arithmetic without a card:
// tests/test_torch_kernels.py builds one with g++ and holds the field and
// group core against Python integers.
#pragma once
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SECP_DEV static __device__
#define SECP_INLINE __device__ __forceinline__
#define SECP_NOINLINE static __device__ __noinline__
#define SECP_LDG(p) __ldg(p)
#define SECP_LDCG(p) __ldcg(p)
#else
#define SECP_DEV static
#define SECP_INLINE inline
#define SECP_NOINLINE static
#define SECP_LDG(p) (*(p))
#define SECP_LDCG(p) (*(p))
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

// load16 through L2 only (not L1): for words another block of the same
// launch wrote (gej_sum's last block reads the blocks' partial sums)
SECP_INLINE u256 load16_cg(const uint32_t* base, int B, int lane) {
    u256 r;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint32_t lo = SECP_LDCG(base + (size_t)(2 * i) * B + lane);
        uint32_t hi = SECP_LDCG(base + (size_t)(2 * i + 1) * B + lane);
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

// (a & m) | (b & ~m) for a mask m of all ones or zeros: on the card one
// LOP3 in an asm, which the compiler cannot turn into a branch or a
// predicated load (the select scans of secret indexes use it)
#ifdef __CUDACC__
SECP_INLINE uint32_t sel_mask(uint32_t a, uint32_t b, uint32_t m) {
    uint32_t r;
    asm("lop3.b32 %0, %1, %2, %3, 0xE4;" : "=r"(r) : "r"(a), "r"(b), "r"(m));
    return r;
}
#else
SECP_INLINE uint32_t sel_mask(uint32_t a, uint32_t b, uint32_t m) {
    return (a & m) | (b & ~m);
}
#endif

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

// --- carry-chain primitives ----------------------------------------------
// One PTX instruction each on the card; a chain is a run of them in which
// every *c* form consumes the carry flag that the one before it set
// (CC.CF: the carry of an add, the borrow of a subtract).  Each is an
// `asm volatile`, so the compiler keeps them in program order; nothing
// else in the code between them touches the flag (only the .cc/c forms
// of PTX do).  This is the shape of GPU big-integer code (sppark,
// ICICLE): the 8x8-word product runs as carry chains of mad.lo.cc /
// madc.hi.cc instead of a 64-bit add and shift after each multiply.
//
// Under a plain C++ compiler (the host harness) the same names compute the
// same words with 64-bit arithmetic and keep the flag in secp_cf, so the
// chains built from them below are one code for both: the CPU test of
// this portable branch checks the chains' structure, and chip_smoke.py
// holds the PTX against the plain PyTorch versions on the card.
#ifdef __CUDACC__
#define SECP_CC1(name, op)                                                 \
    static __device__ __forceinline__ uint32_t name(uint32_t a,            \
                                                    uint32_t b) {         \
        uint32_t r;                                                        \
        asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));        \
        return r;                                                          \
    }
#define SECP_CC2(name, op)                                                 \
    static __device__ __forceinline__ uint32_t name(uint32_t a,            \
                                                    uint32_t b,            \
                                                    uint32_t c) {          \
        uint32_t r;                                                        \
        asm volatile(op " %0, %1, %2, %3;"                                 \
                     : "=r"(r) : "r"(a), "r"(b), "r"(c));                  \
        return r;                                                          \
    }
SECP_CC1(add_cc, "add.cc.u32")      // a + b
SECP_CC1(addc_cc, "addc.cc.u32")    // a + b + CF
SECP_CC1(addc, "addc.u32")          // a + b + CF, flag not set
SECP_CC1(sub_cc, "sub.cc.u32")      // a - b
SECP_CC1(subc_cc, "subc.cc.u32")    // a - b - CF
SECP_CC1(subc, "subc.u32")          // a - b - CF, flag not set
SECP_CC2(mad_lo_cc, "mad.lo.cc.u32")    // lo(a*b) + c
SECP_CC2(madc_lo_cc, "madc.lo.cc.u32")  // lo(a*b) + c + CF
SECP_CC2(mad_hi_cc, "mad.hi.cc.u32")    // hi(a*b) + c
SECP_CC2(madc_hi_cc, "madc.hi.cc.u32")  // hi(a*b) + c + CF
SECP_CC2(madc_hi, "madc.hi.u32")        // hi(a*b) + c + CF, flag not set
#undef SECP_CC1
#undef SECP_CC2
// hi(a*b), and hi(a*b) + c: no flag
static __device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
    return __umulhi(a, b);
}
static __device__ __forceinline__ uint32_t mad_hi(uint32_t a, uint32_t b,
                                                  uint32_t c) {
    return __umulhi(a, b) + c;
}
#else
static uint32_t secp_cf;            // the carry flag of the portable branch

static inline uint32_t cc_out(u64 t) {
    secp_cf = (uint32_t)(t >> 32) & 1u;
    return (uint32_t)t;
}
static inline uint32_t bw_out(u64 t) {
    secp_cf = (uint32_t)(t >> 63);
    return (uint32_t)t;
}
static inline uint32_t lo32(uint32_t a, uint32_t b) { return a * b; }
static inline uint32_t mul_hi(uint32_t a, uint32_t b) {
    return (uint32_t)(((u64)a * b) >> 32);
}
static inline uint32_t add_cc(uint32_t a, uint32_t b) {
    return cc_out((u64)a + b);
}
static inline uint32_t addc_cc(uint32_t a, uint32_t b) {
    return cc_out((u64)a + b + secp_cf);
}
static inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + secp_cf; }
static inline uint32_t sub_cc(uint32_t a, uint32_t b) {
    return bw_out((u64)a - b);
}
static inline uint32_t subc_cc(uint32_t a, uint32_t b) {
    return bw_out((u64)a - b - secp_cf);
}
static inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - secp_cf; }
static inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return cc_out((u64)lo32(a, b) + c);
}
static inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return cc_out((u64)lo32(a, b) + c + secp_cf);
}
static inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return cc_out((u64)mul_hi(a, b) + c);
}
static inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return cc_out((u64)mul_hi(a, b) + c + secp_cf);
}
static inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    return mul_hi(a, b) + c + secp_cf;
}
static inline uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c) {
    return mul_hi(a, b) + c;
}
#endif

#ifdef __CUDACC__
extern "C" const char* secp_cuda_error_string(int code);
#endif
