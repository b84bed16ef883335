// mulmod_chain: out = x * y^n mod p, canonical.
//
// Replaces the TPU kernel _mulmod_chain_kernel (ops/pallas_field.py,
// mulmod_chain): the unit test and first timing of the device library.
// Bound on this card: operations — n dependent 8x8-word multiplies (64
// 32-bit multiply-adds each, plus the fold) per lane against 3 x 64 bytes
// of traffic.  One thread per lane; limb-major operands make the loads and
// stores of a warp contiguous.  The ragged edge is masked (lane < B).
#include "fe.cuh"

SECP_DEV void mulmod_chain_lane(const uint32_t* x, const uint32_t* y,
                                uint32_t* out, int B, int n, int lane) {
    fe a = load16(x, B, lane);
    fe b = load16(y, B, lane);
#pragma unroll 1
    for (int i = 0; i < n; ++i) a = fe_mul(a, b);
    store16(out, B, lane, fe_canon(a));
}

#ifdef __CUDACC__
__global__ void mulmod_chain_kernel(const uint32_t* x, const uint32_t* y,
                                    uint32_t* out, int B, int n) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B) mulmod_chain_lane(x, y, out, B, n, lane);
}

extern "C" int secp_mulmod_chain(const uint32_t* x, const uint32_t* y,
                                 uint32_t* out, int B, int n, void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    mulmod_chain_kernel<<<(B + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(x, y, out, B, n);
    return (int)cudaGetLastError();
}

extern "C" const char* secp_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
#endif
