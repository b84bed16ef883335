// gej_add: batched complete jacobian + jacobian addition with infinity
// flags.
//
// Replaces the TPU kernel _gej_add_kernel (ops/pallas_group.py,
// gej_add_tpu).  One thread per lane: jp_add of group.cuh (the complete
// formula with the degenerate-case select, so P + P, P + (-P) and infinity
// operands need no branch), canonical x, y, z and the inf flag out.  The
// MSM engine collapses its last lanes with it, and batch verify adds its
// two MSM results with it.
//
// Bound on this card: operations at large B — 17 field multiplies a lane
// against 50 words in and 49 out; on the paths above it runs on 1 to 64
// lanes, where one lane's latency sets the time.
#include "group.cuh"

SECP_DEV void gej_add_lane(const uint32_t* ax, const uint32_t* ay,
                           const uint32_t* az, const uint32_t* ainf,
                           const uint32_t* bx, const uint32_t* by,
                           const uint32_t* bz, const uint32_t* binf,
                           uint32_t* ox, uint32_t* oy, uint32_t* oz,
                           uint32_t* oinf, int B, int lane) {
    jp a, b;
    a.x = load16(ax, B, lane); a.y = load16(ay, B, lane);
    a.z = load16(az, B, lane); a.inf = ainf[lane] != 0;
    b.x = load16(bx, B, lane); b.y = load16(by, B, lane);
    b.z = load16(bz, B, lane); b.inf = binf[lane] != 0;
    jp r = jp_add(a, b);
    store16(ox, B, lane, fe_canon(r.x));
    store16(oy, B, lane, fe_canon(r.y));
    store16(oz, B, lane, fe_canon(r.z));
    oinf[lane] = r.inf;
}

#ifdef __CUDACC__
__global__ void gej_add_kernel(const uint32_t* ax, const uint32_t* ay,
                               const uint32_t* az, const uint32_t* ainf,
                               const uint32_t* bx, const uint32_t* by,
                               const uint32_t* bz, const uint32_t* binf,
                               uint32_t* ox, uint32_t* oy, uint32_t* oz,
                               uint32_t* oinf, int B) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane < B)
        gej_add_lane(ax, ay, az, ainf, bx, by, bz, binf, ox, oy, oz, oinf,
                     B, lane);
}

extern "C" int secp_gej_add(const uint32_t* ax, const uint32_t* ay,
                            const uint32_t* az, const uint32_t* ainf,
                            const uint32_t* bx, const uint32_t* by,
                            const uint32_t* bz, const uint32_t* binf,
                            uint32_t* ox, uint32_t* oy, uint32_t* oz,
                            uint32_t* oinf, int B, void* stream) {
    if (B <= 0) return 0;
    const int threads = 64;
    gej_add_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(ax, ay, az, ainf, bx, by, bz,
                                             binf, ox, oy, oz, oinf, B);
    return (int)cudaGetLastError();
}
#endif
