// RG-LRU linear recurrence for Hopper (sm_90a):
//   h[b, t, c] = a[b, t, c] * h[b, t-1, c] + x[b, t, c],  h[b, -1, c] = h0[b, c]
// along the sequence, elementwise over (batch, channel); a and x (B, S, C)
// fp32 or bf16, h0 (B, C) fp32 or absent (zeros), h (B, S, C) fp32. Every
// S and every C run (no tiling asserts).
//
// Replaces the TPU kernel src/repro/kernels/rglru.py (rglru_scan, the
// pl.pallas_call at line 52): a (B, channel block, seq block) grid with the
// seq axis innermost and the running h carried in VMEM scratch. The
// reference model computes the same function with an associative scan
// (src/repro/models/rglru.py, lru_scan); in the port this kernel is what
// lru_scan calls, on every RG-LRU layer of every prefill.
//
// What bounds it on this card: bytes. Each step reads a and x and writes h,
// 12 bytes for 2 flops in fp32, far under any compute ridge: the least time
// is 3 * B * S * C * 4 B over 3.35 TB/s (0.022 ms for a 1,500-token
// recurrentgemma-9b prompt at C 4096).
//
// What this simple design does about it: one thread per (batch, channel)
// walks the sequence, a warp covering 32 neighbouring channels, so each
// step's loads and stores are whole 128-byte lines. A block is one warp, so
// the B * C / 32 blocks (128 at B 1, C 4096) spread over the SMs instead of
// crowding a few. The recurrence is serial in t, but the loads are not: a
// thread keeps the next RG_U steps' a and x in flight in registers while it
// computes the current RG_U. With only B * C threads that still leaves the
// memory system mostly idle; a chunked scan over S (per-chunk products and
// carries, then a fix-up pass) or a cp.async ring in shared memory is the
// follow-up that fills it.
//
// Rounding: each step is an explicit fp32 multiply then add
// (__fmul_rn/__fadd_rn, which nvcc does not contract into an FMA), the
// order and rounding of the plain version (kernels/ref.py, rglru_scan), so
// the two agree bit for bit on the card.

#include "common.cuh"

constexpr int RG_THREADS = 32;  // one warp per block
constexpr int RG_U = 32;        // steps whose loads are in flight at once

template <typename T>
__global__ void __launch_bounds__(RG_THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int S, int C) {
    const int c = blockIdx.x * RG_THREADS + threadIdx.x;
    if (c >= C) return;
    const int64_t row = (int64_t)blockIdx.y * S * C + c;   // (b, 0, c)
    float hv = h0 != nullptr ? h0[(int64_t)blockIdx.y * C + c] : 0.f;

    // the next RG_U steps' inputs; steps past S read as a = x = 0
    float an[RG_U], xn[RG_U];
    auto fetch = [&](int t0) {
#pragma unroll
        for (int u = 0; u < RG_U; ++u) {
            const int t = t0 + u;
            if (t < S) {
                an[u] = to_f32(a[row + (int64_t)t * C]);
                xn[u] = to_f32(x[row + (int64_t)t * C]);
            } else {
                an[u] = 0.f;
                xn[u] = 0.f;
            }
        }
    };
    fetch(0);
    for (int t0 = 0; t0 < S; t0 += RG_U) {
        float ac[RG_U], xc[RG_U];
#pragma unroll
        for (int u = 0; u < RG_U; ++u) {
            ac[u] = an[u];
            xc[u] = xn[u];
        }
        if (t0 + RG_U < S) fetch(t0 + RG_U);
#pragma unroll
        for (int u = 0; u < RG_U; ++u) {
            hv = __fadd_rn(__fmul_rn(ac[u], hv), xc[u]);
            if (t0 + u < S) h[row + (int64_t)(t0 + u) * C] = hv;
        }
    }
}

template <typename T>
static cudaError_t launch(const void* a, const void* x, const void* h0,
                          void* h, int B, int S, int C, cudaStream_t stream) {
    const dim3 grid((C + RG_THREADS - 1) / RG_THREADS, B);
    rglru_scan_kernel<T><<<grid, RG_THREADS, 0, stream>>>(
        (const T*)a, (const T*)x, (const float*)h0, (float*)h, S, C);
    return cudaGetLastError();
}

// a, x (B, S, C) of `dtype` (DT_FLOAT32 or DT_BFLOAT16); h0 (B, C) fp32 or
// null; h (B, S, C) fp32. All contiguous. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* x,
                                 const void* h0, void* h, int B, int S,
                                 int C, int dtype, void* stream) {
    if (dtype == DT_FLOAT32)
        return (int)launch<float>(a, x, h0, h, B, S, C, (cudaStream_t)stream);
    if (dtype == DT_BFLOAT16)
        return (int)launch<__nv_bfloat16>(a, x, h0, h, B, S, C,
                                          (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}
