// Shared helpers for the paged attention kernels: element conversion and
// vector copies for the two supported storage types, warp reductions, the
// finite mask value, and a launch helper that lifts the 48 KB dynamic
// shared memory default when needed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed across the plain C interface
enum DtypeCode { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

// finite mask, the same as ref.NEG_INF: a masked position gives
// exp(NEG_INF - m) == 0 exactly, never the NaN of -inf - -inf
#define REPRO_NEG_INF (-0.7f * 3.4028234663852886e38f)

// query heads one block serves; the group of a kv head with more query
// heads (G > GMAX) is split over several blocks along grid.y
constexpr int GMAX = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
        __nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
        float x) {
    return __float2bfloat16(x);
}

// 8 consecutive elements at a 16-byte aligned address -> 8 floats
__device__ __forceinline__ void load8(const float* p, float* o) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        o[2 * i] = f.x;
        o[2 * i + 1] = f.y;
    }
}

// 8 consecutive elements, 16-byte aligned at both ends, copied raw
template <typename T>
__device__ __forceinline__ void copy8(const T* src, T* dst) {
#pragma unroll
    for (int i = 0; i < (int)(8 * sizeof(T) / 16); ++i)
        reinterpret_cast<uint4*>(dst)[i] =
            reinterpret_cast<const uint4*>(src)[i];
}

// 8 consecutive elements, 16-byte aligned, set to zero
template <typename T>
__device__ __forceinline__ void zero8(T* dst) {
#pragma unroll
    for (int i = 0; i < (int)(8 * sizeof(T) / 16); ++i)
        reinterpret_cast<uint4*>(dst)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// N consecutive elements (aligned to N elements) -> N floats
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* o) {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* o) {
    if constexpr (N % 2 == 0) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            o[2 * i] = f.x;
            o[2 * i + 1] = f.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
    }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
    return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x += __shfl_xor_sync(FULL_MASK, x, o);
    return x;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory on `stream`
// and return the launch's error code (a refused launch never runs, and a
// later synchronize would not report it).
template <typename... KArgs, typename... Args>
static cudaError_t launch_with_smem(void (*kernel)(KArgs...), dim3 grid,
                                    dim3 block, size_t smem,
                                    cudaStream_t stream, Args... args) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<grid, block, smem, stream>>>(args...);
    return cudaGetLastError();
}

// Return `LAUNCH<TQ, TKV, DPL>(...)` for the dtype pair and head_dim
// (D = 32 * DPL, D in {32, 64, 128}); anything else is refused.
// REPRO_DISPATCH_WIDE also takes D = 256 (recurrentgemma's heads): only
// the dense-cache kernels K3/K4 use it, so the paged kernels compile no
// D 256 variant that no path runs.
#define REPRO_DISPATCH(LAUNCH, q_dtype, kv_dtype, D, ...)                   \
    REPRO_DISPATCH_T(REPRO_DISPATCH_D, LAUNCH, q_dtype, kv_dtype, D,         \
                     __VA_ARGS__)
#define REPRO_DISPATCH_WIDE(LAUNCH, q_dtype, kv_dtype, D, ...)              \
    REPRO_DISPATCH_T(REPRO_DISPATCH_D_WIDE, LAUNCH, q_dtype, kv_dtype, D,    \
                     __VA_ARGS__)

#define REPRO_DISPATCH_T(BY_D, LAUNCH, q_dtype, kv_dtype, D, ...)           \
    if (q_dtype == DT_FLOAT32 && kv_dtype == DT_BFLOAT16)                    \
        return BY_D(LAUNCH, float, __nv_bfloat16, D, __VA_ARGS__);           \
    if (q_dtype == DT_FLOAT32 && kv_dtype == DT_FLOAT32)                     \
        return BY_D(LAUNCH, float, float, D, __VA_ARGS__);                   \
    if (q_dtype == DT_BFLOAT16 && kv_dtype == DT_BFLOAT16)                   \
        return BY_D(LAUNCH, __nv_bfloat16, __nv_bfloat16, D, __VA_ARGS__);   \
    if (q_dtype == DT_BFLOAT16 && kv_dtype == DT_FLOAT32)                    \
        return BY_D(LAUNCH, __nv_bfloat16, float, D, __VA_ARGS__);           \
    return (int)cudaErrorInvalidValue

#define REPRO_DISPATCH_D(LAUNCH, TQ, TKV, D, ...)                            \
    (D == 32    ? (int)LAUNCH<TQ, TKV, 1>(__VA_ARGS__)                       \
     : D == 64  ? (int)LAUNCH<TQ, TKV, 2>(__VA_ARGS__)                       \
     : D == 128 ? (int)LAUNCH<TQ, TKV, 4>(__VA_ARGS__)                       \
                : (int)cudaErrorInvalidValue)
#define REPRO_DISPATCH_D_WIDE(LAUNCH, TQ, TKV, D, ...)                       \
    (D == 256 ? (int)LAUNCH<TQ, TKV, 8>(__VA_ARGS__)                         \
              : REPRO_DISPATCH_D(LAUNCH, TQ, TKV, D, __VA_ARGS__))
