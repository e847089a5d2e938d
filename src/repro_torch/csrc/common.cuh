// Shared helpers for the attention kernels' two walks (decode_walk.cuh,
// prefill_walk.cuh) and the backward kernels: element conversion for the
// two supported storage types, warp reductions, the finite mask value, the
// split TF32 tensor-core product (3xTF32) and two fragment-level products
// built on it, pair loads and stores, the cp.async copy ring's primitives,
// mbarriers for a producer/consumer ring, and a launch helper that lifts
// the 48 KB dynamic shared memory default when needed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed across the plain C interface
enum DtypeCode { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

// finite mask, the same as ref.NEG_INF: a masked position gives
// exp(NEG_INF - m) == 0 exactly, never the NaN of -inf - -inf
#define REPRO_NEG_INF (-0.7f * 3.4028234663852886e38f)

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

// x -> (hi, lo) TF32 operands; an EXACT x (a widened bf16) is its own hi.
// hi is cvt.rna.tf32.f32 done as integer ops (round the magnitude half
// away at bit 13, then clear the 13 bits: two instructions where the
// conversion takes more), lo the remainder x - hi (exact in fp32) with its
// 13 low bits cleared: x = hi + lo to ~2^-22 of |x|
constexpr uint32_t TF32_MASK = 0xFFFFE000u;
template <bool EXACT>
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
    if constexpr (EXACT) {
        hi = __float_as_uint(x);
        lo = 0u;
    } else {
        hi = (__float_as_uint(x) + 0x1000u) & TF32_MASK;
        lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
    }
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a.b: the product alone, on zero
__device__ __forceinline__ void mma_tf32_z(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
}
// d += a.b from split operands, the small terms (none for an exact side)
// into ds: a second accumulator halves the chain of dependent products
// where registers allow it, else ds is d and they go first
template <bool AX, bool BX>
__device__ __forceinline__ void mma_split(float (&d)[4], float (&ds)[4],
                                          const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4],
                                          const uint32_t (&bhi)[2],
                                          const uint32_t (&blo)[2]) {
    if constexpr (!AX) mma_tf32(ds, alo, bhi[0], bhi[1]);
    if constexpr (!BX) mma_tf32(ds, ahi, blo[0], blo[1]);
    mma_tf32(d, ahi, bhi[0], bhi[1]);
}
// d += a.b from split fp32 operands, the three products summed on the
// tensor cores from zero and that sum added to d in fp32. The tensor
// cores' fp32 accumulation does not round to nearest: a chain of
// thousands of products accumulated there (a gradient summed over a
// walk) drifts far past fp32's rounding, where adds that round to
// nearest do not
__device__ __forceinline__ void mma_split_rn(float (&d)[4],
                                             const uint32_t (&ahi)[4],
                                             const uint32_t (&alo)[4],
                                             const uint32_t (&bhi)[2],
                                             const uint32_t (&blo)[2]) {
    float t[4];
    mma_tf32_z(t, alo, bhi[0], bhi[1]);
    mma_tf32(t, ahi, blo[0], blo[1]);
    mma_tf32(t, ahi, bhi[0], bhi[1]);
    d[0] += t[0];
    d[1] += t[1];
    d[2] += t[2];
    d[3] += t[3];
}

template <int NT>
__device__ __forceinline__ void frag_zero(float (&c)[NT][4]) {
#pragma unroll
    for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// c (16 x 8 NT) += a . b^T in 3xTF32, each 8-wide k step added in fp32
// (mma_split_rn): a (16 x K) and b (8 NT x K), fp32 rows in shared memory
// at a stride of RS floats (RS = 4 mod 16, so that every fragment load is
// free of bank conflicts): the A fragment takes rows g, g + 8 and columns
// t, t + 4, the B fragment row g of each 8-row tile and columns t, t + 4;
// each operand is split where it is read
template <int K, int NT, int RS>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const float* a,
                                        const float* b, int gq, int tq) {
#pragma unroll 2
    for (int kk = 0; kk < K; kk += 8) {
        const float* a0 = a + gq * RS + kk + tq;
        uint32_t ahi[4], alo[4];
        tf32_split<false>(a0[0], ahi[0], alo[0]);
        tf32_split<false>(a0[8 * RS], ahi[1], alo[1]);
        tf32_split<false>(a0[4], ahi[2], alo[2]);
        tf32_split<false>(a0[8 * RS + 4], ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const float* b0 = b + (8 * n + gq) * RS + kk + tq;
            uint32_t bhi[2], blo[2];
            tf32_split<false>(b0[0], bhi[0], blo[0]);
            tf32_split<false>(b0[4], bhi[1], blo[1]);
            mma_split_rn(c[n], ahi, alo, bhi, blo);
        }
    }
}
// c += a . b^T as mma_abt, with its three products each summed from zero
// and the two cross terms added to each other in fp32 before the large
// one: a . b^T and b . a^T then give the same bits (one product from zero
// sums the same exact TF32 products in the same k order whichever operand
// is A, and fp32 addition commutes). K4's backward takes dP = dO.V^T so in
// all three of its kernels, where one of them computes its transpose
template <int K, int NT, int RS>
__device__ __forceinline__ void mma_abt_sym(float (&c)[NT][4],
                                            const float* a, const float* b,
                                            int gq, int tq) {
#pragma unroll 2
    for (int kk = 0; kk < K; kk += 8) {
        const float* a0 = a + gq * RS + kk + tq;
        uint32_t ahi[4], alo[4];
        tf32_split<false>(a0[0], ahi[0], alo[0]);
        tf32_split<false>(a0[8 * RS], ahi[1], alo[1]);
        tf32_split<false>(a0[4], ahi[2], alo[2]);
        tf32_split<false>(a0[8 * RS + 4], ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const float* b0 = b + (8 * n + gq) * RS + kk + tq;
            uint32_t bhi[2], blo[2];
            tf32_split<false>(b0[0], bhi[0], blo[0]);
            tf32_split<false>(b0[4], bhi[1], blo[1]);
            float x[4], y[4], t[4];
            mma_tf32_z(x, alo, bhi[0], bhi[1]);
            mma_tf32_z(y, ahi, blo[0], blo[1]);
            mma_tf32_z(t, ahi, bhi[0], bhi[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) c[n][e] += t[e] + (x[e] + y[e]);
        }
    }
}
// acc (16 x 8 DT) += s . b in 3xTF32: s (16 x 8 NT) in mma accumulator
// fragments, b (8 NT x 8 DT) fp32 rows in shared memory at a stride of RS
// floats (RS = 4 mod 16). Each 8-wide k step takes the fragment's own
// order (k indices t, t + 4 are its columns 2t, 2t + 1) and reads b's rows
// in that order, so the accumulators are the A operand in place. Each
// output tile's NT k steps are summed on the tensor cores from zero and
// added to acc in fp32 (the rounding mma_split_rn gives, once a call)
template <int NT, int DT, int RS>
__device__ __forceinline__ void mma_fb(float (&acc)[DT][4],
                                       const float (&s)[NT][4],
                                       const float* b, int gq, int tq) {
    uint32_t ahi[NT][4], alo[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        tf32_split<false>(s[n][0], ahi[n][0], alo[n][0]);
        tf32_split<false>(s[n][2], ahi[n][1], alo[n][1]);
        tf32_split<false>(s[n][1], ahi[n][2], alo[n][2]);
        tf32_split<false>(s[n][3], ahi[n][3], alo[n][3]);
    }
    const float* b0 = b + 2 * tq * RS + gq;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
        float t[4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            uint32_t bhi[2], blo[2];
            tf32_split<false>(b0[8 * n * RS + 8 * i], bhi[0], blo[0]);
            tf32_split<false>(b0[(8 * n + 1) * RS + 8 * i], bhi[1], blo[1]);
            if (n == 0) mma_tf32_z(t, alo[0], bhi[0], bhi[1]);
            else mma_tf32(t, alo[n], bhi[0], bhi[1]);
            mma_tf32(t, ahi[n], blo[0], blo[1]);
            mma_tf32(t, ahi[n], bhi[0], bhi[1]);
        }
        acc[i][0] += t[0];
        acc[i][1] += t[1];
        acc[i][2] += t[2];
        acc[i][3] += t[3];
    }
}

// two consecutive elements (8 / 4 aligned bytes) -> two floats
__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes global -> shared, asynchronously; zeros where !live (the source
// is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(live ? 16 : 0));
}
// 4 bytes global -> shared, asynchronously (through L1); zeros where !live
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(live ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers (sm_90), 64-bit words in shared memory. A phase completes
// when `count` arrivals (mbar_init) have come; mbar_wait(bar, p) returns
// once the phase of parity p has completed (a barrier starts in phase 0),
// with acquire semantics; an arrival releases the thread's earlier
// accesses.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(count)
                 : "memory");
}
// release the barriers' initialisation to every later arrival (cp.async
// arrivals included), before the __syncthreads that follows it
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, "
                 "[%0];\n}\n" ::"r"(smem_addr(bar))
                 : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::"
                     "cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done)
                     : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}
// one arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted in mbar_init's count: .noinc)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_addr(bar))
                 : "memory");
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
// (D = 32 * DPL, D in {32, 64, 128, 256}: up to recurrentgemma-9b's and
// paligemma-3b's heads); anything else is refused. Every attention kernel
// (K1-K4) dispatches through it.
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
