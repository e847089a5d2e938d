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
// recurrentgemma-9b prompt at C 4096). The serial chain is not the limit:
// 1,500 dependent multiply-adds take ~12 k cycles, ~7 us. What the bytes
// need is enough of them in flight: by Little's law ~3.35 TB/s x ~0.7 us,
// some 2-3 MB across the card, ~18 KB an SM. The PR 14 design kept 32
// steps of a and x in registers (~8 KB an SM) and drained them before the
// next fetch: 1.0 TB/s.
//
// The design: a block is one warp, a lane a channel, over a strip of 32
// neighbouring channels (B * C / 32 blocks: 128 at B 1, C 4096, one an
// SM). The strip's a and x stream through a shared-memory ring of
// RG_STAGES stages of RG_STEPS steps each, filled with cp.async: while
// the lanes walk one stage, the next RG_STAGES - 1 are in flight (3 x 64
// steps x 32 channels x 2 tensors x 4 B = 48 KB an SM in fp32). Where C
// and the pointers allow it the copies are 16-byte chunks of a step's
// strip (a lane may fill another lane's channels, so a __syncwarp follows
// each wait); otherwise each lane copies the aligned 4-byte word holding
// its own element (for bf16 that word may reach 2 bytes before the
// tensor's first or past its last element, within the same 4-byte granule
// of its allocation). h is stored a step at a time, a 128-byte line a
// warp.
//
// Rounding: each step is an explicit fp32 multiply then add
// (__fmul_rn/__fadd_rn, which nvcc does not contract into an FMA), the
// order and rounding of the plain version (kernels/ref.py, rglru_scan), so
// the two agree bit for bit on the card. The order over S stays serial: a
// chunked two-pass scan would change the bits.

#include "common.cuh"

constexpr int RG_THREADS = 32;  // one warp a block, a lane a channel
constexpr int RG_STEPS = 64;    // steps a ring stage
constexpr int RG_STAGES = 4;    // ring depth: RG_STAGES - 1 stages in flight

// bytes of one step's strip in the ring: the 32 channels' elements (16-byte
// chunks), or a 4-byte word a lane
template <typename T, bool VEC>
__host__ __device__ constexpr int rg_row_bytes() {
    return VEC ? RG_THREADS * (int)sizeof(T) : RG_THREADS * 4;
}
template <typename T, bool VEC>
__host__ __device__ constexpr int rg_smem_bytes() {
    return RG_STAGES * 2 * RG_STEPS * rg_row_bytes<T, VEC>();
}

// element `lane` of a ring row: VEC rows hold the strip's elements; word
// rows a lane's aligned word, whose upper bf16 half is the element where
// its address is 2 mod 4 (`upper`)
template <typename T, bool VEC>
__device__ __forceinline__ float rg_read(const unsigned char* row, int lane,
                                         bool upper) {
    if constexpr (VEC) return to_f32(reinterpret_cast<const T*>(row)[lane]);
    const T* w = reinterpret_cast<const T*>(row + 4 * lane);
    if constexpr (sizeof(T) == 2) return to_f32(w[upper ? 1 : 0]);
    return to_f32(w[0]);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(RG_THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int S, int C) {
    constexpr int RB = rg_row_bytes<T, VEC>();
    constexpr int STAGE = 2 * RG_STEPS * RB;    // a rows, then x rows
    const int lane = threadIdx.x;
    const int c0 = blockIdx.x * RG_THREADS, c = c0 + lane;
    const int64_t base = (int64_t)blockIdx.y * S * C;   // (b, 0, 0)
    float hv = h0 != nullptr && c < C ? h0[(int64_t)blockIdx.y * C + c] : 0.f;
    extern __shared__ __align__(16) unsigned char ring[];

    auto fetch = [&](int kt) {
        unsigned char* sa = ring + (kt % RG_STAGES) * STAGE;
        unsigned char* sx = sa + RG_STEPS * RB;
        const int t0 = kt * RG_STEPS;
        if constexpr (VEC) {
            constexpr int EPC = 16 / (int)sizeof(T);   // elements a chunk
            constexpr int CH = RG_THREADS / EPC;       // chunks a row
            for (int i = lane; i < RG_STEPS * CH; i += RG_THREADS) {
                const int r = i / CH, k = i - r * CH;
                const bool live = t0 + r < S && c0 + k * EPC < C;
                const int64_t off =
                    live ? base + (int64_t)(t0 + r) * C + c0 + k * EPC : 0;
                cp_async16(sa + r * RB + 16 * k, a + off, live);
                cp_async16(sx + r * RB + 16 * k, x + off, live);
            }
        } else {
            for (int r = 0; r < RG_STEPS; ++r) {
                const bool live = t0 + r < S && c < C;
                const int64_t off =
                    live ? base + (int64_t)(t0 + r) * C + c : 0;
                const uintptr_t pa = (uintptr_t)(a + off) & ~(uintptr_t)3;
                const uintptr_t px = (uintptr_t)(x + off) & ~(uintptr_t)3;
                cp_async4(sa + r * RB + 4 * lane, (const void*)pa, live);
                cp_async4(sx + r * RB + 4 * lane, (const void*)px, live);
            }
        }
        cp_async_commit();
    };

    const int nk = (S + RG_STEPS - 1) / RG_STEPS;
#pragma unroll
    for (int k = 0; k < RG_STAGES - 1; ++k) {
        if (k < nk) fetch(k);
        else cp_async_commit();       // an empty group keeps the count
    }
    for (int kt = 0; kt < nk; ++kt) {
        // the stage consumed at kt - 1 is free (the __syncwarp below)
        if (kt + RG_STAGES - 1 < nk) fetch(kt + RG_STAGES - 1);
        else cp_async_commit();
        cp_async_wait<RG_STAGES - 1>();   // stage kt landed for this lane
        if constexpr (VEC) __syncwarp();  // ... and for the other lanes
        const unsigned char* sa = ring + (kt % RG_STAGES) * STAGE;
        const unsigned char* sx = sa + RG_STEPS * RB;
        const int t0 = kt * RG_STEPS, n = min(RG_STEPS, S - t0);
        int64_t off = base + (int64_t)t0 * C + c;
        for (int r = 0; r < n; ++r, off += C) {
            // the bf16 half of a word row: parity of the element's address
            const bool ua = !VEC && (((uintptr_t)(a + off) >> 1) & 1);
            const bool ux = !VEC && (((uintptr_t)(x + off) >> 1) & 1);
            const float av = rg_read<T, VEC>(sa + r * RB, lane, ua);
            const float xv = rg_read<T, VEC>(sx + r * RB, lane, ux);
            hv = __fadd_rn(__fmul_rn(av, hv), xv);
            if (c < C) h[off] = hv;
        }
        __syncwarp();                 // every lane is done with this stage
    }
    cp_async_wait<0>();               // no copy outlives the block
}

// 16-byte chunks where C is a whole number of them and a and x are
// 16-byte aligned
template <typename T>
static bool rg_vec(const void* a, const void* x, int C) {
    return C % (16 / (int)sizeof(T)) == 0 && (uintptr_t)a % 16 == 0 &&
           (uintptr_t)x % 16 == 0;
}

template <typename T, bool VEC>
static cudaError_t launch_t(const void* a, const void* x, const void* h0,
                            void* h, int B, int S, int C,
                            cudaStream_t stream) {
    const dim3 grid((C + RG_THREADS - 1) / RG_THREADS, B);
    return launch_with_smem(rglru_scan_kernel<T, VEC>, grid, dim3(RG_THREADS),
                            (size_t)rg_smem_bytes<T, VEC>(), stream,
                            (const T*)a, (const T*)x, (const float*)h0,
                            (float*)h, S, C);
}

template <typename T>
static cudaError_t launch(const void* a, const void* x, const void* h0,
                          void* h, int B, int S, int C, cudaStream_t stream) {
    return rg_vec<T>(a, x, C)
               ? launch_t<T, true>(a, x, h0, h, B, S, C, stream)
               : launch_t<T, false>(a, x, h0, h, B, S, C, stream);
}

template <typename T, bool VEC>
static cudaError_t attrs_t(int B, int C, int* out) {
    auto kern = rglru_scan_kernel<T, VEC>;
    const int smem = rg_smem_bytes<T, VEC>();
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      RG_THREADS, smem);
    out[0] = fa.numRegs;
    out[1] = smem;
    out[2] = (int)fa.localSizeBytes;
    out[3] = blocks;
    out[4] = (C + RG_THREADS - 1) / RG_THREADS;
    out[5] = B;
    out[6] = VEC ? 1 : 0;
    return e;
}

template <typename T>
static cudaError_t attrs(const void* a, const void* x, int B, int C,
                         int* out) {
    return rg_vec<T>(a, x, C) ? attrs_t<T, true>(B, C, out)
                              : attrs_t<T, false>(B, C, out);
}

// a, x (B, S, C) of `dtype` (DT_FLOAT32 or DT_BFLOAT16); h0 (B, C) fp32 or
// null; h (B, S, C) fp32. All contiguous. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* x,
                                 const void* h0, void* h, int B, int S,
                                 int C, int dtype, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (dtype == DT_FLOAT32)
        return (int)launch<float>(a, x, h0, h, B, S, C, s);
    if (dtype == DT_BFLOAT16)
        return (int)launch<__nv_bfloat16>(a, x, h0, h, B, S, C, s);
    return (int)cudaErrorInvalidValue;
}

// The variant rglru_scan_launch runs for these tensors: its registers,
// dynamic shared memory, local bytes, resident blocks an SM, grid (x, y)
// and whether it copies 16-byte chunks: out[0..6].
extern "C" int rglru_scan_attrs(const void* a, const void* x, int B, int C,
                                int dtype, int* out) {
    if (dtype == DT_FLOAT32) return (int)attrs<float>(a, x, B, C, out);
    if (dtype == DT_BFLOAT16)
        return (int)attrs<__nv_bfloat16>(a, x, B, C, out);
    return (int)cudaErrorInvalidValue;
}
