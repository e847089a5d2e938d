// The backward of K6 (rglru_scan.cu) for Hopper (sm_90a): for the forward
//   h[b, t, c] = a[b, t, c] * h[b, t-1, c] + x[b, t, c],  h[b, -1] = h0,
// the reverse recurrence
//   g[t] = gh[t] + a[t+1] * g[t+1],  g[S] = 0,
// and from it gx[t] = g[t], ga[t] = g[t] * h[t-1] (h[-1] = h0, or zeros)
// and gh0 = a[0] * g[0]. a (B, S, C) fp32 or bf16, h and gh (B, S, C)
// fp32, h0 (B, C) fp32 or absent; ga and gx (B, S, C) in a's type, gh0
// (B, C) fp32 (written only with h0). Every S and every C run.
//
// Replaces no TPU kernel. The reference trains the RG-LRU family through
// XLA's autodiff of lru_scan, an associative scan
// (src/repro/models/rglru.py:76-85); its Pallas kernel
// (src/repro/kernels/rglru.py:52) has no backward. In the port K6 fills h
// through a raw pointer, so this kernel is how the port computes the
// gradient that the reference gets from XLA.
//
// What bounds it on this card: bytes. Each step reads a, h and gh and
// writes ga and gx, 20 bytes in fp32 for 3 flops: the least time is those
// bytes over 3.35 TB/s (0.05 ms at recurrentgemma-9b's train shape, 1 x
// 2,048 x 4,096). The serial chain of 2,048 dependent multiply-adds is
// ~10 us. This first design reaches about a quarter of the byte rate
// there, where K6's forward walk reaches two thirds (chip_smoke.py's
// kernel rows, PERF.md): one warp an SM issues its three ring reads, two
// stores and the copies of three tensors for every step, walking the
// sequence from its end (ROADMAP, Queue 2).
//
// The design is K6's, walked the other way: a block is one warp, a lane
// a channel, over a strip of 32 neighbouring channels, and the strip's a,
// h and gh stream through a shared-memory ring of RB_STAGES stages of
// RB_STEPS steps each, filled with cp.async from the END of the sequence,
// RB_STAGES - 1 stages in flight. Where C and the pointers allow it the
// copies are 16-byte chunks of a step's strip; otherwise each lane copies
// the aligned 4-byte word holding its own element (as K6 does: for bf16
// that word may reach 2 bytes past the tensor's ends, within the same
// 4-byte granule of its allocation). A lane keeps g and a[t+1] in
// registers; ga[t+1] = g[t+1] * h[t] is written when step t is read.
//
// Rounding: each step is an explicit fp32 multiply then add
// (__fmul_rn/__fadd_rn, which nvcc does not contract into an FMA), the
// order and rounding of the plain version (kernels/ref.py,
// rglru_scan_bwd), so the two agree bit for bit; ga and gx are rounded
// to bf16 (round to nearest even) as torch's cast does.

#include "common.cuh"

constexpr int RB_THREADS = 32;  // one warp a block, a lane a channel
constexpr int RB_STEPS = 64;    // steps a ring stage
constexpr int RB_STAGES = 4;    // ring depth: RB_STAGES - 1 stages in flight

// bytes of one step's strip of a tensor of E in the ring: the 32
// channels' elements (16-byte chunks), or a 4-byte word a lane
template <typename E, bool VEC>
__host__ __device__ constexpr int rb_row_bytes() {
    return VEC ? RB_THREADS * (int)sizeof(E) : RB_THREADS * 4;
}
// a stage: RB_STEPS rows of a (T), then of h and of gh (fp32)
template <typename T, bool VEC>
__host__ __device__ constexpr int rb_stage_bytes() {
    return RB_STEPS *
           (rb_row_bytes<T, VEC>() + 2 * rb_row_bytes<float, VEC>());
}
template <typename T, bool VEC>
__host__ __device__ constexpr int rb_smem_bytes() {
    return RB_STAGES * rb_stage_bytes<T, VEC>();
}

// copy the strip's rows [t0, t0 + RB_STEPS) of src (B, S, C) into dst
template <typename E, bool VEC>
__device__ __forceinline__ void rb_fetch(unsigned char* dst,
                                         const E* __restrict__ src,
                                         int64_t base, int t0, int c0,
                                         int lane, int S, int C) {
    constexpr int RB = rb_row_bytes<E, VEC>();
    if constexpr (VEC) {
        constexpr int EPC = 16 / (int)sizeof(E);   // elements a chunk
        constexpr int CH = RB_THREADS / EPC;       // chunks a row
        for (int i = lane; i < RB_STEPS * CH; i += RB_THREADS) {
            const int r = i / CH, k = i - r * CH;
            const bool live = t0 + r >= 0 && t0 + r < S && c0 + k * EPC < C;
            const int64_t off =
                live ? base + (int64_t)(t0 + r) * C + c0 + k * EPC : 0;
            cp_async16(dst + r * RB + 16 * k, src + off, live);
        }
    } else {
        const int c = c0 + lane;
        for (int r = 0; r < RB_STEPS; ++r) {
            const bool live = t0 + r >= 0 && t0 + r < S && c < C;
            const int64_t off = live ? base + (int64_t)(t0 + r) * C + c : 0;
            const uintptr_t p = (uintptr_t)(src + off) & ~(uintptr_t)3;
            cp_async4(dst + r * RB + 4 * lane, (const void*)p, live);
        }
    }
}

// element `lane` of a ring row: VEC rows hold the strip's elements; word
// rows a lane's aligned word, whose upper bf16 half is the element where
// its address is 2 mod 4 (`upper`)
template <typename E, bool VEC>
__device__ __forceinline__ float rb_read(const unsigned char* row, int lane,
                                         bool upper) {
    if constexpr (VEC) return to_f32(reinterpret_cast<const E*>(row)[lane]);
    const E* w = reinterpret_cast<const E*>(row + 4 * lane);
    if constexpr (sizeof(E) == 2) return to_f32(w[upper ? 1 : 0]);
    return to_f32(w[0]);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(RB_THREADS)
rglru_scan_bwd_kernel(const T* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ gh,
                      const float* __restrict__ h0, T* __restrict__ ga,
                      T* __restrict__ gx, float* __restrict__ gh0, int S,
                      int C) {
    constexpr int RA = rb_row_bytes<T, VEC>(), RF = rb_row_bytes<float, VEC>();
    constexpr int STAGE = rb_stage_bytes<T, VEC>();
    const int lane = threadIdx.x;
    const int c0 = blockIdx.x * RB_THREADS, c = c0 + lane;
    const int64_t base = (int64_t)blockIdx.y * S * C;   // (b, 0, 0)
    extern __shared__ __align__(16) unsigned char ring[];

    // stage kt holds steps [S - (kt + 1) RB_STEPS, S - kt RB_STEPS), the
    // first of them possibly negative (not copied)
    const int nk = (S + RB_STEPS - 1) / RB_STEPS;
    auto fetch = [&](int kt) {
        unsigned char* sa = ring + (kt % RB_STAGES) * STAGE;
        unsigned char* sh = sa + RB_STEPS * RA;
        unsigned char* sg = sh + RB_STEPS * RF;
        const int t0 = S - (kt + 1) * RB_STEPS;
        // row r of a stage is step t0 + r; rows below step 0 are not
        // copied (zero-filled) and never read
        rb_fetch<T, VEC>(sa, a, base, t0, c0, lane, S, C);
        rb_fetch<float, VEC>(sh, h, base, t0, c0, lane, S, C);
        rb_fetch<float, VEC>(sg, gh, base, t0, c0, lane, S, C);
        cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < RB_STAGES - 1; ++k) {
        if (k < nk) fetch(k);
        else cp_async_commit();       // an empty group keeps the count
    }
    float g = 0.f, a_next = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
        // the stage consumed at kt - 1 is free (the __syncwarp below)
        if (kt + RB_STAGES - 1 < nk) fetch(kt + RB_STAGES - 1);
        else cp_async_commit();
        cp_async_wait<RB_STAGES - 1>();   // stage kt landed for this lane
        if constexpr (VEC) __syncwarp();  // ... and for the other lanes
        const unsigned char* sa = ring + (kt % RB_STAGES) * STAGE;
        const unsigned char* sh = sa + RB_STEPS * RA;
        const unsigned char* sg = sh + RB_STEPS * RF;
        const int t0 = S - (kt + 1) * RB_STEPS;
        const int rlo = t0 < 0 ? -t0 : 0;   // rows below step 0
        int64_t off = base + (int64_t)(t0 + RB_STEPS - 1) * C + c;
        for (int r = RB_STEPS - 1; r >= rlo; --r, off -= C) {
            // the bf16 half of a word row: parity of the element's address
            const bool ua = !VEC && (((uintptr_t)(a + off) >> 1) & 1);
            const float hv = rb_read<float, VEC>(sh + r * RF, lane, false);
            // ga[t + 1] = g[t + 1] h[t], now that h[t] is here
            if (c < C && t0 + r + 1 < S)
                ga[off + C] = from_f32<T>(__fmul_rn(g, hv));
            const float av = rb_read<T, VEC>(sa + r * RA, lane, ua);
            const float gv = rb_read<float, VEC>(sg + r * RF, lane, false);
            g = __fadd_rn(gv, __fmul_rn(a_next, g));
            if (c < C) gx[off] = from_f32<T>(g);
            a_next = av;
        }
        __syncwarp();                 // every lane is done with this stage
    }
    cp_async_wait<0>();               // no copy outlives the block
    if (c < C && S > 0) {
        const float hp = h0 != nullptr ? h0[(int64_t)blockIdx.y * C + c] : 0.f;
        ga[base + c] = from_f32<T>(__fmul_rn(g, hp));
    }
    if (c < C && h0 != nullptr)
        gh0[(int64_t)blockIdx.y * C + c] = __fmul_rn(a_next, g);
}

// 16-byte chunks where C is a whole number of them for both element types
// and a, h and gh are 16-byte aligned
template <typename T>
static bool rb_vec(const void* a, const void* h, const void* gh, int C) {
    return C % (16 / (int)sizeof(T)) == 0 && C % 4 == 0 &&
           (uintptr_t)a % 16 == 0 && (uintptr_t)h % 16 == 0 &&
           (uintptr_t)gh % 16 == 0;
}

template <typename T, bool VEC>
static cudaError_t launch_t(const void* a, const void* h, const void* gh,
                            const void* h0, void* ga, void* gx, void* gh0,
                            int B, int S, int C, cudaStream_t stream) {
    const dim3 grid((C + RB_THREADS - 1) / RB_THREADS, B);
    return launch_with_smem(
        rglru_scan_bwd_kernel<T, VEC>, grid, dim3(RB_THREADS),
        (size_t)rb_smem_bytes<T, VEC>(), stream, (const T*)a, (const float*)h,
        (const float*)gh, (const float*)h0, (T*)ga, (T*)gx, (float*)gh0, S, C);
}

template <typename T>
static cudaError_t launch(const void* a, const void* h, const void* gh,
                          const void* h0, void* ga, void* gx, void* gh0,
                          int B, int S, int C, cudaStream_t stream) {
    return rb_vec<T>(a, h, gh, C)
               ? launch_t<T, true>(a, h, gh, h0, ga, gx, gh0, B, S, C, stream)
               : launch_t<T, false>(a, h, gh, h0, ga, gx, gh0, B, S, C,
                                    stream);
}

template <typename T, bool VEC>
static cudaError_t attrs_t(int B, int C, int* out) {
    auto kern = rglru_scan_bwd_kernel<T, VEC>;
    const int smem = rb_smem_bytes<T, VEC>();
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      RB_THREADS, smem);
    out[0] = fa.numRegs;
    out[1] = smem;
    out[2] = (int)fa.localSizeBytes;
    out[3] = blocks;
    out[4] = (C + RB_THREADS - 1) / RB_THREADS;
    out[5] = B;
    out[6] = VEC ? 1 : 0;
    return e;
}

template <typename T>
static cudaError_t attrs(const void* a, const void* h, const void* gh, int B,
                         int C, int* out) {
    return rb_vec<T>(a, h, gh, C) ? attrs_t<T, true>(B, C, out)
                                  : attrs_t<T, false>(B, C, out);
}

// a (B, S, C) of `dtype` (DT_FLOAT32 or DT_BFLOAT16); h, gh (B, S, C)
// fp32; h0 (B, C) fp32 or null; ga, gx (B, S, C) of `dtype`; gh0 (B, C)
// fp32, written only with h0. All contiguous. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int rglru_scan_bwd_launch(const void* a, const void* h,
                                     const void* gh, const void* h0,
                                     void* ga, void* gx, void* gh0, int B,
                                     int S, int C, int dtype, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (dtype == DT_FLOAT32)
        return (int)launch<float>(a, h, gh, h0, ga, gx, gh0, B, S, C, s);
    if (dtype == DT_BFLOAT16)
        return (int)launch<__nv_bfloat16>(a, h, gh, h0, ga, gx, gh0, B, S, C,
                                          s);
    return (int)cudaErrorInvalidValue;
}

// The variant rglru_scan_bwd_launch runs for these tensors: its
// registers, dynamic shared memory, local bytes, resident blocks an SM,
// grid (x, y) and whether it copies 16-byte chunks: out[0..6].
extern "C" int rglru_scan_bwd_attrs(const void* a, const void* h,
                                    const void* gh, int B, int C, int dtype,
                                    int* out) {
    if (dtype == DT_FLOAT32) return (int)attrs<float>(a, h, gh, B, C, out);
    if (dtype == DT_BFLOAT16)
        return (int)attrs<__nv_bfloat16>(a, h, gh, B, C, out);
    return (int)cudaErrorInvalidValue;
}
