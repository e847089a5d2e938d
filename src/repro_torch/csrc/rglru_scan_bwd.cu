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
// bytes over 3.35 TB/s (0.050 ms at recurrentgemma-9b's train shape, 1 x
// 2,048 x 4,096, whose 128 strips leave one an SM). The serial chain of
// 2,048 dependent multiply-then-adds is ~10 us. At the byte rate an SM
// moves ~14.5 bytes a cycle, so a strip's step, 640 bytes, may take ~45
// cycles: a warp that issued the ring's copies itself and then, step by
// step, three shared loads whose latency fell between the chain and two
// global stores took ~150-180 on an H100.
//
// The design: a block is two warps over a strip of 32 neighbouring
// channels. A producer warp fills a shared-memory ring of RB_STAGES stages
// of RB_STEPS steps of a, h and gh with cp.async, from the END of the
// sequence; the consumer warp, a lane a channel, only reads it. Each stage
// has a full and an empty mbarrier: a producer lane arrives on the full one
// once its copies have landed (cp.async.mbarrier.arrive), a consumer lane
// on the empty one once it has read the stage. Where C and the pointers
// allow it the copies are 16-byte chunks of a step's strip; otherwise each
// producer lane copies the aligned 4-byte word holding its channel's
// element (as K6 does: for bf16 that word may reach 2 bytes past the
// tensor's ends, within the same 4-byte granule of its allocation). A
// step's strip of a tensor is one contiguous 128 bytes, but 1-D bulk
// copies of it (cp.async.bulk, completing on the barrier) ran far slower
// on an H100: each small bulk copy costs the block a fixed time, three a
// step. Stages are aligned to step 0, so only the first stage walked, the
// top of the sequence, is ragged: the consumer takes it one step at a
// time up to whole batches. Every later stage is
// RB_STEPS / RB_BATCH batches of RB_BATCH steps: a batch's 3 x RB_BATCH
// shared loads issue together under one latency, then its dependent
// multiply-adds run, then its 2 x RB_BATCH coalesced stores (a 128-byte
// line a warp in fp32). A lane keeps g and a[t+1] in registers; ga[t+1] =
// g[t+1] * h[t] is written once h[t] is read. Three stages of 64 steps
// (two in flight while one is read) ran faster on an H100 than deeper
// rings or longer or shorter stages.
//
// Rounding: each step is an explicit fp32 multiply then add
// (__fmul_rn/__fadd_rn, which nvcc does not contract into an FMA), the
// order and rounding of the plain version (kernels/ref.py,
// rglru_scan_bwd), so the two agree bit for bit; ga and gx are rounded
// to bf16 (round to nearest even) as torch's cast does. The order over S
// stays serial: a chunked two-pass scan would change the bits.

#include "common.cuh"

constexpr int RB_THREADS = 64;  // the consumer warp (0), the producer (1)
constexpr int RB_STEPS = 64;    // steps a ring stage
constexpr int RB_STAGES = 3;    // ring depth
constexpr int RB_BATCH = 16;    // steps a consumer batch
static_assert(RB_STEPS % RB_BATCH == 0, "a stage is whole batches");

// bytes of one step's strip of a tensor of E in the ring: the 32
// channels' elements (16-byte chunks), or a 4-byte word a lane
template <typename E, bool VEC>
__host__ __device__ constexpr int rb_row_bytes() {
    return VEC ? 32 * (int)sizeof(E) : 32 * 4;
}
// a stage: RB_STEPS rows of a (T), then of h and of gh (fp32)
template <typename T, bool VEC>
__host__ __device__ constexpr int rb_stage_bytes() {
    return RB_STEPS *
           (rb_row_bytes<T, VEC>() + 2 * rb_row_bytes<float, VEC>());
}
// the ring, then a full and an empty barrier a stage
template <typename T, bool VEC>
__host__ __device__ constexpr int rb_smem_bytes() {
    return RB_STAGES * rb_stage_bytes<T, VEC>() + 2 * RB_STAGES * 8;
}

// copy the strip's rows [t0, t0 + n) of src (B, S, C), from (b, 0, 0) at
// `base`, into ring rows [0, n): 16-byte chunks spread over the lanes, or
// the aligned 4-byte word holding the lane's own element
template <typename E, bool VEC>
__device__ __forceinline__ void rb_fill(unsigned char* dst,
                                        const E* __restrict__ src,
                                        int64_t base, int t0, int n, int c0,
                                        int lane, int C) {
    constexpr int RB = rb_row_bytes<E, VEC>();
    if constexpr (VEC) {
        constexpr int EPC = 16 / (int)sizeof(E);   // elements a chunk
        constexpr int CH = 32 / EPC;               // chunks a row
        for (int i = lane; i < n * CH; i += 32) {
            const int r = i / CH, k = i - r * CH;
            const bool live = c0 + k * EPC < C;
            const int64_t off =
                live ? base + (int64_t)(t0 + r) * C + c0 + k * EPC : 0;
            cp_async16(dst + r * RB + 16 * k, src + off, live);
        }
    } else {
        const bool live = c0 + lane < C;
        int64_t off = live ? base + (int64_t)t0 * C + c0 + lane : 0;
        const int64_t step = live ? C : 0;
        for (int r = 0; r < n; ++r, off += step) {
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

// N steps of a lane's channel, from ring row r of a stage down to row
// r - N + 1: the 3N shared loads first, then the dependent chain, then the
// stores. pgx points at gx's element of row r's step t, pga at ga's of
// step t + 1; both step down a row a step. `ua` is the bf16 half of a's
// word at row r, which flips a step where `codd` (C odd). Nothing is
// stored where !live, and no ga for the first step where !ga_first (the
// top step, whose t + 1 is S).
template <typename T, bool VEC, int N>
__device__ __forceinline__ void rb_steps(const unsigned char* sa,
                                         const unsigned char* sh,
                                         const unsigned char* sg, int r,
                                         int lane, bool& ua, bool codd,
                                         float& g, float& a_next, T*& pga,
                                         T*& pgx, int C, bool live,
                                         bool ga_first) {
    constexpr int RA = rb_row_bytes<T, VEC>(), RF = rb_row_bytes<float, VEC>();
    float hv[N], gv[N], av[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        hv[i] = rb_read<float, VEC>(sh + (r - i) * RF, lane, false);
        gv[i] = rb_read<float, VEC>(sg + (r - i) * RF, lane, false);
        av[i] = rb_read<T, VEC>(sa + (r - i) * RA, lane, ua);
        ua = ua != codd;
    }
    float go[N], xo[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        go[i] = __fmul_rn(g, hv[i]);            // ga[t + 1] = g[t + 1] h[t]
        g = __fadd_rn(gv[i], __fmul_rn(a_next, g));
        xo[i] = g;
        a_next = av[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i, pga -= C, pgx -= C) {
        if (live && (i > 0 || ga_first)) *pga = from_f32<T>(go[i]);
        if (live) *pgx = from_f32<T>(xo[i]);
    }
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
    extern __shared__ __align__(128) unsigned char ring[];
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + RB_STAGES * STAGE);
    uint64_t* empty = full + RB_STAGES;
    const int lane = threadIdx.x & 31;
    const int c0 = blockIdx.x * 32, c = c0 + lane;
    const int64_t base = (int64_t)blockIdx.y * S * C;   // (b, 0, 0)
    // stage k holds the steps [k RB_STEPS, (k + 1) RB_STEPS) below S; the
    // walk's j-th stage is nk - 1 - j, in ring slot j % RB_STAGES
    const int nk = (S + RB_STEPS - 1) / RB_STEPS;
    if (threadIdx.x == 0) {
        for (int s = 0; s < RB_STAGES; ++s) {
            mbar_init(&full[s], 32);          // the producer's lanes
            mbar_init(&empty[s], 32);         // the consumer's lanes
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= 32) {                  // the producer warp
        for (int j = 0; j < nk; ++j) {
            const int s = j % RB_STAGES;
            // the slot's last stage has been read
            if (j >= RB_STAGES) mbar_wait(&empty[s], (j / RB_STAGES - 1) & 1);
            const int t0 = (nk - 1 - j) * RB_STEPS, n = min(RB_STEPS, S - t0);
            unsigned char* sa = ring + s * STAGE;
            unsigned char* sh = sa + RB_STEPS * RA;
            unsigned char* sg = sh + RB_STEPS * RF;
            rb_fill<T, VEC>(sa, a, base, t0, n, c0, lane, C);
            rb_fill<float, VEC>(sh, h, base, t0, n, c0, lane, C);
            rb_fill<float, VEC>(sg, gh, base, t0, n, c0, lane, C);
            cp_async_mbar_arrive(&full[s]);   // once this lane's copies land
        }
        cp_async_wait<0>();                   // no copy outlives the warp
        return;
    }

    // the consumer warp
    const bool live = c < C;
    const bool codd = !VEC && sizeof(T) == 2 && (C & 1);
    float g = 0.f, a_next = 0.f;
    if (nk > 0) {
        const int64_t top = base + (int64_t)(S - 1) * C + c;   // step S - 1
        bool ua = !VEC && sizeof(T) == 2 && (((uintptr_t)(a + top) >> 1) & 1);
        T* pgx = gx + top;
        T* pga = ga + top + C;
        for (int j = 0; j < nk; ++j) {
            const int s = j % RB_STAGES;
            mbar_wait(&full[s], (j / RB_STAGES) & 1);
            const unsigned char* sa = ring + s * STAGE;
            const unsigned char* sh = sa + RB_STEPS * RA;
            const unsigned char* sg = sh + RB_STEPS * RF;
            if (j == 0) {
                // the ragged stage: the top step (no ga[S]), single steps
                // up to whole batches, then batches
                int r = S - (nk - 1) * RB_STEPS - 1;
                rb_steps<T, VEC, 1>(sa, sh, sg, r, lane, ua, codd, g, a_next,
                                    pga, pgx, C, live, false);
                --r;
#pragma unroll 1
                for (int e = (r + 1) % RB_BATCH; e > 0; --e, --r)
                    rb_steps<T, VEC, 1>(sa, sh, sg, r, lane, ua, codd, g,
                                        a_next, pga, pgx, C, live, true);
#pragma unroll 1
                for (; r >= 0; r -= RB_BATCH)
                    rb_steps<T, VEC, RB_BATCH>(sa, sh, sg, r, lane, ua, codd,
                                               g, a_next, pga, pgx, C, live,
                                               true);
            } else {
#pragma unroll
                for (int r = RB_STEPS - 1; r >= 0; r -= RB_BATCH)
                    rb_steps<T, VEC, RB_BATCH>(sa, sh, sg, r, lane, ua, codd,
                                               g, a_next, pga, pgx, C, live,
                                               true);
            }
            mbar_arrive(&empty[s]);             // this lane is done with it
        }
    }
    if (live && S > 0) {
        const float hp = h0 != nullptr ? h0[(int64_t)blockIdx.y * C + c] : 0.f;
        ga[base + c] = from_f32<T>(__fmul_rn(g, hp));
    }
    if (live && h0 != nullptr)
        gh0[(int64_t)blockIdx.y * C + c] = __fmul_rn(a_next, g);
}

// 16-byte chunks where C is a whole number of them for
// both element types and a, h and gh are 16-byte aligned
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
    const dim3 grid((C + 31) / 32, B);
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
    out[4] = (C + 31) / 32;
    out[5] = B;
    out[6] = VEC ? 1 : 0;
    out[7] = RB_THREADS;
    out[8] = RB_STAGES;
    out[9] = RB_STEPS;
    out[10] = RB_BATCH;
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
// grid (x, y), whether it copies 16-byte chunks (else 4-byte words),
// threads a block (a consumer and a producer warp), ring stages, steps a
// stage and steps a consumer batch: out[0..10].
extern "C" int rglru_scan_bwd_attrs(const void* a, const void* h,
                                    const void* gh, int B, int C, int dtype,
                                    int* out) {
    if (dtype == DT_FLOAT32) return (int)attrs<float>(a, h, gh, B, C, out);
    if (dtype == DT_BFLOAT16)
        return (int)attrs<__nv_bfloat16>(a, h, gh, B, C, out);
    return (int)cudaErrorInvalidValue;
}
