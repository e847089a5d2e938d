// Mamba-2 SSD intra-chunk pieces for Hopper (sm_90a). For every (batch,
// chunk, head) of x (B, nc, Q, H, P), dt (B, nc, Q, H), a (H,) and the
// head-shared B/C (B, nc, Q, N), all fp32:
//   cum[t]    = sum_{s<=t} dt[s] * a                  (inclusive, along Q)
//   y[t, p]   = sum_{s<=t} (C[t].B[s]) exp(cum[t] - cum[s]) dt[s] x[s, p]
//   state[p,n]= sum_s exp(cum[Q-1] - cum[s]) dt[s] x[s, p] B[s, n]
//   decay     = exp(cum[Q-1])
// The inter-chunk recurrence and the y_inter combine stay in PyTorch
// (models/ssm.py), as the reference leaves them to XLA.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py (ssd_chunk, the
// pl.pallas_call at line 60), one grid cell per (batch, head, chunk) with
// the whole (Q, Q) decay matrix, the (Q, N) B/C tiles and the (Q, P) x
// tile in VMEM (~0.6 MB at Q 256).
//
// What bounds it on this card: at mamba2-370m's prefill (Q 256, H 32,
// P 64, N 128) a chunk reads and writes ~2 MB per head-chunk group and
// does ~8 MFLOP per head (C.B^T, the masked product with x, and the state
// update), some 80 flops a byte. In fp32 that is below the TF32
// tensor-core ridge (~150 flops a byte at 494 TFLOP/s and 3.35 TB/s), so
// the least time is the bytes: x and y dominate. This version does its
// math in fp32 on CUDA cores (67 TFLOP/s), which at ~80 flops a byte puts
// the CUDA-core ceiling above the byte time: a ceiling of this design that
// TF32 wgmma tiles remove.
//
// What this simple design does about it:
// - The Pallas cell cannot live in 227 KB of shared memory (B and C alone
//   are 256 KB at Q 256, N 128), so each block takes one 64-row query tile
//   of one (batch, chunk, head) and walks 64-row key tiles up to its causal
//   diagonal, flash style: the C tile stays in shared memory, each key tile
//   of B and x is staged once, and the (64, 64) score tile is computed as
//   4x4 register tiles from transposed C/B tiles (float4 broadcasts), masked
//   and decayed in registers, then multiplied into a (64, P) accumulator.
//   One more block per (batch, chunk, head) computes the (P, N) state over
//   all Q rows. So a chunk's work spreads over ceil(Q/64) + 1 blocks (960
//   at nc 6, H 32), not one, and a ragged Q (1..1024) is masked, not
//   padded.
// - The decay is masked BEFORE exp: exp(-inf) is an exact 0, so the upper
//   triangle never overflows and never makes inf * 0 = NaN.
// - cum is the reference's formulation, an inclusive prefix sum of the
//   fp32 products dt * a, taken in order by one thread (Q adds, ~1 us),
//   the order torch.cumsum takes along a non-innermost dimension: where
//   |cum| reaches ~5,000 (a = -32) a different order moves cum_t - cum_s
//   by ulps of 5,000, which the exp turns into relative errors of ~1e-3.
//   Rounding is explicit (__fmul_rn/__fadd_rn) so nvcc cannot fuse it.
// - C.B^T does not depend on the head, yet every head's blocks compute it
//   again (as the Pallas grid does); sharing it across heads, TF32 wgmma
//   and TMA-fed tiles are the follow-ups.

#include "common.cuh"

constexpr int SSD_THREADS = 256;
constexpr int TQ = 64;           // query rows per y block
constexpr int TS = 64;           // key rows per tile
constexpr int TP = TQ + 4;       // row of a transposed tile (float4-aligned)
constexpr int SP = TS + 4;       // row of the score tile
constexpr int QMAX = 1024;       // longest chunk the shared memory takes

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// floats of dynamic shared memory: cum, dt and w (Q each), then the larger
// of a y block's tiles (C^T, B^T, x, scores) and the state block's (x, B w)
__host__ __device__ constexpr int ssd_smem_floats(int Q, int P, int N) {
    const int y_tiles = 2 * N * TP + TS * P + TQ * SP;
    const int st_tiles = TS * P + TS * N;
    return 3 * round4(Q) + (y_tiles > st_tiles ? y_tiles : st_tiles);
}

// grid (ceil(Q/TQ) + 1, H, B * nc): x = query tile, or the state block
template <int PJ, int NJ>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ state, float* __restrict__ decay,
                 float* __restrict__ cum_out, int Q, int H) {
    constexpr int P = 16 * PJ, N = 16 * NJ;
    const int nqt = (Q + TQ - 1) / TQ;
    const int z = blockIdx.x, h = blockIdx.y;
    const int64_t bc = blockIdx.z;            // b * nc + c
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;

    extern __shared__ __align__(16) float smem[];
    float* cum = smem;
    float* dts = cum + round4(Q);
    float* ws = dts + round4(Q);
    float* work = ws + round4(Q);

    // dA = dt * a, then the inclusive prefix sum in order
    const float ah = a[h];
    for (int s = tid; s < Q; s += SSD_THREADS) {
        const float d = dt[(bc * Q + s) * H + h];
        dts[s] = d;
        cum[s] = __fmul_rn(d, ah);
    }
    __syncthreads();
    if (tid == 0) {
        float acc = 0.f;
#pragma unroll 8
        for (int s = 0; s < Q; ++s) {
            acc = __fadd_rn(acc, cum[s]);
            cum[s] = acc;
        }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    if (z == 0) {
        for (int s = tid; s < Q; s += SSD_THREADS)
            cum_out[(bc * Q + s) * H + h] = cum[s];
        if (tid == 0) decay[bc * H + h] = expf(total);
    }

    if (z == nqt) {
        // ---- state[p, n] = sum_s x[s, p] * (w[s] * B[s, n]) -------------
        for (int s = tid; s < Q; s += SSD_THREADS)
            ws[s] = expf(total - cum[s]) * dts[s];
        float* xs = work;              // (TS, P)
        float* bw = xs + TS * P;       // (TS, N)
        float acc[PJ][NJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
        for (int k0 = 0; k0 < Q; k0 += TS) {
            const int kn = min(TS, Q - k0);
            __syncthreads();           // ws ready; previous tile consumed
            for (int i = tid; i < TS * P / 4; i += SSD_THREADS) {
                const int s = i / (P / 4), p4 = i - s * (P / 4);
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (s < kn)
                    v = reinterpret_cast<const float4*>(
                        x + ((bc * Q + k0 + s) * H + h) * P)[p4];
                reinterpret_cast<float4*>(xs + s * P)[p4] = v;
            }
            for (int i = tid; i < TS * N / 4; i += SSD_THREADS) {
                const int s = i / (N / 4), n4 = i - s * (N / 4);
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (s < kn) {
                    v = reinterpret_cast<const float4*>(
                        Bm + (bc * Q + k0 + s) * N)[n4];
                    const float w = ws[k0 + s];
                    v.x *= w; v.y *= w; v.z *= w; v.w *= w;
                }
                reinterpret_cast<float4*>(bw + s * N)[n4] = v;
            }
            __syncthreads();
            for (int s = 0; s < kn; ++s) {
                float xv[PJ], bv[NJ];
#pragma unroll
                for (int i = 0; i < PJ; ++i) xv[i] = xs[s * P + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < NJ; ++j) bv[j] = bw[s * N + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < PJ; ++i)
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
                        acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
            }
        }
        float* out = state + (bc * H + h) * P * N;
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                out[(ty + 16 * i) * N + tx + 16 * j] = acc[i][j];
        return;
    }

    // ---- y rows [t0, t0 + tn): a flash-style walk over key tiles --------
    const int t0 = z * TQ;
    const int tn = min(TQ, Q - t0);
    float* ct = work;                  // (N, TP): C tile, transposed
    float* bt = ct + N * TP;           // (N, TP): B tile, transposed
    float* xs = bt + N * TP;           // (TS, P)
    float* sc = xs + TS * P;           // (TQ, SP): masked, decayed scores
    for (int i = tid; i < TQ * N / 4; i += SSD_THREADS) {
        const int r = i / (N / 4), n = 4 * (i - r * (N / 4));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < tn)
            v = *reinterpret_cast<const float4*>(Cm + (bc * Q + t0 + r) * N
                                                 + n);
        ct[n * TP + r] = v.x;
        ct[(n + 1) * TP + r] = v.y;
        ct[(n + 2) * TP + r] = v.z;
        ct[(n + 3) * TP + r] = v.w;
    }
    float acc[4][PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
    const int kend = t0 + tn;          // causal: keys below the tile's end
    for (int k0 = 0; k0 < kend; k0 += TS) {
        const int kn = min(TS, kend - k0);
        for (int i = tid; i < TS * N / 4; i += SSD_THREADS) {
            const int s = i / (N / 4), n = 4 * (i - s * (N / 4));
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (s < kn)
                v = *reinterpret_cast<const float4*>(
                    Bm + (bc * Q + k0 + s) * N + n);
            bt[n * TP + s] = v.x;
            bt[(n + 1) * TP + s] = v.y;
            bt[(n + 2) * TP + s] = v.z;
            bt[(n + 3) * TP + s] = v.w;
        }
        for (int i = tid; i < TS * P / 4; i += SSD_THREADS) {
            const int s = i / (P / 4), p4 = i - s * (P / 4);
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (s < kn)
                v = reinterpret_cast<const float4*>(
                    x + ((bc * Q + k0 + s) * H + h) * P)[p4];
            reinterpret_cast<float4*>(xs + s * P)[p4] = v;
        }
        __syncthreads();
        // scores of rows ty*4+i against keys tx*4+j
        float s_acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s_acc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
            const float4 cv =
                *reinterpret_cast<const float4*>(ct + n * TP + ty * 4);
            const float4 bv =
                *reinterpret_cast<const float4*>(bt + n * TP + tx * 4);
            const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
            const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s_acc[i][j] = fmaf(c4[i], b4[j], s_acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i, t = t0 + r;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int sl = tx * 4 + j, s = k0 + sl;
                // mask before exp: a key after the query contributes an
                // exact 0, and cum is never read past the chunk
                float v = 0.f;
                if (r < tn && sl < kn && s <= t)
                    v = s_acc[i][j] * expf(cum[t] - cum[s]) * dts[s];
                sc[r * SP + sl] = v;
            }
        }
        __syncthreads();
        for (int s = 0; s < kn; ++s) {
            float xv[PJ];
#pragma unroll
            for (int j = 0; j < PJ; ++j) xv[j] = xs[s * P + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float sv = sc[(ty * 4 + i) * SP + s];
#pragma unroll
                for (int j = 0; j < PJ; ++j)
                    acc[i][j] = fmaf(sv, xv[j], acc[i][j]);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= tn) continue;
        float* out = y + ((bc * Q + t0 + r) * H + h) * P;
#pragma unroll
        for (int j = 0; j < PJ; ++j) out[tx + 16 * j] = acc[i][j];
    }
}

template <int PJ, int NJ>
static cudaError_t launch(const float* x, const float* dt, const float* a,
                          const float* Bm, const float* Cm, float* y,
                          float* state, float* decay, float* cum, int BC,
                          int Q, int H, cudaStream_t stream) {
    const dim3 grid((Q + TQ - 1) / TQ + 1, H, BC);
    const size_t smem =
        sizeof(float) * (size_t)ssd_smem_floats(Q, 16 * PJ, 16 * NJ);
    return launch_with_smem(ssd_chunk_kernel<PJ, NJ>, grid,
                            dim3(SSD_THREADS), smem, stream, x, dt, a, Bm,
                            Cm, y, state, decay, cum, Q, H);
}

#define SSD_DISPATCH_N(PJ)                                                    \
    (N == 16    ? (int)launch<PJ, 1>(x, dt, a, Bm, Cm, y, st, dc, cum, BC, Q, \
                                     H, s)                                    \
     : N == 32  ? (int)launch<PJ, 2>(x, dt, a, Bm, Cm, y, st, dc, cum, BC, Q, \
                                     H, s)                                    \
     : N == 64  ? (int)launch<PJ, 4>(x, dt, a, Bm, Cm, y, st, dc, cum, BC, Q, \
                                     H, s)                                    \
     : N == 128 ? (int)launch<PJ, 8>(x, dt, a, Bm, Cm, y, st, dc, cum, BC, Q, \
                                     H, s)                                    \
                : (int)cudaErrorInvalidValue)

// x (BC, Q, H, P), dt (BC, Q, H), a (H,), B/C (BC, Q, N) -> y (BC, Q, H,
// P), state (BC, H, P, N), decay (BC, H), cum (BC, Q, H); BC = batch *
// chunks. All fp32, contiguous, 16-byte aligned; P and N in {16, 32, 64,
// 128}; 1 <= Q <= 1024. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int ssd_chunk_launch(const float* x, const float* dt,
                                const float* a, const float* Bm,
                                const float* Cm, float* y, float* st,
                                float* dc, float* cum, int BC, int Q, int H,
                                int P, int N, void* stream) {
    if (Q < 1 || Q > QMAX) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (P) {
        case 16: return SSD_DISPATCH_N(1);
        case 32: return SSD_DISPATCH_N(2);
        case 64: return SSD_DISPATCH_N(4);
        case 128: return SSD_DISPATCH_N(8);
        default: return (int)cudaErrorInvalidValue;
    }
}
