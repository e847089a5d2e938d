// One-token GQA decode attention over a K/V store whose rows are found by a
// functor: the body of K1 (paged_attention.cu, rows through a block table)
// and K3 (decode_attention.cu, rows of a dense cache).
//
// One block per (sequence, kv head): each of the block's 8 warps (4 where
// 8 warps' staged fp32 V rows of head_dim 256 would not fit the shared
// memory) walks its own 32-token tiles of the live context with a private online softmax,
// and the warps' partial (m, l, acc) merge in shared memory at the end. A
// lane owns one token of a tile: it issues its K row and its V row as
// 16-byte loads at once, so a warp keeps a whole tile's bytes in flight,
// scores its token against the G query heads of the kv head (queries
// broadcast from shared memory), and stages its V row and its
// probabilities in shared memory for the P.V product, where a lane owns
// D/32 output dims and reads four keys' probabilities per broadcast. Each
// live K/V byte is read from HBM once and serves all G query heads;
// nothing at or past the fill is read, so decode cost tracks the fill.
#pragma once

#include "common.cuh"

// warps per block, each walking its own tiles: 8, or 4 where 8 warps'
// staged V rows would take more than 200 KB of shared memory (fp32 K/V
// at head_dim 256)
template <typename TKV, int DPL>
__host__ __device__ constexpr int dec_warps() {
    return 8 * 32 * (32 * DPL + 16 / (int)sizeof(TKV)) * (int)sizeof(TKV) >
                   200 * 1024
               ? 4
               : 8;
}

// Element offset of token `tok` of sequence `b` in a (.., Hkv, D) K/V
// store, before the kv head's h * D.
struct PagedRows {             // (P, ps, Hkv, D) pages through (B, N) table
    const int32_t* block_table;
    int N, ps;
    int64_t row;               // Hkv * D
    __device__ __forceinline__ int64_t operator()(int b, int tok) const {
        const int ni = tok / ps;
        // read-only path, as a const __restrict__ kernel parameter gets
        return ((int64_t)__ldg(block_table + (int64_t)b * N + ni) * ps +
                (tok - ni * ps)) * row;
    }
};
struct DenseRows {             // (B, S, Hkv, D) cache
    int S;
    int64_t row;
    __device__ __forceinline__ int64_t operator()(int b, int tok) const {
        return ((int64_t)b * S + tok) * row;
    }
};

// q (B, H, D); out (B, H, D) in q's dtype; row b attends its first
// min(valid_lens[b], cap) tokens.
template <typename TQ, typename TKV, int DPL, typename Rows>
__global__ void __launch_bounds__(dec_warps<TKV, DPL>() * 32)
decode_walk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, Rows rows,
                   const int32_t* __restrict__ valid_lens,
                   TQ* __restrict__ out, int H, int Hkv, int cap,
                   float scale) {
    constexpr int D = 32 * DPL;
    constexpr int W = dec_warps<TKV, DPL>();
    constexpr int VS = D + 16 / (int)sizeof(TKV);  // padded staged V row
    const int b = blockIdx.x;
    const int G = H / Hkv;
    const int n_gc = (G + GMAX - 1) / GMAX;
    const int h = blockIdx.y / n_gc;
    const int g0 = (blockIdx.y - h * n_gc) * GMAX;
    const int gn = min(GMAX, G - g0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qs = reinterpret_cast<float*>(smem_raw);  // (GMAX, D) queries
    float* wm = qs + GMAX * D;                        // (W, GMAX) max
    float* wl = wm + W * GMAX;                        // (W, GMAX) sum
    float* pw = wl + W * GMAX + warp * GMAX * 32;     // this warp's (GMAX, 32) p
    float* tail = wl + W * GMAX + W * GMAX * 32;
    // the walk stages V rows here, the merge then reuses it for (W, GMAX, D)
    TKV* vs = reinterpret_cast<TKV*>(tail) + warp * 32 * VS;  // (32, VS)
    float* wacc = tail;

    // the query heads g0 .. g0+gn-1 of kv head h are contiguous in q[b]
    const int64_t qoff = ((int64_t)b * H + (int64_t)h * G + g0) * D;
    for (int i = threadIdx.x; i < gn * D; i += blockDim.x)
        qs[i] = to_f32(q[qoff + i]);
    __syncthreads();

    float m[GMAX], l[GMAX], acc[GMAX][DPL];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
        m[g] = REPRO_NEG_INF;
        l[g] = 0.f;  // this lane's share; summed over the warp at the end
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
    }
    const int live_len = min(valid_lens[b], cap);
    const int ntiles = (live_len + 31) / 32;
    for (int t = warp; t < ntiles; t += W) {
        const int tok = t * 32 + lane;
        const bool live = tok < live_len;
        TKV* vrow = vs + lane * VS;
        float s[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
        if (live) {
            const int64_t off = rows(b, tok) + (int64_t)h * D;
            const TKV* kr = k + off;
            const TKV* vr = v + off;
#pragma unroll 8
            for (int d0 = 0; d0 < D; d0 += 8) {
                float kv[8];
                load8(kr + d0, kv);
                copy8(vr + d0, vrow + d0);
#pragma unroll
                for (int g = 0; g < GMAX; ++g) {
                    if (g < gn) {
                        const float4 qa = *reinterpret_cast<const float4*>(
                            qs + g * D + d0);
                        const float4 qb = *reinterpret_cast<const float4*>(
                            qs + g * D + d0 + 4);
                        float a = s[g];
                        a = fmaf(qa.x, kv[0], a); a = fmaf(qa.y, kv[1], a);
                        a = fmaf(qa.z, kv[2], a); a = fmaf(qa.w, kv[3], a);
                        a = fmaf(qb.x, kv[4], a); a = fmaf(qb.y, kv[5], a);
                        a = fmaf(qb.z, kv[6], a); a = fmaf(qb.w, kv[7], a);
                        s[g] = a;
                    }
                }
            }
        } else {
            // past the fill: a zero V row, so p == 0 meets no stale bits
#pragma unroll 8
            for (int d0 = 0; d0 < D; d0 += 8) zero8(vrow + d0);
        }
        // online softmax over the tile; lane 0's token is always live, so
        // the tile max is a real score and masked lanes give p == 0
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
            if (g < gn) {
                const float sg = live ? s[g] * scale : REPRO_NEG_INF;
                const float mn = fmaxf(m[g], warp_max(sg));
                const float p = expf(sg - mn);
                const float c = expf(m[g] - mn);
                m[g] = mn;
                l[g] = l[g] * c + p;
                pw[g * 32 + lane] = p;
#pragma unroll
                for (int e = 0; e < DPL; ++e) acc[g][e] *= c;
            }
        }
        __syncwarp();
        // P.V, four keys per step: their probabilities arrive in one
        // broadcast read, their V rows in four conflict-free reads
        const int j4 = min(32, live_len - t * 32 + 3) & ~3;
#pragma unroll 2
        for (int j = 0; j < j4; j += 4) {
            float vv[4][DPL];
#pragma unroll
            for (int u = 0; u < 4; ++u)
                load_n<DPL>(vs + (j + u) * VS + lane * DPL, vv[u]);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
                if (g < gn) {
                    const float4 p4 =
                        *reinterpret_cast<const float4*>(pw + g * 32 + j);
#pragma unroll
                    for (int e = 0; e < DPL; ++e) {
                        float a = acc[g][e];
                        a = fmaf(p4.x, vv[0][e], a);
                        a = fmaf(p4.y, vv[1][e], a);
                        a = fmaf(p4.z, vv[2][e], a);
                        a = fmaf(p4.w, vv[3][e], a);
                        acc[g][e] = a;
                    }
                }
            }
        }
        __syncwarp();
    }
    // merge the warps' partial states; a warp that walked nothing holds
    // m = NEG_INF, l = 0, acc = 0 and adds exactly nothing
    __syncthreads();  // every warp is done with its staged V rows
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
        if (g < gn) {
            const float lw = warp_sum(l[g]);
            if (lane == 0) {
                wm[warp * GMAX + g] = m[g];
                wl[warp * GMAX + g] = lw;
            }
#pragma unroll
            for (int e = 0; e < DPL; ++e)
                wacc[(warp * GMAX + g) * D + lane * DPL + e] = acc[g][e];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < gn * D; i += blockDim.x) {
        const int g = i / D, d = i - g * D;
        float mx = REPRO_NEG_INF;
        for (int w = 0; w < W; ++w) mx = fmaxf(mx, wm[w * GMAX + g]);
        float sum = 0.f, a = 0.f;
        for (int w = 0; w < W; ++w) {
            const float c = expf(wm[w * GMAX + g] - mx);
            sum += wl[w * GMAX + g] * c;
            a += wacc[(w * GMAX + g) * D + d] * c;
        }
        out[qoff + i] = from_f32<TQ>(a / fmaxf(sum, 1e-30f));
    }
}

template <typename TQ, typename TKV, int DPL, typename Rows>
static cudaError_t launch_decode_walk(const void* q, const void* k,
                                      const void* v, Rows rows,
                                      const void* valid, void* out, int B,
                                      int H, int Hkv, int cap, float scale,
                                      cudaStream_t stream) {
    constexpr int D = 32 * DPL;
    constexpr int W = dec_warps<TKV, DPL>();
    constexpr int VS = D + 16 / (int)sizeof(TKV);
    const int n_gc = (H / Hkv + GMAX - 1) / GMAX;
    const size_t staged = sizeof(TKV) * W * 32 * VS;
    const size_t merged = sizeof(float) * W * GMAX * D;
    const size_t smem =
        sizeof(float) * (GMAX * D + 2 * W * GMAX + W * GMAX * 32) +
        (staged > merged ? staged : merged);
    return launch_with_smem(
        decode_walk_kernel<TQ, TKV, DPL, Rows>, dim3(B, Hkv * n_gc),
        dim3(W * 32), smem, stream, (const TQ*)q, (const TKV*)k,
        (const TKV*)v, rows, (const int32_t*)valid, (TQ*)out, H, Hkv, cap,
        scale);
}
