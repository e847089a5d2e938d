// Multi-token GQA attention over a K/V store whose rows are found by a
// functor (decode_walk.cuh's PagedRows / DenseRows): the body of K2
// (chunked_prefill.cu, a chunk against paged context) and K4
// (flash_attention.cu, a prompt against its own dense K/V).
//
// Query token t of row b sits at absolute position start[b] + t (start is
// 0 without a start vector); with CAUSAL it attends keys at positions
// <= its own, otherwise every key below `cap`. WINDOWED (local attention,
// K4 only) also drops keys at or below its position minus `window`, and
// the block's walk begins at the first key tile some row of its q tile
// can attend. CAUSAL and WINDOWED are template parameters, not runtime
// flags: with a causal flag, K2 ran 6% slower on the card than before K4
// shared its walk.
//
// One block per (row, kv head, q tile of 16 tokens; 4 at head_dim 256,
// where 16 tokens' rows would need 128 fp32 accumulators a thread and
// ~214 KB of shared memory). The block's 8 warps load
// each 32-key tile into shared memory together (16-byte loads, converted
// to fp32 once), so one read of a K/V row serves every query head of the
// kv head and every token of the q tile; the next tile's loads are in
// flight in registers while the current one is computed. Each warp owns a
// share of the tile's G * 16 query rows: a lane scores one key against
// them (queries broadcast from shared memory, keys read conflict-free),
// the warp keeps each row's online softmax in registers and its
// probabilities in shared memory, and the P.V product gives each lane
// D/32 output dims, reading four keys' probabilities per broadcast. Keys
// past the tile's causal horizon are never read, and a ragged last q tile
// is masked, so every query length runs.
#pragma once

#include "decode_walk.cuh"

constexpr int PF_WARPS = 8;                 // warps per block
constexpr int PF_THREADS = PF_WARPS * 32;
constexpr int KT = 32;                      // keys per shared-memory tile

// query tokens per block at head_dim 32 * DPL
template <int DPL>
__host__ __device__ constexpr int pf_bq() {
    return DPL >= 8 ? 4 : 16;
}

// q (B, T, H, D); out (B, T, H, D) in q's dtype; start_pos (B,) int32 or
// null (all 0); keys [0, cap) exist; with WINDOWED, a query at position p
// attends keys in (p - window, p], window >= 1.
template <typename TQ, typename TKV, int DPL, typename Rows, bool CAUSAL,
          bool WINDOWED>
__global__ void __launch_bounds__(PF_THREADS)
prefill_walk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, Rows rows,
                    const int32_t* __restrict__ start_pos,
                    TQ* __restrict__ out, int T, int H, int Hkv, int cap,
                    int window, float scale) {
    constexpr int D = 32 * DPL;
    constexpr int BQ = pf_bq<DPL>();
    constexpr int RPW = BQ * GMAX / PF_WARPS;  // query rows per warp, at most
    constexpr int KS = D + 4;   // padded fp32 K/V row: conflict-free lanes
    constexpr int CH = D / 8;   // 16-byte chunks per key row
    constexpr int CPT = (KT * CH + PF_THREADS - 1) / PF_THREADS;
    const int b = blockIdx.x;
    const int G = H / Hkv;
    const int n_gc = (G + GMAX - 1) / GMAX;
    const int h = blockIdx.y / n_gc;
    const int g0 = (blockIdx.y - h * n_gc) * GMAX;
    const int gn = min(GMAX, G - g0);
    const int t0 = blockIdx.z * BQ;
    const int tn = min(BQ, T - t0);   // query tokens in this tile
    const int R = tn * gn;            // query rows, r = tl * gn + g
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* ks = reinterpret_cast<float*>(smem_raw);  // (KT, KS)
    float* vs = ks + KT * KS;                         // (KT, KS)
    float* ps_ = vs + KT * KS;                        // (BQ * gn, KT) p
    float* qs = ps_ + BQ * gn * KT;                   // (BQ * gn, D)

    const int start = start_pos != nullptr ? start_pos[b] : 0;
    const int64_t tok = (int64_t)H * D;  // one query token's stride
    const int64_t qbase =
        ((int64_t)b * T + t0) * tok + ((int64_t)h * G + g0) * D;
    for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
        const int r = i / D, d = i - r * D;
        const int tl = r / gn, g = r - tl * gn;
        qs[i] = to_f32(q[qbase + tl * tok + g * D + d]);
    }

    // this warp's rows are r = warp + PF_WARPS * i
    float m[RPW], l[RPW], acc[RPW][DPL];
    int qpos[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        m[i] = REPRO_NEG_INF;
        l[i] = 0.f;  // this lane's share; summed over the warp at the end
        qpos[i] = start + t0 + (warp + PF_WARPS * i) / gn;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
    }
    // keys [kbeg, kend) can be attended by some row of the tile; with a
    // window the walk begins at the tile holding the first row's first key
    const int kend = CAUSAL ? min(start + t0 + tn, cap) : cap;
    const int kbeg = WINDOWED ? max(0, start + t0 - window + 1) / KT * KT : 0;

    // this thread's 16-byte chunks of a key tile, fetched into registers
    // one tile ahead; keys past kend read as zeros
    float kn[CPT][8], vn[CPT][8];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const int idx = threadIdx.x + c * PF_THREADS;
            const int j = idx / CH, d0 = (idx - j * CH) * 8;
            const int key = k0 + j;
            if (idx < KT * CH && key < kend) {
                const int64_t off = rows(b, key) + (int64_t)h * D + d0;
                load8(k + off, kn[c]);
                load8(v + off, vn[c]);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) kn[c][e] = vn[c][e] = 0.f;
            }
        }
    };
    fetch(kbeg);
    for (int k0 = kbeg; k0 < kend; k0 += KT) {
        __syncthreads();  // queries loaded / previous tile consumed
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const int idx = threadIdx.x + c * PF_THREADS;
            if (idx < KT * CH) {
                const int j = idx / CH, d0 = (idx - j * CH) * 8;
                float4* kd = reinterpret_cast<float4*>(ks + j * KS + d0);
                float4* vd = reinterpret_cast<float4*>(vs + j * KS + d0);
                kd[0] = make_float4(kn[c][0], kn[c][1], kn[c][2], kn[c][3]);
                kd[1] = make_float4(kn[c][4], kn[c][5], kn[c][6], kn[c][7]);
                vd[0] = make_float4(vn[c][0], vn[c][1], vn[c][2], vn[c][3]);
                vd[1] = make_float4(vn[c][4], vn[c][5], vn[c][6], vn[c][7]);
            }
        }
        __syncthreads();
        if (k0 + KT < kend) fetch(k0 + KT);
        // scores: lane = key k0 + lane against each of the warp's rows
        const int key = k0 + lane;
        float s[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) s[i] = 0.f;
        const float* kr = ks + lane * KS;
#pragma unroll 4
        for (int d0 = 0; d0 < D; d0 += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(kr + d0);
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const int r = warp + PF_WARPS * i;
                if (r < R) {
                    const float4 qq =
                        *reinterpret_cast<const float4*>(qs + r * D + d0);
                    float a = s[i];
                    a = fmaf(qq.x, kk.x, a); a = fmaf(qq.y, kk.y, a);
                    a = fmaf(qq.z, kk.z, a); a = fmaf(qq.w, kk.w, a);
                    s[i] = a;
                }
            }
        }
        // online softmax per row. Without a window tile 0 holds key 0,
        // which every row attends, so m is a real score from then on and
        // a row whose keys in this tile are all in its future adds p == 0
        // exactly. With a window a row may see a first tile wholly below
        // its window, where m would still be NEG_INF and exp(sv - m) 1:
        // there a masked key's p is set to 0 outright
        const bool exists = key < kend;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const int r = warp + PF_WARPS * i;
            if (r < R) {
                const bool ok = exists && (!CAUSAL || key <= qpos[i]) &&
                                (!WINDOWED || key > qpos[i] - window);
                const float sv = ok ? s[i] * scale : REPRO_NEG_INF;
                const float mn = fmaxf(m[i], warp_max(sv));
                const float p = WINDOWED && !ok ? 0.f : expf(sv - mn);
                const float c = expf(m[i] - mn);
                m[i] = mn;
                l[i] = l[i] * c + p;
                ps_[r * KT + lane] = p;
#pragma unroll
                for (int e = 0; e < DPL; ++e) acc[i][e] *= c;
            }
        }
        __syncwarp();  // a row's probabilities are its warp's own
        // P.V, four keys per step: their probabilities arrive in one
        // broadcast read, their V rows in four conflict-free reads; keys
        // past kend have p == 0 and zero V rows
        const int j4 = min(KT, kend - k0 + 3) & ~3;
#pragma unroll 2
        for (int j = 0; j < j4; j += 4) {
            float vv[4][DPL];
#pragma unroll
            for (int u = 0; u < 4; ++u)
                load_n<DPL>(vs + (j + u) * KS + lane * DPL, vv[u]);
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
                const int r = warp + PF_WARPS * i;
                if (r < R) {
                    const float4 p4 =
                        *reinterpret_cast<const float4*>(ps_ + r * KT + j);
#pragma unroll
                    for (int e = 0; e < DPL; ++e) {
                        float a = acc[i][e];
                        a = fmaf(p4.x, vv[0][e], a);
                        a = fmaf(p4.y, vv[1][e], a);
                        a = fmaf(p4.z, vv[2][e], a);
                        a = fmaf(p4.w, vv[3][e], a);
                        acc[i][e] = a;
                    }
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int r = warp + PF_WARPS * i;
        if (r < R) {
            const float inv = 1.f / fmaxf(warp_sum(l[i]), 1e-30f);
            const int tl = r / gn, g = r - tl * gn;
            TQ* o = out + qbase + tl * tok + g * D + lane * DPL;
#pragma unroll
            for (int e = 0; e < DPL; ++e)
                o[e] = from_f32<TQ>(acc[i][e] * inv);
        }
    }
}

template <typename TQ, typename TKV, int DPL, typename Rows, bool CAUSAL,
          bool WINDOWED>
static cudaError_t launch_prefill_walk(const void* q, const void* k,
                                       const void* v, Rows rows,
                                       const void* start, void* out, int B,
                                       int T, int H, int Hkv, int cap,
                                       int window, float scale,
                                       cudaStream_t stream) {
    constexpr int D = 32 * DPL;
    constexpr int BQ = pf_bq<DPL>();
    const int G = H / Hkv;
    const int n_gc = (G + GMAX - 1) / GMAX;
    const int rows_q = BQ * (G < GMAX ? G : GMAX);
    const size_t smem = sizeof(float) * (2 * KT * (D + 4) + rows_q * (KT + D));
    const dim3 grid(B, Hkv * n_gc, (T + BQ - 1) / BQ);
    return launch_with_smem(
        prefill_walk_kernel<TQ, TKV, DPL, Rows, CAUSAL, WINDOWED>, grid,
        dim3(PF_THREADS), smem, stream, (const TQ*)q, (const TKV*)k,
        (const TKV*)v, rows, (const int32_t*)start, (TQ*)out, T, H, Hkv, cap,
        window, scale);
}
