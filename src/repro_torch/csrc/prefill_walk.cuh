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
// flags. A prefix-LM's `prefix` (K4 only; 0 for none, and always 0 for K2,
// as the reference's chunk mode applies none) is a runtime value: keys
// below it are visible to every query, ORed with the causal and window
// mask (the reference's allowed_mask), so a q tile's walk runs to the
// larger of its causal end and the prefix, and starts at key 0.
//
// What bounds it: both products (S = Q.K^T and O += P.V) are matrix
// products over the D dims and the keys of a tile, so the walk is bound by
// the tensor cores, fed from shared memory. They run on warp-level
// mma.sync m16n8k8 TF32, whose per-lane fragment layouts are fixed: the
// score accumulators become P's operand in place, and the K/V tiles need
// no descriptors or swizzled layout. wgmma (a warpgroup's 64-row products
// from shared-memory descriptors, the card's full rate) is later work.
// TF32 keeps 10 mantissa bits, ~1e-3 on a score: too coarse for the 1e-4
// the kernel is held to. So every fp32 operand x is split into hi =
// tf32_rn(x) and lo = x - hi cut to TF32, and a product takes lo.hi' +
// hi.lo' + hi.hi' (3xTF32, ~22 bits; the lo.lo' term is below fp32's last
// bit). A bf16 value is exact in TF32 and has no lo, so a product with a
// bf16 side takes two passes and bf16 x bf16 one. The effective ceiling is
// the TF32 rate over the passes: ~165 TFLOP/s for fp32 x fp32 (K4 at fp32
// weights), ~247 for fp32 q against bf16 pages (K2), both above the 67
// TFLOP/s of fp32 CUDA cores. Every warp splits the K and V elements it
// reads, so the split's integer and add instructions, not the tensor
// cores, bound the instruction rate: they are kept to three an
// element (integer rounding in place of cvt.rna, a masked remainder), the
// softmax takes the fast exp, and up to D 128 the small terms accumulate
// apart from hi.hi' (two chains of dependent products, not one).
//
// The design:
// - A block is one warpgroup (4 warps) and owns 64 query rows: q tokens x
//   the query heads of one kv head, packed r = tl * gn + g (a kv head with
//   more than 64 query heads spans several blocks along grid.y). Each warp
//   owns 16 rows. At recurrentgemma's G 16 a block is 4 tokens x all 16
//   heads, so each K/V tile is read once per 4 tokens; at smollm's G 3 it
//   is 21 tokens x 3 heads and one padding row, which is computed on zero
//   queries and never written.
// - Q sits in shared memory as fp32 (split into hi/lo where it is read).
//   K/V tiles of KT keys (64, or 32 where two stages of 64 would take more
//   than 80 KB: fp32 at D 128, and D 256) arrive through a two-stage
//   cp.async ring, so the next tile's copies (16-byte chunks, one page
//   lookup per key row for K2, zero-filled past the block's last key) fly
//   while the current one is computed. Rows are padded so that every
//   fragment load is free of bank conflicts.
// - Scores stay in the mma accumulators. Within an 8-wide k step the
//   reduction order is free, so the score product takes dims (2t, 2t+1)
//   as the fragment's k indices (t, t + 4): one 8-byte load of q and of k
//   a lane. The P.V product takes keys (2t, 2t+1) as its k indices, which
//   is exactly where the score fragment holds them: P goes from the
//   accumulators into the A operand with no shuffle and no shared memory
//   (the FlashAttention-2 move, here for TF32's fragment shapes). The
//   online softmax works on the fragments: a row's max across the 4 lanes
//   that share it (two shuffles), each lane's share of l summed at the
//   end. A masked key's p is set to 0 outright, so a range with no key a
//   row may attend leaves (m, l, acc) = (NEG_INF, 0, 0).
// - The split key walk. Where B x Hkv x q tiles would leave the card
//   short of blocks, the wrapper gives n_split > 1: each block walks one
//   of n_split contiguous ranges of whole key tiles of its q tile, writes
//   its unnormalised (m, l, acc) to scratch, and prefill_merge_kernel
//   combines the ranges in split order (m = max m_i, l = sum l_i e^(m_i -
//   m), o = sum acc_i e^(m_i - m) / max(l, 1e-30)): no float atomics, so
//   two launches on the same inputs give the same bits. An empty range
//   adds l_i = 0 and a weight e^(NEG_INF - m) = 0.
// - Causal balance: grid.x runs the q tiles backwards, so the longest
//   walks start in the first wave and the short ones fill the tail.
// - Keys past a tile's causal horizon and the prefix (and pages strictly
//   in its future) are never read, and a ragged last q tile is masked, so
//   every query length runs.
#pragma once

#include "decode_walk.cuh"

constexpr int PF_WARPS = 4;                 // one warpgroup
constexpr int PF_THREADS = PF_WARPS * 32;
constexpr int PF_ROWS = 16 * PF_WARPS;      // query rows a block

// keys a shared-memory tile: 64 where two stages of K and V fit in 80 KB
template <typename TKV, int DPL>
__host__ __device__ constexpr int pf_kt() {
    return 2 * 64 * (2 * 32 * DPL + 16) * (int)sizeof(TKV) <= 80 * 1024
               ? 64 : 32;
}
// padded row strides, in elements: q (fp32) and k take 8-byte fragment
// loads at rows g and dims 2t, v 4-byte loads at keys 2t and dim g
template <int D> __host__ __device__ constexpr int pf_qs() { return D + 8; }
template <int D> __host__ __device__ constexpr int pf_ks() { return D + 8; }
template <typename TKV, int D>
__host__ __device__ constexpr int pf_vs() {
    return D + 16 / (int)sizeof(TKV);
}
template <typename TKV, int DPL>
__host__ __device__ constexpr size_t pf_smem() {
    constexpr int D = 32 * DPL, KT = pf_kt<TKV, DPL>();
    return sizeof(float) * PF_ROWS * pf_qs<D>() +
           2 * sizeof(TKV) * KT * (pf_ks<D>() + pf_vs<TKV, D>());
}

// four consecutive elements (16 / 8 aligned bytes) -> four floats
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

// q (B, T, H, D); out (B, T, H, D) in q's dtype; start_pos (B,) int32 or
// null (all 0); keys [0, cap) exist; with WINDOWED, a query at position p
// attends keys in (p - window, p], window >= 1; keys below prefix (>= 0)
// are attended by every query. With n_split > 1, block
// (.., .., b * n_split + s) walks range s of its q tile's key tiles and
// writes part_o (n_split, B, T, H, D) and part_ml (n_split, B, T, H) of
// (m, l) instead of out. A non-null lse (B, T, H) fp32 takes each row's
// log-sum-exp of its scaled scores, m + log(max(l, 1e-30)), where the row
// is normalised (here unsplit, in the merge when split): K4's backward
// reads it. A null lse writes nothing, and the output is the same.
template <typename TQ, typename TKV, int DPL, typename Rows, bool CAUSAL,
          bool WINDOWED>
__global__ void __launch_bounds__(PF_THREADS)
prefill_walk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, Rows rows,
                    const int32_t* __restrict__ start_pos,
                    TQ* __restrict__ out, float* __restrict__ part_o,
                    float2* __restrict__ part_ml, float* __restrict__ lse,
                    int n_split, int B, int T, int H, int Hkv, int cap,
                    int window, int prefix, float scale) {
    constexpr int D = 32 * DPL;
    constexpr int KT = pf_kt<TKV, DPL>();
    constexpr int NT = KT / 8;          // 8-key n tiles of a score tile
    constexpr int DT = D / 8;           // 8-dim tiles of the output
    constexpr int QS = pf_qs<D>(), KS = pf_ks<D>(), VS = pf_vs<TKV, D>();
    constexpr bool QX = sizeof(TQ) == 2;    // bf16 q: exact in TF32
    constexpr bool KX = sizeof(TKV) == 2;   // bf16 K/V: exact in TF32
    constexpr bool SACC = D <= 128;          // a second score accumulator
    constexpr int EPC = 16 / (int)sizeof(TKV);  // elements a 16-byte chunk
    constexpr int CH = D / EPC;                 // chunks a key row
    const int G = H / Hkv;
    const int gb = min(G, PF_ROWS);
    const int n_gc = (G + gb - 1) / gb;
    const int BQ = PF_ROWS / gb;
    const int h = blockIdx.y / n_gc;
    const int g0 = (blockIdx.y - h * n_gc) * gb;
    const int gn = min(gb, G - g0);
    const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // long walks first
    const int b = blockIdx.z / n_split;
    const int split = blockIdx.z - b * n_split;
    const int tn = min(BQ, T - t0);   // query tokens in this tile
    const int R = tn * gn;            // query rows, r = tl * gn + g
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;  // fragment row / column group

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qs = reinterpret_cast<float*>(smem_raw);             // (64, QS)
    TKV* kring = reinterpret_cast<TKV*>(qs + PF_ROWS * QS);     // 2 x (KT, KS)
    TKV* vring = kring + 2 * KT * KS;                           // 2 x (KT, VS)

    const int start = start_pos != nullptr ? start_pos[b] : 0;
    // keys [kbeg, kend) can be attended by some row of the tile: up to the
    // larger of its last row's position and the prefix; with a window (and
    // no prefix) the walk begins at the tile holding the first row's first
    // key. The split ranges below cut this extended walk
    const int kend = CAUSAL ? min(max(start + t0 + tn, prefix), cap) : cap;
    const int kbeg = WINDOWED && prefix == 0
                         ? max(0, start + t0 - window + 1) / KT * KT : 0;
    const int ntile = kend > kbeg ? (kend - kbeg + KT - 1) / KT : 0;
    const int per = (ntile + n_split - 1) / n_split;
    const int tlo = min(ntile, split * per), thi = min(ntile, tlo + per);

    auto fetch = [&](int tile, int st) {
        const int k0 = kbeg + tile * KT;
        TKV* kd = kring + st * KT * KS;
        TKV* vd = vring + st * KT * VS;
        for (int i = threadIdx.x; i < KT * CH; i += PF_THREADS) {
            const int j = i / CH, c = (i - j * CH) * EPC;
            const int key = k0 + j;
            const bool live = key < kend;
            const int64_t off = live ? rows(b, key) + (int64_t)h * D + c : 0;
            cp_async16(kd + j * KS + c, k + off, live);
            cp_async16(vd + j * VS + c, v + off, live);
        }
        cp_async_commit();
    };
    if (tlo < thi) fetch(tlo, 0);

    const int64_t tok = (int64_t)H * D;  // one query token's stride
    const int64_t qbase =
        ((int64_t)b * T + t0) * tok + ((int64_t)h * G + g0) * D;
    for (int i = threadIdx.x; i < PF_ROWS * (D / 4); i += PF_THREADS) {
        const int r = i / (D / 4), d = (i - r * (D / 4)) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < R) {
            const int tl = r / gn, g = r - tl * gn;
            x = load4(q + qbase + tl * tok + g * D + d);
        }
        *reinterpret_cast<float4*>(qs + r * QS + d) = x;
    }

    // this lane's rows of the warp's 16: ra and ra + 8
    const int ra = warp * 16 + gq, rb = ra + 8;
    const int qpa = start + t0 + ra / gn, qpb = start + t0 + rb / gn;
    float o[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    float ma = REPRO_NEG_INF, mb = REPRO_NEG_INF;
    float la = 0.f, lb = 0.f;  // this lane's shares; summed over the quad

    for (int tile = tlo; tile < thi; ++tile) {
        const int st = (tile - tlo) & 1;
        if (tile + 1 < thi) fetch(tile + 1, st ^ 1);
        else cp_async_commit();  // an empty group keeps the count
        cp_async_wait1();
        __syncthreads();  // this tile (and the queries) landed for all
        const TKV* ks = kring + st * KT * KS;
        const TKV* vs = vring + st * KT * VS;
        const int k0 = kbeg + tile * KT;

        // S = Q.K^T: fragment k indices (t, t + 4) are dims (2t, 2t + 1);
        // the small terms in s2 up to D 128 (at D 256 the registers hold
        // the 64 x 256 output and no more)
        float s[NT][4], s2[SACC ? NT : 1][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int n = 0; n < (SACC ? NT : 1); ++n)
            s2[n][0] = s2[n][1] = s2[n][2] = s2[n][3] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < D; kk += 8) {
            const float2 xa = load2(qs + ra * QS + kk + 2 * tq);
            const float2 xb = load2(qs + rb * QS + kk + 2 * tq);
            uint32_t ahi[4], alo[4];
            tf32_split<QX>(xa.x, ahi[0], alo[0]);
            tf32_split<QX>(xb.x, ahi[1], alo[1]);
            tf32_split<QX>(xa.y, ahi[2], alo[2]);
            tf32_split<QX>(xb.y, ahi[3], alo[3]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float2 y = load2(ks + (n * 8 + gq) * KS + kk + 2 * tq);
                uint32_t bhi[2], blo[2];
                tf32_split<KX>(y.x, bhi[0], blo[0]);
                tf32_split<KX>(y.y, bhi[1], blo[1]);
                mma_split<QX, KX>(s[n], SACC ? s2[SACC ? n : 0] : s[n], ahi,
                                  alo, bhi, blo);
            }
        }
        if constexpr (SACC) {
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[n][e] += s2[n][e];
        }
        // online softmax on the fragments: s[n][e] is (row ra, key
        // k0 + 8n + 2t + e), s[n][2 + e] the same key of row rb
        float xa = REPRO_NEG_INF, xb = REPRO_NEG_INF;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int key = k0 + n * 8 + 2 * tq + e;
                const bool oka = key < kend &&
                                 (((!CAUSAL || key <= qpa) &&
                                   (!WINDOWED || key > qpa - window)) ||
                                  key < prefix);
                const bool okb = key < kend &&
                                 (((!CAUSAL || key <= qpb) &&
                                   (!WINDOWED || key > qpb - window)) ||
                                  key < prefix);
                s[n][e] = oka ? s[n][e] * scale : REPRO_NEG_INF;
                s[n][2 + e] = okb ? s[n][2 + e] * scale : REPRO_NEG_INF;
                xa = fmaxf(xa, s[n][e]);
                xb = fmaxf(xb, s[n][2 + e]);
            }
        }
#pragma unroll
        for (int sh = 1; sh < 4; sh <<= 1) {
            xa = fmaxf(xa, __shfl_xor_sync(FULL_MASK, xa, sh));
            xb = fmaxf(xb, __shfl_xor_sync(FULL_MASK, xb, sh));
        }
        const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
        const float ca = __expf(ma - na), cb = __expf(mb - nb);
        ma = na;
        mb = nb;
        float pa = 0.f, pb = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                // a masked key adds p = 0 exactly, also while m is NEG_INF
                s[n][e] =
                    s[n][e] == REPRO_NEG_INF ? 0.f : __expf(s[n][e] - na);
                s[n][2 + e] = s[n][2 + e] == REPRO_NEG_INF
                                  ? 0.f : __expf(s[n][2 + e] - nb);
                pa += s[n][e];
                pb += s[n][2 + e];
            }
        }
        la = la * ca + pa;
        lb = lb * cb + pb;
#pragma unroll
        for (int i = 0; i < DT; ++i) {
            o[i][0] *= ca; o[i][1] *= ca;
            o[i][2] *= cb; o[i][3] *= cb;
        }
        // O += P.V: fragment k indices (t, t + 4) are keys (2t, 2t + 1),
        // where the score fragment holds them
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            uint32_t ahi[4], alo[4];
            tf32_split<false>(s[n][0], ahi[0], alo[0]);
            tf32_split<false>(s[n][2], ahi[1], alo[1]);
            tf32_split<false>(s[n][1], ahi[2], alo[2]);
            tf32_split<false>(s[n][3], ahi[3], alo[3]);
            const TKV* v0 = vs + (n * 8 + 2 * tq) * VS + gq;
#pragma unroll
            for (int i = 0; i < DT; ++i) {
                uint32_t bhi[2], blo[2];
                tf32_split<KX>(to_f32(v0[i * 8]), bhi[0], blo[0]);
                tf32_split<KX>(to_f32(v0[VS + i * 8]), bhi[1], blo[1]);
                mma_split<false, KX>(o[i], o[i], ahi, alo, bhi, blo);
            }
        }
        __syncthreads();  // every warp is done with this stage
    }

#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
        la += __shfl_xor_sync(FULL_MASK, la, sh);
        lb += __shfl_xor_sync(FULL_MASK, lb, sh);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        if (r >= R) continue;
        const int tl = r / gn, g = r - tl * gn;
        const float m = half ? mb : ma, l = half ? lb : la;
        if (n_split == 1) {
            const float inv = 1.f / fmaxf(l, 1e-30f);
            TQ* dst = out + qbase + tl * tok + g * D + 2 * tq;
#pragma unroll
            for (int i = 0; i < DT; ++i)
                store2(dst + i * 8, o[i][2 * half] * inv,
                       o[i][2 * half + 1] * inv);
            if (lse != nullptr && tq == 0)
                lse[((int64_t)b * T + t0 + tl) * H + h * G + g0 + g] =
                    m + logf(fmaxf(l, 1e-30f));
        } else {
            const int64_t row =
                (((int64_t)split * B + b) * T + t0 + tl) * H + h * G + g0 + g;
            float* dst = part_o + row * D + 2 * tq;
#pragma unroll
            for (int i = 0; i < DT; ++i)
                store2(dst + i * 8, o[i][2 * half], o[i][2 * half + 1]);
            if (tq == 0) part_ml[row] = make_float2(m, l);
        }
    }
}

// The split walk's merge: one warp per (b, t, query head) row, lane D/32
// dims, the n_split ranges combined in split order. Rows names the walk it
// merges (PagedRows for K2, DenseRows for K4) and is otherwise unused.
template <typename TQ, int DPL, typename Rows>
__global__ void __launch_bounds__(256)
prefill_merge_kernel(const float* __restrict__ part_o,
                     const float2* __restrict__ part_ml, TQ* __restrict__ out,
                     float* __restrict__ lse, int64_t nrows, int n_split) {
    constexpr int D = 32 * DPL;
    const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= nrows) return;
    float m = REPRO_NEG_INF;
    for (int s = 0; s < n_split; ++s)
        m = fmaxf(m, part_ml[s * nrows + row].x);
    float l = 0.f, acc[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
    for (int s = 0; s < n_split; ++s) {
        const float2 ml = part_ml[s * nrows + row];
        const float w = expf(ml.x - m);
        l += ml.y * w;
        const float* src = part_o + (s * nrows + row) * D + lane * DPL;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[e] += w * src[e];
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < DPL; ++e)
        out[row * D + lane * DPL + e] = from_f32<TQ>(acc[e] * inv);
    if (lse != nullptr && lane == 0) lse[row] = m + logf(fmaxf(l, 1e-30f));
}

// Query heads a block packs (of the G = H / Hkv that share a kv head) and
// query tokens a block: gb * tokens <= PF_ROWS rows.
static inline int pf_heads(int H, int Hkv) {
    return H / Hkv < PF_ROWS ? H / Hkv : PF_ROWS;
}
// The walk's grid: q tiles (x) x kv heads x head groups (y) x rows x key
// ranges (z).
static inline dim3 pf_grid(int B, int T, int H, int Hkv, int n_split) {
    const int gb = pf_heads(H, Hkv), bq = PF_ROWS / gb;
    return dim3((T + bq - 1) / bq, Hkv * ((H / Hkv + gb - 1) / gb),
                B * n_split);
}

// The blocks of one key range (out[0]) and the query tokens a block
// (out[1]), from the launcher's own grid: the wrappers choose n_split
// from them (kernels/_build.py prefill_split). Each library that includes
// this walk exports it.
extern "C" int prefill_walk_grid(int B, int T, int H, int Hkv, int* out) {
    const dim3 g = pf_grid(B, T, H, Hkv, 1);
    out[0] = (int)(g.x * g.y * g.z);
    out[1] = PF_ROWS / pf_heads(H, Hkv);
    return 0;
}

template <typename TQ, typename TKV, int DPL, typename Rows, bool CAUSAL,
          bool WINDOWED>
static cudaError_t launch_prefill_walk(const void* q, const void* k,
                                       const void* v, Rows rows,
                                       const void* start, void* out,
                                       void* part_o, void* part_ml,
                                       int n_split, int B, int T, int H,
                                       int Hkv, int cap, int window,
                                       int prefix, float scale,
                                       cudaStream_t stream,
                                       void* lse = nullptr) {
    if (n_split < 1 || (n_split > 1 && (part_o == nullptr ||
                                        part_ml == nullptr)))
        return cudaErrorInvalidValue;
    const dim3 grid = pf_grid(B, T, H, Hkv, n_split);
    cudaError_t e = launch_with_smem(
        prefill_walk_kernel<TQ, TKV, DPL, Rows, CAUSAL, WINDOWED>, grid,
        dim3(PF_THREADS), pf_smem<TKV, DPL>(), stream, (const TQ*)q,
        (const TKV*)k, (const TKV*)v, rows, (const int32_t*)start, (TQ*)out,
        (float*)part_o, (float2*)part_ml, (float*)lse, n_split, B, T, H, Hkv,
        cap, window, prefix, scale);
    if (e != cudaSuccess || n_split == 1) return e;
    const int64_t nrows = (int64_t)B * T * H;
    prefill_merge_kernel<TQ, DPL, Rows>
        <<<(unsigned)((nrows + 7) / 8), 256, 0, stream>>>(
            (const float*)part_o, (const float2*)part_ml, (TQ*)out,
            (float*)lse, nrows, n_split);
    return cudaGetLastError();
}

// The walk instantiation's registers a thread, dynamic shared memory,
// local (spill) bytes, resident blocks an SM and key tile: out[0..4].
template <typename TQ, typename TKV, int DPL, typename Rows, bool CAUSAL,
          bool WINDOWED>
static cudaError_t prefill_walk_attrs(int* out) {
    auto kern = prefill_walk_kernel<TQ, TKV, DPL, Rows, CAUSAL, WINDOWED>;
    const size_t smem = pf_smem<TKV, DPL>();
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, kern);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      PF_THREADS, smem);
    out[0] = a.numRegs;
    out[1] = (int)smem;
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = pf_kt<TKV, DPL>();
    return e;
}
