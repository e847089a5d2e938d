// One-token GQA decode attention over a K/V store whose rows are found by a
// functor: the body of K1 (paged_attention.cu, rows through a block table)
// and K3 (decode_attention.cu, rows of a dense cache).
//
// Row b attends its first live = min(valid_lens[b], cap) keys. The plain
// versions mask the rest at the finite NEG_INF; here they are never read.
//
// What bounds it: bytes and latency. A row's live K and V are read once,
// about G flops a byte (3 at smollm-135m's heads, 16 at recurrentgemma-9b's)
// -- far under the ~295 flop/byte at which the tensor cores, not HBM, would
// be the limit. At decode batch sizes the bytes take about a microsecond;
// what the card takes beyond that is latency: the chain of dependent loads
// each block starts with (its fill, then K1's page ids, then the first K/V
// tiles), and each key tile's chain of dependent instructions in a block
// whose warps each run alone on their SM sub-partition, so that nothing
// hides their latencies. The design shortens the chains a row's walk waits
// on: it cuts the walk across blocks, widens the tiles, and keeps the
// copies of a block's whole run in flight.
//
// The design, in the order of what it buys:
// - The split key walk (flash-decoding). A block per (row, kv head, group
//   of <= 16 query heads) gives a decode batch 3 to 24 blocks on 132 SMs.
//   Where that grid is short of two blocks an SM, the wrapper gives n_split
//   > 1 from the shapes alone (kernels/_build.py prefill_split, the rule
//   the prefill walk uses, at this walk's key tile; no host read of the
//   fills, so CUDA graphs capture it): block s reads its row's fill on the
//   device and walks range s of the row's live tiles, the tiles cut into
//   n_split near-equal runs, so a long row and a short one are each spread
//   over their blocks. Each range writes its unnormalised (m, l, acc) to
//   scratch; a range past the fill writes (NEG_INF, 0, 0). decode_merge_-
//   kernel combines the ranges in range order with no float atomics (m =
//   max m_i, l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m) / max(l,
//   1e-30)), so repeated launches are bit-equal. A separate merge kernel and
//   not the last-arriving block: no counter has to outlive a launch, so
//   nothing has to be reset between CUDA graph replays, and its launch is
//   queued behind the walk on the same stream.
// - One K/V read for all query heads. The G query heads of a kv head are the
//   16 rows of an mma.sync m16n8k8 TF32 tile (G 16 fills it; G 1-8 pad with
//   zero queries whose rows are never written), so every K/V tile is read
//   from HBM once and serves all of them. Both products are split as the
//   prefill walk splits them (common.cuh: hi = tf32(x), lo = tf32(x - hi),
//   no pass on a bf16 side, which is exact in TF32), so the fp32 math holds
//   the kernel tolerance. The block's 4 warps cut D, not the keys: warp w
//   owns dims [w D/4, (w+1) D/4) of the queries (kept in registers as split
//   fragments) and of the output. Each warp writes its partial S = Q.K^T
//   to shared memory; after one barrier every warp sums the four partials
//   at its own fragment's keys, in warp order (so all warps hold the same
//   bits), and runs the online softmax on those fragments (a row's max over
//   the 4 lanes that share it), redundantly: no second barrier and no
//   serial pass over the rows. The score and P.V fragments take keys (2t,
//   2t + 1) as k indices (t, t + 4), as in the prefill walk, so P goes
//   from the score fragment into the P.V operand in place.
// - Wide tiles, all in flight. K/V tiles of 64 keys (32 for fp32 K/V at D
//   256) arrive through a cp.async ring of 3-6 stages (16-byte chunks,
//   zero-filled past the fill, whose source is then not read): a tile's
//   instruction chain (two barriers, the partial scores' sum, the max over
//   the quad, P's split) is paid once for 64 keys, and up to five tiles'
//   copies fly while one is computed. K1's page ids (one warp, a lane a
//   key) ride in the cp.async group of the tile S - 1 before theirs, so
//   they are in shared memory S - 1 iterations before the copies that
//   need them: a tile's copies never wait on a page-id load.
//   TMA, wgmma and a producer warp are later work.
// A masked key's p is 0 outright and its V rows are zeros, so a key that no
// row may attend adds an exact zero; nothing at or past the fill is read.
#pragma once

#include "common.cuh"

// Element offset of token `tok` of sequence `b` in a (.., Hkv, D) K/V
// store, before the kv head's h * D. PAGED stores also give the address of
// a token's page id and its offset from that id, so a walk can load a
// tile's page ids ahead of its copies.
struct PagedRows {             // (P, ps, Hkv, D) pages through (B, N) table
    static constexpr bool PAGED = true;
    const int32_t* block_table;
    int N, ps;
    int64_t row;               // Hkv * D
    __device__ __forceinline__ const int32_t* entry(int b, int tok) const {
        return block_table + (int64_t)b * N + tok / ps;
    }
    __device__ __forceinline__ int64_t at(int pg, int tok) const {
        return ((int64_t)pg * ps + tok % ps) * row;
    }
    __device__ __forceinline__ int64_t operator()(int b, int tok) const {
        // read-only path, as a const __restrict__ kernel parameter gets
        return at(__ldg(entry(b, tok)), tok);
    }
};
struct DenseRows {             // (B, S, Hkv, D) cache
    static constexpr bool PAGED = false;
    int S;
    int64_t row;
    __device__ __forceinline__ int64_t operator()(int b, int tok) const {
        return ((int64_t)b * S + tok) * row;
    }
};

constexpr int DW_WARPS = 4;
constexpr int DW_THREADS = 32 * DW_WARPS;
constexpr int DW_ROWS = 16;              // query heads a block: an mma tile

// padded row strides, in elements: k takes pair loads at keys g and dims
// 2t, v single loads at keys 2t and dims g, scores pair loads at rows g and
// keys 2t, all free of bank conflicts
template <int D> __host__ __device__ constexpr int dw_ks() { return D + 8; }
template <typename TKV, int D>
__host__ __device__ constexpr int dw_vs() {
    return D + 16 / (int)sizeof(TKV);
}
__host__ __device__ constexpr int dw_ps(int KT) { return KT + 8; }
// shared memory of a ring of `stages` tiles of KT keys, the warps' partial
// scores and the page-id ring
template <typename TKV, int DPL>
__host__ __device__ constexpr size_t dw_bytes(int KT, int stages) {
    return sizeof(TKV) * stages * KT *
               (dw_ks<32 * DPL>() + dw_vs<TKV, 32 * DPL>()) +
           sizeof(float) * DW_WARPS * DW_ROWS * dw_ps(KT) +
           sizeof(int) * 2 * stages * KT;
}
// keys a tile: 64 where a ring of 3 such tiles fits the 227 KB a block may
// use, else 32 (fp32 K/V at D 256). A tile costs the block a chain of
// dependent instructions whatever its width, so the wider tile halves the
// chains a key walk waits on
template <typename TKV, int DPL>
__host__ __device__ constexpr int dw_kt() {
    return dw_bytes<TKV, DPL>(64, 3) <= 227 * 1024 ? 64 : 32;
}
// tiles in the copy ring: as many as 88 KB of K/V hold, 3 to 6 (4 at
// smollm-135m's D 64 in bf16, 3 at D 128 and 256), so a block's whole run
// at the decode shapes is in flight at once and two blocks fit an SM at
// D 64
template <typename TKV, int DPL>
__host__ __device__ constexpr int dw_stages() {
    constexpr int KT = dw_kt<TKV, DPL>();
    constexpr int stage = KT * (dw_ks<32 * DPL>() + dw_vs<TKV, 32 * DPL>()) *
                          (int)sizeof(TKV);
    return 88 * 1024 / stage < 3 ? 3 : 88 * 1024 / stage > 6
                                           ? 6 : 88 * 1024 / stage;
}
template <typename TKV, int DPL>
__host__ __device__ constexpr size_t dw_smem() {
    return dw_bytes<TKV, DPL>(dw_kt<TKV, DPL>(), dw_stages<TKV, DPL>());
}

// The page id of key `key` of row b, 0 at or past the fill: loaded now, or
// copied into shared memory with the caller's next cp.async group (a paged
// store only: a dense one never instantiates these)
template <typename Rows>
__device__ __forceinline__ int dw_page_id(const Rows& rows, int b, int key,
                                          int live) {
    return key < live ? __ldg(rows.entry(b, key)) : 0;
}
template <typename Rows>
__device__ __forceinline__ void dw_page_id_async(const Rows& rows, int* dst,
                                                 int b, int key, int live) {
    const bool ok = key < live;
    cp_async4(dst, rows.entry(b, ok ? key : 0), ok);
}

// q (B, H, D); out (B, H, D) in q's dtype. Block (s, h * n_gc + group, b)
// walks range s of row b's live key tiles for the group's query heads of
// kv head h; with n_split > 1 it writes part_o (n_split, B, H, D) and
// part_ml (n_split, B, H) of (m, l) instead of out.
template <typename TQ, typename TKV, int DPL, typename Rows>
__global__ void __launch_bounds__(DW_THREADS)
decode_walk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, Rows rows,
                   const int32_t* __restrict__ valid_lens,
                   TQ* __restrict__ out, float* __restrict__ part_o,
                   float2* __restrict__ part_ml, int n_split, int B, int H,
                   int Hkv, int cap, float scale) {
    constexpr int D = 32 * DPL;
    constexpr int DW = D / DW_WARPS;     // a warp's dims: DPL 8-dim steps
    constexpr int KT = dw_kt<TKV, DPL>(), PS = dw_ps(KT);
    constexpr int S = dw_stages<TKV, DPL>();
    constexpr int NT = KT / 8;           // 8-key steps of a tile
    constexpr int KS = dw_ks<D>(), VS = dw_vs<TKV, D>();
    constexpr bool QX = sizeof(TQ) == 2;     // bf16 q: exact in TF32
    constexpr bool KX = sizeof(TKV) == 2;    // bf16 K/V: exact in TF32
    constexpr int EPC = 16 / (int)sizeof(TKV);  // elements a 16-byte chunk
    constexpr int CH = D / EPC;                 // chunks a key row
    const int split = blockIdx.x, b = blockIdx.z;
    const int G = H / Hkv;
    const int n_gc = (G + DW_ROWS - 1) / DW_ROWS;
    const int h = blockIdx.y / n_gc;
    const int g0 = (blockIdx.y - h * n_gc) * DW_ROWS;
    const int gn = min(DW_ROWS, G - g0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;  // fragment row / column group
    const int dw0 = warp * DW;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    TKV* kring = reinterpret_cast<TKV*>(smem_raw);          // S x (KT, KS)
    TKV* vring = kring + S * KT * KS;                       // S x (KT, VS)
    float* sp = reinterpret_cast<float*>(vring + S * KT * VS);  // (W, 16, PS)
    int* pids = reinterpret_cast<int*>(sp + DW_WARPS * DW_ROWS * PS);
    // ^ 2S x (KT): tile u's page ids in slot u % 2S

    // this block's run of whole tiles of the row's live keys
    const int live = max(0, min(valid_lens[b], cap));
    const int ntile = (live + KT - 1) / KT;
    const int per = ntile / n_split, extra = ntile - per * n_split;
    const int tlo = split * per + min(split, extra);
    const int nt = per + (split < extra ? 1 : 0);

    // tile t of the run into stage t % S, from its page ids (in shared
    // memory since group t - S + 1); a thread copies CPT consecutive
    // 16-byte chunks of one key row, so it finds one row a tile. Warp 0
    // adds tile t + S - 1's page ids to the group, so they land S - 1
    // iterations before their copies
    constexpr int CPT = KT * CH / DW_THREADS;
    static_assert(CH % CPT == 0, "a thread's chunks lie in one key row");
    const int jc = threadIdx.x * CPT / CH;              // its key of a tile
    const int ec = (threadIdx.x * CPT - jc * CH) * EPC;  // its first element
    auto fetch = [&](int t) {
        if (t < nt) {
            const int st = t % S, key = (tlo + t) * KT + jc;
            const bool ok = key < live;
            int64_t off = 0;
            if (ok) {
                if constexpr (Rows::PAGED)
                    off = rows.at(pids[(t % (2 * S)) * KT + jc], key);
                else
                    off = rows(b, key);
                off += (int64_t)h * D + ec;
            }
            TKV* kd = kring + (st * KT + jc) * KS + ec;
            TKV* vd = vring + (st * KT + jc) * VS + ec;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                cp_async16(kd + c * EPC, k + off + c * EPC, ok);
                cp_async16(vd + c * EPC, v + off + c * EPC, ok);
            }
            if constexpr (Rows::PAGED) {
                const int u = t + S - 1;
                if (warp == 0 && u < nt)
                    for (int j = lane; j < KT; j += 32)
                        dw_page_id_async(rows, pids + (u % (2 * S)) * KT + j,
                                         b, (tlo + u) * KT + j, live);
            }
        }
        cp_async_commit();  // an empty group keeps the count
    };

    if constexpr (Rows::PAGED) {
        if (warp == 0)
            for (int t = 0; t < S - 1 && t < nt; ++t)
                for (int j = lane; j < KT; j += 32)
                    pids[t * KT + j] =
                        dw_page_id(rows, b, (tlo + t) * KT + j, live);
        __syncthreads();
    }
    for (int t = 0; t < S - 1; ++t) fetch(t);

    // this lane's query fragments while the first tiles fly: rows gq and
    // gq + 8 (query heads g0 + row), dims dw0 + 8i + (2t, 2t + 1); a
    // padding row (past the group's gn heads) is zero and never written
    uint32_t qhi[DPL][4], qlo[DPL][4];
    {
        const TQ* qa = q + ((int64_t)b * H + (int64_t)h * G + g0 + gq) * D;
        const bool ra = gq < gn, rb = gq + 8 < gn;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
            const int d = dw0 + 8 * i + 2 * tq;
            const float xa0 = ra ? to_f32(qa[d]) : 0.f;
            const float xa1 = ra ? to_f32(qa[d + 1]) : 0.f;
            const float xb0 = rb ? to_f32(qa[8 * D + d]) : 0.f;
            const float xb1 = rb ? to_f32(qa[8 * D + d + 1]) : 0.f;
            tf32_split<QX>(xa0, qhi[i][0], qlo[i][0]);
            tf32_split<QX>(xb0, qhi[i][1], qlo[i][1]);
            tf32_split<QX>(xa1, qhi[i][2], qlo[i][2]);
            tf32_split<QX>(xb1, qhi[i][3], qlo[i][3]);
        }
    }

    float o[DPL][4];
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    // the online softmax of rows gq (a) and gq + 8 (b), the same in every
    // warp; l is this lane's share, summed over the quad at the end
    float ma = REPRO_NEG_INF, mb = REPRO_NEG_INF, la = 0.f, lb = 0.f;

    for (int t = 0; t < nt; ++t) {
        const int st = t % S, k0 = (tlo + t) * KT;
        cp_async_wait<S - 2>();  // tile t landed, t + 1 .. may still fly
        __syncthreads();  // ... for every thread; all are done with t - 1
        fetch(t + S - 1);  // into t - 1's stage
        const TKV* ks = kring + st * KT * KS;
        const TKV* vs = vring + st * KT * VS;

        // S = Q.K^T over this warp's dims: fragment k indices (t, t + 4)
        // are dims (2t, 2t + 1); n index g is key 8n + g
        float s[NT][4], s2[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
            s[n][0] = s[n][1] = s[n][2] = s[n][3] =
                s2[n][0] = s2[n][1] = s2[n][2] = s2[n][3] = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float2 y =
                    load2(ks + (n * 8 + gq) * KS + dw0 + 8 * i + 2 * tq);
                uint32_t bhi[2], blo[2];
                tf32_split<KX>(y.x, bhi[0], blo[0]);
                tf32_split<KX>(y.y, bhi[1], blo[1]);
                mma_split<QX, KX>(s[n], s2[n], qhi[i], qlo[i], bhi, blo);
            }
        }
        float* spw = sp + warp * DW_ROWS * PS;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            store2(spw + gq * PS + n * 8 + 2 * tq, s[n][0] + s2[n][0],
                   s[n][1] + s2[n][1]);
            store2(spw + (gq + 8) * PS + n * 8 + 2 * tq, s[n][2] + s2[n][2],
                   s[n][3] + s2[n][3]);
        }
        __syncthreads();

        // every warp sums the warps' partial scores at its own fragment's
        // keys, in warp order (so all warps hold the same bits), and runs
        // the online softmax on them: s[n][e] is (row gq, key k0 + 8n + 2t
        // + e), s[n][2 + e] the same key of row gq + 8
        float xa = REPRO_NEG_INF, xb = REPRO_NEG_INF;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            float2 ya = load2(sp + gq * PS + n * 8 + 2 * tq);
            float2 yb = load2(sp + (gq + 8) * PS + n * 8 + 2 * tq);
#pragma unroll
            for (int w = 1; w < DW_WARPS; ++w) {
                const float2 za =
                    load2(sp + (w * DW_ROWS + gq) * PS + n * 8 + 2 * tq);
                const float2 zb =
                    load2(sp + (w * DW_ROWS + gq + 8) * PS + n * 8 + 2 * tq);
                ya.x += za.x; ya.y += za.y;
                yb.x += zb.x; yb.y += zb.y;
            }
            const int key = k0 + n * 8 + 2 * tq;
            s[n][0] = key < live ? ya.x * scale : REPRO_NEG_INF;
            s[n][1] = key + 1 < live ? ya.y * scale : REPRO_NEG_INF;
            s[n][2] = key < live ? yb.x * scale : REPRO_NEG_INF;
            s[n][3] = key + 1 < live ? yb.y * scale : REPRO_NEG_INF;
            xa = fmaxf(xa, fmaxf(s[n][0], s[n][1]));
            xb = fmaxf(xb, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int sh = 1; sh < 4; sh <<= 1) {
            xa = fmaxf(xa, __shfl_xor_sync(FULL_MASK, xa, sh));
            xb = fmaxf(xb, __shfl_xor_sync(FULL_MASK, xb, sh));
        }
        // the tile's first key is live, so the new max is a real score
        const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
        // the fast exp, as the prefill walk takes it (~2 ulp)
        const float ca = __expf(ma - na), cb = __expf(mb - nb);
        ma = na;
        mb = nb;
        float pa = 0.f, pb = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                // a masked key's p is 0 outright
                s[n][e] = s[n][e] == REPRO_NEG_INF ? 0.f
                                                   : __expf(s[n][e] - na);
                s[n][2 + e] = s[n][2 + e] == REPRO_NEG_INF
                                  ? 0.f : __expf(s[n][2 + e] - nb);
                pa += s[n][e];
                pb += s[n][2 + e];
            }
        }
        la = la * ca + pa;
        lb = lb * cb + pb;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
            o[i][0] *= ca; o[i][1] *= ca;
            o[i][2] *= cb; o[i][3] *= cb;
        }

        // O += P.V over this warp's dims: fragment k indices (t, t + 4) are
        // keys (2t, 2t + 1), where the score fragment holds them; n index g
        // is dim dw0 + 8i + g
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            uint32_t ahi[4], alo[4];
            tf32_split<false>(s[n][0], ahi[0], alo[0]);
            tf32_split<false>(s[n][2], ahi[1], alo[1]);
            tf32_split<false>(s[n][1], ahi[2], alo[2]);
            tf32_split<false>(s[n][3], ahi[3], alo[3]);
            const TKV* v0 = vs + (n * 8 + 2 * tq) * VS + dw0 + gq;
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
                uint32_t bhi[2], blo[2];
                tf32_split<KX>(to_f32(v0[i * 8]), bhi[0], blo[0]);
                tf32_split<KX>(to_f32(v0[VS + i * 8]), bhi[1], blo[1]);
                mma_split<false, KX>(o[i], o[i], ahi, alo, bhi, blo);
            }
        }
    }

#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
        la += __shfl_xor_sync(FULL_MASK, la, sh);
        lb += __shfl_xor_sync(FULL_MASK, lb, sh);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = gq + 8 * half;
        if (r >= gn) continue;
        const float m = half ? mb : ma, l = half ? lb : la;
        const int64_t row = (int64_t)b * H + (int64_t)h * G + g0 + r;
        if (n_split == 1) {
            const float inv = 1.f / fmaxf(l, 1e-30f);
            TQ* dst = out + row * D + dw0 + 2 * tq;
#pragma unroll
            for (int i = 0; i < DPL; ++i)
                store2(dst + i * 8, o[i][2 * half] * inv,
                       o[i][2 * half + 1] * inv);
        } else {
            const int64_t prow = (int64_t)split * B * H + row;
            float* dst = part_o + prow * D + dw0 + 2 * tq;
#pragma unroll
            for (int i = 0; i < DPL; ++i)
                store2(dst + i * 8, o[i][2 * half], o[i][2 * half + 1]);
            if (warp == 0 && tq == 0) part_ml[prow] = make_float2(m, l);
        }
    }
}

// The split walk's merge: one warp per (b, query head) row, a lane D/32
// dims, the n_split ranges combined in range order. Rows names the walk it
// merges (PagedRows for K1, DenseRows for K3) and is otherwise unused.
template <typename TQ, int DPL, typename Rows>
__global__ void __launch_bounds__(256)
decode_merge_kernel(const float* __restrict__ part_o,
                    const float2* __restrict__ part_ml, TQ* __restrict__ out,
                    int64_t nrows, int n_split) {
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
        const float2 mls = part_ml[s * nrows + row];
        const float w = expf(mls.x - m);
        l += mls.y * w;
        const float* src = part_o + (s * nrows + row) * D + lane * DPL;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[e] += w * src[e];
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < DPL; ++e)
        out[row * D + lane * DPL + e] = from_f32<TQ>(acc[e] * inv);
}

// The walk's grid: key ranges (x) x kv heads x head groups (y) x rows (z).
static inline dim3 dw_grid(int B, int H, int Hkv, int n_split) {
    return dim3(n_split, Hkv * ((H / Hkv + DW_ROWS - 1) / DW_ROWS), B);
}

template <typename TQ, typename TKV, int DPL, typename Rows>
static cudaError_t launch_decode_walk(const void* q, const void* k,
                                      const void* v, Rows rows,
                                      const void* valid, void* out,
                                      void* part_o, void* part_ml,
                                      int n_split, int B, int H, int Hkv,
                                      int cap, float scale,
                                      cudaStream_t stream) {
    if (n_split < 1 || (n_split > 1 && (part_o == nullptr ||
                                        part_ml == nullptr)))
        return cudaErrorInvalidValue;
    cudaError_t e = launch_with_smem(
        decode_walk_kernel<TQ, TKV, DPL, Rows>, dw_grid(B, H, Hkv, n_split),
        dim3(DW_THREADS), dw_smem<TKV, DPL>(), stream, (const TQ*)q,
        (const TKV*)k, (const TKV*)v, rows, (const int32_t*)valid, (TQ*)out,
        (float*)part_o, (float2*)part_ml, n_split, B, H, Hkv, cap, scale);
    if (e != cudaSuccess || n_split == 1) return e;
    const int64_t nrows = (int64_t)B * H;
    decode_merge_kernel<TQ, DPL, Rows>
        <<<(unsigned)((nrows + 7) / 8), 256, 0, stream>>>(
            (const float*)part_o, (const float2*)part_ml, (TQ*)out, nrows,
            n_split);
    return cudaGetLastError();
}

// The walk instantiation's registers a thread, dynamic shared memory, local
// (spill) bytes and resident blocks an SM (from the CUDA runtime), its key
// tile, and the blocks of one key range at (B, H, Hkv): out[0..5]. The
// wrappers plan n_split from the last two (kernels/_build.py decode_grid).
template <typename TQ, typename TKV, int DPL, typename Rows>
static cudaError_t decode_walk_attrs(int B, int H, int Hkv, int* out) {
    auto kern = decode_walk_kernel<TQ, TKV, DPL, Rows>;
    const size_t smem = dw_smem<TKV, DPL>();
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, kern);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      DW_THREADS, smem);
    const dim3 g = dw_grid(B, H, Hkv, 1);
    out[0] = a.numRegs;
    out[1] = (int)smem;
    out[2] = (int)a.localSizeBytes;
    out[3] = blocks;
    out[4] = dw_kt<TKV, DPL>();
    out[5] = (int)(g.x * g.y * g.z);
    return e;
}
