// The backward of K4 (flash_attention.cu) for Hopper (sm_90a): dQ, dK and
// dV of causal (or full) GQA attention over q (B, Sq, H, D) and k/v (B, Sk,
// Hkv, D), with the forward's masks: causal aligned at the top left, an
// optional local-attention window W (query t attends keys t-W+1..t) and an
// optional prefix-LM prefix P (keys below P are visible to every query).
// Head dims 32, 64, 128 and 256; fp32 q, k, v, o and dO.
//
// Replaces no TPU kernel. The reference trains through XLA's attention
// (src/repro/models/steps.py:38-39 calls Model.forward with
// triangular=False, which never takes the Pallas kernel of
// src/repro/kernels/flash_attention.py:82) under jax.value_and_grad, and
// none of its Pallas kernels has a backward. The port's full mode always
// takes K4, so this kernel is how the port computes the gradient that the
// reference gets from XLA's autodiff.
//
// It computes, from the saved log-sum-exp of each row's scaled scores
// (K4's lse output) and with S the scaled scores recomputed from q and k:
//   P = exp(S - lse), 0 where masked;  dV = P^T dO;  dP = dO V^T;
//   D = rowsum(dO * O);  dS = P * (dP - D);  dQ = scale dS K;
//   dK = scale dS^T Q;  dK and dV sum the G query heads of their kv head.
//
// What bounds it on this card: the four products of the backward (and the
// two score products that it recomputes) are ~2.5x the forward's flops
// over the pairs the mask allows, some 100-400 flops for every byte it
// reads: operations. The least time is those flops over the TF32 rate of
// fp32 operands (494 TFLOP/s).
//
// What the design does about it: it is right first. Three launches, no
// float atomics, so two launches on the same inputs give the same bits
// (as K4's split merge, prefill_walk.cuh):
// - flash_bwd_dot_kernel: D, one warp a (b, t, h) row;
// - flash_bwd_dkdv_kernel: one block per (key tile, kv head, batch row).
//   It keeps its K and V tile in shared memory and dK, dV in registers,
//   and walks exactly the q tiles whose mask reaches the key tile (causal:
//   q >= its first key; a window: q <= its last key + W - 1; a tile with
//   a key below the prefix: every q), each for the G query heads of its kv
//   head, so the group's sum happens inside the block. Where key tiles x
//   kv heads x rows leave the card short of two blocks an SM (one kv head,
//   as paligemma-3b's and recurrentgemma-9b's), the wrapper splits the G
//   heads into n_split groups, one block each: the groups' partial dK and
//   dV go to fp32 scratch, and flash_bwd_merge_kernel sums them in group
//   order;
// - flash_bwd_dq_kernel: one block per (q tile, query head, batch row),
//   walking the key tiles the forward walks (to the larger of its causal
//   end and the prefix, from the first tile of its window), the longest
//   walks first.
// Every product is a plain fp32 FMA over tiles in shared memory, each of
// a 16 x 16 thread grid's threads owning a strided micro-tile (rows
// ty + 16a, columns tx + 16c), with rows padded by one word so that the
// 16 rows a half-warp reads sit in 16 banks. A masked pair's P is set to
// 0 outright, so it adds exactly nothing. Tensor cores (3xTF32 mma.sync or
// wgmma, as the forward) are later work.

#include "common.cuh"

constexpr int BW_THREADS = 256;  // a 16 x 16 grid of threads

// query rows (BQ) and keys (BK) a tile, by head_dim
template <int D> struct BwdTiles;
template <> struct BwdTiles<32> { static constexpr int BQ = 64, BK = 64; };
template <> struct BwdTiles<64> { static constexpr int BQ = 64, BK = 64; };
template <> struct BwdTiles<128> { static constexpr int BQ = 32, BK = 64; };
template <> struct BwdTiles<256> { static constexpr int BQ = 32, BK = 32; };

template <int D>
__host__ __device__ constexpr size_t bwd_smem_dkdv() {
    constexpr int BQ = BwdTiles<D>::BQ, BK = BwdTiles<D>::BK;
    return sizeof(float) *
           (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}
template <int D>
__host__ __device__ constexpr size_t bwd_smem_dq() {
    constexpr int BQ = BwdTiles<D>::BQ, BK = BwdTiles<D>::BK;
    return sizeof(float) *
           (2 * BK * (D + 1) + 2 * BQ * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}

// the forward's mask: query t may attend key j
__device__ __forceinline__ bool bwd_allowed(int t, int j, int Sq, int Sk,
                                            int causal, int window,
                                            int prefix) {
    if (t >= Sq || j >= Sk) return false;
    if (!causal) return true;
    return (j <= t && (window == 0 || j > t - window)) || j < prefix;
}

// ROWS rows of D fp32 values, src row r at src + r * rs (16-byte
// aligned), into shared memory at a stride of D + 1; rows at or past
// nvalid are zeros. Each thread issues all of its 16-byte loads before
// its first store, so they are in flight together
template <int D, int ROWS>
__device__ __forceinline__ void bwd_load_rows(float* dst, const float* src,
                                              int64_t rs, int nvalid) {
    constexpr int V = D / 4;                     // 16-byte chunks a row
    constexpr int PER = ROWS * V / BW_THREADS;   // chunks a thread
    static_assert(ROWS * V % BW_THREADS == 0, "whole chunks a thread");
    float4 buf[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int i = threadIdx.x + u * BW_THREADS;
        const int r = i / V, c = (i - r * V) * 4;
        buf[u] = r < nvalid ? *reinterpret_cast<const float4*>(
                                  src + (int64_t)r * rs + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        const int i = threadIdx.x + u * BW_THREADS;
        const int r = i / V, c = (i - r * V) * 4;
        float* d = dst + r * (D + 1) + c;
        d[0] = buf[u].x;
        d[1] = buf[u].y;
        d[2] = buf[u].z;
        d[3] = buf[u].w;
    }
}

// the tile's rows' lse and D, zeros past nvalid; row i of the tile is
// (b, t0 + i, h)
template <int BQ>
__device__ __forceinline__ void bwd_load_stats(float* ls, float* dsm,
                                               const float* lse,
                                               const float* dsum,
                                               int64_t row0, int H,
                                               int nvalid) {
    for (int i = threadIdx.x; i < BQ; i += BW_THREADS) {
        const int64_t r = row0 + (int64_t)i * H;
        ls[i] = i < nvalid ? lse[r] : 0.f;
        dsm[i] = i < nvalid ? dsum[r] : 0.f;
    }
}

// S = Q K^T and dP = dO V^T for the thread's rows ty + 16a and keys
// tx + 16c, then P and dS: P into p (and, when ps is not null, shared
// memory), dS into dss
template <int D, int BQ, int BK>
__device__ __forceinline__ void bwd_scores(
        const float* qs, const float* dos, const float* ks, const float* vs,
        const float* ls, const float* dsm, float* ps, float* dss, int t0,
        int k0, int Sq, int Sk, int causal, int window, int prefix,
        float scale) {
    constexpr int DS = D + 1, PS = BK + 1;
    constexpr int MA = BQ / 16, NC = BK / 16;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float s[MA][NC], dp[MA][NC];
#pragma unroll
    for (int a = 0; a < MA; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
        float qa[MA], oa[MA], kb[NC], vb[NC];
#pragma unroll
        for (int a = 0; a < MA; ++a) {
            qa[a] = qs[(ty + 16 * a) * DS + d];
            oa[a] = dos[(ty + 16 * a) * DS + d];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            kb[c] = ks[(tx + 16 * c) * DS + d];
            vb[c] = vs[(tx + 16 * c) * DS + d];
        }
#pragma unroll
        for (int a = 0; a < MA; ++a)
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                s[a][c] = fmaf(qa[a], kb[c], s[a][c]);
                dp[a][c] = fmaf(oa[a], vb[c], dp[a][c]);
            }
    }
#pragma unroll
    for (int a = 0; a < MA; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int j = tx + 16 * c;
            const float p = bwd_allowed(t0 + i, k0 + j, Sq, Sk, causal,
                                        window, prefix)
                                ? expf(s[a][c] * scale - ls[i]) : 0.f;
            if (ps != nullptr) ps[i * PS + j] = p;
            dss[i * PS + j] = p * (dp[a][c] - dsm[i]);
        }
    }
}

// D = rowsum(dO * O): one warp a row of nrows (b, t, h) rows
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const float* __restrict__ o,
                     const float* __restrict__ dout,
                     float* __restrict__ dsum, int64_t nrows) {
    const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= nrows) return;
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
        const int64_t i = row * D + e * 32 + lane;
        acc = fmaf(o[i], dout[i], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) dsum[row] = acc;
}

// dK, dV of one key tile of one kv head of one batch row
template <int D>
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ part_dk,
                      float* __restrict__ part_dv, int n_split, int Sq,
                      int Sk, int H, int Hkv, int causal, int window,
                      int prefix, float scale) {
    constexpr int BQ = BwdTiles<D>::BQ, BK = BwdTiles<D>::BK;
    constexpr int DS = D + 1, PS = BK + 1;
    constexpr int JA = BK / 16, DC = D / 16;
    extern __shared__ __align__(16) float smem_bw[];
    float* ks = smem_bw;          // (BK, DS)
    float* vs = ks + BK * DS;     // (BK, DS)
    float* qs = vs + BK * DS;     // (BQ, DS)
    float* dos = qs + BQ * DS;    // (BQ, DS)
    float* ps = dos + BQ * DS;    // (BQ, PS): P
    float* dss = ps + BQ * PS;    // (BQ, PS): dS
    float* ls = dss + BQ * PS;    // (BQ): lse
    float* dsm = ls + BQ;         // (BQ): D
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int k0 = blockIdx.x * BK, hk = blockIdx.y;
    const int b = blockIdx.z / n_split, split = blockIdx.z - b * n_split;
    const int G = H / Hkv;
    // this block's query heads of the kv head: group `split` of n_split
    const int per = (G + n_split - 1) / n_split;
    const int g_lo = min(G, split * per), g_hi = min(G, g_lo + per);
    const int nk = min(BK, Sk - k0);
    const int64_t kvrow = (int64_t)Hkv * D, qrow = (int64_t)H * D;
    const int64_t kvbase = ((int64_t)b * Sk + k0) * kvrow + (int64_t)hk * D;
    bwd_load_rows<D, BK>(ks, k + kvbase, kvrow, nk);
    bwd_load_rows<D, BK>(vs, v + kvbase, kvrow, nk);

    // the query rows some key of this tile is visible to: every row where
    // the tile holds a prefix key (or without causal masking), else from
    // the tile's first key to its last key's window end
    int qlo = 0, qhi = Sq;
    if (causal && k0 >= prefix) {
        qlo = min(k0, Sq);
        if (window > 0) qhi = min(Sq, k0 + nk - 1 + window);
    }
    const int qt_lo = qlo / BQ;
    const int qt_hi = qhi > qlo ? (qhi + BQ - 1) / BQ : qt_lo;

    float ak[JA][DC], av[JA][DC];
#pragma unroll
    for (int a = 0; a < JA; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) ak[a][c] = av[a][c] = 0.f;

    for (int qt = qt_lo; qt < qt_hi; ++qt) {
        const int t0 = qt * BQ, nq = min(BQ, Sq - t0);
        for (int g = g_lo; g < g_hi; ++g) {
            const int h = hk * G + g;
            __syncthreads();  // the last tile's operands are consumed
            const int64_t qbase =
                ((int64_t)b * Sq + t0) * qrow + (int64_t)h * D;
            bwd_load_rows<D, BQ>(qs, q + qbase, qrow, nq);
            bwd_load_rows<D, BQ>(dos, dout + qbase, qrow, nq);
            bwd_load_stats<BQ>(ls, dsm, lse, dsum,
                               ((int64_t)b * Sq + t0) * H + h, H, nq);
            __syncthreads();
            bwd_scores<D, BQ, BK>(qs, dos, ks, vs, ls, dsm, ps, dss, t0, k0,
                                  Sq, Sk, causal, window, prefix, scale);
            __syncthreads();
            // dV += P^T dO and dK += dS^T Q over the tile's query rows
#pragma unroll 2
            for (int i = 0; i < BQ; ++i) {
                float pa[JA], sa[JA], ob[DC], qb[DC];
#pragma unroll
                for (int a = 0; a < JA; ++a) {
                    pa[a] = ps[i * PS + ty + 16 * a];
                    sa[a] = dss[i * PS + ty + 16 * a];
                }
#pragma unroll
                for (int c = 0; c < DC; ++c) {
                    ob[c] = dos[i * DS + tx + 16 * c];
                    qb[c] = qs[i * DS + tx + 16 * c];
                }
#pragma unroll
                for (int a = 0; a < JA; ++a)
#pragma unroll
                    for (int c = 0; c < DC; ++c) {
                        av[a][c] = fmaf(pa[a], ob[c], av[a][c]);
                        ak[a][c] = fmaf(sa[a], qb[c], ak[a][c]);
                    }
            }
        }
    }
    // a split writes its group's partial sums to scratch laid out as
    // (n_split, B, Sk, Hkv, D)
    const int64_t part = (int64_t)split * (gridDim.z / n_split) * Sk * kvrow;
    float* odk = n_split == 1 ? dk : part_dk + part;
    float* odv = n_split == 1 ? dv : part_dv + part;
#pragma unroll
    for (int a = 0; a < JA; ++a) {
        const int j = ty + 16 * a;
        if (j >= nk) continue;
        const int64_t base =
            ((int64_t)b * Sk + k0 + j) * kvrow + (int64_t)hk * D;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
            odk[base + tx + 16 * c] = ak[a][c] * scale;
            odv[base + tx + 16 * c] = av[a][c];
        }
    }
}

// dK, dV of a split walk: the n_split groups' partial sums of each of the
// n elements added in group order (no atomics: the same bits every launch)
__global__ void __launch_bounds__(256)
flash_bwd_merge_kernel(const float* __restrict__ part_dk,
                       const float* __restrict__ part_dv,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int64_t n, int n_split) {
    const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
    if (i >= n) return;
    float a = 0.f, c = 0.f;
    for (int s = 0; s < n_split; ++s) {
        a += part_dk[s * n + i];
        c += part_dv[s * n + i];
    }
    dk[i] = a;
    dv[i] = c;
}

// dQ of one q tile of one query head of one batch row
template <int D>
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dq,
                    int Sq, int Sk, int H, int Hkv, int causal, int window,
                    int prefix, float scale) {
    constexpr int BQ = BwdTiles<D>::BQ, BK = BwdTiles<D>::BK;
    constexpr int DS = D + 1, PS = BK + 1;
    constexpr int MA = BQ / 16, DC = D / 16;
    extern __shared__ __align__(16) float smem_bw[];
    float* qs = smem_bw;          // (BQ, DS)
    float* dos = qs + BQ * DS;    // (BQ, DS)
    float* ks = dos + BQ * DS;    // (BK, DS)
    float* vs = ks + BK * DS;     // (BK, DS)
    float* dss = vs + BK * DS;    // (BQ, PS): dS
    float* ls = dss + BQ * PS;    // (BQ): lse
    float* dsm = ls + BQ;         // (BQ): D
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // long walks first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int nq = min(BQ, Sq - t0);
    const int64_t kvrow = (int64_t)Hkv * D, qrow = (int64_t)H * D;
    const int64_t qbase = ((int64_t)b * Sq + t0) * qrow + (int64_t)h * D;
    bwd_load_rows<D, BQ>(qs, q + qbase, qrow, nq);
    bwd_load_rows<D, BQ>(dos, dout + qbase, qrow, nq);
    bwd_load_stats<BQ>(ls, dsm, lse, dsum, ((int64_t)b * Sq + t0) * H + h,
                       H, nq);

    // the keys some row of this tile attends: to the larger of its last
    // row's causal end and the prefix; with a window (and no prefix) from
    // the key tile that holds its first row's first key
    const int kend = causal ? min(Sk, max(t0 + nq, prefix)) : Sk;
    const int kbeg = causal && window > 0 && prefix == 0
                         ? max(0, t0 - window + 1) / BK * BK : 0;

    float acc[MA][DC];
#pragma unroll
    for (int a = 0; a < MA; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        const int64_t kvbase =
            ((int64_t)b * Sk + k0) * kvrow + (int64_t)hk * D;
        __syncthreads();  // the last key tile is consumed
        bwd_load_rows<D, BK>(ks, k + kvbase, kvrow, min(BK, Sk - k0));
        bwd_load_rows<D, BK>(vs, v + kvbase, kvrow, min(BK, Sk - k0));
        __syncthreads();
        bwd_scores<D, BQ, BK>(qs, dos, ks, vs, ls, dsm, nullptr, dss, t0, k0,
                              Sq, Sk, causal, window, prefix, scale);
        __syncthreads();
        // dQ += dS K over the tile's keys
#pragma unroll 2
        for (int j = 0; j < BK; ++j) {
            float sa[MA], kb[DC];
#pragma unroll
            for (int a = 0; a < MA; ++a) sa[a] = dss[(ty + 16 * a) * PS + j];
#pragma unroll
            for (int c = 0; c < DC; ++c) kb[c] = ks[j * DS + tx + 16 * c];
#pragma unroll
            for (int a = 0; a < MA; ++a)
#pragma unroll
                for (int c = 0; c < DC; ++c)
                    acc[a][c] = fmaf(sa[a], kb[c], acc[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < MA; ++a) {
        const int i = ty + 16 * a;
        if (i >= nq) continue;
        const int64_t base = qbase + (int64_t)i * qrow;
#pragma unroll
        for (int c = 0; c < DC; ++c)
            dq[base + tx + 16 * c] = acc[a][c] * scale;
    }
}

template <int D>
static cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                              const float* o, const float* lse,
                              const float* dout, float* dq, float* dk,
                              float* dv, float* dsum, float* part_dk,
                              float* part_dv, int n_split, int B, int Sq,
                              int Sk, int H, int Hkv, int causal, int window,
                              int prefix, float scale, cudaStream_t stream) {
    constexpr int BQ = BwdTiles<D>::BQ, BK = BwdTiles<D>::BK;
    const int64_t nrows = (int64_t)B * Sq * H;
    flash_bwd_dot_kernel<D><<<(unsigned)((nrows + 7) / 8), 256, 0, stream>>>(
        o, dout, dsum, nrows);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_with_smem(flash_bwd_dkdv_kernel<D>,
                         dim3((Sk + BK - 1) / BK, Hkv, B * n_split),
                         dim3(BW_THREADS), bwd_smem_dkdv<D>(), stream, q, k,
                         v, dout, lse, (const float*)dsum, dk, dv, part_dk,
                         part_dv, n_split, Sq, Sk, H, Hkv, causal, window,
                         prefix, scale);
    if (e != cudaSuccess) return e;
    if (n_split > 1) {
        const int64_t n = (int64_t)B * Sk * Hkv * D;
        flash_bwd_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                                 stream>>>(part_dk, part_dv, dk, dv, n,
                                           n_split);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return launch_with_smem(flash_bwd_dq_kernel<D>,
                            dim3((Sq + BQ - 1) / BQ, H, B), dim3(BW_THREADS),
                            bwd_smem_dq<D>(), stream, q, k, v, dout, lse,
                            (const float*)dsum, dq, Sq, Sk, H, Hkv, causal,
                            window, prefix, scale);
}

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, Hkv, D); lse and
// dsum (B, Sq, H); all fp32, contiguous, q, k, v and dout 16-byte
// aligned, D in {32, 64, 128, 256}, H a
// multiple of Hkv. lse is K4's output for the same q, k, v and mask;
// dsum is scratch. window 0 for none, else >= 1 and causal; prefix >= 0.
// n_split >= 1 groups of each kv head's query heads, at most H / Hkv;
// with more than one, part_dk and part_dv (n_split, B, Sk, Hkv, D) fp32
// scratch. Returns the cudaError_t of the launches (0 = launched).
extern "C" int flash_attention_bwd_launch(
        const void* q, const void* k, const void* v, const void* o,
        const void* lse, const void* dout, void* dq, void* dk, void* dv,
        void* dsum, void* part_dk, void* part_dv, int n_split, int B, int Sq,
        int Sk, int H, int Hkv, int D, int causal, int window, int prefix,
        float scale, void* stream) {
    if (prefix < 0 || window < 0 || (window > 0 && !causal) || Hkv < 1 ||
        H % Hkv || n_split < 1 || n_split > H / Hkv ||
        (n_split > 1 && (part_dk == nullptr || part_dv == nullptr)))
        return (int)cudaErrorInvalidValue;
#define REPRO_BWD_ARGS                                                        \
    (const float*)q, (const float*)k, (const float*)v, (const float*)o,      \
        (const float*)lse, (const float*)dout, (float*)dq, (float*)dk,       \
        (float*)dv, (float*)dsum, (float*)part_dk, (float*)part_dv, n_split, \
        B, Sq, Sk, H, Hkv, causal, window, prefix, scale,                     \
        (cudaStream_t)stream
    switch (D) {
        case 32: return (int)launch_bwd<32>(REPRO_BWD_ARGS);
        case 64: return (int)launch_bwd<64>(REPRO_BWD_ARGS);
        case 128: return (int)launch_bwd<128>(REPRO_BWD_ARGS);
        case 256: return (int)launch_bwd<256>(REPRO_BWD_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef REPRO_BWD_ARGS
}

template <int D>
static cudaError_t bwd_attrs(int* out) {
    const void* kerns[2] = {(const void*)flash_bwd_dkdv_kernel<D>,
                            (const void*)flash_bwd_dq_kernel<D>};
    const size_t smem[2] = {bwd_smem_dkdv<D>(), bwd_smem_dq<D>()};
    for (int i = 0; i < 2; ++i) {
        cudaError_t e = cudaFuncSetAttribute(
            kerns[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem[i]);
        if (e != cudaSuccess) return e;
        cudaFuncAttributes a;
        e = cudaFuncGetAttributes(&a, kerns[i]);
        if (e != cudaSuccess) return e;
        int blocks = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kerns[i], BW_THREADS, smem[i]);
        if (e != cudaSuccess) return e;
        out[5 * i + 0] = a.numRegs;
        out[5 * i + 1] = (int)smem[i];
        out[5 * i + 2] = (int)a.localSizeBytes;
        out[5 * i + 3] = blocks;
        out[5 * i + 4] = i == 0 ? BwdTiles<D>::BK : BwdTiles<D>::BQ;
    }
    return cudaSuccess;
}

// The dK/dV blocks of one head group (out[0]) at these shapes, from the
// launcher's own grid: the wrapper chooses n_split from it.
extern "C" int flash_attention_bwd_grid(int D, int B, int Sk, int Hkv,
                                        int* out) {
    const int bk = D == 32    ? BwdTiles<32>::BK
                   : D == 64  ? BwdTiles<64>::BK
                   : D == 128 ? BwdTiles<128>::BK
                   : D == 256 ? BwdTiles<256>::BK
                              : 0;
    if (bk == 0) return (int)cudaErrorInvalidValue;
    out[0] = (Sk + bk - 1) / bk * Hkv * B;
    return 0;
}

// The dK/dV and dQ kernels' registers, dynamic shared memory bytes, local
// bytes, resident blocks an SM and tile (keys a dK/dV block, query rows a
// dQ block), into out[0..4] and out[5..9].
extern "C" int flash_attention_bwd_attrs(int D, int* out) {
    switch (D) {
        case 32: return (int)bwd_attrs<32>(out);
        case 64: return (int)bwd_attrs<64>(out);
        case 128: return (int)bwd_attrs<128>(out);
        case 256: return (int)bwd_attrs<256>(out);
        default: return (int)cudaErrorInvalidValue;
    }
}
