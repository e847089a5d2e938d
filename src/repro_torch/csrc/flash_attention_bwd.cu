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
//   D = sum_j softmax(S)_ij dP_ij;  dS = P * (dP - D);  dQ = scale dS K;
//   dK = scale dS^T Q;  dK and dV sum the G query heads of their kv head.
// D equals rowsum(dO * O) in exact arithmetic. Taken from dP itself, with
// every kernel's dP the same bits (mma_abt_sym), it is exactly dP_ii for a
// row that sees one key (a window of 1), so that row's dS, and its share
// of dQ and dK, are exactly 0, as the exact gradient is; rowsum(dO * O)
// left fp32 noise of 1e-6 there. The output o is therefore not read.
//
// What bounds it on this card: the backward's products, five at least,
// nine here (the dQ kernel recomputes S and dP: a dQ summed without
// atomics from kept dS tiles would need a partial per key tile, ~1.2 GB at
// smollm-135m's train shape; the D pass computes them once more), some
// 100-400 flops for every byte read: operations. Its least time is five
// products over the TF32 rate of fp32 operands (494 TFLOP/s); with nine
// products taken in three TF32 passes (below) the design's own ceiling is
// 9/5 x 3 = 5.4 times that.
//
// What the design does about it. Every product runs on the tensor cores,
// as mma.sync m16n8k8 TF32 with each fp32 operand split into hi + lo and
// three passes (lo.hi' + hi.lo' + hi.hi', common.cuh: tf32_split,
// mma_split), as K4's forward walk (prefill_walk.cuh). One TF32 pass
// keeps ~1e-3 of a score, ten times the 1e-4 the gradients are held to.
// Three launches and a merge, no float atomics, so two launches on the
// same inputs give the same bits (as K4's split merge):
// - flash_bwd_dq_kernel<D, true>: D, the dQ kernel's walk (below) over the
//   same key steps, with S and dP but no dQ product: each lane keeps a
//   running max, sum of exps and sum of exps x dP for its two rows, and
//   the four lanes of a row merge them as the forward merges its ranges;
// - flash_bwd_dkdv_kernel: one block of 8 warps per (64 keys, kv head,
//   batch row, head group). Warp w takes keys 16 (w % 4) .. +16 and one
//   role: warps 0-3 compute S^T = K.Q^T, P^T and dV += P^T.dO; warps 4-7
//   dP^T = V.dO^T, dS^T = P^T o (dP^T - D) and dK += dS^T.Q. P^T passes
//   from a role-0 warp to its role-1 partner through shared memory, in the
//   mma accumulator's own layout (a lane a word, no bank conflict). The
//   two roles do two products each, and a warp holds one output (16 keys
//   x D: D/2 accumulators a lane, 128 at D 256, under the 255-register
//   cap). Rows are keys, so the score fragment is the A operand of the
//   dV/dK product in place: its query k order is permuted to the
//   accumulator's (k indices (t, t+4) are queries (2t, 2t+1)) and dO's and
//   Q's rows are read in that order, as prefill_walk.cuh does for P.V.
//   K and V stay in shared memory; the steps of QS query rows (Q, dO, lse
//   and D of one query head) arrive through a two-stage cp.async ring. The
//   walk takes exactly the steps whose mask reaches the key tile (causal:
//   q >= its first key; a window: q <= its last key + W - 1; a tile with
//   a key below the prefix: every q), each for the G query heads of its
//   kv head in order, so the group's sum happens inside the block. Where
//   key tiles x kv heads x rows leave the card short of two blocks an SM
//   (one kv head, as paligemma-3b's and recurrentgemma-9b's), the wrapper
//   splits the G heads into n_split groups, one block each: the groups'
//   partial dK and dV go to fp32 scratch, and flash_bwd_merge_kernel sums
//   them in group order;
// - flash_bwd_dq_kernel: one block of 8 warps per (64 query rows, query
//   head, batch row), walking the key steps of KS keys that the forward
//   walks (to the larger of its causal end and the prefix, from the step
//   that holds its first row's first window key), the longest walks first.
//   Warps w and w + 4 share query rows 16 (w % 4) .. +16: the first
//   computes S = Q.K^T and P, the second dP = dO.V^T; each hands its
//   fragment to the other through shared memory, both form the same dS
//   (the same operations on the same values: the same bits), and each
//   adds dS.K into its half of dQ's columns (D/4 accumulators a lane).
//   Q, dO, lse and D stay in shared memory; K and V steps arrive through
//   a two-stage cp.async ring.
// Every operand an mma reads from shared memory sits in rows padded to
// D + 4 floats, so that each fragment load (rows g and columns t, or rows
// 2t and columns g) is free of bank conflicts. The hi/lo split is taken in
// registers where an operand is read: split once into shared memory, it
// would double the shared-memory reads. The tensor cores' fp32
// accumulation does not round to nearest, and a gradient summed there
// over a 2,048-query walk drifted close to the 1e-4 it is held to: each
// score's k steps and each step's dV, dK or dQ products are summed on
// the tensor cores from zero and added in fp32 (mma_split_rn, mma_abt,
// mma_fb in common.cuh). A masked pair's P is set to 0 outright, so it
// adds exactly nothing.
//
// Resources (flash_attention_bwd_attrs on an H100; 0 local bytes at every
// head dim), dK/dV then dQ: D 32 and 64, two blocks an SM each (steps of
// 32; 123-128 registers, 45-87 KB); D 128, one dK/dV block (218
// registers) and two dQ blocks (steps of 16); D 256, one block an SM each
// (254 and 188 registers, 204 and 208 KB: K and V of 64 keys, or Q and
// dO of 64 rows, take 133 KB).
//
// What bounds it now (chip_smoke.py's kernel phase, PERF.md): neither the
// tensor cores nor the bytes. Each three-pass product issues some seven
// other instructions (fragment loads, hi/lo splits, fp32 adds), and with
// 16 warps an SM (8 at D 256) and three barriers a step the warps mostly
// wait: about a fifth of the design's three-pass ceiling at smollm-135m's
// train shape. 16 warps a block at D 256 (two splitting each score's D
// reduction) was no faster; wgmma from operands split once per tile is
// the follow-up (ROADMAP).

#include "common.cuh"

constexpr int BW_WARPS = 8;
constexpr int BW_THREADS = BW_WARPS * 32;
constexpr int BW_ROWS = 64;  // keys a dK/dV block, query rows a dQ block

// QS: query rows a dK/dV walk step; KS: keys a dQ walk step; MKV, MQ:
// blocks an SM the dK/dV and dQ kernels are compiled for: two where their
// shared memory and 128 registers a thread (no spill) allow it
template <int D> struct BwdTiles;
template <> struct BwdTiles<32> {
    static constexpr int QS = 32, KS = 32, MKV = 2, MQ = 2;
};
template <> struct BwdTiles<64> {
    static constexpr int QS = 32, KS = 32, MKV = 2, MQ = 2;
};
template <> struct BwdTiles<128> {
    static constexpr int QS = 16, KS = 16, MKV = 1, MQ = 2;
};
template <> struct BwdTiles<256> {
    static constexpr int QS = 16, KS = 16, MKV = 1, MQ = 1;
};

// floats of each kernel's dynamic shared memory
template <int D> __host__ __device__ constexpr int bwd_dkdv_stage() {
    return 2 * BwdTiles<D>::QS * (D + 4) + 2 * BwdTiles<D>::QS;
}
template <int D>
__host__ __device__ constexpr size_t bwd_smem_dkdv() {
    constexpr int QS = BwdTiles<D>::QS;
    return sizeof(float) * (2 * BW_ROWS * (D + 4) + 2 * bwd_dkdv_stage<D>() +
                            4 * 16 * QS);
}
template <int D>
__host__ __device__ constexpr size_t bwd_smem_dq() {
    constexpr int KS = BwdTiles<D>::KS;
    return sizeof(float) * (2 * BW_ROWS * (D + 4) + 2 * BW_ROWS +
                            2 * 2 * KS * (D + 4) + 4 * 2 * 16 * KS);
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
// aligned), into shared memory at a stride of D + 4, by cp.async; rows at
// or past nvalid are zeros (and not read)
template <int D, int ROWS>
__device__ __forceinline__ void bwd_fetch_rows(float* dst, const float* src,
                                               int64_t rs, int nvalid) {
    for (int i = threadIdx.x; i < ROWS * (D / 4); i += BW_THREADS) {
        const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
        const bool live = r < nvalid;
        cp_async16(dst + r * (D + 4) + c,
                   src + (live ? (int64_t)r * rs + c : 0), live);
    }
}

// dK, dV of 64 keys of one kv head of one batch row (one head group)
template <int D>
__global__ void __launch_bounds__(BW_THREADS, BwdTiles<D>::MKV)
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
    constexpr int QS = BwdTiles<D>::QS, RS = D + 4;
    constexpr int NQ = QS / 8;          // 8-query n tiles of a step
    constexpr int DT = D / 8;           // 8-dim tiles of dK or dV
    constexpr int STAGE = bwd_dkdv_stage<D>();
    extern __shared__ __align__(16) float smem_bw[];
    float* ks = smem_bw;                // (64, RS)
    float* vs = ks + BW_ROWS * RS;      // (64, RS)
    float* ring = vs + BW_ROWS * RS;    // 2 x [Q, dO (QS, RS); lse, D (QS)]
    float* pex = ring + 2 * STAGE;      // 4 x (NQ * 4, 32): P^T fragments
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int kg = warp & 3;            // keys 16 kg .. 16 kg + 15
    const bool pv = warp < 4;           // S, P, dV; else dP, dS, dK
    const int k0 = blockIdx.x * BW_ROWS, hk = blockIdx.y;
    const int b = blockIdx.z / n_split, split = blockIdx.z - b * n_split;
    const int G = H / Hkv;
    // this block's query heads of the kv head: group `split` of n_split
    const int per = (G + n_split - 1) / n_split;
    const int g_lo = min(G, split * per), g_hi = min(G, g_lo + per);
    const int ng = g_hi - g_lo;
    const int nk = min(BW_ROWS, Sk - k0);
    const int64_t kvrow = (int64_t)Hkv * D, qrow = (int64_t)H * D;
    const int64_t kvbase = ((int64_t)b * Sk + k0) * kvrow + (int64_t)hk * D;
    bwd_fetch_rows<D, BW_ROWS>(ks, k + kvbase, kvrow, nk);
    bwd_fetch_rows<D, BW_ROWS>(vs, v + kvbase, kvrow, nk);

    // the query rows some key of this tile is visible to: every row where
    // the tile holds a prefix key (or without causal masking), else from
    // the tile's first key to its last key's window end
    int qlo = 0, qhi = Sq;
    if (causal && k0 >= prefix) {
        qlo = min(k0, Sq);
        if (window > 0) qhi = min(Sq, k0 + nk - 1 + window);
    }
    const int qt_lo = qlo / QS;
    const int qt_hi = qhi > qlo ? (qhi + QS - 1) / QS : qt_lo;
    const int nsteps = (qt_hi - qt_lo) * ng;

    // step `it`: q tile qt_lo + it / ng of query head g_lo + it % ng
    auto fetch = [&](int it, int st) {
        const int t0 = (qt_lo + it / ng) * QS, h = hk * G + g_lo + it % ng;
        float* qd = ring + st * STAGE;
        float* ld = qd + 2 * QS * RS;
        const int64_t row0 = (int64_t)b * Sq + t0;
        const int64_t qbase = row0 * qrow + (int64_t)h * D;
        bwd_fetch_rows<D, QS>(qd, q + qbase, qrow, Sq - t0);
        bwd_fetch_rows<D, QS>(qd + QS * RS, dout + qbase, qrow, Sq - t0);
        for (int i = threadIdx.x; i < QS; i += BW_THREADS) {
            const bool live = t0 + i < Sq;
            const int64_t off = live ? (row0 + i) * H + h : 0;
            cp_async4(ld + i, lse + off, live);
            cp_async4(ld + QS + i, dsum + off, live);
        }
        cp_async_commit();
    };
    if (nsteps > 0) fetch(0, 0);  // one group with K and V
    else cp_async_commit();

    // this warp's role: its score product's A rows (K or V), its B rows
    // (Q or dO), and the B rows of its output's product (dO or Q)
    const float* arows = (pv ? ks : vs) + 16 * kg * RS;
    const int ja = k0 + 16 * kg + gq, jb = ja + 8;   // this lane's keys
    float* pmine = pex + kg * NQ * 4 * 32 + lane;
    float acc[DT][4];
    frag_zero(acc);

    for (int it = 0; it < nsteps; ++it) {
        const int st = it & 1;
        if (it + 1 < nsteps) fetch(it + 1, st ^ 1);
        else cp_async_commit();  // an empty group keeps the count
        cp_async_wait1();
        __syncthreads();         // this step (and K, V) landed for all
        const float* qd = ring + st * STAGE;
        const float* dod = qd + QS * RS;
        const float* ld = dod + QS * RS;
        const float* dd = ld + QS;
        const int t0 = (qt_lo + it / ng) * QS;
        // S^T = K.Q^T or dP^T = V.dO^T: rows keys, columns the step's
        // queries; s[n][e] is key (e < 2 ? ja : jb), query t0 + 8n + 2tq +
        // (e & 1)
        float s[NQ][4];
        frag_zero(s);
        if (pv) mma_abt<D, NQ, RS>(s, arows, qd, gq, tq);
        else mma_abt_sym<D, NQ, RS>(s, arows, dod, gq, tq);  // dsum's dP
        if (pv) {
#pragma unroll
            for (int n = 0; n < NQ; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = 8 * n + 2 * tq + (e & 1);
                    const bool ok = bwd_allowed(t0 + i, e < 2 ? ja : jb, Sq,
                                                Sk, causal, window, prefix);
                    s[n][e] = ok ? expf(s[n][e] * scale - ld[i]) : 0.f;
                    pmine[(n * 4 + e) * 32] = s[n][e];
                }
        }
        __syncthreads();         // P^T is in shared memory
        if (!pv) {
#pragma unroll
            for (int n = 0; n < NQ; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = 8 * n + 2 * tq + (e & 1);
                    s[n][e] = pmine[(n * 4 + e) * 32] * (s[n][e] - dd[i]);
                }
        }
        // dV += P^T.dO or dK += dS^T.Q over the step's queries
        mma_fb<NQ, DT, RS>(acc, s, pv ? dod : qd, gq, tq);
        __syncthreads();         // the stage and P^T are consumed
    }
    cp_async_wait<0>();
    // a split writes its group's partial sums to scratch laid out as
    // (n_split, B, Sk, Hkv, D)
    const int64_t part = (int64_t)split * (gridDim.z / n_split) * Sk * kvrow;
    float* out = pv ? (n_split == 1 ? dv : part_dv + part)
                    : (n_split == 1 ? dk : part_dk + part);
    const float mul = pv ? 1.f : scale;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int j = (half ? jb : ja) - k0;
        if (j >= nk) continue;
        float* dst = out + ((int64_t)b * Sk + k0 + j) * kvrow +
                     (int64_t)hk * D + 2 * tq;
#pragma unroll
        for (int i = 0; i < DT; ++i)
            store2(dst + 8 * i, acc[i][2 * half] * mul,
                   acc[i][2 * half + 1] * mul);
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

// dQ of 64 query rows of one query head of one batch row; with DSUM, the
// walk before it: D = sum_j P_ij dP_ij of the same rows, P the softmax of
// the scores this pass recomputes (online, as the forward's walk) and dP
// the very bits the dQ and dK/dV walks compute (mma_abt_sym). A row with
// one visible key then has P 1, D its dP and dS exactly 0
template <int D, bool DSUM>
__global__ void __launch_bounds__(BW_THREADS, BwdTiles<D>::MQ)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ dsum, float* __restrict__ dq,
                    int Sq, int Sk, int H, int Hkv, int causal, int window,
                    int prefix, float scale) {
    constexpr int KS = BwdTiles<D>::KS, RS = D + 4;
    constexpr int NK = KS / 8;          // 8-key n tiles of a step
    constexpr int DT = D / 16;          // 8-dim tiles of a warp's half of dQ
    constexpr int STAGE = 2 * KS * RS;
    extern __shared__ __align__(16) float smem_bw[];
    float* qs = smem_bw;                // (64, RS)
    float* dos = qs + BW_ROWS * RS;     // (64, RS)
    float* ls = dos + BW_ROWS * RS;     // (64): lse
    float* dsm = ls + BW_ROWS;          // (64): D
    float* ring = dsm + BW_ROWS;        // 2 x [K, V (KS, RS)]
    float* pex = ring + 2 * STAGE;      // 4 x 2 x (NK * 4, 32): P, dP
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int qg = warp & 3;            // query rows 16 qg .. 16 qg + 15
    const int hf = warp >> 2;           // 0: S and P; 1: dP. dQ's half
    const int t0 = (gridDim.x - 1 - blockIdx.x) * BW_ROWS;  // long first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int nq = min(BW_ROWS, Sq - t0);
    const int64_t kvrow = (int64_t)Hkv * D, qrow = (int64_t)H * D;
    const int64_t qbase = ((int64_t)b * Sq + t0) * qrow + (int64_t)h * D;
    bwd_fetch_rows<D, BW_ROWS>(qs, q + qbase, qrow, nq);
    bwd_fetch_rows<D, BW_ROWS>(dos, dout + qbase, qrow, nq);
    for (int i = threadIdx.x; i < BW_ROWS && !DSUM; i += BW_THREADS) {
        const bool live = i < nq;
        const int64_t off = live ? ((int64_t)b * Sq + t0 + i) * H + h : 0;
        cp_async4(ls + i, lse + off, live);
        cp_async4(dsm + i, dsum + off, live);
    }

    // the keys some row of this tile attends: to the larger of its last
    // row's causal end and the prefix; with a window (and no prefix) from
    // the key step that holds its first row's first key
    const int kend = causal ? min(Sk, max(t0 + nq, prefix)) : Sk;
    const int kbeg = causal && window > 0 && prefix == 0
                         ? max(0, t0 - window + 1) / KS * KS : 0;
    const int nsteps = kend > kbeg ? (kend - kbeg + KS - 1) / KS : 0;
    auto fetch = [&](int kt, int st) {
        const int k0 = kbeg + kt * KS;
        const int64_t kvbase =
            ((int64_t)b * Sk + k0) * kvrow + (int64_t)hk * D;
        float* kd = ring + st * STAGE;
        bwd_fetch_rows<D, KS>(kd, k + kvbase, kvrow, kend - k0);
        bwd_fetch_rows<D, KS>(kd + KS * RS, v + kvbase, kvrow, kend - k0);
        cp_async_commit();
    };
    if (nsteps > 0) fetch(0, 0);  // one group with Q, dO, lse and D
    else cp_async_commit();

    const int ra = 16 * qg + gq, rb = ra + 8;   // this lane's rows
    const float* arows = (hf ? dos : qs) + 16 * qg * RS;
    float* pmine = pex + (qg * 2 + hf) * NK * 4 * 32 + lane;
    const float* pother = pex + (qg * 2 + (hf ^ 1)) * NK * 4 * 32 + lane;
    float acc[DT][4];
    frag_zero(acc);
    // DSUM: this lane's running max, sum of exps and sum of exps x dP of
    // its rows ra (0) and rb (1) over the entries it holds
    float rm[2] = {-INFINITY, -INFINITY}, rl[2] = {0.f, 0.f},
          ra_[2] = {0.f, 0.f};

    for (int kt = 0; kt < nsteps; ++kt) {
        const int st = kt & 1;
        if (kt + 1 < nsteps) fetch(kt + 1, st ^ 1);
        else cp_async_commit();  // an empty group keeps the count
        cp_async_wait1();
        __syncthreads();         // this step (and Q, dO, lse, D) landed
        const float* kd = ring + st * STAGE;
        const int k0 = kbeg + kt * KS;
        // S = Q.K^T or dP = dO.V^T: rows queries, columns the step's
        // keys; s[n][e] is row (e < 2 ? ra : rb), key k0 + 8n + 2tq +
        // (e & 1)
        float s[NK][4];
        frag_zero(s);
        if (hf) mma_abt_sym<D, NK, RS>(s, arows, kd + KS * RS, gq, tq);
        else mma_abt<D, NK, RS>(s, arows, kd, gq, tq);
        if (DSUM) {
            if (hf) {
#pragma unroll
                for (int n = 0; n < NK; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        pmine[(n * 4 + e) * 32] = s[n][e];
            }
            __syncthreads();     // dP is in shared memory
            if (!hf) {
                // the visible scaled scores, -inf where masked
#pragma unroll
                for (int n = 0; n < NK; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const bool ok = bwd_allowed(
                            t0 + (e < 2 ? ra : rb),
                            k0 + 8 * n + 2 * tq + (e & 1), Sq, Sk, causal,
                            window, prefix);
                        s[n][e] = ok ? s[n][e] * scale : -INFINITY;
                    }
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float m = rm[r];
#pragma unroll
                    for (int n = 0; n < NK; ++n)
                        m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
                    if (m == -INFINITY) continue;   // nothing visible yet
                    const float c = expf(rm[r] - m);
                    rl[r] *= c;
                    ra_[r] *= c;
                    rm[r] = m;
#pragma unroll
                    for (int n = 0; n < NK; ++n)
#pragma unroll
                        for (int e = 2 * r; e < 2 * r + 2; ++e) {
                            const float p = expf(s[n][e] - m);
                            rl[r] += p;
                            ra_[r] += p * pother[(n * 4 + e) * 32];
                        }
                }
            }
            __syncthreads();     // the stage and dP are consumed
            continue;
        }
        if (!hf) {
            const float la = ls[ra], lb = ls[rb];
#pragma unroll
            for (int n = 0; n < NK; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool ok = bwd_allowed(
                        t0 + (e < 2 ? ra : rb), k0 + 8 * n + 2 * tq + (e & 1),
                        Sq, Sk, causal, window, prefix);
                    s[n][e] = ok ? expf(s[n][e] * scale - (e < 2 ? la : lb))
                                 : 0.f;
                }
        }
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pmine[(n * 4 + e) * 32] = s[n][e];
        __syncthreads();         // P and dP are in shared memory
        // dS = P (dP - D), the same operations in both warps of the pair
        const float da = dsm[ra], db = dsm[rb];
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float o = pother[(n * 4 + e) * 32];
                const float p = hf ? o : s[n][e], dp = hf ? s[n][e] : o;
                s[n][e] = p * (dp - (e < 2 ? da : db));
            }
        // dQ[:, half] += dS.K[:, half] over the step's keys
        mma_fb<NK, DT, RS>(acc, s, kd + hf * (D / 2), gq, tq);
        __syncthreads();         // the stage and the fragments are consumed
    }
    cp_async_wait<0>();
    if (DSUM) {
        if (hf) return;
        // merge the four lanes of each row (tq), as the forward's ranges
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                const float m2 = __shfl_xor_sync(0xffffffffu, rm[r], off);
                const float l2 = __shfl_xor_sync(0xffffffffu, rl[r], off);
                const float a2 = __shfl_xor_sync(0xffffffffu, ra_[r], off);
                const float m = fmaxf(rm[r], m2);
                if (m == -INFINITY) continue;
                const float c1 = expf(rm[r] - m), c2 = expf(m2 - m);
                rl[r] = rl[r] * c1 + l2 * c2;
                ra_[r] = ra_[r] * c1 + a2 * c2;
                rm[r] = m;
            }
            const int row = r ? rb : ra;
            if (tq == 0 && row < nq)
                dsum[((int64_t)b * Sq + t0 + row) * H + h] =
                    rl[r] > 0.f ? ra_[r] / rl[r] : 0.f;
        }
        return;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        if (r >= nq) continue;
        float* dst = dq + qbase + (int64_t)r * qrow + hf * (D / 2) + 2 * tq;
#pragma unroll
        for (int i = 0; i < DT; ++i)
            store2(dst + 8 * i, acc[i][2 * half] * scale,
                   acc[i][2 * half + 1] * scale);
    }
}

template <int D>
static cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                              const float* lse, const float* dout, float* dq,
                              float* dk, float* dv, float* dsum,
                              float* part_dk, float* part_dv, int n_split,
                              int B, int Sq, int Sk, int H, int Hkv,
                              int causal, int window, int prefix, float scale,
                              cudaStream_t stream) {
    const dim3 qgrid((Sq + BW_ROWS - 1) / BW_ROWS, H, B);
    cudaError_t e = launch_with_smem(
        flash_bwd_dq_kernel<D, true>, qgrid, dim3(BW_THREADS),
        bwd_smem_dq<D>(), stream, q, k, v, dout, lse, dsum, dq, Sq, Sk, H,
        Hkv, causal, window, prefix, scale);
    if (e != cudaSuccess) return e;
    e = launch_with_smem(flash_bwd_dkdv_kernel<D>,
                         dim3((Sk + BW_ROWS - 1) / BW_ROWS, Hkv,
                              B * n_split),
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
    return launch_with_smem(flash_bwd_dq_kernel<D, false>, qgrid,
                            dim3(BW_THREADS), bwd_smem_dq<D>(), stream, q, k,
                            v, dout, lse, dsum, dq, Sq, Sk, H, Hkv, causal,
                            window, prefix, scale);
}

// q, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, Hkv, D); lse and dsum
// (B, Sq, H); all fp32, contiguous, q, k, v and dout 16-byte aligned, D in {32, 64, 128, 256}, H a
// multiple of Hkv. lse is K4's output for the same q, k, v and mask;
// dsum is scratch. window 0 for none, else >= 1 and causal; prefix >= 0.
// n_split >= 1 groups of each kv head's query heads, at most H / Hkv;
// with more than one, part_dk and part_dv (n_split, B, Sk, Hkv, D) fp32
// scratch. Returns the cudaError_t of the launches (0 = launched).
extern "C" int flash_attention_bwd_launch(
        const void* q, const void* k, const void* v,
        const void* lse, const void* dout, void* dq, void* dk, void* dv,
        void* dsum, void* part_dk, void* part_dv, int n_split, int B, int Sq,
        int Sk, int H, int Hkv, int D, int causal, int window, int prefix,
        float scale, void* stream) {
    if (prefix < 0 || window < 0 || (window > 0 && !causal) || Hkv < 1 ||
        H % Hkv || n_split < 1 || n_split > H / Hkv ||
        (n_split > 1 && (part_dk == nullptr || part_dv == nullptr)))
        return (int)cudaErrorInvalidValue;
#define REPRO_BWD_ARGS                                                        \
    (const float*)q, (const float*)k, (const float*)v, (const float*)lse,    \
        (const float*)dout, (float*)dq, (float*)dk,                          \
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
                            (const void*)flash_bwd_dq_kernel<D, false>};
    const size_t smem[2] = {bwd_smem_dkdv<D>(), bwd_smem_dq<D>()};
    const int step[2] = {BwdTiles<D>::QS, BwdTiles<D>::KS};
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
        out[6 * i + 0] = a.numRegs;
        out[6 * i + 1] = (int)smem[i];
        out[6 * i + 2] = (int)a.localSizeBytes;
        out[6 * i + 3] = blocks;
        out[6 * i + 4] = BW_ROWS;
        out[6 * i + 5] = step[i];
    }
    return cudaSuccess;
}

// The dK/dV blocks of one head group (out[0]) at these shapes, from the
// launcher's own grid: the wrapper chooses n_split from it.
extern "C" int flash_attention_bwd_grid(int D, int B, int Sk, int Hkv,
                                        int* out) {
    if (D != 32 && D != 64 && D != 128 && D != 256)
        return (int)cudaErrorInvalidValue;
    out[0] = (Sk + BW_ROWS - 1) / BW_ROWS * Hkv * B;
    return 0;
}

// The dK/dV and dQ kernels' registers, dynamic shared memory bytes, local
// bytes, resident blocks an SM, tile (keys a dK/dV block, query rows a dQ
// block) and walk step (query rows a dK/dV step, keys a dQ step), into
// out[0..5] and out[6..11].
extern "C" int flash_attention_bwd_attrs(int D, int* out) {
    switch (D) {
        case 32: return (int)bwd_attrs<32>(out);
        case 64: return (int)bwd_attrs<64>(out);
        case 128: return (int)bwd_attrs<128>(out);
        case 256: return (int)bwd_attrs<256>(out);
        default: return (int)cudaErrorInvalidValue;
    }
}
