// The backward of K5 (ssd_chunk.cu) for Hopper (sm_90a): the gradients
// (gx, gdt, ga, gB, gC) of Mamba-2's SSD chunk pieces for the gradients
// (gy, gstate, gdecay, gcum) of its four outputs. Per (batch, chunk, head),
// with s <= t, cum the forward's saved prefix sum of dt * a:
//   L_ts = exp(cum_t - cum_s) (masked BEFORE the exp), S = C.B^T (shared
//   by the heads), M_ts = S_ts L_ts dt_s, w_s = exp(cum_{Q-1} - cum_s) dt_s;
//   G_ts = gy_t.x_s, R = G o M;
//   gx_s = sum_t M_ts gy_t + w_s gstate.B_s,  wbar_s = x_s.gstate.B_s;
//   S_bar = sum over heads of G o L o dt_s;  gC = S_bar.B;
//   gB = S_bar^T.C + sum_h w_s gstate^T.x_s;
//   gcum' = gcum + rowsum(R) - colsum(R) - wbar o w (+ sum_s wbar_s w_s +
//   gdecay exp(cum_{Q-1}) at row Q-1); gdA = reverse cumsum of gcum';
//   gdt_s = sum_t G_ts S_ts L_ts + wbar_s exp(cum_{Q-1} - cum_s) + gdA_s a;
//   ga = sum over (batch, chunk, row) of gdA dt.
// The plain version is kernels/ref.py (ssd_chunk_bwd), which derives these.
//
// Replaces no TPU kernel. The reference trains the SSM family through
// XLA's autodiff of ssd_chunked (src/repro/models/ssm.py:58-110); its
// Pallas kernel (src/repro/kernels/ssd.py:60) has no backward. In the port
// K5's forward fills its outputs through raw pointers, so this kernel is
// how the port computes the gradient that the reference gets from XLA.
//
// What bounds it on this card: bytes. At mamba2-370m's train shape (8 x
// 2,048 tokens: 64 chunks of Q 256, H 32, P 64, N 128) it reads x, gy,
// gstate, B, C, dt, cum and gcum and writes gx, gdt, gB and gC, ~0.5 GB a
// layer, against ~36 GFLOP over the causal pairs (G and M^T.gy per head,
// the state products per head, the head-free score products once a
// chunk): ~70 flops a byte, under the TF32 ridge (~150), so the least time
// is the bytes over 3.35 TB/s, ~0.15 ms (chip_smoke.py reckons it).
//
// What the design does about it: it is right first, on plain fp32 FMA
// (no tensor cores: later work, ROADMAP). It recomputes the scores from
// C and B and reads the forward's saved cum (it does not keep the
// forward's score scratch). Five launches on the stream, each sum in a
// fixed order and no float atomics, so two launches on the same inputs
// give the same bits:
// 1. the pair pass (ssd_bwd_pair_kernel), one block per (b*c, lower-
//    triangle pair of 64-row query and key tiles): S of the pair once,
//    written to a scratch tile, then every head in order through a
//    2-stage cp.async ring of its gy and x rows: G, L (masked before the
//    exp, so an upper-triangle pair is exp(-inf) = 0 and never inf * 0),
//    M; S_bar summed over the heads in registers (written once, a scratch
//    tile), and each head's rowsum(R), colsum(R) and sum_t G S L of the
//    pair (64 values each) to a partial scratch;
// 2. the head pass (ssd_bwd_head_kernel), one block per (key tile, head,
//    b*c): V = B.gstate^T for its 64 rows, gx = w V + the walk over the
//    query tiles at or below it of M^T.gy (M from the score scratch),
//    and wbar = rowsum(x o V);
// 3. the chunk pass (ssd_bwd_bc_kernel), one block per (64-row tile, b*c,
//    gC or gB): S_bar.B over the key tiles at or below the tile, or
//    S_bar^T.C over the query tiles at or above it plus the heads' state
//    term, summed over the heads in order;
// 4. the vector pass (ssd_bwd_vec_kernel), one block per (32 heads, b*c),
//    a lane a head: the partials summed over the pairs in order, gcum',
//    the reverse cumsum (serial, in shared memory, 256 rows at a time),
//    gdt and the chunk's share of ga;
// 5. ssd_bwd_ga_kernel: ga, each head's shares summed over b*c in order.
// Every product is a plain fp32 FMA over tiles in shared memory, each of
// a 16 x 16 thread grid's threads owning a strided micro-tile (rows ty +
// 16i, columns tx + 16j). A ragged chunk (Q of 1..1024) is masked, not
// padded: rows past Q are zero-filled on load and never written.
//
// Where the time goes (chip_smoke.py's pass times, PERF.md): the head
// pass most, then the pair pass and the chunk pass, all on CUDA-core FMA
// at ~12x the byte bound. 3xTF32 tensor cores for the per-head products,
// as K5's forward runs them, are the follow-up (ROADMAP, Queue 2).

#include "common.cuh"

constexpr int BT = 64;                // rows of a query or key tile
constexpr int BTILE = BT * BT;        // floats of a packed tile
constexpr int BW = 256;               // a 16 x 16 grid of threads
constexpr int BQMAX = 1024;           // longest chunk
constexpr int MS = BT + 4;            // row of a 64-wide tile in smem
constexpr int NK = 32;                // state columns a head-pass stage
                                      // (all N where N is 16)
constexpr int VROWS = 256;            // rows of a vector-pass stage

__host__ __device__ constexpr int bwd_tiles(int Q) {
    return (Q + BT - 1) / BT;
}
__host__ __device__ constexpr int bwd_pairs(int Q) {
    return bwd_tiles(Q) * (bwd_tiles(Q) + 1) / 2;
}
__device__ __forceinline__ int pair_index(int qi, int kj) {
    return qi * (qi + 1) / 2 + kj;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// floats of dynamic shared memory of each pass
__host__ __device__ constexpr int pair_stage_floats(int P) {
    return 2 * BT * (P + 4) + 3 * BT;
}
__host__ __device__ constexpr int pair_smem_floats(int P, int N) {
    const int sc = 2 * BT * (N + 4);
    const int st = 2 * pair_stage_floats(P);
    return (sc > st ? sc : st) + 2 * 16 * BT;
}
__host__ __device__ constexpr int head_smem_floats_bwd(int P) {
    const int a = BT * (NK + 4) + P * (NK + 4) + BT * (P + 4);
    const int b = BT * MS + BT * (P + 4);
    return 4 * BT + (a > b ? a : b);
}
__host__ __device__ constexpr int bc_smem_floats(int P, int N) {
    const int a = BT * MS + BT * (N + 4);
    const int b = BT * (P + 4) + P * (N + 4);
    return 2 * BT + (a > b ? a : b);
}
constexpr int VEC_SMEM_FLOATS = 2 * VROWS * 32 + 2 * 8 * 32;

// ---------------------------------------------------------------------
// 1. Pair pass: grid (pairs, b*c). Rows t of query tile qi, keys s of key
// tile kj <= qi.
template <int PJ, int NJ>
__global__ void __launch_bounds__(BW)
ssd_bwd_pair_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    const float* __restrict__ cum,
                    const float* __restrict__ gy, float* __restrict__ scores,
                    float* __restrict__ sbar, float* __restrict__ part, int Q,
                    int H) {
    constexpr int P = 16 * PJ, N = 16 * NJ, PS = P + 4, NS = N + 4;
    constexpr int STAGE = pair_stage_floats(P);
    const int64_t bc = blockIdx.y;
    const int p = blockIdx.x, npairs = bwd_pairs(Q);
    int qi = 0;
    while ((qi + 1) * (qi + 2) / 2 <= p) ++qi;
    const int kj = p - qi * (qi + 1) / 2;
    const int t0 = qi * BT, s0 = kj * BT;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    extern __shared__ __align__(16) float smem[];
    const int sc_floats = 2 * BT * NS, st_floats = 2 * STAGE;
    float* red = smem + (sc_floats > st_floats ? sc_floats : st_floats);

    // ---- S = C_qi . B_kj^T, once for every head
    {
        float* cs = smem;
        float* bs = cs + BT * NS;
        for (int i = tid; i < BT * (N / 4); i += BW) {
            const int r = i / (N / 4), c = (i - r * (N / 4)) * 4;
            const bool lc = t0 + r < Q, lb = s0 + r < Q;
            cp_async16(cs + r * NS + c,
                       Cm + (lc ? (bc * Q + t0 + r) * N + c : 0), lc);
            cp_async16(bs + r * NS + c,
                       Bm + (lb ? (bc * Q + s0 + r) * N + c : 0), lb);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
    }
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(smem + (ty + 16 * i) * NS + n);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            bv[j] = ld4(smem + BT * NS + (tx + 16 * j) * NS + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = dot4(cv[i], bv[j], sc[i][j]);
    }
    const int64_t tile = bc * npairs + p;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            scores[tile * BTILE + (ty + 16 * i) * BT + tx + 16 * j] = sc[i][j];
    __syncthreads();                  // C and B rows give way to the ring

    // ---- every head in order: gy rows of qi, x rows of kj, cum, dt
    auto fetch = [&](int h, int st) {
        float* g = smem + st * STAGE;
        float* xx = g + BT * PS;
        float* ct = xx + BT * PS;     // cum of rows t
        float* cs = ct + BT;          // cum of keys s
        float* ds = cs + BT;          // dt of keys s
        for (int i = tid; i < BT * (P / 4); i += BW) {
            const int r = i / (P / 4), c = (i - r * (P / 4)) * 4;
            const bool lt = t0 + r < Q, ls = s0 + r < Q;
            cp_async16(g + r * PS + c,
                       gy + (lt ? ((bc * Q + t0 + r) * H + h) * P + c : 0),
                       lt);
            cp_async16(xx + r * PS + c,
                       x + (ls ? ((bc * Q + s0 + r) * H + h) * P + c : 0),
                       ls);
        }
        if (tid < BT) {
            const bool lt = t0 + tid < Q, ls = s0 + tid < Q;
            cp_async4(ct + tid, cum + (lt ? (bc * Q + t0 + tid) * H + h : 0),
                      lt);
            cp_async4(cs + tid, cum + (ls ? (bc * Q + s0 + tid) * H + h : 0),
                      ls);
            cp_async4(ds + tid, dt + (ls ? (bc * Q + s0 + tid) * H + h : 0),
                      ls);
        }
        cp_async_commit();
    };
    float sb[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sb[i][j] = 0.f;
    fetch(0, 0);
    for (int h = 0; h < H; ++h) {
        const int st = h & 1;
        if (h + 1 < H) fetch(h + 1, st ^ 1);
        else cp_async_commit();       // an empty group keeps the count
        cp_async_wait1();
        __syncthreads();              // this head's rows landed for all
        const float* g = smem + st * STAGE;
        const float* xx = g + BT * PS;
        const float* ct = xx + BT * PS;
        const float* cs = ct + BT;
        const float* ds = cs + BT;
        float G[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) G[i][j] = 0.f;
        for (int k = 0; k < P; k += 4) {
            float4 gv[4], xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) gv[i] = ld4(g + (ty + 16 * i) * PS + k);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                xv[j] = ld4(xx + (tx + 16 * j) * PS + k);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    G[i][j] = dot4(gv[i], xv[j], G[i][j]);
        }
        float rowp[4] = {0.f, 0.f, 0.f, 0.f}, colp[4] = {0.f, 0.f, 0.f, 0.f};
        float gdl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i, t = t0 + r;
            const float cr = ct[r];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j;
                // mask before exp: a pair with s > t (or a row past Q) is
                // exp(-inf) = 0. A select, not a branch
                const bool live = t < Q && s0 + c <= t;
                const float e = expf(live ? cr - cs[c] : -INFINITY);
                const float q = G[i][j] * e;
                const float d = ds[c];
                sb[i][j] = fmaf(q, d, sb[i][j]);
                const float u = q * sc[i][j];
                gdl[j] += u;
                const float R = u * d;
                rowp[i] += R;
                colp[j] += R;
            }
        }
        // rowsum(R): the 16 lanes of a half-warp hold one row's columns
        float* out = part + tile * 3 * H * BT + (int64_t)h * BT;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float v = rowp[i];
            v += __shfl_xor_sync(FULL_MASK, v, 8);
            v += __shfl_xor_sync(FULL_MASK, v, 4);
            v += __shfl_xor_sync(FULL_MASK, v, 2);
            v += __shfl_xor_sync(FULL_MASK, v, 1);
            if (tx == 0) out[ty + 16 * i] = v;
        }
        // colsum(R) and sum_t G S L: the 16 rows of a column lie in 16
        // threads of other warps, summed through shared memory in order
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            red[ty * BT + tx + 16 * j] = colp[j];
            red[16 * BT + ty * BT + tx + 16 * j] = gdl[j];
        }
        __syncthreads();
        if (tid < 2 * BT) {
            const int k = tid / BT, c = tid - k * BT;
            float v = 0.f;
#pragma unroll
            for (int r = 0; r < 16; ++r) v += red[k * 16 * BT + r * BT + c];
            out[(int64_t)(1 + k) * H * BT + c] = v;
        }
        __syncthreads();              // every thread is done with the stage
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            sbar[tile * BTILE + (ty + 16 * i) * BT + tx + 16 * j] = sb[i][j];
    cp_async_wait<0>();
}

// ---------------------------------------------------------------------
// 2. Head pass: grid (key tiles, H, b*c). gx and wbar of the key tile's
// 64 rows for one head.
template <int PJ, int NJ>
__global__ void __launch_bounds__(BW)
ssd_bwd_head_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Bm,
                    const float* __restrict__ cum,
                    const float* __restrict__ gy,
                    const float* __restrict__ gstate,
                    const float* __restrict__ scores, float* __restrict__ gx,
                    float* __restrict__ wbar, int Q, int H) {
    constexpr int P = 16 * PJ, N = 16 * NJ, PS = P + 4;
    constexpr int NKS = N < NK ? N : NK, KS = NKS + 4;  // a stage's columns
    constexpr int PC = PJ;            // columns of P a thread: tx + 16 j
    const int j0 = blockIdx.x, h = blockIdx.y;
    const int64_t bc = blockIdx.z;
    const int T = bwd_tiles(Q), npairs = bwd_pairs(Q), s0 = j0 * BT;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    extern __shared__ __align__(16) float smem[];
    float* cs = smem;                 // cum of the key rows
    float* ds = cs + BT;              // dt of the key rows
    float* ws = ds + BT;              // w of the key rows
    float* ct = ws + BT;              // cum of a query tile's rows
    float* area = ct + BT;

    // ---- V = B_s . gstate^T over N in stages of NKS columns
    float* bs = area;                 // (64, NKS + 4)
    float* gs = bs + BT * KS;         // (P, NKS + 4)
    float* xs = gs + P * KS;          // (64, P + 4)
    const float* gst = gstate + (bc * H + h) * P * N;
    for (int i = tid; i < BT * (P / 4); i += BW) {
        const int r = i / (P / 4), c = (i - r * (P / 4)) * 4;
        const bool live = s0 + r < Q;
        cp_async16(xs + r * PS + c,
                   x + (live ? ((bc * Q + s0 + r) * H + h) * P + c : 0), live);
    }
    if (tid < BT) {
        const bool live = s0 + tid < Q;
        cp_async4(cs + tid, cum + (live ? (bc * Q + s0 + tid) * H + h : 0),
                  live);
        cp_async4(ds + tid, dt + (live ? (bc * Q + s0 + tid) * H + h : 0),
                  live);
    }
    cp_async_commit();
    float V[4][PC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) V[i][j] = 0.f;
    for (int n0 = 0; n0 < N; n0 += NKS) {
        for (int i = tid; i < BT * (NKS / 4); i += BW) {
            const int r = i / (NKS / 4), c = (i - r * (NKS / 4)) * 4;
            const bool live = s0 + r < Q;
            cp_async16(bs + r * KS + c,
                       Bm + (live ? (bc * Q + s0 + r) * N + n0 + c : 0), live);
        }
        for (int i = tid; i < P * (NKS / 4); i += BW) {
            const int r = i / (NKS / 4), c = (i - r * (NKS / 4)) * 4;
            cp_async16(gs + r * KS + c, gst + r * N + n0 + c, true);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int k = 0; k < NKS; k += 4) {
            float4 bv[4], gv[PC];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                bv[i] = ld4(bs + (ty + 16 * i) * KS + k);
#pragma unroll
            for (int j = 0; j < PC; ++j)
                gv[j] = ld4(gs + (tx + 16 * j) * KS + k);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < PC; ++j)
                    V[i][j] = dot4(bv[i], gv[j], V[i][j]);
        }
        __syncthreads();              // the stage is refilled next
    }
    const float total = cum[(bc * Q + Q - 1) * H + h];
    if (tid < BT)
        ws[tid] = s0 + tid < Q ? expf(total - cs[tid]) * ds[tid] : 0.f;
    __syncthreads();
    float acc[4][PC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        float wb = 0.f;
#pragma unroll
        for (int j = 0; j < PC; ++j) {
            acc[i][j] = ws[r] * V[i][j];
            wb = fmaf(xs[r * PS + tx + 16 * j], V[i][j], wb);
        }
        wb += __shfl_xor_sync(FULL_MASK, wb, 8);
        wb += __shfl_xor_sync(FULL_MASK, wb, 4);
        wb += __shfl_xor_sync(FULL_MASK, wb, 2);
        wb += __shfl_xor_sync(FULL_MASK, wb, 1);
        if (tx == 0 && s0 + r < Q) wbar[(bc * Q + s0 + r) * H + h] = wb;
    }
    __syncthreads();                  // the V stage gives way to the walk

    // ---- gx += M^T . gy over the query tiles at or below the key tile
    float* mt = area;                 // (64 keys, 64 + 4): M transposed
    float* gys = mt + BT * MS;        // (64, P + 4)
    for (int qi = j0; qi < T; ++qi) {
        const int t0 = qi * BT;
        for (int i = tid; i < BT * (P / 4); i += BW) {
            const int r = i / (P / 4), c = (i - r * (P / 4)) * 4;
            const bool live = t0 + r < Q;
            cp_async16(gys + r * PS + c,
                       gy + (live ? ((bc * Q + t0 + r) * H + h) * P + c : 0),
                       live);
        }
        if (tid < BT) {
            const bool live = t0 + tid < Q;
            cp_async4(ct + tid, cum + (live ? (bc * Q + t0 + tid) * H + h : 0),
                      live);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const float* stile =
            scores + (bc * npairs + pair_index(qi, j0)) * BTILE;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i, t = t0 + r;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j;
                const bool live = t < Q && s0 + c <= t;
                const float e = expf(live ? ct[r] - cs[c] : -INFINITY);
                mt[c * MS + r] = live ? stile[r * BT + c] * e * ds[c] : 0.f;
            }
        }
        __syncthreads();
        for (int t = 0; t < BT; t += 4) {
            float4 mv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                mv[i] = ld4(mt + (ty + 16 * i) * MS + t);
#pragma unroll
            for (int j = 0; j < PC; ++j) {
                const float g0 = gys[t * PS + tx + 16 * j];
                const float g1 = gys[(t + 1) * PS + tx + 16 * j];
                const float g2 = gys[(t + 2) * PS + tx + 16 * j];
                const float g3 = gys[(t + 3) * PS + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    acc[i][j] = dot4(mv[i], make_float4(g0, g1, g2, g3),
                                     acc[i][j]);
            }
        }
        __syncthreads();              // the tiles are refilled next
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (s0 + r >= Q) continue;
#pragma unroll
        for (int j = 0; j < PC; ++j)
            gx[((bc * Q + s0 + r) * H + h) * P + tx + 16 * j] = acc[i][j];
    }
}

// ---------------------------------------------------------------------
// 3. Chunk pass: grid (tiles, b*c, 2). z 0: gC of the tile's rows; z 1: gB.
template <int PJ, int NJ>
__global__ void __launch_bounds__(BW)
ssd_bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ cum,
                  const float* __restrict__ gstate,
                  const float* __restrict__ sbar, float* __restrict__ gB,
                  float* __restrict__ gC, int Q, int H) {
    constexpr int P = 16 * PJ, N = 16 * NJ, PS = P + 4, NS = N + 4;
    constexpr int NC = NJ;            // columns of N a thread: tx + 16 j
    const int k0 = blockIdx.x, is_b = blockIdx.z;
    const int64_t bc = blockIdx.y;
    const int T = bwd_tiles(Q), npairs = bwd_pairs(Q), r0 = k0 * BT;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    extern __shared__ __align__(16) float smem[];
    float* cs = smem;                 // cum of the tile's rows (gB)
    float* ws = cs + BT;              // their w, one head at a time
    float* ss = ws + BT;              // (64, 64 + 4): an S_bar tile
    float* os = ss + BT * MS;         // (64, N + 4): B or C rows
    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

    // S_bar products: gC_t = sum_{s-tiles <= k0} S_bar[t][s] B_s, or
    // gB_s = sum_{t-tiles >= k0} S_bar[t][s] C_t
    const int first = is_b ? k0 : 0, last = is_b ? T - 1 : k0;
    for (int m = first; m <= last; ++m) {
        const int pidx = is_b ? pair_index(m, k0) : pair_index(k0, m);
        const float* stile = sbar + (bc * npairs + pidx) * BTILE;
        for (int i = tid; i < BT * (BT / 4); i += BW) {
            const int r = i / (BT / 4), c = (i - r * (BT / 4)) * 4;
            cp_async16(ss + r * MS + c, stile + r * BT + c, true);
        }
        const float* src = is_b ? Cm : Bm;
        const int o0 = m * BT;
        for (int i = tid; i < BT * (N / 4); i += BW) {
            const int r = i / (N / 4), c = (i - r * (N / 4)) * 4;
            const bool live = o0 + r < Q;
            cp_async16(os + r * NS + c,
                       src + (live ? (bc * Q + o0 + r) * N + c : 0), live);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (is_b) {
            for (int t = 0; t < BT; ++t) {
                float sv[4], ov[NC];
#pragma unroll
                for (int i = 0; i < 4; ++i) sv[i] = ss[t * MS + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < NC; ++j) ov[j] = os[t * NS + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < NC; ++j)
                        acc[i][j] = fmaf(sv[i], ov[j], acc[i][j]);
            }
        } else {
            for (int s = 0; s < BT; s += 4) {
                float4 sv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    sv[i] = ld4(ss + (ty + 16 * i) * MS + s);
#pragma unroll
                for (int j = 0; j < NC; ++j) {
                    const float4 ov = make_float4(
                        os[s * NS + tx + 16 * j],
                        os[(s + 1) * NS + tx + 16 * j],
                        os[(s + 2) * NS + tx + 16 * j],
                        os[(s + 3) * NS + tx + 16 * j]);
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[i][j] = dot4(sv[i], ov, acc[i][j]);
                }
            }
        }
        __syncthreads();              // the tiles are refilled next
    }

    if (is_b) {
        // the state term: sum_h sum_p (w_s x_s,p) gstate_{p, n}, the heads
        // in order
        float* xs = ss;               // (64, P + 4): w-scaled x rows
        float* gs = xs + BT * PS;     // (P, N + 4)
        for (int h = 0; h < H; ++h) {
            const float* gst = gstate + (bc * H + h) * P * N;
            for (int i = tid; i < BT * (P / 4); i += BW) {
                const int r = i / (P / 4), c = (i - r * (P / 4)) * 4;
                const bool live = r0 + r < Q;
                const int64_t o = ((bc * Q + r0 + r) * H + h) * P + c;
                cp_async16(xs + r * PS + c, x + (live ? o : 0), live);
            }
            for (int i = tid; i < P * (N / 4); i += BW) {
                const int r = i / (N / 4), c = (i - r * (N / 4)) * 4;
                cp_async16(gs + r * NS + c, gst + r * N + c, true);
            }
            if (tid < BT) {
                const bool live = r0 + tid < Q;
                const int64_t o = (bc * Q + r0 + tid) * H + h;
                cp_async4(cs + tid, cum + (live ? o : 0), live);
                cp_async4(ws + tid, dt + (live ? o : 0), live);
            }
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
            if (tid < BT) {
                const float total = cum[(bc * Q + Q - 1) * H + h];
                ws[tid] = r0 + tid < Q ? expf(total - cs[tid]) * ws[tid] : 0.f;
            }
            __syncthreads();
            for (int i = tid; i < BT * P; i += BW) {
                const int r = i / P, c = i - r * P;
                xs[r * PS + c] *= ws[r];
            }
            __syncthreads();
            for (int p = 0; p < P; p += 4) {
                float4 xv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    xv[i] = ld4(xs + (ty + 16 * i) * PS + p);
#pragma unroll
                for (int j = 0; j < NC; ++j) {
                    const float4 gv = make_float4(
                        gs[p * NS + tx + 16 * j],
                        gs[(p + 1) * NS + tx + 16 * j],
                        gs[(p + 2) * NS + tx + 16 * j],
                        gs[(p + 3) * NS + tx + 16 * j]);
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[i][j] = dot4(xv[i], gv, acc[i][j]);
                }
            }
            __syncthreads();          // the stage is refilled next
        }
    }
    float* out = is_b ? gB : gC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r0 + r >= Q) continue;
#pragma unroll
        for (int j = 0; j < NC; ++j)
            out[(bc * Q + r0 + r) * N + tx + 16 * j] = acc[i][j];
    }
}

// ---------------------------------------------------------------------
// 4. Vector pass: grid (ceil(H/32), b*c), 8 warps, a lane a head.
__global__ void __launch_bounds__(BW)
ssd_bwd_vec_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                   const float* __restrict__ cum,
                   const float* __restrict__ gdecay,
                   const float* __restrict__ gcum,
                   const float* __restrict__ part,
                   const float* __restrict__ wbar, float* __restrict__ gdt,
                   float* __restrict__ ga_part, int Q, int H) {
    const int64_t bc = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int h = blockIdx.x * 32 + lane;
    const bool hl = h < H;
    const int hh = hl ? h : 0;
    const int npairs = bwd_pairs(Q), T = bwd_tiles(Q);
    extern __shared__ __align__(16) float smem[];
    float* base = smem;               // (VROWS, 32): gcum' then gdA
    float* gp = base + VROWS * 32;    // (VROWS, 32): gdt less gdA a
    float* red = gp + VROWS * 32;     // (8, 32)
    float* red2 = red + 8 * 32;       // (8, 32)
    const float total = cum[(bc * Q + Q - 1) * H + hh];
    const float ah = a[hh];
    const float* pb = part + bc * npairs * 3 * H * BT + (int64_t)hh * BT;

    // K = sum_s wbar_s w_s + gdecay exp(total): it enters row Q-1, so
    // every row's reverse cumsum
    float k = 0.f;
    for (int s = warp; s < Q; s += 8) {
        const int64_t o = (bc * Q + s) * H + hh;
        k += wbar[o] * (expf(total - cum[o]) * dt[o]);
    }
    red[warp * 32 + lane] = k;
    __syncthreads();
    float acc = 0.f;                  // warp 0: the running reverse sum
    if (warp == 0) {
#pragma unroll
        for (int w = 0; w < 8; ++w) acc += red[w * 32 + lane];
        if (gdecay != nullptr) acc += gdecay[bc * H + hh] * expf(total);
    }
    float gas = 0.f;
    for (int c0 = (Q - 1) / VROWS * VROWS; c0 >= 0; c0 -= VROWS) {
        const int n = min(VROWS, Q - c0);
        for (int r = warp; r < n; r += 8) {
            const int s = c0 + r, i = s / BT, rr = s - i * BT;
            const int64_t o = (bc * Q + s) * H + hh;
            float row = 0.f, col = 0.f, gdm = 0.f;
            for (int j = 0; j <= i; ++j)
                row += pb[(int64_t)pair_index(i, j) * 3 * H * BT + rr];
            for (int m = i; m < T; ++m) {
                const float* q = pb + (int64_t)pair_index(m, i) * 3 * H * BT;
                col += q[(int64_t)H * BT + rr];
                gdm += q[(int64_t)2 * H * BT + rr];
            }
            const float e = expf(total - cum[o]);
            const float wb = wbar[o];
            const float g0 = gcum != nullptr ? gcum[o] : 0.f;
            base[r * 32 + lane] = g0 + row - col - wb * (e * dt[o]);
            gp[r * 32 + lane] = gdm + wb * e;
        }
        __syncthreads();
        if (warp == 0) {
            for (int r = n - 1; r >= 0; --r) {
                acc += base[r * 32 + lane];
                base[r * 32 + lane] = acc;
            }
        }
        __syncthreads();
        for (int r = warp; r < n; r += 8) {
            const int64_t o = (bc * Q + c0 + r) * H + hh;
            const float gda = base[r * 32 + lane];
            if (hl) gdt[o] = gp[r * 32 + lane] + gda * ah;
            gas += gda * dt[o];
        }
        __syncthreads();              // the stage is refilled next
    }
    red2[warp * 32 + lane] = gas;
    __syncthreads();
    if (warp == 0 && hl) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) v += red2[w * 32 + lane];
        ga_part[bc * H + h] = v;
    }
}

// 5. ga[h] = sum over b*c of the chunks' shares, in order.
__global__ void ssd_bwd_ga_kernel(const float* __restrict__ ga_part,
                                  float* __restrict__ ga, int BC, int H) {
    const int h = blockIdx.x * blockDim.x + threadIdx.x;
    if (h >= H) return;
    float v = 0.f;
    for (int b = 0; b < BC; ++b) v += ga_part[(int64_t)b * H + h];
    ga[h] = v;
}

struct BwdGrids {
    dim3 pair, head, bc, vec, ga;
};
static BwdGrids bwd_grids(int BC, int Q, int H) {
    return {dim3(bwd_pairs(Q), BC), dim3(bwd_tiles(Q), H, BC),
            dim3(bwd_tiles(Q), BC, 2), dim3((H + 31) / 32, BC),
            dim3((H + 127) / 128)};
}

template <int PJ, int NJ>
static cudaError_t launch(const float* x, const float* dt, const float* a,
                          const float* Bm, const float* Cm, const float* cum,
                          const float* gy, const float* gstate,
                          const float* gdecay, const float* gcum, float* gx,
                          float* gdt, float* ga, float* gB, float* gC,
                          float* scores, float* sbar, float* part,
                          float* wbar, float* ga_part, int BC, int Q, int H,
                          cudaStream_t stream) {
    constexpr int P = 16 * PJ, N = 16 * NJ;
    const BwdGrids g = bwd_grids(BC, Q, H);
    cudaError_t e = launch_with_smem(
        ssd_bwd_pair_kernel<PJ, NJ>, g.pair, dim3(BW),
        sizeof(float) * (size_t)pair_smem_floats(P, N), stream, x, dt, Bm, Cm,
        cum, gy, scores, sbar, part, Q, H);
    if (e != cudaSuccess) return e;
    e = launch_with_smem(ssd_bwd_head_kernel<PJ, NJ>, g.head, dim3(BW),
                         sizeof(float) * (size_t)head_smem_floats_bwd(P),
                         stream, x, dt, Bm, cum, gy, gstate,
                         (const float*)scores, gx, wbar, Q, H);
    if (e != cudaSuccess) return e;
    e = launch_with_smem(ssd_bwd_bc_kernel<PJ, NJ>, g.bc, dim3(BW),
                         sizeof(float) * (size_t)bc_smem_floats(P, N), stream,
                         x, dt, Bm, Cm, cum, gstate, (const float*)sbar, gB,
                         gC, Q, H);
    if (e != cudaSuccess) return e;
    e = launch_with_smem(ssd_bwd_vec_kernel, g.vec, dim3(BW),
                         sizeof(float) * (size_t)VEC_SMEM_FLOATS, stream, dt,
                         a, cum, gdecay, gcum, (const float*)part,
                         (const float*)wbar, gdt, ga_part, Q, H);
    if (e != cudaSuccess) return e;
    return launch_with_smem(ssd_bwd_ga_kernel, g.ga, dim3(128), 0, stream,
                            (const float*)ga_part, ga, BC, H);
}

// registers, dynamic shared memory, local bytes and resident blocks an SM
// of `kern` at `smem` bytes, then its grid: out[0..6]
template <typename K>
static cudaError_t kern_attrs(K kern, int threads, size_t smem, dim3 grid,
                              int* out) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem);
    out[0] = fa.numRegs;
    out[1] = (int)smem;
    out[2] = (int)fa.localSizeBytes;
    out[3] = blocks;
    out[4] = (int)grid.x;
    out[5] = (int)grid.y;
    out[6] = (int)grid.z;
    return e;
}

// out[7 k .. 7 k + 6], k = pair, head, bc, vec, ga: each pass's registers,
// shared memory, local bytes, blocks an SM and grid (x, y, z)
template <int PJ, int NJ>
static cudaError_t attrs(int BC, int Q, int H, int* out) {
    constexpr int P = 16 * PJ, N = 16 * NJ;
    const BwdGrids g = bwd_grids(BC, Q, H);
    cudaError_t e = kern_attrs(ssd_bwd_pair_kernel<PJ, NJ>, BW,
                               sizeof(float) * (size_t)pair_smem_floats(P, N),
                               g.pair, out);
    if (e != cudaSuccess) return e;
    e = kern_attrs(ssd_bwd_head_kernel<PJ, NJ>, BW,
                   sizeof(float) * (size_t)head_smem_floats_bwd(P), g.head,
                   out + 7);
    if (e != cudaSuccess) return e;
    e = kern_attrs(ssd_bwd_bc_kernel<PJ, NJ>, BW,
                   sizeof(float) * (size_t)bc_smem_floats(P, N), g.bc,
                   out + 14);
    if (e != cudaSuccess) return e;
    e = kern_attrs(ssd_bwd_vec_kernel, BW,
                   sizeof(float) * (size_t)VEC_SMEM_FLOATS, g.vec, out + 21);
    if (e != cudaSuccess) return e;
    return kern_attrs(ssd_bwd_ga_kernel, 128, 0, g.ga, out + 28);
}

// Return FN<PJ, NJ>(...) for head_dim P = 16 PJ and state N = 16 NJ, both
// in {16, 32, 64, 128}; anything else is refused.
#define SSDB_BY_N(FN, PJ, ...)                                               \
    (N == 16    ? (int)FN<PJ, 1>(__VA_ARGS__)                                \
     : N == 32  ? (int)FN<PJ, 2>(__VA_ARGS__)                                \
     : N == 64  ? (int)FN<PJ, 4>(__VA_ARGS__)                                \
     : N == 128 ? (int)FN<PJ, 8>(__VA_ARGS__)                                \
                : (int)cudaErrorInvalidValue)
#define SSDB_DISPATCH(FN, ...)                                               \
    switch (P) {                                                             \
        case 16: return SSDB_BY_N(FN, 1, __VA_ARGS__);                       \
        case 32: return SSDB_BY_N(FN, 2, __VA_ARGS__);                       \
        case 64: return SSDB_BY_N(FN, 4, __VA_ARGS__);                       \
        case 128: return SSDB_BY_N(FN, 8, __VA_ARGS__);                      \
        default: return (int)cudaErrorInvalidValue;                          \
    }

// x, gy, gx (BC, Q, H, P); dt, cum, gcum, gdt (BC, Q, H); a, ga (H,);
// B, C, gB, gC (BC, Q, N); gstate (BC, H, P, N); gdecay (BC, H). gdecay
// and gcum may be null (zeros). Scratch: scores and sbar (BC, T(T+1)/2,
// 64, 64), part (BC, T(T+1)/2, 3, H, 64), wbar (BC, Q, H), ga_part (BC,
// H), T = ceil(Q/64). All fp32, contiguous, 16-byte aligned; P and N in
// {16, 32, 64, 128}; 1 <= Q <= 1024. Returns the cudaError_t of the
// launches (0 = all five launched).
extern "C" int ssd_chunk_bwd_launch(
        const float* x, const float* dt, const float* a, const float* Bm,
        const float* Cm, const float* cum, const float* gy,
        const float* gstate, const float* gdecay, const float* gcum,
        float* gx, float* gdt, float* ga, float* gB, float* gC,
        float* scores, float* sbar, float* part, float* wbar, float* ga_part,
        int BC, int Q, int H, int P, int N, void* stream) {
    if (Q < 1 || Q > BQMAX) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    SSDB_DISPATCH(launch, x, dt, a, Bm, Cm, cum, gy, gstate, gdecay, gcum, gx,
                  gdt, ga, gB, gC, scores, sbar, part, wbar, ga_part, BC, Q,
                  H, s)
}

// The five passes' attributes and grids at these shapes (see attrs).
extern "C" int ssd_chunk_bwd_attrs(int BC, int Q, int H, int P, int N,
                                   int* out) {
    if (Q < 1 || Q > BQMAX) return (int)cudaErrorInvalidValue;
    SSDB_DISPATCH(attrs, BC, Q, H, out)
}
