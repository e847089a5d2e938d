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
// What bounds it on this card. At mamba2-370m's prefill (6 chunks of Q
// 256, H 32, P 64, N 128) the function needs 0.83 G multiply-adds: the
// scores C.B^T once per chunk (they have no head axis, 0.025 G), the
// masked product with x per head (0.40 G) and the state product per head
// (0.40 G), against 33 MB of inputs and outputs: ~50 flops a byte. The
// operands are fp32, so the tensor cores take each product in three TF32
// passes (hi.hi' + hi.lo' + lo.hi', common.cuh; one pass misses
// kernels.ssd.error_bound on short rows): ~2.5 M mma.sync m16n8k8, 5.2
// GFLOP of TF32, ~10 us even at wgmma's full 494 TFLOP/s, which mma.sync
// does not reach. So the tensor cores bound it, not the 10 us of bytes,
// and close behind them the shared-memory reads that feed the fragments
// and the tile loads each block waits on. The PR 13 design ran everything
// on CUDA cores, recomputed C.B^T for every head (53% of its
// multiply-adds, 31/32 of them repeats), and was bound by shared-memory
// loads and bank conflicts.
//
// The design, two launches on the stream:
// 1. The score pass (ssd_chunk_score_kernel), 4 warps a block, one block
//    per (b*c, lower-triangle pair of 64-row query and key tiles, diagonal
//    included, 32-key half): C and B rows land with 16-byte cp.async in
//    rows padded by 8 floats (every fragment load free of bank conflicts;
//    B is read row-major as the mma's col operand, nothing is
//    transposed), each warp takes 16 rows x 32 keys of C.B^T on mma.sync
//    3xTF32, and the half goes to a scratch of packed lower-triangle tiles
//    (b*c, T(T+1)/2, 64, 64), T = ceil(Q/64), which the wrapper allocates:
//    0.98 MB for a 1,500-token note, held in L2. More blocks of the same
//    launch, one per (b*c, 32 heads), take cum and decay: the block stages
//    dt in shared memory by cp.async, then one warp, a lane a head, sums
//    dt * a in order, rounding each product and sum (__fmul_rn/__fadd_rn,
//    never contracted), 32 rows at a time with their loads ahead of the
//    chain of adds and their stores after it: the order of torch.cumsum
//    along a non-innermost dimension on the card, so cum is bit-equal to
//    the plain version's there. The order matters: at a = -32, |cum|
//    reaches ~8,000 and one ulp of it is 5e-4 in every decay factor.
// 2. The head pass (ssd_chunk_head_kernel), 4 warps a block, grid (b*c,
//    head, item): the state blocks first, then the y blocks, longest walks
//    first so the short ones fill the tail. Every warp holds two m tiles
//    (32 rows) of its output, so each B fragment it reads feeds two
//    products. A y block takes two 64-row query tiles and walks the keys
//    up to their diagonal in 32-key stages of a 2-stage cp.async ring
//    holding both tiles' score rows (from L2) and the x rows, so each x
//    row is read once for 128 queries; each lane masks s <= t BEFORE the
//    exp (a masked pair is exp(-inf) = 0, the upper triangle never
//    overflows), scales its score fragment by expf(cum[t] - cum[s]) dt[s]
//    with selects, not branches, and the (32 x 32).(32 x P) products run
//    in 3xTF32, the score fragment's keys (2t, 2t+1) taken as the mma's k
//    indices (t, t+4); a warp stops at its last row's key. A state block
//    (all N, or half where a warp would hold more than 64 accumulators)
//    reads each x row once and takes x^T.(B w) in 3xTF32 with w =
//    expf(cum[Q-1] - cum[s]) dt[s] folded into x's fragment. Every sum is
//    taken in a fixed order with no atomics, so repeated launches give the
//    same bits. No inner loop branches on a warp's or a lane's index: a
//    branch there splits the independent products into serial chains.
// A ragged chunk (Q of 1..1024) is masked, not padded: rows past Q are
// zero-filled on load and never written.
//
// Where the time goes (chip_smoke.py's pass times, PERF.md): the head
// pass is most of it, and the mma.sync products most of that: three TF32
// passes a product. wgmma (the full TF32 rate) and blocks that share a
// score or B tile across heads (fewer L2 reads) are the follow-ups.

#include "common.cuh"

constexpr int TT = 64;                // rows of a query or key tile
constexpr int TILE = TT * TT;         // floats of a packed score tile
constexpr int SC_THREADS = 128;       // score pass: 4 warps
constexpr int HD_THREADS = 128;       // head pass: 4 warps
constexpr int CUM_HEADS = 32;         // heads of a cum block, a lane each
constexpr int CUM_ROWS = 256;         // rows of dt a cum block stages
constexpr int KS = 32;                // keys a head-pass ring stage
constexpr int YS = KS + 8;            // row of a stage's score rows
constexpr int QMAX = 1024;            // longest chunk

__host__ __device__ constexpr int ssd_tiles(int Q) {
    return (Q + TT - 1) / TT;
}
__host__ __device__ constexpr int ssd_pairs(int Q) {
    return ssd_tiles(Q) * (ssd_tiles(Q) + 1) / 2;
}
// state columns a state block: all N, or half of them where a warp's
// share of P x N would take more than 64 accumulators
__host__ __device__ constexpr int ssd_nc(int P, int N) {
    return (P / 16) * (N / 16) <= 32 ? N : N / 2;
}

// floats of dynamic shared memory
__host__ __device__ constexpr int score_smem_floats(int N) {
    const int tiles = (TT + TT / 2) * (N + 8);
    const int cum = CUM_ROWS * CUM_HEADS;
    return tiles > cum ? tiles : cum;
}
__host__ __device__ constexpr int head_smem_floats(int Q, int P, int N) {
    const int y = 2 * (2 * TT * YS + KS * (P + 4));
    const int st = 2 * KS * ((P + 8) + (ssd_nc(P, N) + 8));
    return 2 * ssd_tiles(Q) * TT + (y > st ? y : st);
}

// ---------------------------------------------------------------------
// Score pass: grid (ceil(H/32) + 2 pairs, b*c). x < ceil(H/32): the cum
// and decay of 32 heads; else C.B^T of one half (32 keys) of a
// lower-triangle tile pair.
template <int NJ>
__global__ void __launch_bounds__(SC_THREADS)
ssd_chunk_score_kernel(const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       float* __restrict__ scores, float* __restrict__ decay,
                       float* __restrict__ cum, int Q, int H) {
    constexpr int N = 16 * NJ, NS = N + 8;
    const int64_t bc = blockIdx.y;
    const int ncg = (H + CUM_HEADS - 1) / CUM_HEADS;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    extern __shared__ __align__(16) float smem[];

    if ((int)blockIdx.x < ncg) {
        // ---- cum and decay of heads [h0, h0 + 32): the block stages dt
        // in shared memory, then one warp sums it, a lane a head, and
        // stores cum straight from its registers
        const int h0 = blockIdx.x * CUM_HEADS;
        const int hn = min(CUM_HEADS, H - h0);
        const float ah = lane < hn ? a[h0 + lane] : 0.f;
        const float* src = dt + bc * Q * H + h0;
        float* dst = cum + bc * Q * H + h0 + lane;
        float acc = 0.f;
        for (int s0 = 0; s0 < Q; s0 += CUM_ROWS) {
            const int n = min(CUM_ROWS, Q - s0);
            for (int i = tid; i < n * CUM_HEADS; i += SC_THREADS) {
                const int r = i / CUM_HEADS, j = i - r * CUM_HEADS;
                const bool live = j < hn;
                cp_async4(smem + i,
                          src + (live ? (int64_t)(s0 + r) * H + j : 0), live);
            }
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
            if (warp == 0) {
                for (int r0 = 0; r0 < n; r0 += 32) {
                    // 32 rows: the loads and products ahead of the chain
                    // of adds, the stores after it
                    float v[32];
#pragma unroll
                    for (int r = 0; r < 32; ++r)
                        v[r] = __fmul_rn(smem[(r0 + r) * CUM_HEADS + lane],
                                         ah);
#pragma unroll
                    for (int r = 0; r < 32; ++r) {
                        acc = r0 + r < n ? __fadd_rn(acc, v[r]) : acc;
                        v[r] = acc;
                    }
                    float* out = dst + (int64_t)(s0 + r0) * H;
                    if (hn == CUM_HEADS && r0 + 32 <= n) {
                        // every lane and row live: no guard on the stores
#pragma unroll
                        for (int r = 0; r < 32; ++r, out += H) *out = v[r];
                    } else {
#pragma unroll
                        for (int r = 0; r < 32; ++r, out += H)
                            if (lane < hn && r0 + r < n) *out = v[r];
                    }
                }
            }
            __syncthreads();          // the next rows reuse the buffer
        }
        if (warp == 0 && lane < hn) decay[bc * H + h0 + lane] = expf(acc);
        return;
    }

    // ---- rows [t0, t0 + 64) x keys [k0, k0 + 32) of a score tile -------
    const int p = (blockIdx.x - ncg) >> 1, half = (blockIdx.x - ncg) & 1;
    int qi = 0;
    while ((qi + 1) * (qi + 2) / 2 <= p) ++qi;
    const int kj = p - qi * (qi + 1) / 2;
    const int t0 = qi * TT, k0 = kj * TT + half * (TT / 2);
    float* cs = smem;                 // (64, NS): C rows
    float* bs = cs + TT * NS;         // (32, NS): B rows
    for (int i = tid; i < TT * (N / 4); i += SC_THREADS) {
        const int r = i / (N / 4), c = (i - r * (N / 4)) * 4;
        const bool lc = t0 + r < Q;
        cp_async16(cs + r * NS + c, Cm + (lc ? (bc * Q + t0 + r) * N + c : 0),
                   lc);
        if (r < TT / 2) {
            const bool lb = k0 + r < Q;
            cp_async16(bs + r * NS + c,
                       Bm + (lb ? (bc * Q + k0 + r) * N + c : 0), lb);
        }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // warp: rows [16 warp, 16 warp + 16) x the 32 keys
    const int ra = warp * 16 + gq, rb = ra + 8;
    float s[4][4], s2[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < N; kk += 8) {
        const float2 xa = load2(cs + ra * NS + kk + 2 * tq);
        const float2 xb = load2(cs + rb * NS + kk + 2 * tq);
        uint32_t ahi[4], alo[4];
        tf32_split<false>(xa.x, ahi[0], alo[0]);
        tf32_split<false>(xb.x, ahi[1], alo[1]);
        tf32_split<false>(xa.y, ahi[2], alo[2]);
        tf32_split<false>(xb.y, ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float2 y = load2(bs + (8 * j + gq) * NS + kk + 2 * tq);
            uint32_t bhi[2], blo[2];
            tf32_split<false>(y.x, bhi[0], blo[0]);
            tf32_split<false>(y.y, bhi[1], blo[1]);
            mma_split<false, false>(s[j], s2[j], ahi, alo, bhi, blo);
        }
    }
    float* tile = scores + (bc * ssd_pairs(Q) + p) * TILE + half * (TT / 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = 8 * j + 2 * tq;
        store2(tile + ra * TT + c, s[j][0] + s2[j][0], s[j][1] + s2[j][1]);
        store2(tile + rb * TT + c, s[j][2] + s2[j][2], s[j][3] + s2[j][3]);
    }
}

// ---------------------------------------------------------------------
// Head pass: grid (b*c, H, N/NC + ceil(T/2)). z < N/NC: the state's
// columns [z NC, z NC + NC); else the y rows of query tiles 2j and 2j + 1,
// j = ceil(T/2) - 1 - (z - N/NC). A warp holds two m tiles (32 rows) of
// its output, so every B fragment it reads feeds two products.
template <int PJ, int NJ>
__global__ void __launch_bounds__(HD_THREADS)
ssd_chunk_head_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ Bm,
                      const float* __restrict__ scores,
                      const float* __restrict__ cum, float* __restrict__ y,
                      float* __restrict__ state, int Q, int H) {
    constexpr int P = 16 * PJ, N = 16 * NJ;
    constexpr int NC = ssd_nc(P, N), NSB = N / NC;
    const int64_t bc = blockIdx.x;
    const int h = blockIdx.y, z = blockIdx.z;
    const int T = ssd_tiles(Q), QT = T * TT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    extern __shared__ __align__(16) float smem[];
    float* cum_s = smem;              // (QT,): cum[s], zero past the walk
    float* dt_s = cum_s + QT;         // (QT,): dt[s], then w[s] (state)
    float* ring = dt_s + QT;

    const bool is_state = z < NSB;
    const int qa = is_state ? 0 : 2 * ((T + 1) / 2 - 1 - (z - NSB));
    const int t0 = qa * TT;           // the y block's first row
    const int rows = is_state ? 0 : min(2 * TT, Q - t0);
    const int kend = is_state ? Q : t0 + rows;  // keys [0, kend) are read
    const int nks = (kend + KS - 1) / KS;       // ring stages walked
    for (int s = tid; s < QT; s += HD_THREADS) {
        const bool live = s < kend;
        const int64_t off = live ? (bc * Q + s) * H + h : 0;
        cp_async4(cum_s + s, cum + off, live);
        cp_async4(dt_s + s, dt + off, live);
    }

    if (is_state) {
        // ---- state[p, n0 + n] = sum_s (x[s, p] w[s]) B[s, n0 + n] -------
        // warp: m tiles [mh MW, mh MW + MW) (mod P's, a repeat stores
        // nothing) x the 8-column n tiles of columns [nh NC/2, +NC/2)
        constexpr int XS = P + 8, BS = NC + 8;       // conflict-free strides
        constexpr int MW = PJ / 2 > 0 ? PJ / 2 : 1;  // m tiles a warp
        constexpr int NW = NC / 16;                  // n tiles a warp
        constexpr int STAGE = KS * (XS + BS);
        const int n0 = z * NC;
        const int mh = warp & 1, nh = warp >> 1;
        int m0[MW];
#pragma unroll
        for (int i = 0; i < MW; ++i) m0[i] = (mh * MW + i) % PJ * 16;
        auto fetch = [&](int ks, int st) {
            float* xd = ring + st * STAGE;
            float* bd = xd + KS * XS;
            const int k0 = ks * KS;
            for (int i = tid; i < KS * (P / 4); i += HD_THREADS) {
                const int r = i / (P / 4), c = (i - r * (P / 4)) * 4;
                const bool live = k0 + r < Q;
                const int64_t off = live ? ((bc * Q + k0 + r) * H + h) * P + c
                                         : 0;
                cp_async16(xd + r * XS + c, x + off, live);
            }
            for (int i = tid; i < KS * (NC / 4); i += HD_THREADS) {
                const int r = i / (NC / 4), c = (i - r * (NC / 4)) * 4;
                const bool live = k0 + r < Q;
                cp_async16(bd + r * BS + c,
                           Bm + (live ? (bc * Q + k0 + r) * N + n0 + c : 0),
                           live);
            }
            cp_async_commit();
        };
        fetch(0, 0);                  // one group with cum and dt
        cp_async_wait<0>();
        __syncthreads();
        const float total = cum_s[Q - 1];
        for (int s = tid; s < QT; s += HD_THREADS)
            dt_s[s] = s < Q ? expf(total - cum_s[s]) * dt_s[s] : 0.f;
        float acc[MW][NW][4];
#pragma unroll
        for (int i = 0; i < MW; ++i)
#pragma unroll
            for (int j = 0; j < NW; ++j)
                acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] =
                    0.f;
        for (int ks = 0; ks < nks; ++ks) {
            const int st = ks & 1;
            if (ks + 1 < nks) fetch(ks + 1, st ^ 1);
            else cp_async_commit();   // an empty group keeps the count
            cp_async_wait1();
            __syncthreads();          // this stage (and w) ready for all
            const float* xs = ring + st * STAGE;
            const float* bs = xs + KS * XS + nh * (NC / 2) + gq;
            const float* ws = dt_s + ks * KS;
#pragma unroll
            for (int kk = 0; kk < KS; kk += 8) {
                const float w0 = ws[kk + tq], w1 = ws[kk + tq + 4];
                uint32_t ahi[MW][4], alo[MW][4];
#pragma unroll
                for (int i = 0; i < MW; ++i) {
                    const float* x0 = xs + (kk + tq) * XS + m0[i] + gq;
                    const float* x1 = x0 + 4 * XS;
                    tf32_split<false>(x0[0] * w0, ahi[i][0], alo[i][0]);
                    tf32_split<false>(x0[8] * w0, ahi[i][1], alo[i][1]);
                    tf32_split<false>(x1[0] * w1, ahi[i][2], alo[i][2]);
                    tf32_split<false>(x1[8] * w1, ahi[i][3], alo[i][3]);
                }
#pragma unroll
                for (int j = 0; j < NW; ++j) {
                    uint32_t bhi[2], blo[2];
                    const float* b0 = bs + (kk + tq) * BS + 8 * j;
                    tf32_split<false>(b0[0], bhi[0], blo[0]);
                    tf32_split<false>(b0[4 * BS], bhi[1], blo[1]);
#pragma unroll
                    for (int i = 0; i < MW; ++i)
                        mma_split<false, false>(acc[i][j], acc[i][j], ahi[i],
                                                alo[i], bhi, blo);
                }
            }
            __syncthreads();          // every warp is done with this stage
        }
        float* out = state + (bc * H + h) * P * N + n0 + nh * (NC / 2) +
                     2 * tq;
#pragma unroll
        for (int i = 0; i < MW; ++i) {
            if (mh * MW + i >= PJ) continue;
#pragma unroll
            for (int j = 0; j < NW; ++j) {
                store2(out + (m0[i] + gq) * N + 8 * j, acc[i][j][0],
                       acc[i][j][1]);
                store2(out + (m0[i] + gq + 8) * N + 8 * j, acc[i][j][2],
                       acc[i][j][3]);
            }
        }
        return;
    }

    // ---- y rows [t0, t0 + rows): query tiles qa and qa + 1, the key
    // stages up to their diagonal. Warp w: rows [32 w, 32 w + 32) of the
    // block, in query tile qa + w / 2 ------------------------------------
    constexpr int XS = P + 4;         // conflict-free for keys 2t, 2t + 1
    constexpr int NT = P / 8;
    constexpr int STAGE = 2 * TT * YS + KS * XS;
    const float* tiles = scores + bc * ssd_pairs(Q) * TILE;
    auto fetch = [&](int ks, int st) {
        float* sd = ring + st * STAGE;
        float* xd = sd + 2 * TT * YS;
        const int kj = ks / 2, kc = (ks & 1) * KS;
        for (int i = tid; i < 2 * TT * (KS / 4); i += HD_THREADS) {
            const int qq = i / (TT * (KS / 4));
            const int r = i / (KS / 4) - qq * TT, c = (i % (KS / 4)) * 4;
            const int q = qa + qq;
            if (q >= T || kj > q) continue;   // no rows of the block use it
            cp_async16(sd + (qq * TT + r) * YS + c,
                       tiles + (q * (q + 1) / 2 + kj) * TILE + r * TT + kc +
                           c,
                       true);
        }
        const int k0 = ks * KS;
        for (int i = tid; i < KS * (P / 4); i += HD_THREADS) {
            const int r = i / (P / 4), c = (i - r * (P / 4)) * 4;
            const bool live = k0 + r < kend;
            cp_async16(xd + r * XS + c,
                       x + (live ? ((bc * Q + k0 + r) * H + h) * P + c : 0),
                       live);
        }
        cp_async_commit();
    };
    fetch(0, 0);                      // one group with cum and dt
    const int rw = 32 * warp;         // the warp's first row in the block
    const int tmax = t0 + rw + 31;    // its last row
    int ta[2], tb[2];
    bool la[2], lb[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
        ta[m] = t0 + rw + 16 * m + gq;
        tb[m] = ta[m] + 8;
        la[m] = ta[m] < Q;
        lb[m] = tb[m] < Q;
    }
    float o[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
            o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.f;
    for (int ks = 0; ks < nks; ++ks) {
        const int st = ks & 1;
        if (ks + 1 < nks) fetch(ks + 1, st ^ 1);
        else cp_async_commit();       // an empty group keeps the count
        cp_async_wait1();
        __syncthreads();              // this stage (and cum, dt) landed
        const int k0 = ks * KS;
        // a warp whose rows all lie before the stage, or past Q, idles
        if (k0 <= tmax && t0 + rw < Q) {
            const float* ss = ring + st * STAGE + (rw % (2 * TT)) * YS;
            const float* xs = ring + st * STAGE + 2 * TT * YS;
            float ca[2], cb[2];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                ca[m] = cum_s[min(ta[m], QT - 1)];
                cb[m] = cum_s[min(tb[m], QT - 1)];
            }
            // on the diagonal, keys past the warp's last row are masked
            const int kmax = min(KS, tmax - k0 + 1);
            for (int kk = 0; kk < kmax; kk += 8) {
                const int sl = kk + 2 * tq, s0 = k0 + sl;
                const float c0 = cum_s[s0], c1 = cum_s[s0 + 1];
                const float d0 = dt_s[s0], d1 = dt_s[s0 + 1];
                uint32_t ahi[2][4], alo[2][4];
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    const float2 va = load2(ss + (16 * m + gq) * YS + sl);
                    const float2 vb = load2(ss + (16 * m + gq + 8) * YS + sl);
                    // mask before exp: a pair with s > t has exp(-inf) = 0
                    // and its score is not used. Selects, not branches
                    const bool m0 = la[m] && s0 <= ta[m];
                    const bool m1 = la[m] && s0 < ta[m];
                    const bool m2 = lb[m] && s0 <= tb[m];
                    const bool m3 = lb[m] && s0 < tb[m];
                    const float e0 = expf(m0 ? ca[m] - c0 : -INFINITY);
                    const float e1 = expf(m1 ? ca[m] - c1 : -INFINITY);
                    const float e2 = expf(m2 ? cb[m] - c0 : -INFINITY);
                    const float e3 = expf(m3 ? cb[m] - c1 : -INFINITY);
                    tf32_split<false>(m0 ? va.x * e0 * d0 : 0.f, ahi[m][0],
                                      alo[m][0]);
                    tf32_split<false>(m2 ? vb.x * e2 * d0 : 0.f, ahi[m][1],
                                      alo[m][1]);
                    tf32_split<false>(m1 ? va.y * e1 * d1 : 0.f, ahi[m][2],
                                      alo[m][2]);
                    tf32_split<false>(m3 ? vb.y * e3 * d1 : 0.f, ahi[m][3],
                                      alo[m][3]);
                }
                const float* x0 = xs + sl * XS + gq;
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    uint32_t bhi[2], blo[2];
                    tf32_split<false>(x0[8 * n], bhi[0], blo[0]);
                    tf32_split<false>(x0[XS + 8 * n], bhi[1], blo[1]);
#pragma unroll
                    for (int m = 0; m < 2; ++m)
                        mma_split<false, false>(o[m][n], o[m][n], ahi[m],
                                                alo[m], bhi, blo);
                }
            }
        }
        __syncthreads();              // every warp is done with this stage
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            if (!(half ? lb[m] : la[m])) continue;
            float* out = y + ((bc * Q + (half ? tb[m] : ta[m])) * H + h) * P +
                         2 * tq;
#pragma unroll
            for (int n = 0; n < NT; ++n)
                store2(out + 8 * n, o[m][n][2 * half], o[m][n][2 * half + 1]);
        }
    }
}

static dim3 score_grid(int BC, int Q, int H) {
    return dim3((H + CUM_HEADS - 1) / CUM_HEADS + 2 * ssd_pairs(Q), BC);
}
static dim3 head_grid(int BC, int Q, int H, int P, int N) {
    return dim3(BC, H, N / ssd_nc(P, N) + (ssd_tiles(Q) + 1) / 2);
}

template <int PJ, int NJ>
static cudaError_t launch(const float* x, const float* dt, const float* a,
                          const float* Bm, const float* Cm, float* y,
                          float* state, float* decay, float* cum,
                          float* scores, int BC, int Q, int H,
                          cudaStream_t stream) {
    constexpr int P = 16 * PJ, N = 16 * NJ;
    cudaError_t e = launch_with_smem(
        ssd_chunk_score_kernel<NJ>, score_grid(BC, Q, H), dim3(SC_THREADS),
        sizeof(float) * (size_t)score_smem_floats(N), stream, dt, a, Bm, Cm,
        scores, decay, cum, Q, H);
    if (e != cudaSuccess) return e;
    return launch_with_smem(
        ssd_chunk_head_kernel<PJ, NJ>, head_grid(BC, Q, H, P, N),
        dim3(HD_THREADS), sizeof(float) * (size_t)head_smem_floats(Q, P, N),
        stream, x, dt, Bm, (const float*)scores, (const float*)cum, y, state,
        Q, H);
}

// registers, dynamic shared memory, local bytes and resident blocks an SM
// of `kern` at `smem` bytes: out[0..3]
template <typename K>
static cudaError_t kernel_attrs(K kern, int threads, size_t smem, int* out) {
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
    return e;
}

// out[0..6]: the score pass's registers, shared memory, local bytes,
// blocks an SM and grid (x, y, z); out[7..13]: the head pass's
template <int PJ, int NJ>
static cudaError_t attrs(int BC, int Q, int H, int* out) {
    constexpr int P = 16 * PJ, N = 16 * NJ;
    cudaError_t e = kernel_attrs(
        ssd_chunk_score_kernel<NJ>, SC_THREADS,
        sizeof(float) * (size_t)score_smem_floats(N), out);
    if (e != cudaSuccess) return e;
    e = kernel_attrs(ssd_chunk_head_kernel<PJ, NJ>, HD_THREADS,
                     sizeof(float) * (size_t)head_smem_floats(Q, P, N),
                     out + 7);
    const dim3 g[2] = {score_grid(BC, Q, H), head_grid(BC, Q, H, P, N)};
    for (int k = 0; k < 2; ++k) {
        out[7 * k + 4] = (int)g[k].x;
        out[7 * k + 5] = (int)g[k].y;
        out[7 * k + 6] = (int)g[k].z;
    }
    return e;
}

// Return FN<PJ, NJ>(...) for head_dim P = 16 PJ and state N = 16 NJ, both
// in {16, 32, 64, 128}; anything else is refused.
#define SSD_BY_N(FN, PJ, ...)                                                \
    (N == 16    ? (int)FN<PJ, 1>(__VA_ARGS__)                                \
     : N == 32  ? (int)FN<PJ, 2>(__VA_ARGS__)                                \
     : N == 64  ? (int)FN<PJ, 4>(__VA_ARGS__)                                \
     : N == 128 ? (int)FN<PJ, 8>(__VA_ARGS__)                                \
                : (int)cudaErrorInvalidValue)
#define SSD_DISPATCH(FN, ...)                                                \
    switch (P) {                                                             \
        case 16: return SSD_BY_N(FN, 1, __VA_ARGS__);                        \
        case 32: return SSD_BY_N(FN, 2, __VA_ARGS__);                        \
        case 64: return SSD_BY_N(FN, 4, __VA_ARGS__);                        \
        case 128: return SSD_BY_N(FN, 8, __VA_ARGS__);                       \
        default: return (int)cudaErrorInvalidValue;                          \
    }

// x (BC, Q, H, P), dt (BC, Q, H), a (H,), B/C (BC, Q, N) -> y (BC, Q, H,
// P), state (BC, H, P, N), decay (BC, H), cum (BC, Q, H); scratch (BC,
// T(T+1)/2, 64, 64), T = ceil(Q/64), holds the score tiles between the two
// launches. BC = batch * chunks. All fp32, contiguous, 16-byte aligned; P
// and N in {16, 32, 64, 128}; 1 <= Q <= 1024. Returns the cudaError_t of
// the launches (0 = both launched).
extern "C" int ssd_chunk_launch(const float* x, const float* dt,
                                const float* a, const float* Bm,
                                const float* Cm, float* y, float* st,
                                float* dc, float* cum, float* scratch, int BC,
                                int Q, int H, int P, int N, void* stream) {
    if (Q < 1 || Q > QMAX) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    SSD_DISPATCH(launch, x, dt, a, Bm, Cm, y, st, dc, cum, scratch, BC, Q, H,
                 s)
}

// The two passes' attributes and grids at these shapes (see attrs).
extern "C" int ssd_chunk_attrs(int BC, int Q, int H, int P, int N,
                               int* out) {
    if (Q < 1 || Q > QMAX) return (int)cudaErrorInvalidValue;
    SSD_DISPATCH(attrs, BC, Q, H, out)
}
