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
// is the bytes over 3.35 TB/s, ~0.15 ms (chip_smoke.py reckons it). Taken
// in three TF32 passes (below) the flops alone would take ~0.22 ms at the
// full TF32 rate, so the products, not the bytes, are what the design has
// to make fast.
//
// What the design does about it. Every product of the pair, head and
// chunk passes runs on the tensor cores, as mma.sync m16n8k8 TF32 with
// each fp32 operand split into hi + lo and three passes (lo.hi' + hi.lo' +
// hi.hi', common.cuh), as K5's forward (ssd_chunk.cu): one TF32 pass
// misses kernels.ssd.bwd_error_bound, whose sums are as long as the
// forward's. Operand rows sit in shared memory padded so that every
// fragment load is free of bank conflicts (4 mod 16 floats where a
// fragment reads rows g and columns t, 8 mod 32 where it reads rows t and
// columns g: B and gstate read row-major as the col operand, an S_bar or
// score tile read transposed), and each operand is split where it is
// read. The pass recomputes the scores from C and B and reads the
// forward's saved cum (it does not keep the forward's score scratch). Five
// launches on the stream, each sum in a fixed order and no float atomics,
// so two launches on the same inputs give the same bits:
// 1. the pair pass (ssd_bwd_pair_kernel), 8 warps per (b*c, lower-triangle
//    pair of 64-row query and key tiles), warp w on rows 16 (w % 4) ..+16
//    and keys 32 (w / 4) .. +32: S = C.B^T of the pair once (written to a
//    scratch tile), then every head in order through a 2-stage cp.async
//    ring of its gy and x rows: G = gy.x^T on the tensor cores, and on G's
//    fragments L (masked before the exp, so an upper-triangle pair is
//    exp(-inf) = 0 and never inf * 0) and M; S_bar summed over the heads in
//    the fragments' registers (written once, a scratch tile), and each
//    head's rowsum(R), colsum(R) and sum_t G S L of the pair (64 values
//    each: quad and octet shuffles, then the warps' shares added in order
//    through shared memory) to a partial scratch;
// 2. the head pass (ssd_bwd_head_kernel), 4 warps per (key tile, head,
//    b*c), warp w on key rows 16 w .. +16 and every column of P: V =
//    B.gstate^T on the tensor cores, gx = w V, and wbar = rowsum(x o V) on
//    V's fragments; then the walk over the query tiles at or below the key
//    tile adds M^T.gy, each M^T element built in the A fragment that reads
//    it from the score tile (masked before the exp), once per block;
// 3. the chunk pass (ssd_bwd_bc_kernel), 8 warps per (64-row tile, b*c, gC
//    or gB), warp w on rows 16 (w % 4) .. +16 and half of N: S_bar.B over
//    the key tiles at or below the tile, or S_bar^T.C over the query tiles
//    at or above it plus the heads' state term (w x).gstate through a
//    2-stage cp.async ring, summed over the heads in order;
// 4. the vector pass (ssd_bwd_vec_kernel), one block per (32 heads, b*c),
//    a lane a head: the partials summed over the pairs in order, gcum',
//    the reverse cumsum (serial, in shared memory, 256 rows at a time),
//    gdt and the chunk's share of ga;
// 5. ssd_bwd_ga_kernel: ga, each head's shares summed over b*c in order.
// A ragged chunk (Q of 1..1024) is masked, not padded: rows past Q are
// zero-filled on load and never written. The tensor cores' fp32
// accumulation does not round to nearest, so each k step's three passes
// are summed there from zero and added in fp32 (mma_split_rn,
// common.cuh): the head pass's walk and the chunk pass's 32 heads are
// long chains.
//
// Resources at mamba2-370m's shape (P 64, N 128; ssd_chunk_bwd_attrs on
// an H100, 0 local bytes at every (P, N) of the three mma passes): pair
// pass 124 registers, 88 KB, two blocks an SM; head pass 128
// registers, 53 KB, four; chunk pass 127 registers, 103 KB, two. The
// vector pass, unchanged, reports 8 local bytes.
//
// What bounds it now (chip_smoke.py's pass times, PERF.md): the head and
// pair passes, each block re-reading from L2 tiles that other blocks
// read too (the head-shared B rows and score tiles once a head, gstate
// once a key tile, gy once a key tile at or below it: ~1.3 GB a call at
// mamba2's train shape, reckoned from the tile sizes), then the serial
// vector pass. Blocks that walk
// several heads or key tiles, so that each tile read feeds more
// products, and a warp scan for the vector pass are the follow-ups
// (ROADMAP).

#include "common.cuh"

constexpr int BT = 64;                // rows of a query or key tile
constexpr int BTILE = BT * BT;        // floats of a packed tile
constexpr int BW = 256;               // pair, chunk and vector passes
constexpr int HW = 128;               // head pass: 4 warps
constexpr int BQMAX = 1024;           // longest chunk
constexpr int NK = 64;                // state columns a head-pass stage
                                      // (all N up to 64)
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

// floats of dynamic shared memory of each pass
__host__ __device__ constexpr int pair_stage_floats(int P) {
    return 2 * BT * (P + 4) + 3 * BT;
}
__host__ __device__ constexpr int pair_smem_floats(int P, int N) {
    const int sc = 2 * BT * (N + 4);
    const int st = 2 * pair_stage_floats(P);
    return (sc > st ? sc : st) + 10 * BT + 8 * 16 * 32;
}
__host__ __device__ constexpr int head_smem_floats_bwd(int P, int N) {
    const int nks = N < NK ? N : NK;
    const int a = BT * (nks + 4) + P * (nks + 4) + BT * (P + 8);
    const int b = BT * (BT + 8) + BT * (P + 8);
    return 4 * BT + (a > b ? a : b);
}
__host__ __device__ constexpr int bc_stage_floats(int P, int N) {
    return BT * (P + 4) + P * (N + 8) + 2 * BT;
}
__host__ __device__ constexpr int bc_smem_floats(int P, int N) {
    const int a = BT * (BT + 8) + BT * (N + 8);
    const int b = 2 * bc_stage_floats(P, N);
    return a > b ? a : b;
}
constexpr int VEC_SMEM_FLOATS = 2 * VROWS * 32 + 2 * 8 * 32;

// ---------------------------------------------------------------------
// 1. Pair pass: grid (pairs, b*c). Rows t of query tile qi, keys s of key
// tile kj <= qi.
template <int PJ, int NJ>
__global__ void __launch_bounds__(BW, 2)
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
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int rw = warp & 3, cw = warp >> 2;  // rows 16 rw, keys 32 cw
    const int ra = 16 * rw + gq, rb = ra + 8;  // this lane's rows
    extern __shared__ __align__(16) float smem[];
    const int sc_floats = 2 * BT * NS, st_floats = 2 * STAGE;
    float* rowred = smem + (sc_floats > st_floats ? sc_floats : st_floats);
    float* colred = rowred + 2 * BT;  // (4, 64): colsum(R) of each warp row
    float* gdlred = colred + 4 * BT;  // (4, 64): sum_t G S L likewise
    // S in each warp's fragment layout, a lane a word: read once a head,
    // it keeps 16 registers a thread free
    float* scs = gdlred + 4 * BT + warp * 16 * 32 + lane;

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
    // sc[n][e]: row (e < 2 ? ra : rb), key 32 cw + 8n + 2tq + (e & 1)
    float sc[4][4];
    frag_zero(sc);
    mma_abt<N, 4, NS>(sc, smem + 16 * rw * NS, smem + BT * NS + 32 * cw * NS,
                      gq, tq);
    const int64_t tile = bc * npairs + p;
    float* so = scores + tile * BTILE + 32 * cw + 2 * tq;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
        store2(so + ra * BT + 8 * n, sc[n][0], sc[n][1]);
        store2(so + rb * BT + 8 * n, sc[n][2], sc[n][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) scs[(n * 4 + e) * 32] = sc[n][e];
    }
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
    frag_zero(sb);
    const bool la = t0 + ra < Q, lb = t0 + rb < Q;
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
        frag_zero(G);
        mma_abt<P, 4, PS>(G, g + 16 * rw * PS, xx + 32 * cw * PS, gq, tq);
        const float cra = ct[ra], crb = ct[rb];
        float rowa = 0.f, rowb = 0.f, colp[4][2], gdl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int c = 32 * cw + 8 * n + 2 * tq + j;
                const float csc = cs[c], d = ds[c];
                // mask before exp: a pair with s > t (or a row past Q) is
                // exp(-inf) = 0. Selects, not branches
                const bool ma = la && s0 + c <= t0 + ra;
                const bool mb = lb && s0 + c <= t0 + rb;
                const float qa = G[n][j] * expf(ma ? cra - csc : -INFINITY);
                const float qb =
                    G[n][2 + j] * expf(mb ? crb - csc : -INFINITY);
                sb[n][j] = fmaf(qa, d, sb[n][j]);
                sb[n][2 + j] = fmaf(qb, d, sb[n][2 + j]);
                const float ua = qa * scs[(n * 4 + j) * 32];
                const float ub = qb * scs[(n * 4 + 2 + j) * 32];
                gdl[n][j] = ua + ub;
                const float Ra = ua * d, Rb = ub * d;
                rowa += Ra;
                rowb += Rb;
                colp[n][j] = Ra + Rb;
            }
        }
        // rowsum(R): a row's 32 keys of this warp lie in its quad's lanes
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
            rowa += __shfl_xor_sync(FULL_MASK, rowa, o);
            rowb += __shfl_xor_sync(FULL_MASK, rowb, o);
        }
        if (tq == 0) {
            rowred[cw * BT + ra] = rowa;
            rowred[cw * BT + rb] = rowb;
        }
        // colsum(R) and sum_t G S L: a key's 16 rows of this warp lie in
        // the 8 lanes of its column group
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                float v = colp[n][j], u = gdl[n][j];
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                    v += __shfl_xor_sync(FULL_MASK, v, o);
                    u += __shfl_xor_sync(FULL_MASK, u, o);
                }
                if (gq == 0) {
                    const int c = 32 * cw + 8 * n + 2 * tq + j;
                    colred[rw * BT + c] = v;
                    gdlred[rw * BT + c] = u;
                }
            }
        }
        __syncthreads();              // the warps' shares are in
        // the warps' shares in order. The next head's first barrier keeps
        // these reads ahead of the next writes
        float* out = part + tile * 3 * H * BT + (int64_t)h * BT;
        if (tid < BT) {
            out[tid] = rowred[tid] + rowred[BT + tid];
        } else if (tid < 3 * BT) {
            const int k = tid / BT, c = tid - k * BT;
            const float* r = (k == 1 ? colred : gdlred) + c;
            out[(int64_t)k * H * BT + c] =
                ((r[0] + r[BT]) + r[2 * BT]) + r[3 * BT];
        }
    }
    float* sbo = sbar + tile * BTILE + 32 * cw + 2 * tq;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
        store2(sbo + ra * BT + 8 * n, sb[n][0], sb[n][1]);
        store2(sbo + rb * BT + 8 * n, sb[n][2], sb[n][3]);
    }
    cp_async_wait<0>();
}

// ---------------------------------------------------------------------
// 2. Head pass: grid (key tiles, H, b*c). gx and wbar of the key tile's
// 64 rows for one head.
template <int PJ, int NJ>
__global__ void __launch_bounds__(HW, PJ > 4 ? 2 : 4)
ssd_bwd_head_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Bm,
                    const float* __restrict__ cum,
                    const float* __restrict__ gy,
                    const float* __restrict__ gstate,
                    const float* __restrict__ scores, float* __restrict__ gx,
                    float* __restrict__ wbar, int Q, int H) {
    constexpr int P = 16 * PJ, N = 16 * NJ, XS = P + 8, SS = BT + 8;
    constexpr int NKS = N < NK ? N : NK, KS = NKS + 4;  // a stage's columns
    constexpr int NT = P / 8;         // 8-column n tiles of gx
    const int j0 = blockIdx.x, h = blockIdx.y;
    const int64_t bc = blockIdx.z;
    const int T = bwd_tiles(Q), npairs = bwd_pairs(Q), s0 = j0 * BT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int ra = 16 * warp + gq, rb = ra + 8;  // this lane's key rows
    extern __shared__ __align__(16) float smem[];
    float* cs = smem;                 // cum of the key rows
    float* ds = cs + BT;              // dt of the key rows
    float* ws = ds + BT;              // w of the key rows
    float* ct = ws + BT;              // cum of a query tile's rows
    float* area = ct + BT;

    // ---- V = B_s . gstate^T over N in stages of NKS columns
    float* bs = area;                 // (64, KS)
    float* gs = bs + BT * KS;         // (P, KS)
    float* xs = gs + P * KS;          // (64, XS)
    const float* gst = gstate + (bc * H + h) * P * N;
    for (int i = tid; i < BT * (P / 4); i += HW) {
        const int r = i / (P / 4), c = (i - r * (P / 4)) * 4;
        const bool live = s0 + r < Q;
        cp_async16(xs + r * XS + c,
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
    // V[i][e]: key row (e < 2 ? ra : rb), column 8i + 2tq + (e & 1)
    float V[NT][4];
    frag_zero(V);
    for (int n0 = 0; n0 < N; n0 += NKS) {
        for (int i = tid; i < BT * (NKS / 4); i += HW) {
            const int r = i / (NKS / 4), c = (i - r * (NKS / 4)) * 4;
            const bool live = s0 + r < Q;
            cp_async16(bs + r * KS + c,
                       Bm + (live ? (bc * Q + s0 + r) * N + n0 + c : 0), live);
        }
        for (int i = tid; i < P * (NKS / 4); i += HW) {
            const int r = i / (NKS / 4), c = (i - r * (NKS / 4)) * 4;
            cp_async16(gs + r * KS + c, gst + r * N + n0 + c, true);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        mma_abt<NKS, NT, KS>(V, bs + 16 * warp * KS, gs, gq, tq);
        __syncthreads();              // the stage is refilled next
    }
    const float total = cum[(bc * Q + Q - 1) * H + h];
    if (tid < BT)
        ws[tid] = s0 + tid < Q ? expf(total - cs[tid]) * ds[tid] : 0.f;
    __syncthreads();
    // wbar = rowsum(x o V) on V's fragments; then gx starts at w V
    float wa = 0.f, wb = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
        const float2 xa = load2(xs + ra * XS + 8 * i + 2 * tq);
        const float2 xb = load2(xs + rb * XS + 8 * i + 2 * tq);
        wa = fmaf(xa.y, V[i][1], fmaf(xa.x, V[i][0], wa));
        wb = fmaf(xb.y, V[i][3], fmaf(xb.x, V[i][2], wb));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        wa += __shfl_xor_sync(FULL_MASK, wa, o);
        wb += __shfl_xor_sync(FULL_MASK, wb, o);
    }
    if (tq == 0 && s0 + ra < Q) wbar[(bc * Q + s0 + ra) * H + h] = wa;
    if (tq == 0 && s0 + rb < Q) wbar[(bc * Q + s0 + rb) * H + h] = wb;
    const float wsa = ws[ra], wsb = ws[rb];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
        V[i][0] *= wsa;
        V[i][1] *= wsa;
        V[i][2] *= wsb;
        V[i][3] *= wsb;
    }
    const float csa = cs[ra], csb = cs[rb], dsa = ds[ra], dsb = ds[rb];
    __syncthreads();                  // the V stage gives way to the walk

    // ---- gx += M^T . gy over the query tiles at or below the key tile
    float* stl = area;                // (64 queries, SS): a score tile
    float* gys = stl + BT * SS;       // (64, XS)
    for (int qi = j0; qi < T; ++qi) {
        const int t0 = qi * BT;
        const float* stile =
            scores + (bc * npairs + pair_index(qi, j0)) * BTILE;
        for (int i = tid; i < BT * (BT / 4); i += HW) {
            const int r = i / (BT / 4), c = (i - r * (BT / 4)) * 4;
            cp_async16(stl + r * SS + c, stile + r * BT + c, true);
        }
        for (int i = tid; i < BT * (P / 4); i += HW) {
            const int r = i / (P / 4), c = (i - r * (P / 4)) * 4;
            const bool live = t0 + r < Q;
            cp_async16(gys + r * XS + c,
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
#pragma unroll 2
        for (int kk = 0; kk < BT; kk += 8) {
            // the A fragment of M^T: key rows ra, rb; queries kk + tq and
            // kk + tq + 4. Mask before exp: s > t (or t past Q) is
            // exp(-inf) = 0. Selects, not branches
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int r = u & 1 ? rb : ra, tl = kk + tq + (u >> 1) * 4;
                const float cr = u & 1 ? csb : csa, dr = u & 1 ? dsb : dsa;
                const bool live = t0 + tl < Q && s0 + r <= t0 + tl;
                const float e = expf(live ? ct[tl] - cr : -INFINITY);
                tf32_split<false>(live ? stl[tl * SS + r] * e * dr : 0.f,
                                  ahi[u], alo[u]);
            }
#pragma unroll
            for (int i = 0; i < NT; ++i) {
                const float* b0 = gys + (kk + tq) * XS + 8 * i + gq;
                uint32_t bhi[2], blo[2];
                tf32_split<false>(b0[0], bhi[0], blo[0]);
                tf32_split<false>(b0[4 * XS], bhi[1], blo[1]);
                mma_split_rn(V[i], ahi, alo, bhi, blo);
            }
        }
        __syncthreads();              // the tiles are refilled next
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        if (s0 + r >= Q) continue;
        float* dst = gx + ((bc * Q + s0 + r) * H + h) * P + 2 * tq;
#pragma unroll
        for (int i = 0; i < NT; ++i)
            store2(dst + 8 * i, V[i][2 * half], V[i][2 * half + 1]);
    }
}

// ---------------------------------------------------------------------
// 3. Chunk pass: grid (tiles, b*c, 2). z 0: gC of the tile's rows; z 1: gB.
template <int PJ, int NJ>
__global__ void __launch_bounds__(BW, 2)
ssd_bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ cum,
                  const float* __restrict__ gstate,
                  const float* __restrict__ sbar, float* __restrict__ gB,
                  float* __restrict__ gC, int Q, int H) {
    constexpr int P = 16 * PJ, N = 16 * NJ, PS = P + 4, OS = N + 8;
    constexpr int NC = N / 2;         // columns of N a warp
    constexpr int NT = NC / 8;        // their 8-column n tiles
    constexpr int STAGE = bc_stage_floats(P, N);
    const int k0 = blockIdx.x, is_b = blockIdx.z;
    const int64_t bc = blockIdx.y;
    const int T = bwd_tiles(Q), npairs = bwd_pairs(Q), r0 = k0 * BT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int rw = warp & 3, cw = warp >> 2;  // rows 16 rw, columns NC cw
    const int ra = 16 * rw + gq, rb = ra + 8;  // this lane's rows
    extern __shared__ __align__(16) float smem[];
    // acc[n][e]: row (e < 2 ? ra : rb), column NC cw + 8n + 2tq + (e & 1)
    float acc[NT][4];
    frag_zero(acc);

    // S_bar products: gC_t = sum_{s-tiles <= k0} S_bar[t][s] B_s, or
    // gB_s = sum_{t-tiles >= k0} S_bar[t][s] C_t. The A operand is S_bar
    // (rows t, k = s) for gC, its transpose for gB, each tile held at the
    // stride its fragment loads need free of bank conflicts
    const int SS = is_b ? BT + 8 : BT + 4;
    const int ar = is_b ? 1 : SS, ak = is_b ? SS : 1;
    float* ss = smem;                 // (64, SS): an S_bar tile
    float* os = ss + BT * (BT + 8);   // (64, OS): B or C rows
    const int first = is_b ? k0 : 0, last = is_b ? T - 1 : k0;
    for (int m = first; m <= last; ++m) {
        const int pidx = is_b ? pair_index(m, k0) : pair_index(k0, m);
        const float* stile = sbar + (bc * npairs + pidx) * BTILE;
        for (int i = tid; i < BT * (BT / 4); i += BW) {
            const int r = i / (BT / 4), c = (i - r * (BT / 4)) * 4;
            cp_async16(ss + r * SS + c, stile + r * BT + c, true);
        }
        const float* src = is_b ? Cm : Bm;
        const int o0 = m * BT;
        for (int i = tid; i < BT * (N / 4); i += BW) {
            const int r = i / (N / 4), c = (i - r * (N / 4)) * 4;
            const bool live = o0 + r < Q;
            cp_async16(os + r * OS + c,
                       src + (live ? (bc * Q + o0 + r) * N + c : 0), live);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll 2
        for (int kk = 0; kk < BT; kk += 8) {
            const float* a0 = ss + ra * ar + (kk + tq) * ak;
            uint32_t ahi[4], alo[4];
            tf32_split<false>(a0[0], ahi[0], alo[0]);
            tf32_split<false>(a0[8 * ar], ahi[1], alo[1]);
            tf32_split<false>(a0[4 * ak], ahi[2], alo[2]);
            tf32_split<false>(a0[8 * ar + 4 * ak], ahi[3], alo[3]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float* b0 = os + (kk + tq) * OS + NC * cw + 8 * n + gq;
                uint32_t bhi[2], blo[2];
                tf32_split<false>(b0[0], bhi[0], blo[0]);
                tf32_split<false>(b0[4 * OS], bhi[1], blo[1]);
                mma_split_rn(acc[n], ahi, alo, bhi, blo);
            }
        }
        __syncthreads();              // the tiles are refilled next
    }

    if (is_b) {
        // the state term: sum_h (w_s x_s) . gstate_h, the heads in order
        // through a 2-stage ring
        auto fetch = [&](int h, int st) {
            float* xs = smem + st * STAGE;    // (64, PS): x rows
            float* gs = xs + BT * PS;         // (P, OS): gstate
            float* cs = gs + P * OS;          // cum of the tile's rows
            float* dts = cs + BT;             // their dt
            const float* gst = gstate + (bc * H + h) * P * N;
            for (int i = tid; i < BT * (P / 4); i += BW) {
                const int r = i / (P / 4), c = (i - r * (P / 4)) * 4;
                const bool live = r0 + r < Q;
                const int64_t o = ((bc * Q + r0 + r) * H + h) * P + c;
                cp_async16(xs + r * PS + c, x + (live ? o : 0), live);
            }
            for (int i = tid; i < P * (N / 4); i += BW) {
                const int r = i / (N / 4), c = (i - r * (N / 4)) * 4;
                cp_async16(gs + r * OS + c, gst + r * N + c, true);
            }
            if (tid < BT) {
                const bool live = r0 + tid < Q;
                const int64_t o = (bc * Q + r0 + tid) * H + h;
                cp_async4(cs + tid, cum + (live ? o : 0), live);
                cp_async4(dts + tid, dt + (live ? o : 0), live);
            }
            cp_async_commit();
        };
        const bool la = r0 + ra < Q, lb = r0 + rb < Q;
        fetch(0, 0);
        for (int h = 0; h < H; ++h) {
            const int st = h & 1;
            if (h + 1 < H) fetch(h + 1, st ^ 1);
            else cp_async_commit();   // an empty group keeps the count
            cp_async_wait1();
            __syncthreads();          // this head's rows landed for all
            const float* xs = smem + st * STAGE;
            const float* gs = xs + BT * PS;
            const float* cs = gs + P * OS;
            const float* dts = cs + BT;
            const float total = cum[(bc * Q + Q - 1) * H + h];
            const float wa = la ? expf(total - cs[ra]) * dts[ra] : 0.f;
            const float wb = lb ? expf(total - cs[rb]) * dts[rb] : 0.f;
#pragma unroll 2
            for (int kk = 0; kk < P; kk += 8) {
                const float* a0 = xs + ra * PS + kk + tq;
                uint32_t ahi[4], alo[4];
                tf32_split<false>(a0[0] * wa, ahi[0], alo[0]);
                tf32_split<false>(a0[8 * PS] * wb, ahi[1], alo[1]);
                tf32_split<false>(a0[4] * wa, ahi[2], alo[2]);
                tf32_split<false>(a0[8 * PS + 4] * wb, ahi[3], alo[3]);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    const float* b0 =
                        gs + (kk + tq) * OS + NC * cw + 8 * n + gq;
                    uint32_t bhi[2], blo[2];
                    tf32_split<false>(b0[0], bhi[0], blo[0]);
                    tf32_split<false>(b0[4 * OS], bhi[1], blo[1]);
                    mma_split_rn(acc[n], ahi, alo, bhi, blo);
                }
            }
            __syncthreads();          // the stage is refilled next
        }
    }
    float* out = is_b ? gB : gC;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        if (r0 + r >= Q) continue;
        float* dst = out + (bc * Q + r0 + r) * N + NC * cw + 2 * tq;
#pragma unroll
        for (int n = 0; n < NT; ++n)
            store2(dst + 8 * n, acc[n][2 * half], acc[n][2 * half + 1]);
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
    e = launch_with_smem(ssd_bwd_head_kernel<PJ, NJ>, g.head, dim3(HW),
                         sizeof(float) * (size_t)head_smem_floats_bwd(P, N),
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
    e = kern_attrs(ssd_bwd_head_kernel<PJ, NJ>, HW,
                   sizeof(float) * (size_t)head_smem_floats_bwd(P, N), g.head,
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
