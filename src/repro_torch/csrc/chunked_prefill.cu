// Chunked-prefill GQA attention for Hopper (sm_90a): T fresh prompt tokens
// per row (token t at absolute position start_pos[b] + t) attend causally
// over all context gathered through a per-row block table over a shared
// (P, page_size, Hkv, D) page pool that already holds the chunk's own K/V.
//
// Replaces the TPU kernel src/repro/kernels/chunked_prefill.py
// (chunked_prefill_attention, the pl.pallas_call at line 123).
//
// What bounds it on this card: bytes. At the chunk lengths the serving
// tick uses (T <= 64 tokens) it reads each attended K/V byte for about
// G * T / 2 flops, under 100 -- below the ~295 flop/byte ridge of bf16
// tensor cores. The least time is the q, output and attended K/V bytes
// (each row's start + T context tokens * Hkv * D * 2 tensors * 2 B) over
// 3.35 TB/s. Two things stand between the walk and that bound: its 4 * H
// * D flops per (query token, attended key) are too many for fp32 CUDA
// cores (67 TFLOP/s) to keep up with the bytes, and a tick's few rows
// give far fewer blocks than the card has SMs, each walking one row's
// whole context in series (a 1,088-key row is 34 tiles of 32 keys).
//
// What the design does about it: the Pallas grid's sequential page axis
// (m/l/acc carried in VMEM across grid steps) becomes the walk shared with
// K4 in prefill_walk.cuh (whose note gives the details). Both products run
// on mma.sync TF32 tensor cores: fp32 q is split into two TF32 halves and
// bf16 pages are exact in TF32, so each product takes two passes (~247
// TFLOP/s effective), accurate to fp32's ~1e-7. A block of 64 query rows
// (21 tokens x smollm's 3 query heads of a kv head) gathers 64-key tiles
// (four 16-row pages, one table lookup a key row) through a two-stage
// cp.async ring; pages strictly in the tile's future are never read. At
// paligemma-3b's heads (8 of 256 on one kv head) a block is 8 tokens x 8
// heads, with 32-key tiles: its fp32 q block (66 KB) and the bf16 ring
// (66 KB) take 132 KB of shared memory, one block an SM. Where
// B x Hkv x q tiles leave the card short of blocks (a tick's 4 rows of 64
// tokens give 48), the wrapper splits each walk into n_split ranges of
// whole key tiles, and a merge kernel combines them in split order, so
// the longest row's context is walked by several blocks at once, and two
// launches give the same bits. TMA for paged tiles and warp
// specialisation are later work.

#include "prefill_walk.cuh"

template <typename TQ, typename TKV, int DPL>
static cudaError_t launch(const void* q, const void* kp, const void* vp,
                          const void* bt, const void* start, void* out,
                          void* part_o, void* part_ml, int n_split, int B,
                          int T, int H, int Hkv, int ps, int N, float scale,
                          cudaStream_t stream) {
    const PagedRows rows{(const int32_t*)bt, N, ps, (int64_t)Hkv * 32 * DPL};
    return launch_prefill_walk<TQ, TKV, DPL, PagedRows, true, false>(
        q, kp, vp, rows, start, out, part_o, part_ml, n_split, B, T, H, Hkv,
        N * ps, 0, 0, scale, stream);
}

template <typename TQ, typename TKV, int DPL>
static cudaError_t attrs(int* out) {
    return prefill_walk_attrs<TQ, TKV, DPL, PagedRows, true, false>(out);
}

// q (B, T, H, D); k/v pages (P, ps, Hkv, D); block_table (B, N) int32;
// start_pos (B,) int32; out (B, T, H, D) in q's dtype. All contiguous and
// 16-byte aligned, D in {32, 64, 128, 256}. n_split >= 1 key ranges; with more
// than one, part_o (n_split, B, T, H, D) and part_ml (n_split, B, T, H, 2)
// fp32 scratch. Returns the cudaError_t of the launches (0 = launched).
extern "C" int chunked_prefill_attention_launch(
        const void* q, const void* k_pages, const void* v_pages,
        const void* block_table, const void* start_pos, void* out,
        void* part_o, void* part_ml, int n_split, int B, int T, int H,
        int Hkv, int D, int ps, int N, float scale, int q_dtype,
        int kv_dtype, void* stream) {
    REPRO_DISPATCH_WIDE(launch, q_dtype, kv_dtype, D, q, k_pages, v_pages,
                   block_table, start_pos, out, part_o, part_ml, n_split, B,
                   T, H, Hkv, ps, N, scale, (cudaStream_t)stream);
}

// The walk instantiation's registers, dynamic shared memory bytes, local
// bytes, resident blocks an SM and key tile, into out[0..4].
extern "C" int chunked_prefill_attention_attrs(int q_dtype, int kv_dtype,
                                               int D, int* out) {
    REPRO_DISPATCH_WIDE(attrs, q_dtype, kv_dtype, D, out);
}
