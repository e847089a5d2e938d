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
// 3.35 TB/s. This version does its math in fp32 on CUDA cores (67
// TFLOP/s), where its 4 * H * D flops per (query token, attended key)
// take longer than those bytes: a ceiling of this design, not of the
// function, which tensor-core tiles remove.
//
// What this simple design does about it: the Pallas grid's sequential page
// axis (m/l/acc carried in VMEM across grid steps) becomes a loop inside
// one block per (row, kv head, 16-token q tile), shared with K4 in
// prefill_walk.cuh (whose note gives the details): 32-key tiles staged in
// shared memory serve every query head and token of the tile, the next
// tile's loads fly while the current one is computed, and pages strictly
// in the tile's future are never read. wgmma, TMA and a deeper tile ring
// are later work.

#include "prefill_walk.cuh"

template <typename TQ, typename TKV, int DPL>
static cudaError_t launch(const void* q, const void* kp, const void* vp,
                          const void* bt, const void* start, void* out, int B,
                          int T, int H, int Hkv, int ps, int N, float scale,
                          cudaStream_t stream) {
    const PagedRows rows{(const int32_t*)bt, N, ps, (int64_t)Hkv * 32 * DPL};
    return launch_prefill_walk<TQ, TKV, DPL, PagedRows, true, false>(
        q, kp, vp, rows, start, out, B, T, H, Hkv, N * ps, 0, scale, stream);
}

// q (B, T, H, D); k/v pages (P, ps, Hkv, D); block_table (B, N) int32;
// start_pos (B,) int32; out (B, T, H, D) in q's dtype. All contiguous and
// 16-byte aligned, D in {32, 64, 128}. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int chunked_prefill_attention_launch(
        const void* q, const void* k_pages, const void* v_pages,
        const void* block_table, const void* start_pos, void* out, int B,
        int T, int H, int Hkv, int D, int ps, int N, float scale,
        int q_dtype, int kv_dtype, void* stream) {
    REPRO_DISPATCH(launch, q_dtype, kv_dtype, D, q, k_pages, v_pages,
                   block_table, start_pos, out, B, T, H, Hkv, ps, N, scale,
                   (cudaStream_t)stream);
}
