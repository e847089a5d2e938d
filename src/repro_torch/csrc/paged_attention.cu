// Paged GQA decode attention for Hopper (sm_90a): ONE query token per
// sequence, K/V gathered through a per-sequence block table over a shared
// (P, page_size, Hkv, D) page pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_decode_attention, the pl.pallas_call at line 111).
//
// What bounds it on this card: bytes. Each (sequence, kv head) reads its
// live K and V once, valid_len * D * 2 tensors * 2 B in bf16, and does
// about G flops per byte it reads (3 at smollm-135m's widths) -- far under
// the ~295 flop/byte the H100 needs before its tensor cores, not HBM, are
// the limit. The least time is the live KV bytes (sum over b of
// valid_len[b] * Hkv * D * 2 * 2 B) over 3.35 TB/s.
//
// What this simple design does about it: the Pallas grid's sequential page
// axis (which carried m/l/acc in VMEM across grid steps) becomes a walk
// inside one block per (sequence, kv head), shared with K3 in
// decode_walk.cuh (whose note gives the details): 8 warps walk 32-token
// tiles with private online softmaxes and merge in shared memory; each
// live K/V byte is read from HBM once and serves all G query heads;
// nothing past valid_len is read. It does not yet split a sequence across
// blocks (flash-decoding), so at small decode batches only B * Hkv SMs
// are busy; that, TMA and wgmma are later work.

#include "decode_walk.cuh"

template <typename TQ, typename TKV, int DPL>
static cudaError_t launch(const void* q, const void* kp, const void* vp,
                          const void* bt, const void* valid, void* out, int B,
                          int H, int Hkv, int ps, int N, float scale,
                          cudaStream_t stream) {
    const PagedRows rows{(const int32_t*)bt, N, ps, (int64_t)Hkv * 32 * DPL};
    return launch_decode_walk<TQ, TKV, DPL>(q, kp, vp, rows, valid, out, B,
                                            H, Hkv, N * ps, scale, stream);
}

// q (B, H, D); k/v pages (P, ps, Hkv, D); block_table (B, N) int32;
// valid_lens (B,) int32; out (B, H, D) in q's dtype. All contiguous and
// 16-byte aligned, D in {32, 64, 128}. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int paged_decode_attention_launch(
        const void* q, const void* k_pages, const void* v_pages,
        const void* block_table, const void* valid_lens, void* out, int B,
        int H, int Hkv, int D, int ps, int N, float scale, int q_dtype,
        int kv_dtype, void* stream) {
    REPRO_DISPATCH(launch, q_dtype, kv_dtype, D, q, k_pages, v_pages,
                   block_table, valid_lens, out, B, H, Hkv, ps, N, scale,
                   (cudaStream_t)stream);
}
