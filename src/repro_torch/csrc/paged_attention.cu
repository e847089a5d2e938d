// Paged GQA decode attention for Hopper (sm_90a): ONE query token per
// sequence, K/V gathered through a per-sequence block table over a shared
// (P, page_size, Hkv, D) page pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_decode_attention, the pl.pallas_call at line 111).
//
// What bounds it on this card: bytes, and at decode batch sizes the latency
// of getting them. Each (sequence, kv head) reads its live K and V once,
// valid_len * D * 2 tensors * 2 B in bf16, and does about G flops per byte
// it reads (3 at smollm-135m's widths) -- far under the ~295 flop/byte the
// H100 needs before its tensor cores, not HBM, are the limit. The least
// time is the live KV bytes (sum over b of valid_len[b] * Hkv * D * 2 * 2
// B) over 3.35 TB/s, about a microsecond at the main path's tick, so what
// the card takes beyond it is latency: the page-id load before each K/V
// load, and how many blocks are in flight.
//
// What the design does about it (decode_walk.cuh, shared with K3, whose
// note gives the details): the Pallas grid's sequential page axis (m/l/acc
// carried in VMEM across grid steps) becomes a walk inside a block, and a
// row's walk is split across blocks (flash-decoding) where the grid of
// sequences x kv heads is short of two blocks an SM: the main path's
// phone island decodes one sequence on 3 kv heads, 3 blocks without the
// split. A block copies a tile's page ids (four 16-token pages a 64-token
// tile at page size 16) with one warp, in the cp.async group of an earlier
// tile, so they wait in shared memory before the tile's own copies are
// issued; those fly in a 4-stage cp.async ring at D 64 (3 stages of 64
// bf16 keys at D 128 and 256: paligemma-3b's 8 query heads of 256 on one
// kv head are 8 rows of one tile, glm4-9b's 16 a full tile, musicgen's 1
// a tile of one live row). All G query heads of a kv head are one
// tensor-core tile, so each live K/V byte is read once.
// Table entries past valid_len (the scratch page) are never read.

#include "decode_walk.cuh"

template <typename TQ, typename TKV, int DPL>
static cudaError_t launch(const void* q, const void* kp, const void* vp,
                          const void* bt, const void* valid, void* out,
                          void* part_o, void* part_ml, int n_split, int B,
                          int H, int Hkv, int ps, int N, float scale,
                          cudaStream_t stream) {
    const PagedRows rows{(const int32_t*)bt, N, ps, (int64_t)Hkv * 32 * DPL};
    return launch_decode_walk<TQ, TKV, DPL>(q, kp, vp, rows, valid, out,
                                            part_o, part_ml, n_split, B, H,
                                            Hkv, N * ps, scale, stream);
}

template <typename TQ, typename TKV, int DPL>
static cudaError_t attrs(int B, int H, int Hkv, int* out) {
    return decode_walk_attrs<TQ, TKV, DPL, PagedRows>(B, H, Hkv, out);
}

// q (B, H, D); k/v pages (P, ps, Hkv, D); block_table (B, N) int32;
// valid_lens (B,) int32; out (B, H, D) in q's dtype. All contiguous and
// 16-byte aligned, D in {32, 64, 128, 256}. With n_split > 1, part_o (n_split,
// B, H, D) and part_ml (n_split, B, H, 2) are fp32 scratch. Returns the
// cudaError_t of the launches (0 = launched).
extern "C" int paged_decode_attention_launch(
        const void* q, const void* k_pages, const void* v_pages,
        const void* block_table, const void* valid_lens, void* out,
        void* part_o, void* part_ml, int n_split, int B, int H, int Hkv,
        int D, int ps, int N, float scale, int q_dtype, int kv_dtype,
        void* stream) {
    REPRO_DISPATCH_WIDE(launch, q_dtype, kv_dtype, D, q, k_pages, v_pages,
                   block_table, valid_lens, out, part_o, part_ml, n_split, B,
                   H, Hkv, ps, N, scale, (cudaStream_t)stream);
}

// The walk's registers, shared memory, local bytes, blocks an SM, key tile
// and blocks of one key range at (B, H, Hkv) (decode_walk_attrs).
extern "C" int paged_decode_attention_attrs(int q_dtype, int kv_dtype,
                                            int D, int B, int H, int Hkv,
                                            int* out) {
    REPRO_DISPATCH_WIDE(attrs, q_dtype, kv_dtype, D, B, H, Hkv, out);
}
