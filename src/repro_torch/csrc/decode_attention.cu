// Dense-cache GQA decode attention for Hopper (sm_90a): ONE query token per
// row against that row's (S, Hkv, D) slice of a (B, S, Hkv, D) K/V cache,
// of which the first valid_len[b] slots are filled.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, the pl.pallas_call at line 95). The Pallas kernel
// takes one scalar fill; the stacked batcher runs it under jax.vmap over
// its slots, which gives each row its own fill, so this kernel takes a
// (B,) fill vector (the wrapper broadcasts a scalar).
//
// What bounds it on this card: bytes, and at decode batch sizes the latency
// of getting them. A row reads its filled K and V once, valid_len * D * 2
// tensors * 2 B in bf16, for about G flops a byte (3 at smollm-135m's
// widths, 4 at qwen3-4b's, 16 at recurrentgemma-9b's) -- far under the
// ~295 flop/byte ridge of the bf16 tensor cores. The least time is the
// filled KV bytes (sum over b of valid_len[b] * Hkv * D * 2 * 2 B) over
// 3.35 TB/s, about a microsecond at these batches, so what the card takes
// beyond it is how few tiles are in flight and the math a tile waits on.
//
// What the design does about it (decode_walk.cuh, shared with K1, whose
// note gives the details): the Pallas grid's sequential cache-block axis
// (m/l/acc carried in VMEM, blocks past the fill predicated off) becomes a
// walk inside a block, split across blocks (flash-decoding) where rows x
// kv heads give the card under two blocks an SM: recurrentgemma-9b's 8
// slots on one kv head are 8 blocks without the split. Its 16 query heads
// of 256 on that kv head are the 16 rows of one tensor-core tile, so each
// K/V tile is read once for all of them, and both products run on TF32
// tensor cores with fp32 operands split in two. A windowed ring-buffer
// cache (recurrentgemma's local attention) is read the same way: the model
// passes min(pos + 1, W) as the fill, and attention does not depend on the
// order of the slots. Slots at or past valid_len[b] are never read, so
// decode cost tracks the fill and not the cache's capacity.

#include "decode_walk.cuh"

template <typename TQ, typename TKV, int DPL>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* valid, void* out, void* part_o,
                          void* part_ml, int n_split, int B, int H, int Hkv,
                          int S, float scale, cudaStream_t stream) {
    const DenseRows rows{S, (int64_t)Hkv * 32 * DPL};
    return launch_decode_walk<TQ, TKV, DPL>(q, k, v, rows, valid, out,
                                            part_o, part_ml, n_split, B, H,
                                            Hkv, S, scale, stream);
}

template <typename TQ, typename TKV, int DPL>
static cudaError_t attrs(int B, int H, int Hkv, int* out) {
    return decode_walk_attrs<TQ, TKV, DPL, DenseRows>(B, H, Hkv, out);
}

// q (B, H, D); k/v (B, S, Hkv, D); valid_lens (B,) int32; out (B, H, D)
// in q's dtype. All contiguous and 16-byte aligned, D in {32, 64, 128,
// 256}. With n_split > 1, part_o (n_split, B, H, D) and part_ml (n_split,
// B, H, 2) are fp32 scratch. Returns the cudaError_t of the launches (0 =
// launched).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid_lens,
                                       void* out, void* part_o, void* part_ml,
                                       int n_split, int B, int H, int Hkv,
                                       int D, int S, float scale,
                                       int q_dtype, int kv_dtype,
                                       void* stream) {
    REPRO_DISPATCH_WIDE(launch, q_dtype, kv_dtype, D, q, k, v, valid_lens,
                        out, part_o, part_ml, n_split, B, H, Hkv, S, scale,
                        (cudaStream_t)stream);
}

// The walk's registers, shared memory, local bytes, blocks an SM, key tile
// and blocks of one key range at (B, H, Hkv) (decode_walk_attrs).
extern "C" int decode_attention_attrs(int q_dtype, int kv_dtype, int D,
                                      int B, int H, int Hkv, int* out) {
    REPRO_DISPATCH_WIDE(attrs, q_dtype, kv_dtype, D, B, H, Hkv, out);
}
