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
// What bounds it on this card: bytes. A row reads its filled K and V once,
// valid_len * D * 2 tensors * 2 B in bf16, for about G flops a byte (3 at
// smollm-135m's widths, 4 at qwen3-4b's) -- far under the ~295 flop/byte
// ridge of the bf16 tensor cores. The least time is the filled KV bytes
// (sum over b of valid_len[b] * Hkv * D * 2 * 2 B) over 3.35 TB/s.
//
// What this simple design does about it: the Pallas grid's sequential
// cache-block axis (m/l/acc carried in VMEM, blocks past the fill
// predicated off) becomes the walk K1 uses (decode_walk.cuh): one block per
// (row, kv head) serves the head's G query heads, 8 warps walk 32-slot
// tiles with private online softmaxes in registers and merge (m, l, acc)
// in shared memory. A windowed ring-buffer cache (recurrentgemma's local
// attention) is read the same way: the model passes min(pos + 1, W) as
// the fill, and attention does not depend on the order of the slots.
// At head_dim 256, 16 query heads on one kv head are two blocks of 8.
// Slots at or past valid_len[b] are never read, so decode cost tracks the
// fill and not the cache's capacity. A row is not
// yet split across blocks (flash-decoding), so a decode batch of B rows
// keeps only B * Hkv SMs busy; that, TMA and wgmma are later work.

#include "decode_walk.cuh"

template <typename TQ, typename TKV, int DPL>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* valid, void* out, int B, int H,
                          int Hkv, int S, float scale, cudaStream_t stream) {
    const DenseRows rows{S, (int64_t)Hkv * 32 * DPL};
    return launch_decode_walk<TQ, TKV, DPL>(q, k, v, rows, valid, out, B, H,
                                            Hkv, S, scale, stream);
}

// q (B, H, D); k/v (B, S, Hkv, D); valid_lens (B,) int32; out (B, H, D)
// in q's dtype. All contiguous and 16-byte aligned, D in {32, 64, 128,
// 256}.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid_lens,
                                       void* out, int B, int H, int Hkv,
                                       int D, int S, float scale,
                                       int q_dtype, int kv_dtype,
                                       void* stream) {
    REPRO_DISPATCH_WIDE(launch, q_dtype, kv_dtype, D, q, k, v, valid_lens,
                        out, B, H, Hkv, S, scale, (cudaStream_t)stream);
}
