// Causal (or full) GQA prefill attention for Hopper (sm_90a): Sq query
// tokens of each batch row attend the row's Sk keys, read in the layouts
// the model holds them in, q (B, Sq, H, D) and k/v (B, Sk, Hkv, D), with
// no transposes. Causal masking is aligned at the top left: query t
// attends keys 0..t; with a local-attention window W (recurrentgemma's
// attention layers) keys t-W+1..t. Head dims 32, 64, 128 and 256.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, the pl.pallas_call at line 82; its wrapper
// src/repro/kernels/ops.py:29 transposes (B, S, H, D) into (B*H, S, D)
// first). The Pallas kernel needs Sq and Sk to be multiples of its 128-row
// blocks, and the model falls back to XLA otherwise; here a masked ragged
// q tile and a masked ragged key tile run every length.
//
// What bounds it on this card: at prompt lengths the serving paths reach
// (S ~ 1000-2000) it does about 2 * H * D * S flops for every K/V row it
// reads and about S/2 flops per q byte, some 200-400 flops a byte, at or
// above the tensor-core ridge: operations at the prompt lengths that
// matter. The least time is the larger of the causal half's 4 * H * D *
// S^2 / 2 flops over the tensor-core rate of the operand type (989 TFLOP/s
// bf16, 494 TF32 for fp32) and the q, k, v and output bytes over 3.35
// TB/s. This version does its math in fp32 on CUDA cores (67 TFLOP/s) so
// that it matches the plain version to 1e-4: a ceiling of this design,
// which wgmma tiles remove.
//
// What this simple design does about it: the Pallas grid's sequential key
// axis (m/l/acc carried in VMEM, blocks above the diagonal predicated off)
// becomes the walk K2 uses (prefill_walk.cuh): one block per (batch row,
// kv head, 16-token q tile) walks 32-key tiles from key 0 up to the tile's
// causal diagonal, staging each tile in shared memory once for every query
// head of the kv head and every token of the q tile, with the online
// softmax in registers and fp32 accumulation. Key tiles above the diagonal
// are never read, so the work is the causal half; with a window the walk
// also begins at the first key tile of the q tile's window, so the work
// is a band of width W. At head_dim 256 a block takes 4 query tokens, not
// 16, to keep its accumulators in registers (16 query heads on one kv
// head are two blocks of 8 heads).

#include "prefill_walk.cuh"

template <typename TQ, typename TKV, int DPL>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int H, int Hkv,
                          int causal, int window, float scale,
                          cudaStream_t stream) {
    const DenseRows rows{Sk, (int64_t)Hkv * 32 * DPL};
    if (!causal)
        return window > 0 ? cudaErrorInvalidValue
                          : launch_prefill_walk<TQ, TKV, DPL, DenseRows,
                                                false, false>(
                                q, k, v, rows, nullptr, out, B, Sq, H, Hkv,
                                Sk, 0, scale, stream);
    return window > 0
        ? launch_prefill_walk<TQ, TKV, DPL, DenseRows, true, true>(
              q, k, v, rows, nullptr, out, B, Sq, H, Hkv, Sk, window, scale,
              stream)
        : launch_prefill_walk<TQ, TKV, DPL, DenseRows, true, false>(
              q, k, v, rows, nullptr, out, B, Sq, H, Hkv, Sk, 0, scale,
              stream);
}

// q (B, Sq, H, D); k/v (B, Sk, Hkv, D); out (B, Sq, H, D) in q's dtype.
// All contiguous and 16-byte aligned, D in {32, 64, 128, 256}; window 0
// for none, else >= 1 and causal. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int H, int Hkv, int D,
                                      int causal, int window, float scale,
                                      int q_dtype, int kv_dtype,
                                      void* stream) {
    REPRO_DISPATCH_WIDE(launch, q_dtype, kv_dtype, D, q, k, v, out, B, Sq,
                        Sk, H, Hkv, causal, window, scale,
                        (cudaStream_t)stream);
}
