// Causal (or full) GQA prefill attention for Hopper (sm_90a): Sq query
// tokens of each batch row attend the row's Sk keys, read in the layouts
// the model holds them in, q (B, Sq, H, D) and k/v (B, Sk, Hkv, D), with
// no transposes. Causal masking is aligned at the top left: query t
// attends keys 0..t; with a local-attention window W (recurrentgemma's
// attention layers) keys t-W+1..t; with a prefix-LM's prefix P
// (paligemma-3b's 256 image tokens) also every key below P, whatever the
// query. Head dims 32, 64, 128 and 256.
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
// above the tensor-core ridge: operations. The least time is the causal
// half's 4 * H * D * S^2 / 2 flops over the TF32 rate of its fp32
// operands (494 TFLOP/s) or bf16's 989. Held to 1e-4 of its fp32 plain
// version, the walk cannot take single-pass TF32 (~1e-3 on a score): it
// splits each fp32 operand into two TF32 halves and takes three products
// (3xTF32), an effective ceiling of ~165 TFLOP/s for fp32 q/k/v.
//
// What the design does about it: the Pallas grid's sequential key axis
// (m/l/acc carried in VMEM, blocks above the diagonal predicated off)
// becomes the walk K2 uses (prefill_walk.cuh, whose note gives the
// details): a warpgroup block of 64 query rows (q tokens x the query
// heads of one kv head; 4 tokens x 16 heads at recurrentgemma's heads)
// walks 64-key tiles (32 at D 256 and fp32 D 128) from key 0 up to its
// q tile's diagonal, both products on mma.sync TF32 tensor cores with the
// scores in registers, fed by a two-stage cp.async ring. Key tiles above
// the diagonal are never read, so the work is the causal half; with a
// window the walk begins at the first key tile of the q tile's window (a
// band of width W); with a prefix a q tile above it walks on to the
// prefix's last tile (the prefix is a runtime value, so it adds no
// instantiation). The q tiles with the longest walks launch first, and
// a grid too small for the card splits each walk into ranges merged in
// a fixed order (short prompts).

#include "prefill_walk.cuh"

template <typename TQ, typename TKV, int DPL>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, void* part_o, void* part_ml, void* lse,
                          int n_split, int B, int Sq, int Sk, int H, int Hkv,
                          int causal, int window, int prefix, float scale,
                          cudaStream_t stream) {
    const DenseRows rows{Sk, (int64_t)Hkv * 32 * DPL};
    if (!causal)
        return window > 0 ? cudaErrorInvalidValue
                          : launch_prefill_walk<TQ, TKV, DPL, DenseRows,
                                                false, false>(
                                q, k, v, rows, nullptr, out, part_o,
                                part_ml, n_split, B, Sq, H, Hkv, Sk, 0, 0,
                                scale, stream, lse);
    return window > 0
        ? launch_prefill_walk<TQ, TKV, DPL, DenseRows, true, true>(
              q, k, v, rows, nullptr, out, part_o, part_ml, n_split, B, Sq,
              H, Hkv, Sk, window, prefix, scale, stream, lse)
        : launch_prefill_walk<TQ, TKV, DPL, DenseRows, true, false>(
              q, k, v, rows, nullptr, out, part_o, part_ml, n_split, B, Sq,
              H, Hkv, Sk, 0, prefix, scale, stream, lse);
}

template <typename TQ, typename TKV, int DPL>
static cudaError_t attrs(int causal, int window, int* out) {
    if (!causal)
        return prefill_walk_attrs<TQ, TKV, DPL, DenseRows, false, false>(out);
    return window > 0
        ? prefill_walk_attrs<TQ, TKV, DPL, DenseRows, true, true>(out)
        : prefill_walk_attrs<TQ, TKV, DPL, DenseRows, true, false>(out);
}

// q (B, Sq, H, D); k/v (B, Sk, Hkv, D); out (B, Sq, H, D) in q's dtype.
// All contiguous and 16-byte aligned, D in {32, 64, 128, 256}; window 0
// for none, else >= 1 and causal; prefix >= 0 keys visible to every query
// (a prefix-LM; 0 for none). n_split >= 1 key ranges; with more than
// one, part_o (n_split, B, Sq, H, D) and part_ml (n_split, B, Sq, H, 2)
// fp32 scratch. lse null, or (B, Sq, H) fp32 for each row's log-sum-exp
// of its scaled scores (the backward's input, flash_attention_bwd.cu); it
// changes no bit of out. Returns the cudaError_t of the launches (0 =
// launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      void* part_o, void* part_ml,
                                      void* lse, int n_split, int B,
                                      int Sq, int Sk, int H, int Hkv, int D,
                                      int causal,
                                      int window, int prefix, float scale,
                                      int q_dtype, int kv_dtype,
                                      void* stream) {
    if (prefix < 0) return (int)cudaErrorInvalidValue;
    REPRO_DISPATCH_WIDE(launch, q_dtype, kv_dtype, D, q, k, v, out, part_o,
                        part_ml, lse, n_split, B, Sq, Sk, H, Hkv, causal,
                        window, prefix, scale, (cudaStream_t)stream);
}

// The walk instantiation's registers, dynamic shared memory bytes, local
// bytes, resident blocks an SM and key tile, into out[0..4].
extern "C" int flash_attention_attrs(int q_dtype, int kv_dtype, int D,
                                     int causal, int window, int* out) {
    REPRO_DISPATCH_WIDE(attrs, q_dtype, kv_dtype, D, causal, window, out);
}
