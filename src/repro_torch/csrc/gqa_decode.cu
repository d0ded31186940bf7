// Ragged GQA flash-decode over a dense KV cache for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the TPU kernel `_decode_kernel` of src/repro/kernels/
// decode_attention.py and its two launchers, `gqa_decode`
// (src/repro/kernels/gqa_decode.py) and `decode_attention`: one query
// token per head attends its request's cache up to the request's own length.
//
//   q        (B, Hq, D)          T = float or bf16, contiguous
//   k, v     (B, Hkv, T_len, D)  T, read through strides (sb, sh, st) in
//                                elements with D contiguous: the serving
//                                cache is stored (B, T_len, Hkv, D) and
//                                handed over as a transposed view
//   kv_len   (B,)                int32, clamped to [0, T_len]
//   out      (B, Hq, D)          T, f32 math cast at the end
//   part_o   (rows, S, G, D)     f32 partials, only when k_splits S > 1
//   part_lse (rows, S, G)        f32 log-sum-exp of each partial
//
// Bound: memory. A call reads 2 * sum_b min(kv_len_b, T) * Hkv * D * itemsize
// bytes of K/V and does 4 operations per K/V element and query head of the
// group, far below the card's balance point. So the design streams each
// K/V row from HBM once and keeps the card's SMs busy doing it:
//
//   * Grid (rows, S). With pack_gqa a row is one (b, kv_head), scoring all
//     G = Hq / Hkv query heads of the group against each staged K/V row;
//     without it a row is one (b, q_head), G = 1, and the group re-reads
//     the rows (the L2 may absorb part of it). S = k_splits cuts each
//     request's positions into spans of blocks_per_split * block_kv rows,
//     one block each, as the TPU kernel's split axis does: B * Hkv = 64
//     packed rows at the serving shape would leave most of the 132 SMs
//     idle. Splits past kv_len find no key and write lse = -1e30, acc = 0;
//     a second launch (`combine`) weighs the S partials by exp(lse - max),
//     the TPU wrapper's logsumexp combine, so they count 0 and a row whose
//     splits are all empty comes out 0, not NaN. S == 1 writes o directly.
//   * The TPU grid's sequential block axis becomes a loop over chunks of
//     `block_kv` rows of the span, copied into shared memory with 16-byte
//     cp.async copies, double-buffered; the loop stops at kv_len, so no
//     chunk past a request's length is fetched.
//   * Every warp of the block takes 32 keys of a chunk at a time, one key a
//     lane: the lane runs the whole D-long q.k of its key for each of the
//     G query rows, 16 bytes of the key row at a time, into four partial
//     sums a row (short FMA chains: a warp often has its scheduler to
//     itself, so the chains' latency is what it waits on). Staged rows are
//     padded by 16 bytes, which puts the 32 lanes' reads of their rows on
//     distinct banks while all lanes read the same q elements (q waits in
//     shared memory in f32), a broadcast; no reduction crosses lanes. One
//     online-softmax update per 32 keys and row follows (two warp
//     reductions), then p.V with the lanes splitting D, each key's
//     probability taken by a broadcast shuffle, so each V row is read once
//     for all G rows. Each warp keeps its own (m, l, acc) in registers; the
//     warps' states are merged once at the end through shared memory (the
//     staging area, reused).
//   * The scale multiplies the finished dot product and the probabilities
//     use the accurate expf, as the plain version computes them. A masked
//     key adds nothing (probability 0, not exp of a large negative), so a
//     request with kv_len == 0 gets exact zeros.
//
// CUDA-core FMAs, no tensor cores, no TMA: for one query token per head the
// product is a matrix-vector one; wgmma over the packed rows is later work.
//
// The kernel template is in gqa_decode.cuh, shared with gqa_decode_kv8.cu
// (the int8 cache); this file instantiates it for float32 and bfloat16
// caches.

#include "gqa_decode.cuh"

extern "C" {

// Dynamic shared memory one launch needs: the block's query rows in f32,
// then the double-buffered K/V staging area (rows padded by 16 bytes),
// reused afterwards for the warps' f32 (acc, m, l).
int gqa_decode_smem_bytes(int D, int dtype_bytes, int block_kv, int rows,
                          int num_warps) {
  return smem_bytes(D, dtype_bytes, block_kv, rows, num_warps);
}

// dtype: 0 = float32, 1 = bfloat16. part_o / part_lse hold (rows, k_splits,
// G, D) and (rows, k_splits, G) floats when k_splits > 1 (else unused).
// Strides are k's and v's (the same), in elements. Returns a cudaError_t
// (0 = launched).
int gqa_decode_launch(const void* q, const void* k, const void* v,
                      const int* kv_len, void* out, void* part_o,
                      void* part_lse, int B, int Hq, int Hkv, int t_len,
                      int D, long long sb, long long sh, long long st,
                      float scale, int block_kv, int k_splits, int pack_gqa,
                      int num_warps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, float>(q, k, v, nullptr, nullptr, kv_len, out, part_o,
                             part_lse, B, Hq, Hkv, t_len, D, sb, sh, st, 0, 0,
                             0, scale, block_kv, k_splits, pack_gqa,
                             num_warps, s);
  if (dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, kv_len, out, part_o, part_lse, B, Hq, Hkv,
        t_len, D, sb, sh, st, 0, 0, 0, scale, block_kv, k_splits, pack_gqa,
        num_warps, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
