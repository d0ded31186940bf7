// Ragged GQA flash-decode over an int8 dense KV cache for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces the TPU kernel `_kv8_kernel` of src/repro/kernels/
// gqa_decode_kv8.py (the kv8 policy's dense decode): one query token per
// head attends its request's int8 cache up to the request's own length,
// dequantizing each row by its per-token, per-head f32 scale inside the
// kernel.
//
//   q                 (B, Hq, D)          Q = float or bf16, contiguous
//   k, v              (B, Hkv, T_len, D)  int8, read through strides (sb,
//                                         sh, st) in elements with D
//                                         contiguous: the serving cache is
//                                         stored (B, T_len, Hkv, D) and
//                                         handed over as a transposed view
//   k_scale, v_scale  (B, Hkv, T_len)     f32, read through strides (ssb,
//                                         ssh, sst): stored (B, T_len, Hkv)
//                                         and handed over transposed, so a
//                                         key's scales sit Hkv * 4 bytes
//                                         apart along T
//   kv_len            (B,)                int32, clamped to [0, T_len]
//   out               (B, Hq, D)          Q, f32 math cast at the end
//
// Bound: memory. A call reads 2 * sum_b min(kv_len_b, T) * Hkv * (D + 4)
// bytes of K/V rows and scales: D + 4 bytes a row where the float kernel
// reads 2 D (bf16), so about half of gqa_decode's traffic at D = 128. The
// design is gqa_decode.cu's (the kernel template in gqa_decode.cuh): grid
// (rows, k_splits) with the query group packed or not, double-buffered
// 16-byte cp.async staging of the rows through the transposed view, one key
// a lane for q.k, p.V with the lanes splitting D, fp32 online softmax, and
// the second launch combining the splits' partials by their logsumexp, in
// which empty splits weigh 0 and kv_len 0 gives exact zeros. What int8 adds:
//
//   * A 16-byte copy stages 16 values of a row, and a row is D bytes (plus
//     16 of padding, which keeps the lanes' reads on distinct banks as for
//     the float rows). The lane converts the 16 values of each 16-byte read
//     to f32 and runs its FMAs on them: q stays float, as the reference
//     never quantizes it, so the int8 dot-product instructions (dp4a, int8
//     MMA) do not apply.
//   * The scales are not staged: the lane that owns a key loads its two
//     scales with plain 4-byte loads (they hit L2, the Hkv heads' scales of
//     one token share a 32-byte sector) before its dot product, and no
//     step copies the scale buffers.
//   * The key's scale multiplies the finished dot product,
//     s = (q . k_q[t]) * (k_scale[t] * scale), and the value's scale folds
//     into the probability, acc += (p_t * v_scale[t]) * v_q[t]; the sum l
//     takes p_t unscaled. Both are exact in algebra and reorder only the
//     rounding against the plain version, which dequantizes first.
//
// At block_kv 128 the int8 staging is 4 * 128 * 144 B = 72 KB where the
// bf16 kernel's is 136 KB, so two blocks of 128 keys may share an SM.

#include "gqa_decode.cuh"

extern "C" {

// Dynamic shared memory one launch needs (gqa_decode_smem_bytes with
// int8 rows).
int gqa_decode_kv8_smem_bytes(int D, int block_kv, int rows, int num_warps) {
  return smem_bytes(D, 1, block_kv, rows, num_warps);
}

// q_dtype: 0 = float32, 1 = bfloat16 (q and out). part_o / part_lse hold
// (rows, k_splits, G, D) and (rows, k_splits, G) floats when k_splits > 1
// (else unused). Strides are k's and v's (the same) and k_scale's and
// v_scale's (the same), in elements. Returns a cudaError_t (0 = launched).
int gqa_decode_kv8_launch(const void* q, const void* k, const void* v,
                          const float* k_scale, const float* v_scale,
                          const int* kv_len, void* out, void* part_o,
                          void* part_lse, int B, int Hq, int Hkv, int t_len,
                          int D, long long sb, long long sh, long long st,
                          long long ssb, long long ssh, long long sst,
                          float scale, int block_kv, int k_splits,
                          int pack_gqa, int num_warps, int q_dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return run<float, int8_t>(q, k, v, k_scale, v_scale, kv_len, out, part_o,
                              part_lse, B, Hq, Hkv, t_len, D, sb, sh, st,
                              ssb, ssh, sst, scale, block_kv, k_splits,
                              pack_gqa, num_warps, s);
  if (q_dtype == 1)
    return run<__nv_bfloat16, int8_t>(
        q, k, v, k_scale, v_scale, kv_len, out, part_o, part_lse, B, Hq, Hkv,
        t_len, D, sb, sh, st, ssb, ssh, sst, scale, block_kv, k_splits,
        pack_gqa, num_warps, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
