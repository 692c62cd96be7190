// K1: unified ragged paged attention over the serving engine's KV block pool.
//
// Replaces the TPU kernel repro/kernels/ragged_flash.py::
// _ragged_paged_flash_kernel (built by make_ragged_paged_flash, reached
// through kernels/ops.py::ragged_attention once per layer of every engine
// step).  One launch serves a whole mixed step: q (T, H, Dk) is a flattened
// stream of prefill chunks, decode rows and speculative tails; sequence s
// owns stream rows [q_start[s], q_start[s] + q_len[s]) and sees kv_len[s]
// KV rows through its block table; row i of s is the token at absolute
// position kv_len - q_len + i and attends causally to kv positions <= it.
//
// What bounds it on an H100: the bytes of the KV codes each sequence reads
// (int8: KVH * (Dk + Dv) bytes a visible position), plus q and out.  A
// serving step reads well under a megabyte a layer, so there the launch's
// fixed cost and its few blocks' latency are what is left; a long context
// (32k positions, 67 MB at qwen3-1.7B's heads) is bound by the bytes.
//
// Design: the work list, split-KV with a combine kernel, the cp.async
// staging ring, bf16 q on the tensor cores and fp32 q on the CUDA cores of
// paged_kv_attention.cuh, whose body K4 shares.  K1's rows find their
// causal limit from the item alone: the item's first token sees kv rows
// <= lim0 (kv_len - q_len + its index), each later token one more.  The
// wrapper zero-fills the output, so rows no descriptor covers stay exactly
// 0.  Timed with its products compiled out, a decode stage was not much
// faster, so the tensor cores are not what holds a decode row (the stage
// loop's latency is); a CUDA-core decode path was not tried.
#include "paged_kv_attention.cuh"

namespace {

// K1's causal limit of the item's row r: its first token's, one more a token
struct RelLimit {
  __device__ int operator()(const Item& it, int r, int groups) const {
    return it.lim0 + r / groups;
  }
};

}  // namespace

// C entry.  q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32,
// 1 bfloat16, 2 int8 codes on the 2^-kv_frac_bits grid (0 for float pools).
// work: (n_items + n_combine, 8) int32, the items (sequence, first token,
// tokens, kv begin, kv end, partial slot or -1, the first token's stream
// row, its causal limit kv_len - q_len + first token) then the combine
// entries (sequence, first token, tokens, first slot, slots, 0, stream
// row, 0); ws holds (slots, KVH, 16, Dv + 2) floats when n_combine > 0,
// max_splits (1..MAX_SPLITS) is the most slots one combine entry lists
// and max_blocks the most pool blocks one item's kv range touches.
// score_scale arrives as the bits of a float32 (plain-int C interface).
// Returns cudaGetLastError() after each launch (0 on success).
extern "C" int ragged_paged_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* block_tables,
                                             const void* work, void* out, void* ws, int H,
                                             int KVH, int Dk, int Dv, int nbmax, int bs,
                                             int n_items, int n_combine, int max_splits,
                                             int max_blocks, int score_scale_bits,
                                             int kv_frac_bits, int q_dtype, int kv_dtype,
                                             void* stream) {
  const Args a{q, k_pool, v_pool, block_tables, work, out, ws, H, KVH, Dk, Dv, nbmax, bs,
               n_items, n_combine, max_splits, max_blocks, f32_from_bits(score_scale_bits),
               ldexpf(1.f, -kv_frac_bits), static_cast<cudaStream_t>(stream)};
  return launch_typed(a, q_dtype, kv_dtype, RelLimit{});
}
