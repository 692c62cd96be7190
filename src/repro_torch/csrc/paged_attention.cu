// K4: paged attention over the serving engine's KV block pool, for the
// legacy per-shape engine's decode, chunked-prefill and speculative-verify
// steps.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// _paged_flash_decode_kernel (built by make_paged_flash_decode, reached
// through kernels/ops.py::paged_attention from the paged branch of
// models/attention.py::gqa_attention, once per layer of every
// models/model.py::paged_step).  q (B, C, H, Dk) holds C query tokens per
// slot at per-token absolute positions q_positions (B, C); slot b's logical
// kv row j lives in pool block block_tables[b, j / bs], row j % bs, of the
// pool (NB, bs, KVH, D) — int8 Eq.-1 codes or floats — and a query at
// position p attends to the kv rows j <= p.  The TPU kernel runs only
// C == 1 (its wrapper sends every other shape to a gather path computing
// the same function); this kernel takes every C: the decode (n_slots, 1),
// the prefill chunk (1, chunk) and the verify (n_slots, K + 1) shapes.
//
// What bounds it on an H100: the bytes of the kv rows each slot's queries
// see (KVH * (Dk + Dv) bytes a position for int8), plus q and out.  At the
// engine's decode shape that is well under a megabyte a layer, so a launch
// is bound by its fixed cost and one 16-row stage's latency; over a long
// cache (32k positions a slot) by memory, which needs enough blocks in
// flight to keep 132 SMs reading.
//
// Design: K1's body (paged_kv_attention.cuh), on a work list the host
// plans once per engine dispatch for every layer
// (kernels/flash_attention.py::plan_paged_work).  q is read as (B * C, H,
// Dk), stream row b * C + c.  An item carries up to 16 / groups
// consecutive tokens of one slot whose positions rise by 0 or 1 from one
// token to the next, and sees kv rows [0, its largest position + 1),
// clipped to the table's W * bs rows; a padded verify row (the engine's
// trash column) therefore gets its own item and never widens a real row's
// range.  A range past 512 rows is cut into at most 32 chunks, one block
// each, merged by combine_kernel: a long cache puts B * KVH * 32 blocks on
// the card where the first K4 had B * KVH.  Each row's causal limit is its
// own entry of q_positions, read on the device, so rows at any positions
// (the padded verify rows, repeated) are masked exactly.  bf16 q runs QK^T
// and PV on the tensor cores (mma.sync m16n8k16); fp32 q on the CUDA cores.
// Any head dim up to 256 (not whole 16-byte vectors: staged value by
// value).
//
// Arithmetic as the reference: fp32 online softmax from -inf; K, V and P
// rounded to the q type (int8 codes and bf16 values convert exactly); l
// sums the unrounded P; int8's 2^-n folds into the score scale (K) and
// into the final acc / l (V); a row whose l is 0 is written as 0.  Every
// (b, c) row is in exactly one item, so every output row is written.
//
// What is left (PERF.md §6, §7): a decode launch waits on three dependent
// reads (its work-list row, its table slice, its kv rows) and one stage in
// which 2 of an m16 tile's 16 rows are live, several times the launch
// floor; over a long cache what stands between it and the bytes' bound
// is each block's 4-warp stage loop (a barrier and a wait a 64-row stage).
#include "paged_kv_attention.cuh"

namespace {

// K4's causal limit of the item's row r: its token's own position
struct PosLimit {
  const int* positions;  // (B * C,): q_positions flattened
  __device__ int operator()(const Item& it, int r, int groups) const {
    return positions[it.row0 + r / groups];
  }
};

}  // namespace

// C entry.  q (B, C, H, Dk) is read as (B * C, H, Dk), out likewise.
// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// codes on the 2^-kv_frac_bits grid (0 for float pools).  block_tables
// (B, W) int32, q_positions (B, C) int32.  work: (n_items + n_combine, 8)
// int32, the items (slot, first token, tokens, kv begin, kv end, partial
// slot or -1, the first token's stream row b * C + c, 0) then the combine
// entries (slot, first token, tokens, first slot, slots, 0, stream row, 0);
// ws holds (slots, KVH, 16, Dv + 2) floats when n_combine > 0, max_splits
// (1..MAX_SPLITS) is the most slots one combine entry lists and max_blocks
// the most pool blocks one item's kv range touches.  score_scale (the
// caller's scale times 2^-kv_frac_bits) arrives as the bits of a float32
// (plain-int C interface).  Returns cudaGetLastError() after each launch
// (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* q_positions,
                                      const void* work, void* out, void* ws, int H, int KVH,
                                      int Dk, int Dv, int W, int bs, int n_items, int n_combine,
                                      int max_splits, int max_blocks, int score_scale_bits,
                                      int kv_frac_bits, int q_dtype, int kv_dtype,
                                      void* stream) {
  if (q_positions == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, block_tables, work, out, ws, H, KVH, Dk, Dv, W, bs,
               n_items, n_combine, max_splits, max_blocks, f32_from_bits(score_scale_bits),
               ldexpf(1.f, -kv_frac_bits), static_cast<cudaStream_t>(stream)};
  return launch_typed(a, q_dtype, kv_dtype, PosLimit{static_cast<const int*>(q_positions)});
}
