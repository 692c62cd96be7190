// The paged-KV attention body shared by K1 (ragged_attention.cu) and K4
// (paged_attention.cu): a block takes one work-list item of up to 16
// (token, head) rows of one KV head over a kv range of one sequence's (or
// slot's) block table, and writes its rows' outputs or, for a split range,
// its partial softmax state (m, l, acc) for combine_kernel to merge.  The
// two kernels differ only in how a row finds its causal limit, the last kv
// row it sees: the kernels are templated on a functor Lim, called as
// limit(item, r, groups) for the item's row r.
//
// Work list.  The host plans it (kernels/ragged_flash.py::plan_ragged_work
// for K1, kernels/flash_attention.py::plan_paged_work for K4): items
// (sequence, first token, tokens, kv begin, kv end, partial slot or -1,
// the first token's stream row, K1's causal limit of that token), longest
// kv range first, then combine entries (sequence, first token, tokens,
// first slot, slots, 0, stream row, 0).  An item carries 16 / groups tokens
// times the GQA group, so each K/V row is read once for the group; an item
// seeing more than 512 kv rows is cut into at most 32 chunks, one block
// each.  The grid is (items, KVH); q and out are (stream rows, H, D).
// A list may be padded to a fixed capacity (ragged_flash.py::pad_work, so
// that a step replayed from a CUDA graph keeps one grid and one shared
// memory size): a padding item has no token and a padding combine entry no
// slot, and their blocks return before touching memory.
//
// Staging: a block of 4 warps walks its kv range in stages of 64 rows (32
// where a row is wider than 256 bytes), several pool blocks a stage,
// copied with 16-byte cp.async in the pool's own type into a ring of
// three (two land while one is used), rows at or past the range's end
// zero-filled.  The item's slice of the block table is read into shared
// memory once, and q's rows arrive by cp.async with the first stage.  Each
// warp takes 16 rows of a stage with its own online-softmax state, and one
// barrier at the end merges the four warps: their live rows only, through
// a buffer whose odd row stride puts a fragment's 8 rows on 8 banks.  Pool blocks past the range
// (a padding slot's trash block, a table's tail) are never read.
//
// bf16 q on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
// accumulate): S = Q K^T over the warp's 16 kv rows, the online softmax on
// the accumulator fragments, P rounded to bf16 in registers as the A
// operand of O += P V.  Fragments are built from the staged rows in
// registers: int8 codes become floats by the 2^23 magic number (a byte
// permute and a subtraction, exact) and bf16 pairs by cvt.rn.bf16x2.  For
// S the head dim is permuted inside each 16-wide step (k 2t, 2t+1, 2t+8,
// 2t+9 are dims 4t..4t+3), so a K fragment is one 4-byte word of a row;
// for P.V a lane reads four kv rows' words of four head dims and
// transposes them with __byte_perm (n-tile j's column g is head dim 4g + j
// of its 32-dim slice), so no transposed copy of V is staged.  Decode rows
// take the same path, the m16 tile mostly empty rows.
//
// fp32 q stays on the CUDA cores (the model checks hold fp32 to 1e-4): in
// a warp, lane l scores kv row l % 16 against 8 of the item's rows (float4
// q, 16-byte K vectors), the softmax reduces over half-warps, and for P.V a
// lane owns Dv / 32 consecutive head dims of all 16 rows.
//
// Semantics as the reference: fp32 online softmax from -inf; K, V and P
// rounded to the q type (int8 codes and bf16 values convert exactly), l
// sums the unrounded P, the int8 grid 2^-n folded into the score scale and
// the final 1/l; a row whose l is 0 is written as 0.  A block writes only
// its own rows.  Head dims that are not whole 16-byte vectors (or
// unaligned tensors) are staged value by value, zero-padded.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16;        // (token, head) rows an item carries
constexpr int WROWS = 16;       // kv rows a warp takes of a stage
constexpr int ITEM_COLS = 8;    // a work-list row (see the C entries)
constexpr int MAX_DIM = 256;
constexpr int MAX_SPLITS = 256;  // slots one combine entry lists, at most
constexpr int MAX_SMEM = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t v) { return (float)v; }

template <typename QT>
__device__ __forceinline__ QT from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// one 32-bit word of cache values -> floats.  int8: byte ^ 0x80 under the
// exponent of 2^23 is the float 2^23 + code + 128, exact, so one subtraction
// gives the code; bf16: the high half of an fp32 word
template <typename KT>
struct Word;
template <>
struct Word<int8_t> {
  static constexpr int N = 4;
  __device__ static void unpack(uint32_t w, float* f) {
    const uint32_t u = w ^ 0x80808080u;
    f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
    f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
    f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
    f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int N = 2;
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <>
struct Word<float> {
  static constexpr int N = 1;
  __device__ static void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
};

__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// r_i holds row i's four bytes; c_j gets byte j of the four rows, row 0 low
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// bytes 0, 1 (lo) and 2, 3 (hi) of four int8 codes as two bf16 pairs
__device__ __forceinline__ void codes_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  float f[4];
  Word<int8_t>::unpack(w, f);
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
}

// K fragment of one kv row (p: its staged bytes) at head dims d..d+3:
// b0 = dims d, d+1 and b1 = dims d+2, d+3, rounded to bf16
template <typename KT>
__device__ __forceinline__ void k_frag(const unsigned char* p, int d, uint32_t& b0, uint32_t& b1);
template <>
__device__ __forceinline__ void k_frag<int8_t>(const unsigned char* p, int d, uint32_t& b0,
                                               uint32_t& b1) {
  codes_bf16(*reinterpret_cast<const uint32_t*>(p + d), b0, b1);
}
template <>
__device__ __forceinline__ void k_frag<__nv_bfloat16>(const unsigned char* p, int d, uint32_t& b0,
                                                      uint32_t& b1) {
  const uint2 v = *reinterpret_cast<const uint2*>(p + 2 * d);
  b0 = v.x;
  b1 = v.y;
}
template <>
__device__ __forceinline__ void k_frag<float>(const unsigned char* p, int d, uint32_t& b0,
                                              uint32_t& b1) {
  const float4 v = *reinterpret_cast<const float4*>(p + 4 * d);
  b0 = pack_bf16(v.x, v.y);
  b1 = pack_bf16(v.z, v.w);
}

// V fragments of four n-tiles: rows p0, p1 (kv rows 2t, 2t + 1) and p2,
// p3 (2t + 8, 2t + 9) at head dims d..d+3; n-tile j gets dim d + j
template <typename KT>
__device__ __forceinline__ void v_frags(const unsigned char* p0, const unsigned char* p1,
                                        const unsigned char* p2, const unsigned char* p3, int d,
                                        uint32_t (&b0)[4], uint32_t (&b1)[4]);
template <>
__device__ __forceinline__ void v_frags<int8_t>(const unsigned char* p0, const unsigned char* p1,
                                                const unsigned char* p2, const unsigned char* p3,
                                                int d, uint32_t (&b0)[4], uint32_t (&b1)[4]) {
  const uint32_t r[4] = {*reinterpret_cast<const uint32_t*>(p0 + d),
                         *reinterpret_cast<const uint32_t*>(p1 + d),
                         *reinterpret_cast<const uint32_t*>(p2 + d),
                         *reinterpret_cast<const uint32_t*>(p3 + d)};
  uint32_t c[4];
  transpose4x4(r, c);
#pragma unroll
  for (int j = 0; j < 4; ++j) codes_bf16(c[j], b0[j], b1[j]);
}
template <>
__device__ __forceinline__ void v_frags<__nv_bfloat16>(
    const unsigned char* p0, const unsigned char* p1, const unsigned char* p2,
    const unsigned char* p3, int d, uint32_t (&b0)[4], uint32_t (&b1)[4]) {
  const uint2 r0 = *reinterpret_cast<const uint2*>(p0 + 2 * d);
  const uint2 r1 = *reinterpret_cast<const uint2*>(p1 + 2 * d);
  const uint2 r2 = *reinterpret_cast<const uint2*>(p2 + 2 * d);
  const uint2 r3 = *reinterpret_cast<const uint2*>(p3 + 2 * d);
  b0[0] = __byte_perm(r0.x, r1.x, 0x5410);
  b0[1] = __byte_perm(r0.x, r1.x, 0x7632);
  b0[2] = __byte_perm(r0.y, r1.y, 0x5410);
  b0[3] = __byte_perm(r0.y, r1.y, 0x7632);
  b1[0] = __byte_perm(r2.x, r3.x, 0x5410);
  b1[1] = __byte_perm(r2.x, r3.x, 0x7632);
  b1[2] = __byte_perm(r2.y, r3.y, 0x5410);
  b1[3] = __byte_perm(r2.y, r3.y, 0x7632);
}
template <>
__device__ __forceinline__ void v_frags<float>(const unsigned char* p0, const unsigned char* p1,
                                               const unsigned char* p2, const unsigned char* p3,
                                               int d, uint32_t (&b0)[4], uint32_t (&b1)[4]) {
  const float4 r0 = *reinterpret_cast<const float4*>(p0 + 4 * d);
  const float4 r1 = *reinterpret_cast<const float4*>(p1 + 4 * d);
  const float4 r2 = *reinterpret_cast<const float4*>(p2 + 4 * d);
  const float4 r3 = *reinterpret_cast<const float4*>(p3 + 4 * d);
  b0[0] = pack_bf16(r0.x, r1.x);
  b0[1] = pack_bf16(r0.y, r1.y);
  b0[2] = pack_bf16(r0.z, r1.z);
  b0[3] = pack_bf16(r0.w, r1.w);
  b1[0] = pack_bf16(r2.x, r3.x);
  b1[1] = pack_bf16(r2.y, r3.y);
  b1[2] = pack_bf16(r2.z, r3.z);
  b1[3] = pack_bf16(r2.w, r3.w);
}


// DPL values of one staged row from value `first` on, as floats
template <typename KT, int DPL>
__device__ __forceinline__ void load_dims(const unsigned char* row, int first, float (&f)[DPL]) {
  constexpr int BYTES = DPL * (int)sizeof(KT);
  if constexpr (BYTES % 4 == 0) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row + first * sizeof(KT));
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) Word<KT>::unpack(w[i], f + i * Word<KT>::N);
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i) f[i] = to_f(reinterpret_cast<const KT*>(row)[first + i]);
  }
}

// a row of the warps' merge buffer, in floats: odd, so the 8 rows of a
// tensor-core accumulator fragment's store fall on 8 distinct banks
template <int DP>
constexpr int OB_LD = DP + 1;

// shared-memory layout, shared by the kernels and the launch
template <typename QT, typename KT, int DP>
struct Layout {
  static constexpr int ROW_BYTES = DP * (int)sizeof(KT) + 16;  // a staged row (bank offset)
  // kv rows a stage: WROWS a warp, half the warps where a row is wider
  static constexpr int SR = (DP * (int)sizeof(KT) <= 256 ? WARPS : WARPS / 2) * WROWS;
  static constexpr int STAGE = 2 * SR * ROW_BYTES;                  // K rows, then V rows
  // stages in the ring, two in flight while one is used (a fourth measured
  // slower: at 78 KB a block, two blocks an SM instead of three)
  static constexpr int NST = 3;
  static constexpr int RING = NST * STAGE;
  // per warp m, l, acc; then the rows' merge weights
  static constexpr int MERGE = (WARPS * ROWS * (OB_LD<DP> + 2) + ROWS * (WARPS + 2)) * 4;
  static constexpr int BODY = RING > MERGE ? RING : MERGE;
  static constexpr int LDQ = sizeof(QT) == 2 ? DP + 8 : DP;         // q row, in QT values
  static constexpr int P_BYTES = sizeof(QT) == 2 ? 0 : WARPS * ROWS * WROWS * 4;
  static constexpr int SMEM = BODY + ROWS * LDQ * (int)sizeof(QT) + P_BYTES;  // + the table slice
  static_assert(SMEM <= MAX_SMEM, "the staging exceeds the shared memory of a block");
};

// one work-list item as a block reads it (s: the sequence or slot whose
// block table the item walks)
struct Item {
  int s, c0, c1, part, nr, row0, lim0;
  __device__ Item(const int* work, int groups) {
    const int* it = work + (size_t)blockIdx.x * ITEM_COLS;
    s = it[0];
    nr = it[2] * groups;  // live rows
    c0 = it[3];
    c1 = it[4];
    part = it[5];
    row0 = it[6];         // the stream row of the item's first token
    lim0 = it[7];         // K1: the first token's causal limit
  }
};

// the item's slice of its sequence's block table into tbl (blocks
// c0 / bs .. (c1 - 1) / bs), so staging reads no global index
__device__ __forceinline__ int stage_table(int* tbl, const int* __restrict__ block_tables,
                                           const Item& it, int nbmax, int bs) {
  const int blk0 = it.c0 / bs, nblk = (it.c1 - 1) / bs - blk0 + 1;
  const int* src = block_tables + (size_t)it.s * nbmax + blk0;
  for (int i = threadIdx.x; i < nblk; i += THREADS) tbl[i] = src[i];
  return blk0;
}

// the pool row of kv row j: the table slice tbl starts at block blk0;
// bs_shift is log2(bs) for a power-of-two block size, else -1
__device__ __forceinline__ size_t pool_row(const int* tbl, int blk0, int j, int bs, int bs_shift) {
  if (bs_shift >= 0) return (size_t)tbl[(j >> bs_shift) - blk0] * bs + (j & (bs - 1));
  return (size_t)tbl[j / bs - blk0] * bs + j % bs;
}

// stage kv rows [j0, j0 + SR) of the block's sequence and KV head into
// `kd` (K rows) and the V rows after them; rows >= c1 and head dims past
// Dk / Dv are zero.  vec: 16-byte cp.async copies (committed here), a
// thread keeping one 16-byte column of its rows; otherwise value by value
template <typename QT, typename KT, int DP>
__device__ __forceinline__ void stage_rows(unsigned char* kd, const KT* __restrict__ k_pool,
                                           const KT* __restrict__ v_pool, const int* tbl,
                                           int blk0, int bs, int bs_shift, int kvh, size_t row_k,
                                           size_t row_v, int Dk, int Dv, int j0, int c1,
                                           bool vec) {
  using L = Layout<QT, KT, DP>;
  unsigned char* vd = kd + L::SR * L::ROW_BYTES;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CPR = DP * (int)sizeof(KT) / 16;  // vectors a padded row
    static_assert(THREADS % CPR == 0, "a thread keeps one column of the staged rows");
    constexpr int RPP = THREADS / CPR;              // rows a pass
    const int c = tid % CPR;
    const bool ck = 16 * c < Dk * (int)sizeof(KT), cv = 16 * c < Dv * (int)sizeof(KT);
    const unsigned char* kb = reinterpret_cast<const unsigned char*>(k_pool + (size_t)kvh * Dk);
    const unsigned char* vb = reinterpret_cast<const unsigned char*>(v_pool + (size_t)kvh * Dv);
    const size_t rk = row_k * sizeof(KT), rv = row_v * sizeof(KT);
#pragma unroll
    for (int r = tid / CPR; r < L::SR; r += RPP) {
      const int j = j0 + r;
      const bool live = j < c1;
      const size_t prow = live ? pool_row(tbl, blk0, j, bs, bs_shift) : 0;
      copy16_async(kd + r * L::ROW_BYTES + 16 * c,
                   live && ck ? kb + prow * rk + 16 * c : (const void*)k_pool, live && ck);
      copy16_async(vd + r * L::ROW_BYTES + 16 * c,
                   live && cv ? vb + prow * rv + 16 * c : (const void*)v_pool, live && cv);
    }
  } else {
    for (int e = tid; e < L::SR * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      const int j = j0 + r;
      const bool live = j < c1;
      const size_t prow = live ? pool_row(tbl, blk0, j, bs, bs_shift) : 0;
      reinterpret_cast<KT*>(kd + r * L::ROW_BYTES)[c] =
          live && c < Dk ? k_pool[prow * row_k + (size_t)kvh * Dk + c] : KT{};
      reinterpret_cast<KT*>(vd + r * L::ROW_BYTES)[c] =
          live && c < Dv ? v_pool[prow * row_v + (size_t)kvh * Dv + c] : KT{};
    }
  }
  copies_commit();
}

// the item's q rows into q_s (LDQ apart), zero past Dk and past the live
// rows.  q_vec: 16-byte cp.async copies, left to the next commit (the
// first stage's); otherwise value by value
template <typename QT, int LDQ, int DP>
__device__ __forceinline__ void stage_q(QT* q_s, const QT* __restrict__ q, const Item& it, int H,
                                        int kvh, int groups, int Dk, bool q_vec) {
  if (q_vec) {
    constexpr int CPR = DP * (int)sizeof(QT) / 16;  // vectors a padded row
    const int live = Dk * (int)sizeof(QT) / 16;
    for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR;
      const bool ok = r < it.nr && c < live;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          q + ((size_t)(it.row0 + r / groups) * H + kvh * groups + r % groups) * Dk);
      copy16_async(reinterpret_cast<unsigned char*>(q_s + r * LDQ) + 16 * c,
                   ok ? src + 16 * c : (const void*)q, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
      const int r = e / DP, d = e % DP;
      float val = 0.f;
      if (r < it.nr && d < Dk)
        val = to_f(q[((size_t)(it.row0 + r / groups) * H + kvh * groups + r % groups) * Dk + d]);
      q_s[r * LDQ + d] = from_f<QT>(val);
    }
  }
}

// After every warp wrote its live rows' state (ml: [WARPS][ROWS][m, l],
// ob: [WARPS][ROWS][OB_LD] accumulators), merge the warps: each row's weights
// e^(m_w - m) once (rw: [ROWS][WARPS + 2], the row's m and l after them),
// then every output, written (part < 0, scaled by 1 / l * 2^-n) or kept as
// the partial state ws[part]
template <typename QT, int DP>
__device__ __forceinline__ void merge_store(const float* ml, const float* ob, float* rw,
                                            const Item& it, QT* __restrict__ out,
                                            float* __restrict__ ws, int H, int KVH, int kvh,
                                            int groups, int Dv, float v_scale) {
  constexpr int RW = WARPS + 2;
  for (int r = threadIdx.x; r < it.nr; r += THREADS) {
    float mt = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, ml[(w * ROWS + r) * 2]);
    float wgt[WARPS], lt = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = ml[(w * ROWS + r) * 2];
      wgt[w] = mw == -INFINITY ? 0.f : expf(mw - mt);
      lt += ml[(w * ROWS + r) * 2 + 1] * wgt[w];
    }
    const float scale = it.part < 0 ? (lt == 0.f ? 1.f : 1.f / lt) * v_scale : 1.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) rw[r * RW + w] = wgt[w] * scale;
    rw[r * RW + WARPS] = mt;
    rw[r * RW + WARPS + 1] = lt;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < it.nr * Dv; e += THREADS) {
    const int r = e / Dv, d = e % Dv;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc += ob[(w * ROWS + r) * OB_LD<DP> + d] * rw[r * RW + w];
    if (it.part < 0) {
      const size_t orow = (size_t)(it.row0 + r / groups) * H + kvh * groups + r % groups;
      out[orow * Dv + d] = from_f<QT>(acc);
    } else {
      float* p = ws + (((size_t)it.part * KVH + kvh) * ROWS + r) * (Dv + 2);
      if (d == 0) {
        p[0] = rw[r * RW + WARPS];
        p[1] = rw[r * RW + WARPS + 1];
      }
      p[2 + d] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 q: the tensor-core kernel.  Block (item, KV head).
// ---------------------------------------------------------------------------
template <typename KT, int DP, typename Lim>
__global__ void __launch_bounds__(THREADS)
paged_kv_tc_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k_pool,
                   const KT* __restrict__ v_pool, const int* __restrict__ block_tables,
                   const int* __restrict__ work, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ ws, int H, int KVH, int Dk, int Dv, int nbmax, int bs,
                   float score_scale, float v_scale, bool vec, bool q_vec, Lim limit) {
  using L = Layout<__nv_bfloat16, KT, DP>;
  constexpr int OT = DP / 8;  // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::BODY);  // [ROWS][LDQ]

  const int kvh = blockIdx.y, groups = H / KVH;
  const Item it(work, groups);
  if (it.nr == 0) return;  // a padding item: the whole block leaves
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t4 = lane % 4;
  const size_t row_k = (size_t)KVH * Dk, row_v = (size_t)KVH * Dv;
  int* tbl = reinterpret_cast<int*>(smem + L::SMEM);
  const int blk0 = stage_table(tbl, block_tables, it, nbmax, bs);
  const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;

  stage_q<__nv_bfloat16, L::LDQ, DP>(q_s, q, it, H, kvh, groups, Dk, q_vec);
  __syncthreads();  // the table slice
  const int n_stages = (it.c1 - it.c0 + L::SR - 1) / L::SR;
  auto issue = [&](int st) {  // stage st into its ring slot, or an empty group
    if (st < n_stages)
      stage_rows<__nv_bfloat16, KT, DP>(smem + (st % L::NST) * L::STAGE, k_pool, v_pool, tbl,
                                        blk0, bs, bs_shift, kvh, row_k, row_v, Dk, Dv,
                                        it.c0 + st * L::SR, it.c1, vec);
    else
      copies_commit();
  };
#pragma unroll
  for (int st = 0; st < L::NST - 1; ++st) issue(st);

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // this lane's rows gid and gid + 8 see kv rows <= lim[i]; rows past the
  // live ones see none
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = gid + 8 * i;
    lim[i] = r < it.nr ? limit(it, r, groups) : -1;
  }

  // q's A fragments: held in registers for the whole range up to 128 head
  // dims, read from shared memory each stage past that
  constexpr bool QREG = DP <= 128;
  uint32_t qa[QREG ? DP / 16 : 1][4];
  auto q_frag = [&](int kc, uint32_t (&a)[4]) {
    const int d = kc * 16 + 4 * t4;
    const uint2 lo = *reinterpret_cast<const uint2*>(q_s + gid * L::LDQ + d);
    const uint2 hi = *reinterpret_cast<const uint2*>(q_s + (gid + 8) * L::LDQ + d);
    a[0] = lo.x;
    a[1] = hi.x;
    a[2] = lo.y;
    a[3] = hi.y;
  };

  for (int st = 0; st < n_stages; ++st) {
    copies_wait<L::NST - 2>();
    __syncthreads();  // stage st (and q) visible; the slot refilled next was used at st - 1
    issue(st + L::NST - 1);
    if constexpr (QREG) {
      if (st == 0) {
#pragma unroll
        for (int kc = 0; kc < DP / 16; ++kc) q_frag(kc, qa[kc]);
      }
    }
    const int j0 = it.c0 + st * L::SR + warp * WROWS;  // this warp's first kv row
    if (warp * WROWS < L::SR && j0 < it.c1) {
      const unsigned char* kb = smem + (st % L::NST) * L::STAGE + warp * WROWS * L::ROW_BYTES;
      const unsigned char* vb = kb + L::SR * L::ROW_BYTES;
      // S = Q K^T over this warp's 16 kv rows (two n-tiles)
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        uint32_t a[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qa[kc][i];
        } else {
          q_frag(kc, a);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t b0, b1;
          k_frag<KT>(kb + (8 * n + gid) * L::ROW_BYTES, kc * 16 + 4 * t4, b0, b1);
          mma_bf16(sc[n], a, b0, b1);
        }
      }
      // scale, mask (past c1 or the row's causal limit), online softmax
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 8 * n + 2 * t4 + (e & 1);
          const bool ok = j < it.c1 && j <= lim[e / 2];
          const float x = ok ? sc[n][e] * score_scale : -INFINITY;
          sc[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        alpha[i] = m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
        m_run[i] = m_new;
        l_run[i] *= alpha[i];  // this lane's share of the row sum (reduced at the end)
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[n][e];
          const float p = x == -INFINITY ? 0.f : expf(x - m_run[e / 2]);
          l_run[e / 2] += p;
          sc[n][e] = p;
        }
      if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row max moved
#pragma unroll
        for (int n = 0; n < OT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
      }
      // O += P V: P rounded to bf16 is the A operand straight from S's fragments
      const uint32_t a[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                             pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
      const unsigned char* v0 = vb + (2 * t4) * L::ROW_BYTES;
#pragma unroll
      for (int c = 0; c < DP / 32; ++c) {
        uint32_t b0[4], b1[4];
        v_frags<KT>(v0, v0 + L::ROW_BYTES, v0 + 8 * L::ROW_BYTES, v0 + 9 * L::ROW_BYTES,
                    32 * c + 4 * gid, b0, b1);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(o[4 * c + j], a, b0[j], b1[j]);
      }
    }
  }
  copies_wait<0>();
  __syncthreads();  // every warp is done with the ring: the merge buffers overlay it

  // each warp's state into the merge buffers (over the staging ring)
  float* ml = reinterpret_cast<float*>(smem);  // [WARPS][ROWS][2]
  float* ob = ml + WARPS * ROWS * 2;           // [WARPS][ROWS][OB_LD]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const int r = gid + 8 * i;
    if (t4 == 0) {
      ml[(warp * ROWS + r) * 2] = m_run[i];
      ml[(warp * ROWS + r) * 2 + 1] = l;
    }
  }
  // n-tile 4c + j's element e is row gid + 8 (e / 2), head dim
  // 32c + 8 t4 + 4 (e & 1) + j; rows past the live ones are not merged
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = gid + 8 * i;
    if (r < it.nr) {
#pragma unroll
      for (int c = 0; c < DP / 32; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e)
            ob[(warp * ROWS + r) * OB_LD<DP> + 32 * c + 8 * t4 + 4 * (e & 1) + j] =
                o[4 * c + j][e];
    }
  }
  __syncthreads();
  merge_store<__nv_bfloat16, DP>(ml, ob, ob + WARPS * ROWS * OB_LD<DP>, it, out, ws, H, KVH,
                                 kvh, groups, Dv, v_scale);
}

// ---------------------------------------------------------------------------
// fp32 q: the CUDA-core kernel, same items, staging and merge
// ---------------------------------------------------------------------------
template <typename KT, int DP, typename Lim>
__global__ void __launch_bounds__(THREADS)
paged_kv_simt_kernel(const float* __restrict__ q, const KT* __restrict__ k_pool,
                     const KT* __restrict__ v_pool, const int* __restrict__ block_tables,
                     const int* __restrict__ work, float* __restrict__ out,
                     float* __restrict__ ws, int H, int KVH, int Dk, int Dv, int nbmax, int bs,
                     float score_scale, float v_scale, bool vec, bool q_vec, Lim limit) {
  using L = Layout<float, KT, DP>;
  constexpr int DPL = DP / 32;          // head dims of the output a lane owns
  constexpr int EPV = 16 / sizeof(KT);  // values a 16-byte vector holds
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::BODY);  // [ROWS][DP]
  float* p_all = q_s + ROWS * DP;                         // [WARPS][ROWS][WROWS]

  const int kvh = blockIdx.y, groups = H / KVH;
  const Item it(work, groups);
  if (it.nr == 0) return;  // a padding item: the whole block leaves
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int jr = lane % 16, half = lane / 16;  // scores: kv row jr, rows 8 half .. + 7
  const size_t row_k = (size_t)KVH * Dk, row_v = (size_t)KVH * Dv;
  int* tbl = reinterpret_cast<int*>(smem + L::SMEM);
  const int blk0 = stage_table(tbl, block_tables, it, nbmax, bs);
  const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;

  stage_q<float, L::LDQ, DP>(q_s, q, it, H, kvh, groups, Dk, q_vec);
  __syncthreads();  // the table slice
  const int n_stages = (it.c1 - it.c0 + L::SR - 1) / L::SR;
  auto issue = [&](int st) {  // stage st into its ring slot, or an empty group
    if (st < n_stages)
      stage_rows<float, KT, DP>(smem + (st % L::NST) * L::STAGE, k_pool, v_pool, tbl, blk0, bs,
                                bs_shift, kvh, row_k, row_v, Dk, Dv, it.c0 + st * L::SR, it.c1,
                                vec);
    else
      copies_commit();
  };
#pragma unroll
  for (int st = 0; st < L::NST - 1; ++st) issue(st);

  float m_run[8], l_run[8];  // rows 8 half + i, kept alike by the half-warp's lanes
  int lim[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
    const int r = 8 * half + i;
    lim[i] = r < it.nr ? limit(it, r, groups) : -1;
  }
  float acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  float* ps = p_all + warp * ROWS * WROWS;  // this warp's P: [row][kv row]

  for (int st = 0; st < n_stages; ++st) {
    copies_wait<L::NST - 2>();
    __syncthreads();  // stage st (and q) visible; the slot refilled next was used at st - 1
    issue(st + L::NST - 1);
    const int j0 = it.c0 + st * L::SR + warp * WROWS;
    if (warp * WROWS < L::SR && j0 < it.c1) {
      const unsigned char* kb = smem + (st % L::NST) * L::STAGE + warp * WROWS * L::ROW_BYTES;
      const unsigned char* vb = kb + L::SR * L::ROW_BYTES;
      float dot[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) dot[i] = 0.f;
      const unsigned char* kr = kb + jr * L::ROW_BYTES;
      const float* qh = q_s + 8 * half * DP;
      for (int cv = 0; cv < DP * (int)sizeof(KT) / 16; ++cv) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + 16 * cv);
        float kf[EPV];
        constexpr int WN = Word<KT>::N;
        Word<KT>::unpack(raw.x, kf);
        Word<KT>::unpack(raw.y, kf + WN);
        Word<KT>::unpack(raw.z, kf + 2 * WN);
        Word<KT>::unpack(raw.w, kf + 3 * WN);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4* qv = reinterpret_cast<const float4*>(qh + i * DP + cv * EPV);
#pragma unroll
          for (int i4 = 0; i4 < EPV / 4; ++i4) {
            const float4 q4 = qv[i4];
            dot[i] += q4.x * kf[4 * i4] + q4.y * kf[4 * i4 + 1] + q4.z * kf[4 * i4 + 2] +
                      q4.w * kf[4 * i4 + 3];
          }
        }
      }
      // online softmax per row over the half-warp; every lane learns every
      // row's rescale factor (lane 0 holds rows 0..7's, lane 16 rows 8..15's)
      const int j = j0 + jr;
      float alpha_all[ROWS];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool ok = j < it.c1 && j <= lim[i];
        const float x = ok ? dot[i] * score_scale : -INFINITY;
        float mx = x;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_new = fmaxf(m_run[i], mx);
        const float alpha = m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);
        float sum = p;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
        l_run[i] = l_run[i] * alpha + sum;
        m_run[i] = m_new;
        ps[(8 * half + i) * WROWS + jr] = p;
        alpha_all[i] = __shfl_sync(FULL, alpha, 0);
        alpha_all[8 + i] = __shfl_sync(FULL, alpha, 16);
      }
      __syncwarp();
      // P.V: this lane's DPL head dims of every row, four kv rows at a time
      // (P is 0 past the live rows, whose V rows are zero)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha_all[r];
#pragma unroll
      for (int jj = 0; jj < WROWS; jj += 4) {
        float vf[4][DPL];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          load_dims<KT, DPL>(vb + (jj + t) * L::ROW_BYTES, lane * DPL, vf[t]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(ps + r * WROWS + jj);
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            acc[r][i] += p4.x * vf[0][i] + p4.y * vf[1][i] + p4.z * vf[2][i] + p4.w * vf[3][i];
        }
      }
      __syncwarp();  // P is read before the next stage rewrites it
    }
  }
  copies_wait<0>();
  __syncthreads();  // every warp is done with the ring: the merge buffers overlay it

  float* ml = reinterpret_cast<float*>(smem);  // [WARPS][ROWS][2]
  float* ob = ml + WARPS * ROWS * 2;           // [WARPS][ROWS][OB_LD]
  if (jr == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ml[(warp * ROWS + 8 * half + i) * 2] = m_run[i];
      ml[(warp * ROWS + 8 * half + i) * 2 + 1] = l_run[i];
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (r < it.nr) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) ob[(warp * ROWS + r) * OB_LD<DP> + lane * DPL + i] = acc[r][i];
    }
  __syncthreads();
  merge_store<float, DP>(ml, ob, ob + WARPS * ROWS * OB_LD<DP>, it, out, ws, H, KVH, kvh, groups,
                         Dv, v_scale);
}

// The split items' second pass: block (combine entry, KV head) merges the
// partial states of its rows' splits (m = max m_i, l = sum l_i e^(m_i - m),
// out = sum acc_i e^(m_i - m) / l * 2^-n).  A warp takes a row's weights
// with its lanes over the splits; then each thread sums its outputs over
// the splits, the loads independent of one another.
template <typename QT>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ ws, const int* __restrict__ combines,
               QT* __restrict__ out, int H, int KVH, int Dv, float v_scale) {
  extern __shared__ float wgt[];  // [ROWS][n]: e^(m_i - m) / l * 2^-n
  const int* c = combines + (size_t)blockIdx.x * ITEM_COLS;
  const int first = c[3], n = c[4], row0 = c[6];
  if (n == 0) return;  // a padding combine entry
  const int kvh = blockIdx.y, groups = H / KVH;
  const int nr = c[2] * groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t stride = (size_t)KVH * ROWS * (Dv + 2);  // one partial slot
  const float* base = ws + ((size_t)first * KVH + kvh) * ROWS * (Dv + 2);
  for (int r = warp; r < nr; r += WARPS) {
    const float* row = base + (size_t)r * (Dv + 2);
    float mt = -INFINITY;
    for (int i = lane; i < n; i += 32) mt = fmaxf(mt, row[i * stride]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
    float lt = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float mi = row[i * stride];
      const float w = mi == -INFINITY ? 0.f : expf(mi - mt);
      wgt[r * n + i] = w;
      lt += row[i * stride + 1] * w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(FULL, lt, off);
    const float scale = (lt == 0.f ? 1.f : 1.f / lt) * v_scale;
    __syncwarp();
    for (int i = lane; i < n; i += 32) wgt[r * n + i] *= scale;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * Dv; e += THREADS) {
    const int r = e / Dv, d = e % Dv;
    const float* p = base + (size_t)r * (Dv + 2) + 2 + d;
    const float* wr = wgt + r * n;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) acc += p[i * stride] * wr[i];
    const size_t orow = (size_t)(row0 + r / groups) * H + kvh * groups + r % groups;
    out[orow * Dv + d] = from_f<QT>(acc);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k_pool, *v_pool, *block_tables, *work;
  void *out, *ws;
  int H, KVH, Dk, Dv, nbmax, bs, n_items, n_combine, max_splits, max_blocks;
  float score_scale, v_scale;
  cudaStream_t stream;
};

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename K>
int raise_smem_limit(K kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
}

template <typename QT, typename KT, int DP, typename Lim>
int launch_dp(const Args& a, Lim limit) {
  using L = Layout<QT, KT, DP>;
  const bool vec = (a.Dk * (int)sizeof(KT)) % 16 == 0 && (a.Dv * (int)sizeof(KT)) % 16 == 0 &&
                   aligned16(a.k_pool) && aligned16(a.v_pool);
  const bool q_vec = (a.Dk * (int)sizeof(QT)) % 16 == 0 && aligned16(a.q);
  const size_t smem = (size_t)L::SMEM + (size_t)a.max_blocks * sizeof(int);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid(a.n_items, a.KVH);
#define RK_ARGS                                                                                 \
  static_cast<const QT*>(a.q), static_cast<const KT*>(a.k_pool),                                \
      static_cast<const KT*>(a.v_pool), static_cast<const int*>(a.block_tables),                \
      static_cast<const int*>(a.work), static_cast<QT*>(a.out), static_cast<float*>(a.ws), a.H, \
      a.KVH, a.Dk, a.Dv, a.nbmax, a.bs, a.score_scale, a.v_scale, vec, q_vec, limit
  // the limit is raised once per instantiation, not per launch
  if constexpr (sizeof(QT) == 2) {
    static const int smem_err = raise_smem_limit(paged_kv_tc_kernel<KT, DP, Lim>);
    if (smem_err != 0) return smem_err;
    paged_kv_tc_kernel<KT, DP, Lim><<<grid, THREADS, smem, a.stream>>>(RK_ARGS);
  } else {
    static const int smem_err = raise_smem_limit(paged_kv_simt_kernel<KT, DP, Lim>);
    if (smem_err != 0) return smem_err;
    paged_kv_simt_kernel<KT, DP, Lim><<<grid, THREADS, smem, a.stream>>>(RK_ARGS);
  }
#undef RK_ARGS
  const int err = (int)cudaGetLastError();
  if (err != 0 || a.n_combine == 0) return err;
  combine_kernel<QT><<<dim3(a.n_combine, a.KVH), THREADS,
                       (size_t)ROWS * a.max_splits * sizeof(float), a.stream>>>(
      static_cast<const float*>(a.ws),
      static_cast<const int*>(a.work) + (size_t)a.n_items * ITEM_COLS, static_cast<QT*>(a.out),
      a.H, a.KVH, a.Dv, a.v_scale);
  return (int)cudaGetLastError();
}

// head dims zero-padded to 64, 128 or 256
template <typename QT, typename KT, typename Lim>
int launch(const Args& a, Lim limit) {
  const int D = a.Dk > a.Dv ? a.Dk : a.Dv;
  if (D <= 64) return launch_dp<QT, KT, 64>(a, limit);
  if (D <= 128) return launch_dp<QT, KT, 128>(a, limit);
  return launch_dp<QT, KT, 256>(a, limit);
}

// An entry's arguments checked, then the launch for the q and pool types
// (q_dtype: 0 float32, 1 bfloat16; kv_dtype: 0 float32, 1 bfloat16, 2 int8)
template <typename Lim>
int launch_typed(const Args& a, int q_dtype, int kv_dtype, Lim limit) {
  if (a.KVH <= 0 || a.H % a.KVH || a.H / a.KVH > ROWS || a.Dk <= 0 || a.Dv <= 0 ||
      a.Dk > MAX_DIM || a.Dv > MAX_DIM || a.bs <= 0 || a.nbmax <= 0 || a.n_items <= 0 ||
      a.n_combine < 0 || a.max_blocks < 1 ||
      (a.n_combine > 0 && (a.ws == nullptr || a.max_splits < 1 || a.max_splits > MAX_SPLITS)))
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch<float, float>(a, limit);
    if (kv_dtype == 1) return launch<float, __nv_bfloat16>(a, limit);
    if (kv_dtype == 2) return launch<float, int8_t>(a, limit);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch<__nv_bfloat16, float>(a, limit);
    if (kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, limit);
    if (kv_dtype == 2) return launch<__nv_bfloat16, int8_t>(a, limit);
  }
  return (int)cudaErrorInvalidValue;
}

// a float32 that arrives as the bits of an int (plain-int C interface)
inline float f32_from_bits(int bits) {
  static_assert(sizeof(float) == sizeof(int), "float32 bits travel as an int");
  float f;
  memcpy(&f, &bits, sizeof(float));
  return f;
}

}  // namespace
