// K5 and K6: flash attention over a dense (B, S, KVH, D) KV cache whose
// entries are int8 Eq.-1 codes or floats.
//
// Replaces the TPU kernels in repro/kernels/flash_attention.py:
//   K5 <- _flash_prefill_kernel (built by make_flash_prefill, reached
//     through kernels/ops.py::flash_attention: the dense-cache prefill and
//     calibration's forward under attn_kernel='flash');
//   K6 <- _flash_decode_kernel (built by make_flash_decode, reached through
//     kernels/ops.py::flash_decode: every decode step of the classic serve
//     path).
// K6 is causal at pos; K5 is causal from q_offset 0 or, with causal
// false, lets every query see every kv row (whisper's encoder and the
// cross-attention's prefill, Sq != Skv).  Scores are scaled by
// 2^-n / sqrt(Dk): the int8 grid's 2^-n of K is folded into the score scale
// and V's into the final 1/l, so no dequantized copy of the cache exists.  A masked score is
// the reference's finite DEFAULT_MASK_VALUE; the running max starts at
// -inf.  The softmax is fp32, K/V values and P are rounded to the q type
// before their products (int8 codes and bf16 values convert exactly), l
// sums the unrounded P, and a row whose l is 0 is written as 0.  Kv rows
// past Sq (causal K5) or past pos (K6) are never read.  K6 reads pos from the
// card (an int32 every block loads, as the TPU kernel takes it by scalar
// prefetch), so one captured launch serves every decode position.
//
// K6, split-KV decode.  Bound on an H100 by the bytes of the cache up to
// pos (KVH * (Dk + Dv) bytes a position for int8: 268 MB at B 4 over 32768
// rows, 0.08 ms at 3.35 TB/s).  One (KV head, batch) pair is far too
// little work for a block (32 of them at the serving batch, on 132 SMs),
// so the host cuts the cache's S_max rows into chunks (flash_attention.py
// ::plan_decode_splits; the host never sees pos) and the grid is (splits
// x row tiles, KVH, B).  A block whose chunk starts past pos reads
// nothing: it writes the empty partial state (l = 0, m at the mask value)
// and exits, and the combine weighs it by 0 (split 0 always holds row 0,
// so the merged maximum is a real score).  A pos outside [0, S_max) reads
// nothing and writes NaN outputs.  A
// block of 4 warps carries the GQA group's query heads (up to 8 rows a
// block) over one chunk; its warps take the chunk's 32-row slices in turn,
// each with its own online-softmax state, so a tile needs no block-wide
// barrier.  A warp stages a slice's K and V rows with 16-byte cp.async
// copies into one of two buffers (the next slice lands while this one is
// scored; rows padded by 16 bytes so the lanes' 16-byte reads fall on
// distinct banks), and the rows are issued before q is staged.  Scores: a
// lane owns one kv row and dots it with the group's q rows, which every
// lane reads as the same shared-memory words (one broadcast a vector); q
// is not held in registers, since a lane walks all of D and would need
// rows x D of them.  int8 codes become floats by the 2^23 magic number (a
// byte permute and a subtraction, exact) rather than the quarter-rate
// integer conversion.  P.V runs over live rows only, a lane owning 4 (Dv <=
// 128) or 8 consecutive head dims, the accumulator in registers.  One
// barrier at the end merges the warps; a block then writes its output
// directly (one split) or fp32 partials (m, l, acc[Dv]) to a workspace the
// wrapper allocated, and flash_combine_kernel merges the splits:
// m = max m_i, l = sum l_i e^(m_i - m), out = sum acc_i e^(m_i - m) / l *
// 2^-n.  Head dims whose rows are not whole 16-byte vectors (or unaligned
// tensors) are staged element by element, zero-padded.  Left: the scores
// are fp32 FMAs on the CUDA cores (the K4 kernel shares the layout).
//
// K5, prefill.  Bound by its operations at a long prefill (4 * Sq * Skv / 2
// * H * D causal FLOPs: 68.7 GFLOP at 4096^2, H 16, D 128; non-causal 4 *
// Sq * Skv * H * D: 46.1 GFLOP at whisper's encoder, B 4, 1500^2, H 20,
// D 64); a launch at the serving path's 32-token prompt.  Built with mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate) and ldmatrix rather than wgmma: the warp-level product
// keeps each warp's 16 rows, their softmax state and the P fragments in
// registers with no warpgroup or descriptor machinery, and reaches the
// time asked of it (PERF.md); wgmma with a TMA ring is the next step.  A
// 256-thread block carries 128 (position, head) rows of one KV head's GQA
// group (64 / groups positions x groups heads), so each K/V tile is loaded
// once for the whole group; each warp owns 16 rows.  Per 64-row kv tile:
// S = Q K^T from ldmatrix fragments of Q and K, the online softmax on the
// accumulator fragments (each row's stats reduced over its 4 lanes), P
// rounded to bf16 and reused in registers as the A operand of O += P V,
// V read by ldmatrix.trans.  Tiles wholly above the diagonal (causal) or
// at/past Skv are skipped, only the diagonal and the tail tile are masked
// per element (non-causal: the tail tile alone, every block reading all
// Skv rows), and q tiles are walked longest first.  bf16 K/V tiles arrive by
// cp.async into a double buffer; int8 (and fp32) K/V are converted to bf16
// on their way into shared memory.  Head dims are zero-padded to 64, 128
// or 256.  Left: no TMA, no wgmma, no warp specialisation.
//
// K5 on fp32 q keeps the CUDA-core kernel (fp32 FMAs from shared memory):
// TF32 would break the 1e-4 tolerance of the fp32 model.  The q type is a
// compile-time dispatch in the same entry.
//
// cudaFuncSetAttribute (dynamic shared memory above 48 KB) runs once per
// kernel instantiation, not per launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_DIM = 256;
constexpr int MAX_SMEM = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t v) { return (float)v; }

// value rounded to the q type (the reference casts K, V and P to it)
template <typename QT>
__device__ __forceinline__ float round_q(float v);
template <>
__device__ __forceinline__ float round_q<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_q<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename QT>
__device__ __forceinline__ QT from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// K / V values need a rounding to the q type only when they are fp32 and
// q is bf16; int8 codes and bf16 values convert exactly
template <typename QT, typename KT>
__device__ __forceinline__ float kv_val(float f) {
  if (sizeof(KT) == 4 && sizeof(QT) == 2) return round_q<QT>(f);
  return f;
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

// one 16-byte global -> shared copy that does not hold a register or wait
// (cp.async); with valid false it writes 16 zero bytes and reads nothing
__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// raise a kernel's dynamic shared-memory limit to the card's; each launch
// template holds the result in a function-local static, so this runs once
// per kernel instantiation, not on every launch
template <typename K>
int raise_smem_limit(K kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
}

// ---------------------------------------------------------------------------
// K5 on fp32 q: prefill, q (B, Sq, H, Dk) over K/V (B, Skv, KVH, D), causal
// from q_offset 0 or non-causal, fp32 FMAs on the CUDA cores.  One
// 256-thread block per (q tile, KV head, batch) carries all `groups` query
// heads of that KV head
// for TQ = 64 / groups positions (64 rows); K/V tiles of 64 rows are
// staged as floats (rows padded by one word); four threads own a row: each
// scores 16 kv rows of the tile, the quad reduces the row max and sum with
// shuffles, and for P.V each owns every fourth head dim of the row.
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int P_ROWS = THREADS / 4;   // q rows a block carries (4 threads a row)
constexpr int P_BK = 64;              // kv rows a tile
constexpr int P_SPT = P_BK / 4;       // scores a thread computes per tile

// NPT: head dims of the output a thread owns (every fourth one), >= Dv / 4.
template <typename QT, typename KT, int NPT>
__global__ void __launch_bounds__(THREADS)
flash_prefill_simt_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                          const KT* __restrict__ v, QT* __restrict__ out, int Sq, int Skv,
                          int H, int KVH, int Dk, int Dv, int tq, float score_scale,
                          float v_scale, float mask_value, bool causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = Dk + 1, ldv = Dv + 1, lds = P_BK + 1;
  float* q_s = reinterpret_cast<float*>(smem);  // [P_ROWS][Dk + 1]
  float* k_s = q_s + P_ROWS * ldk;       // [P_BK][Dk + 1]
  float* v_s = k_s + P_BK * ldk;         // [P_BK][Dv + 1]
  float* p_s = v_s + P_BK * ldv;         // [P_ROWS][P_BK + 1]

  const int groups = H / KVH;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * tq;
  const int tid = threadIdx.x;
  const int row = tid >> 2, quad = tid & 3;
  const int t_row = row / groups;        // this row's position within the tile
  const int qpos = q0 + t_row;
  const bool row_live = t_row < tq && qpos < Sq;
  const int n_rows = tq * groups;

  // stage the q rows: row r is (position q0 + r / groups, head kvh * groups + r % groups)
  for (int idx = tid; idx < P_ROWS * Dk; idx += THREADS) {
    const int r = idx / Dk, d = idx - r * Dk;
    const int pos = q0 + r / groups;
    float val = 0.f;
    if (r < n_rows && pos < Sq) {
      const int h = kvh * groups + r % groups;
      val = to_f(q[(((size_t)b * Sq + pos) * H + h) * Dk + d]);
    }
    q_s[r * ldk + d] = val;
  }

  float m_run = -INFINITY, l_run = 0.f;
  float acc[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) acc[i] = 0.f;

  // causal: tiles that start past the block's last position are skipped
  const int kv_end = causal ? min(Skv, q0 + tq) : Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += P_BK) {
    __syncthreads();   // the previous tile (and the q staging) is done
    for (int idx = tid; idx < P_BK * Dk; idx += THREADS) {
      const int j = idx / Dk, d = idx - j * Dk;
      const int pos = kv0 + j;
      k_s[j * ldk + d] = pos < Skv
          ? round_q<QT>(to_f(k[(((size_t)b * Skv + pos) * KVH + kvh) * Dk + d])) : 0.f;
    }
    for (int idx = tid; idx < P_BK * Dv; idx += THREADS) {
      const int j = idx / Dv, d = idx - j * Dv;
      const int pos = kv0 + j;
      v_s[j * ldv + d] = pos < Skv
          ? round_q<QT>(to_f(v[(((size_t)b * Skv + pos) * KVH + kvh) * Dv + d])) : 0.f;
    }
    __syncthreads();

    // scores of kv rows quad, quad + 4, ... of this tile
    float s[P_SPT];
    float m_tile = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < P_SPT; ++jj) {
      const int j = quad + 4 * jj;
      const float* qr = q_s + row * ldk;
      const float* kr = k_s + j * ldk;
      float dot = 0.f;
      for (int d = 0; d < Dk; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int kpos = kv0 + j;
      const bool live = kpos < Skv && (!causal || kpos <= qpos);
      s[jj] = live ? dot * score_scale : mask_value;
      m_tile = fmaxf(m_tile, s[jj]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_next = fmaxf(m_run, m_tile);
    const float alpha = expf(m_run - m_next);
    float l_tile = 0.f;
    float* pr = p_s + row * lds;
#pragma unroll
    for (int jj = 0; jj < P_SPT; ++jj) {
      const float p = expf(s[jj] - m_next);
      l_tile += p;
      pr[quad + 4 * jj] = round_q<QT>(p);
    }
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 1);
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 2);
    l_run = l_run * alpha + l_tile;
    m_run = m_next;
    __syncwarp();      // the quad's P row is written

#pragma unroll
    for (int i = 0; i < NPT; ++i) acc[i] *= alpha;
    for (int j = 0; j < P_BK; ++j) {
      const float p = pr[j];
      const float* vr = v_s + j * ldv;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int c = quad + 4 * i;
        if (c < Dv) acc[i] = fmaf(p, vr[c], acc[i]);
      }
    }
  }

  if (!row_live) return;
  const float l_inv = l_run == 0.f ? 1.f : 1.f / l_run;
  const int h = kvh * groups + row % groups;
  QT* o = out + (((size_t)b * Sq + qpos) * H + h) * Dv;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int c = quad + 4 * i;
    if (c < Dv) o[c] = from_f<QT>(acc[i] * l_inv * v_scale);
  }
}

// ---------------------------------------------------------------------------
// K5 on bf16 q: the same function on the tensor cores (mma.sync.m16n8k16,
// bf16 x bf16 -> fp32), DP the head dim zero-padded to 64, 128 or 256
// ---------------------------------------------------------------------------
constexpr int TC_THREADS = 256;   // 8 warps
constexpr int TC_ROWS = 128;      // (position, head) rows a block carries: 16 a warp
constexpr int TC_BN = 64;         // kv rows a tile
constexpr int TC_PAD = 8;         // bf16 a shared row is padded by: ldmatrix rows on distinct banks

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage rows [0, n_rows) (n_rows a multiple of 8; warp w takes rows w,
// w + 8, ...) of DP bf16 each into dst (LD = DP + TC_PAD apart); row r's
// source is src_of(r) (nullptr: a zero row), its first `dk` values live,
// the rest zero; `any` is a valid source address (read by no zero
// vector).  vec: the rows are whole 16-byte vectors of the source
// (dk a multiple of 16 / sizeof(KT), 16-byte aligned): bf16 arrives by
// cp.async (the caller commits and waits), int8 and fp32 are loaded 16
// bytes at a time and converted; otherwise value by value.
template <typename KT, int DP, typename SrcOf>
__device__ __forceinline__ void stage_bf16_rows(__nv_bfloat16* dst, int n_rows, int dk, bool vec,
                                                const KT* any, SrcOf src_of) {
  constexpr int LD = DP + TC_PAD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows_w = n_rows / 8;
  if (vec) {
    constexpr int EPC = 16 / sizeof(KT);  // source values a 16-byte vector
    constexpr int CPR = DP / EPC;         // vectors a padded row
    for (int e = lane; e < rows_w * CPR; e += 32) {
      const int r = warp + 8 * (e / CPR), c = e % CPR;
      const KT* src = src_of(r);
      const bool ok = src != nullptr && c * EPC < dk;
      __nv_bfloat16* d = dst + r * LD + c * EPC;
      if constexpr (sizeof(KT) == 2) {
        copy16_async(d, ok ? src + c * EPC : any, ok);
      } else {
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (ok) raw = *reinterpret_cast<const uint4*>(src + c * EPC);
        float f[EPC];
        constexpr int WN = Word<KT>::N;
        Word<KT>::unpack(raw.x, f);
        Word<KT>::unpack(raw.y, f + WN);
        Word<KT>::unpack(raw.z, f + 2 * WN);
        Word<KT>::unpack(raw.w, f + 3 * WN);
        uint32_t packed[EPC / 2];
#pragma unroll
        for (int i = 0; i < EPC / 2; ++i) packed[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
#pragma unroll
        for (int i = 0; i < EPC / 8; ++i)
          reinterpret_cast<uint4*>(d)[i] =
              make_uint4(packed[4 * i], packed[4 * i + 1], packed[4 * i + 2], packed[4 * i + 3]);
        if constexpr (EPC == 4) reinterpret_cast<uint2*>(d)[0] = make_uint2(packed[0], packed[1]);
      }
    }
  } else {
    for (int e = lane; e < rows_w * DP; e += 32) {
      const int r = warp + 8 * (e / DP), c = e % DP;
      const KT* src = src_of(r);
      dst[r * LD + c] = __float2bfloat16_rn(src != nullptr && c < dk ? to_f(src[c]) : 0.f);
    }
  }
}

template <typename KT, int DP>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                        int H, int KVH, int Dk, int Dv, int tq, float score_scale, float v_scale,
                        float mask_value, bool q_vec, bool kv_vec, bool causal) {
  constexpr int LD = DP + TC_PAD;
  constexpr int NT = TC_BN / 8;  // n-tiles of S
  constexpr int OT = DP / 8;     // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [TC_ROWS][LD]
  __nv_bfloat16* k_s = q_s + TC_ROWS * LD;                       // [2][TC_BN][LD]
  __nv_bfloat16* v_s = k_s + 2 * TC_BN * LD;                     // [2][TC_BN][LD]

  const int groups = H / KVH;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * tq;  // longest rows first
  const int tq_live = min(tq, Sq - q0);
  const int n_live = tq_live * groups;               // live rows: 0 .. n_live - 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  // q rows: row r is (position q0 + r / groups, head kvh * groups + r % groups)
  const __nv_bfloat16* q_blk = q + ((size_t)b * Sq + q0) * H * Dk + (size_t)kvh * groups * Dk;
  stage_bf16_rows<__nv_bfloat16, DP>(q_s, TC_ROWS, Dk, q_vec, q, [&](int r) {
    return r < n_live ? q_blk + ((size_t)(r / groups) * H + r % groups) * Dk : nullptr;
  });
  const size_t row_k = (size_t)KVH * Dk, row_v = (size_t)KVH * Dv;
  const KT* k_b = k + (size_t)b * Skv * row_k + (size_t)kvh * Dk;
  const KT* v_b = v + (size_t)b * Skv * row_v + (size_t)kvh * Dv;
  // rows no live query sees are never read (non-causal: every row is seen)
  const int kv_end = causal ? min(Skv, q0 + tq_live) : Skv;
  const int n_tiles = (kv_end + TC_BN - 1) / TC_BN;
  auto stage_kv = [&](int tile) {
    const int kv0 = tile * TC_BN;
    __nv_bfloat16* kd = k_s + (tile & 1) * TC_BN * LD;
    __nv_bfloat16* vd = v_s + (tile & 1) * TC_BN * LD;
    stage_bf16_rows<KT, DP>(kd, TC_BN, Dk, kv_vec, k, [&](int r) {
      return kv0 + r < kv_end ? k_b + (size_t)(kv0 + r) * row_k : nullptr;
    });
    stage_bf16_rows<KT, DP>(vd, TC_BN, Dv, kv_vec, v, [&](int r) {
      return kv0 + r < kv_end ? v_b + (size_t)(kv0 + r) * row_v : nullptr;
    });
    copies_commit();
  };
  if (n_tiles > 0) stage_kv(0);

  // this thread's two rows of the warp's 16: g and g + 8
  const int w0 = warp * 16;
  const bool warp_live = w0 < n_live;
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qp[i] = q0 + (w0 + g + 8 * i) / groups;
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      stage_kv(tile + 1);
      copies_wait<1>();
    } else {
      copies_wait<0>();
    }
    __syncthreads();  // tile `tile` (and q) visible to every warp
    const int kv0 = tile * TC_BN;
    const __nv_bfloat16* ks = k_s + (tile & 1) * TC_BN * LD;
    const __nv_bfloat16* vs = v_s + (tile & 1) * TC_BN * LD;
    if (warp_live) {
      // S = Q K^T over the padded head dim
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        uint32_t a[4];
        ldsm_x4(a, q_s + (w0 + lane % 16) * LD + kc * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, ks + (np * 16 + (lane / 16) * 8 + lane % 8) * LD + kc * 16 +
                          ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      // scale; mask only the tile that crosses the diagonal or Skv
      const bool masked = (causal && kv0 + TC_BN - 1 > q0) || kv0 + TC_BN > Skv;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * score_scale;
          if (masked) {
            const int kp = kv0 + n * 8 + 2 * t4 + (e & 1);
            if (!(kp < Skv && (!causal || kp <= qp[e / 2]))) x = mask_value;
          }
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        const float m_next = fmaxf(m_run[i], mx[i]);
        alpha[i] = exp2f((m_run[i] - m_next) * LOG2E);
        m_run[i] = m_next;
        l_run[i] *= alpha[i];  // this lane's share of the row sum (reduced at the end)
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f((s[n][e] - m_run[e / 2]) * LOG2E);
          l_run[e / 2] += p;
          s[n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < OT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
      // O += P V: P rounded to bf16 is the A operand straight from S's fragments
#pragma unroll
      for (int kk = 0; kk < TC_BN / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + dp * 16 +
                                (lane / 16) * 8);
          mma_bf16(o[2 * dp], a, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  copies_commit();  // no copy is left in flight (Skv == 0 runs no tile)
  copies_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const int r = w0 + g + 8 * i;
    if (r >= n_live) continue;
    const float scale = (l == 0.f ? 1.f : 1.f / l) * v_scale;
    const int h = kvh * groups + r % groups;
    __nv_bfloat16* orow = out + (((size_t)b * Sq + qp[i]) * H + h) * Dv;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      const int d = n * 8 + 2 * t4;
      const float x0 = o[n][2 * i] * scale, x1 = o[n][2 * i + 1] * scale;
      if (d + 1 < Dv && (Dv & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < Dv) orow[d] = __float2bfloat16_rn(x0);
        if (d + 1 < Dv) orow[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6: split-KV decode, q (B, 1, H, Dk) over the cache (B, S_max, KVH, D), kv
// rows <= pos; block (split, row tile) of grid x carries RB of the group's
// query heads over kv rows [split * chunk, min((split + 1) * chunk, pos + 1))
// ---------------------------------------------------------------------------
constexpr int D_SLICE = 32;      // kv rows a warp scores per pass: one a lane
constexpr int D_WARPS = 4;       // warps a block, at most
constexpr int D_MAX_GROUPS = 16; // query heads per KV head
constexpr int D_MAX_RB = 8;      // of them a block carries, at most

// shared-memory layout, shared by the kernel and the launch
struct DecodeLayout {
  int vk, vv;              // 16-byte vectors a staged K / V row
  int stride_k, stride_v;  // bytes a staged row (padded by 16)
  size_t q_bytes, warp_bytes, merge_bytes;
  __host__ __device__ DecodeLayout(int Dk, int Dv, int kv_size, int n_warps, int RB) {
    vk = (Dk * kv_size + 15) / 16;
    vv = (Dv * kv_size + 15) / 16;
    stride_k = vk * 16 + 16;
    stride_v = vv * 16 + 16;
    q_bytes = (size_t)RB * (vk * 16 / kv_size) * sizeof(float);
    // two (K, V) staging buffers and the slice's P
    warp_bytes = 2 * (size_t)D_SLICE * (stride_k + stride_v) + (size_t)RB * D_SLICE * sizeof(float);
    merge_bytes = (size_t)n_warps * RB * (Dv + 2) * sizeof(float);
  }
  __host__ __device__ size_t total(int n_warps) const {
    const size_t stage = (size_t)n_warps * warp_bytes;
    return q_bytes + (stage > merge_bytes ? stage : merge_bytes);
  }
};

// stage kv rows [j0, j0 + D_SLICE) of one cache (row r at base + r * row,
// `vecs` 16-byte vectors of `n_val` live values) into dst (rows stride
// bytes apart); rows at or past end are zero.  vec: 16-byte cp.async copies
// (the caller commits and waits); otherwise value by value, zero-padded.
template <typename KT>
__device__ __forceinline__ void stage_slice_rows(unsigned char* dst, int stride, const KT* base,
                                                 size_t row, int vecs, int n_val, int j0, int end,
                                                 bool vec, int lane) {
  auto copy = [&](int rw, int cv) {
    const bool ok = j0 + rw < end;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(base + (size_t)(j0 + rw) * row);
    copy16_async(dst + rw * stride + 16 * cv, ok ? src + 16 * cv : (const void*)base, ok);
  };
  if (vec && 32 % vecs == 0) {  // a lane keeps its vector of the row: one division a call
    const int step = 32 / vecs, rw0 = lane / vecs, cv = lane - rw0 * vecs;
    for (int rw = rw0; rw < D_SLICE; rw += step) copy(rw, cv);
  } else if (vec) {
    for (int e = lane; e < D_SLICE * vecs; e += 32) copy(e / vecs, e % vecs);
  } else {
    const int n_pad = vecs * 16 / (int)sizeof(KT);
    for (int rw = 0; rw < D_SLICE; ++rw) {
      const bool ok = j0 + rw < end;
      const KT* src = base + (size_t)(j0 + rw) * row;
      KT* d = reinterpret_cast<KT*>(dst + rw * stride);
      for (int c = lane; c < n_pad; c += 32) d[c] = ok && c < n_val ? src[c] : KT{};
    }
  }
}

template <typename QT, typename KT, int DPL, int RB>
__global__ void __launch_bounds__(D_WARPS * 32)
flash_decode_split_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                          const KT* __restrict__ v, QT* __restrict__ out, float* __restrict__ ws,
                          const int* __restrict__ pos_ptr, int S_max, int H, int KVH, int Dk,
                          int Dv, int splits, int chunk, float score_scale, float v_scale,
                          float mask_value, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_warps = blockDim.x / 32;
  const DecodeLayout lay(Dk, Dv, (int)sizeof(KT), n_warps, RB);
  constexpr int EPV = 16 / sizeof(KT);  // values a 16-byte vector holds
  const int dk_pad = lay.vk * EPV;
  float* qs = reinterpret_cast<float*>(smem);  // [RB][dk_pad]
  unsigned char* stage = smem + lay.q_bytes;

  const int split = blockIdx.x % splits, tile = blockIdx.x / splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int groups = H / KVH;
  const int r0 = tile * RB;
  const int nr = min(RB, groups - r0);  // live rows of this block (>= 1)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pos = __ldg(pos_ptr);
  const bool bad_pos = pos < 0 || pos >= S_max;
  const int c0 = split * chunk, c1 = bad_pos ? c0 : min(c0 + chunk, pos + 1);
  if (c1 <= c0) {  // no row of this chunk is visible: nothing to read
    for (int e = threadIdx.x; e < nr * 2; e += blockDim.x) {
      const int r = e / 2, h = kvh * groups + r0 + r;
      if (splits > 1) {
        float* prow =
            ws + ((((size_t)b * KVH + kvh) * splits + split) * groups + r0 + r) * (Dv + 2);
        prow[e % 2] = e % 2 == 0 ? mask_value : 0.f;
      } else {
        for (int d = e % 2; d < Dv; d += 2) out[((size_t)b * H + h) * Dv + d] = from_f<QT>(NAN);
      }
    }
    return;
  }
  const int n_slices = (c1 - c0 + D_SLICE - 1) / D_SLICE;

  const size_t row_k = (size_t)KVH * Dk, row_v = (size_t)KVH * Dv;
  const KT* kb = k + (size_t)b * S_max * row_k + (size_t)kvh * Dk;
  const KT* vb = v + (size_t)b * S_max * row_v + (size_t)kvh * Dv;
  const size_t buf_bytes = (size_t)D_SLICE * (lay.stride_k + lay.stride_v);
  unsigned char* wbuf = stage + (size_t)warp * lay.warp_bytes;  // [2][K rows, V rows]
  float* ps = reinterpret_cast<float*>(wbuf + 2 * buf_bytes);
  auto stage_slice = [&](int sl, int buf) {
    unsigned char* kd = wbuf + buf * buf_bytes;
    const int j0 = c0 + sl * D_SLICE;
    stage_slice_rows(kd, lay.stride_k, kb, row_k, lay.vk, Dk, j0, c1, vec, lane);
    stage_slice_rows(kd + (size_t)D_SLICE * lay.stride_k, lay.stride_v, vb, row_v, lay.vv, Dv, j0,
                     c1, vec, lane);
    copies_commit();
  };
  // the first slice's rows go out before q is staged
  if (warp < n_slices) stage_slice(warp, 0);
  for (int r = warp; r < RB; r += n_warps) {
    const QT* qr = q + ((size_t)b * H + kvh * groups + r0 + r) * Dk;
    for (int d = lane; d < dk_pad; d += 32)
      qs[r * dk_pad + d] = r < nr && d < Dk ? to_f(qr[d]) : 0.f;
  }
  __syncthreads();

  float m[RB], l[RB], acc[RB][DPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const bool own_dims = lane * DPL < Dv;

  for (int sl = warp, it = 0; sl < n_slices; sl += n_warps, ++it) {
    // the next slice's copies go out before this one is scored
    if (sl + n_warps < n_slices) {
      stage_slice(sl + n_warps, (it + 1) & 1);
      copies_wait<1>();
    } else {
      copies_wait<0>();
    }
    __syncwarp();
    const unsigned char* ks = wbuf + (it & 1) * buf_bytes;
    const unsigned char* vs = ks + (size_t)D_SLICE * lay.stride_k;
    const int j0 = c0 + sl * D_SLICE;
    const bool row_ok = j0 + lane < c1;  // the kv row this lane scores (all <= pos)

    // scores: this lane's kv row against the block's query rows
    float dot[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) dot[r] = 0.f;
    const unsigned char* kr = ks + lane * lay.stride_k;
    for (int cv = 0; cv < lay.vk; ++cv) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + 16 * cv);
      float kf[EPV];
      constexpr int WN = Word<KT>::N;
      Word<KT>::unpack(raw.x, kf);
      Word<KT>::unpack(raw.y, kf + WN);
      Word<KT>::unpack(raw.z, kf + 2 * WN);
      Word<KT>::unpack(raw.w, kf + 3 * WN);
#pragma unroll
      for (int i = 0; i < EPV; ++i) kf[i] = kv_val<QT, KT>(kf[i]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          const float4* qv = reinterpret_cast<const float4*>(qs + r * dk_pad + cv * EPV);
#pragma unroll
          for (int i4 = 0; i4 < EPV / 4; ++i4) {
            const float4 q4 = qv[i4];
            dot[r] += q4.x * kf[4 * i4] + q4.y * kf[4 * i4 + 1] + q4.z * kf[4 * i4 + 2] +
                      q4.w * kf[4 * i4 + 3];
          }
        }
      }
    }

    // online softmax update; the slice holds at least one live row, so the
    // tile max is a real score and a masked row's p is exactly 0
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float p = 0.f;
      if (r < nr) {
        const float s = row_ok ? dot[r] * score_scale : mask_value;
        const float m_new = fmaxf(m[r], warp_max(s));
        const float alpha = expf(m[r] - m_new);
        p = expf(s - m_new);
        l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
        m[r] = m_new;
      }
      ps[r * D_SLICE + lane] = round_q<QT>(p);
    }
    __syncwarp();

    // P.V over the slice's live rows: this lane's DPL head dims, four kv
    // rows at a time (P is 0 past the live rows, whose V rows are zero)
    const int jn = min(D_SLICE, c1 - j0);
    for (int jj = 0; jj < jn; jj += 4) {
      float vf[4][DPL];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned char* vr = vs + (jj + t) * lay.stride_v + lane * DPL * sizeof(KT);
#pragma unroll
        for (int w = 0; w < DPL / Word<KT>::N; ++w) {
          const uint32_t word = own_dims ? reinterpret_cast<const uint32_t*>(vr)[w] : 0u;
          Word<KT>::unpack(word, vf[t] + w * Word<KT>::N);
        }
#pragma unroll
        for (int i = 0; i < DPL; ++i) vf[t][i] = kv_val<QT, KT>(vf[t][i]);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          const float4 p4 = *reinterpret_cast<const float4*>(ps + r * D_SLICE + jj);
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            acc[r][i] += p4.x * vf[0][i] + p4.y * vf[1][i] + p4.z * vf[2][i] + p4.w * vf[3][i];
        }
      }
    }
    __syncwarp();  // this buffer is consumed before the slice after next lands in it
  }

  // merge the warps' softmax states (the staging area is reused)
  __syncthreads();
  float* ml = reinterpret_cast<float*>(stage);  // [n_warps][RB][2]: m, l
  float* accs = ml + n_warps * RB * 2;          // [n_warps][RB][Dv]
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (lane == 0) {
      ml[(warp * RB + r) * 2] = m[r];
      ml[(warp * RB + r) * 2 + 1] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (lane * DPL + i < Dv) accs[((size_t)warp * RB + r) * Dv + lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  for (int r = warp; r < nr; r += n_warps) {
    // lane w < n_warps holds warp w's weight exp(m_w - m) for this row
    const float mw = lane < n_warps ? ml[(lane * RB + r) * 2] : -INFINITY;
    const float mt = warp_max(mw);
    const float scale_w = mw == -INFINITY ? 0.f : expf(mw - mt);
    const float lt = warp_sum(lane < n_warps ? ml[(lane * RB + r) * 2 + 1] * scale_w : 0.f);
    float sw[D_WARPS];
#pragma unroll
    for (int w = 0; w < D_WARPS; ++w) sw[w] = __shfl_sync(FULL, scale_w, w);
    const int h = kvh * groups + r0 + r;
    // one split: the output; else this split's partials (m, l, acc)
    QT* orow = out + ((size_t)b * H + h) * Dv;
    float* prow = ws + ((((size_t)b * KVH + kvh) * splits + split) * groups + r0 + r) * (Dv + 2);
    const float l_inv = lt == 0.f ? 1.f : 1.f / lt;
    if (splits > 1 && lane == 0) {
      prow[0] = mt;
      prow[1] = lt;
    }
    for (int d = lane; d < Dv; d += 32) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < D_WARPS; ++w)
        if (w < n_warps) o += accs[((size_t)w * RB + r) * Dv + d] * sw[w];
      if (splits > 1)
        prow[2 + d] = o;
      else
        orow[d] = from_f<QT>(o * l_inv * v_scale);
    }
  }
}

// K6's second pass: one block per (head, batch) merges the splits'
// partials; an empty split (l = 0) weighs 0 and its acc is not read
template <typename QT>
__global__ void __launch_bounds__(128)
flash_combine_kernel(const float* __restrict__ ws, QT* __restrict__ out,
                     const int* __restrict__ pos_ptr, int S_max, int H, int KVH, int Dv,
                     int splits, float v_scale) {
  extern __shared__ float wgt[];  // [splits]: e^(m_i - m)
  __shared__ float red[2];
  const int h = blockIdx.x, b = blockIdx.y;
  const int groups = H / KVH, kvh = h / groups, g = h % groups;
  const size_t stride = (size_t)groups * (Dv + 2);
  const float* base = ws + (((size_t)b * KVH + kvh) * splits * groups + g) * (Dv + 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
    float mt = -INFINITY;
    for (int i = lane; i < splits; i += 32) mt = fmaxf(mt, base[i * stride]);
    mt = warp_max(mt);
    float lt = 0.f;
    for (int i = lane; i < splits; i += 32) {
      const float mi = base[i * stride], li = base[i * stride + 1];
      const float w = li == 0.f || mi == -INFINITY ? 0.f : expf(mi - mt);
      wgt[i] = w;
      lt += li * w;
    }
    lt = warp_sum(lt);
    if (lane == 0) red[0] = lt == 0.f ? 1.f : 1.f / lt;
  }
  __syncthreads();
  const int pos = __ldg(pos_ptr);
  const float scale = pos < 0 || pos >= S_max ? NAN : red[0] * v_scale;
  QT* orow = out + ((size_t)b * H + h) * Dv;
  for (int d = threadIdx.x; d < Dv; d += blockDim.x) {
    float o = 0.f;
    for (int i = 0; i < splits; ++i)
      if (wgt[i] != 0.f) o += base[i * stride + 2 + d] * wgt[i];
    orow[d] = from_f<QT>(o * scale);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename QT, typename KT, int NPT>
int launch_prefill_simt(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Skv, int H, int KVH, int Dk, int Dv, float score_scale,
                        float v_scale, float mask_value, bool causal, cudaStream_t stream) {
  auto kernel = flash_prefill_simt_kernel<QT, KT, NPT>;
  static const int smem_err = raise_smem_limit(kernel);
  if (smem_err != 0) return smem_err;
  const size_t smem = ((size_t)P_ROWS * (Dk + 1) + (size_t)P_BK * (Dk + 1) +
                       (size_t)P_BK * (Dv + 1) + (size_t)P_ROWS * (P_BK + 1)) * sizeof(float);
  const int tq = P_ROWS / (H / KVH);
  const dim3 grid((Sq + tq - 1) / tq, KVH, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<QT*>(out), Sq, Skv, H, KVH, Dk, Dv, tq, score_scale, v_scale, mask_value,
      causal);
  return (int)cudaGetLastError();
}

template <typename KT, int DP>
int launch_prefill_tc(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                      int Skv, int H, int KVH, int Dk, int Dv, float score_scale, float v_scale,
                      float mask_value, bool causal, cudaStream_t stream) {
  auto kernel = flash_prefill_tc_kernel<KT, DP>;
  static const int smem_err = raise_smem_limit(kernel);
  if (smem_err != 0) return smem_err;
  const size_t smem = (size_t)(TC_ROWS + 4 * TC_BN) * (DP + TC_PAD) * sizeof(__nv_bfloat16);
  const int tq = TC_ROWS / (H / KVH);
  const dim3 grid((Sq + tq - 1) / tq, KVH, B);
  const bool q_vec = Dk % 8 == 0 && aligned16(q);
  constexpr int EPC = 16 / sizeof(KT);
  const bool kv_vec = Dk % EPC == 0 && Dv % EPC == 0 && aligned16(k) && aligned16(v);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<__nv_bfloat16*>(out), Sq, Skv, H, KVH, Dk, Dv, tq, score_scale, v_scale,
      mask_value, q_vec, kv_vec, causal);
  return (int)cudaGetLastError();
}

// q type dispatch at compile time: bf16 q on the tensor cores, fp32 q on
// the CUDA cores
template <typename QT, typename KT>
int launch_prefill(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Skv, int H, int KVH, int Dk, int Dv, float score_scale, float v_scale,
                   float mask_value, bool causal, cudaStream_t stream) {
#define FP_ARGS q, k, v, out, B, Sq, Skv, H, KVH, Dk, Dv, score_scale, v_scale, mask_value, causal, stream
  const int D = Dk > Dv ? Dk : Dv;
  if constexpr (sizeof(QT) == 2) {
    if (D <= 64) return launch_prefill_tc<KT, 64>(FP_ARGS);
    if (D <= 128) return launch_prefill_tc<KT, 128>(FP_ARGS);
    return launch_prefill_tc<KT, 256>(FP_ARGS);
  } else {
    if (Dv <= 64) return launch_prefill_simt<QT, KT, 16>(FP_ARGS);
    if (Dv <= 128) return launch_prefill_simt<QT, KT, 32>(FP_ARGS);
    return launch_prefill_simt<QT, KT, 64>(FP_ARGS);
  }
#undef FP_ARGS
}

template <typename QT, typename KT, int DPL, int RB>
int launch_decode_rb(const void* q, const void* k, const void* v, void* out, void* ws,
                     const int* pos, int B, int S_max, int H, int KVH, int Dk, int Dv, int splits,
                     int chunk, float score_scale, float v_scale, float mask_value,
                     cudaStream_t stream) {
  auto kernel = flash_decode_split_kernel<QT, KT, DPL, RB>;
  static const int smem_err = raise_smem_limit(kernel);
  if (smem_err != 0) return smem_err;
  int n_warps = D_WARPS;
  while (n_warps > 1 && DecodeLayout(Dk, Dv, (int)sizeof(KT), n_warps, RB).total(n_warps) > MAX_SMEM)
    --n_warps;
  const size_t smem = DecodeLayout(Dk, Dv, (int)sizeof(KT), n_warps, RB).total(n_warps);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const bool vec = (Dk * (int)sizeof(KT)) % 16 == 0 && (Dv * (int)sizeof(KT)) % 16 == 0 &&
                   aligned16(k) && aligned16(v);
  const int n_tiles = (H / KVH + RB - 1) / RB;
  const dim3 grid(splits * n_tiles, KVH, B);
  kernel<<<grid, n_warps * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<QT*>(out), static_cast<float*>(ws), pos, S_max, H, KVH, Dk, Dv, splits, chunk,
      score_scale, v_scale, mask_value, vec);
  int err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  flash_combine_kernel<QT><<<dim3(H, B), 128, splits * sizeof(float), stream>>>(
      static_cast<const float*>(ws), static_cast<QT*>(out), pos, S_max, H, KVH, Dv, splits,
      v_scale);
  return (int)cudaGetLastError();
}

// rows a block carries: the GQA group, up to 8 (a larger group is cut into
// row tiles, each reading its chunk of the cache)
template <typename QT, typename KT, int DPL>
int launch_decode_groups(const void* q, const void* k, const void* v, void* out, void* ws,
                         const int* pos, int B, int S_max, int H, int KVH, int Dk, int Dv,
                         int splits, int chunk, float score_scale, float v_scale,
                         float mask_value, cudaStream_t stream) {
#define FD_ARGS \
  q, k, v, out, ws, pos, B, S_max, H, KVH, Dk, Dv, splits, chunk, score_scale, v_scale, mask_value, stream
  const int groups = H / KVH;
  if (groups <= 2) return launch_decode_rb<QT, KT, DPL, 2>(FD_ARGS);
  if (groups <= 4) return launch_decode_rb<QT, KT, DPL, 4>(FD_ARGS);
  return launch_decode_rb<QT, KT, DPL, D_MAX_RB>(FD_ARGS);
}

template <typename QT, typename KT>
int launch_decode(const void* q, const void* k, const void* v, void* out, void* ws,
                  const int* pos, int B, int S_max, int H, int KVH, int Dk, int Dv, int splits,
                  int chunk, float score_scale, float v_scale, float mask_value,
                  cudaStream_t stream) {
  if (Dv <= 128) return launch_decode_groups<QT, KT, 4>(FD_ARGS);
  return launch_decode_groups<QT, KT, 8>(FD_ARGS);
#undef FD_ARGS
}

float from_bits(int bits) {
  float f;
  static_assert(sizeof(float) == sizeof(int), "float32 bits travel as an int");
  memcpy(&f, &bits, sizeof(float));
  return f;
}

}  // namespace

// C entries.  q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32,
// 1 bfloat16, 2 int8 codes on the 2^-kv_frac_bits grid (0 for floats).
// K5's causal: 1 masks kv rows past each query's position, 0 none.
// score_scale and mask_value arrive as the bits of float32s.  Every tensor
// is contiguous; out (and K6's workspace) is allocated by the caller.  Each
// returns cudaGetLastError() after each of its launches (0 on success).
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* out,
                                    int B, int Sq, int Skv, int H, int KVH, int Dk, int Dv,
                                    int score_scale_bits, int kv_frac_bits, int mask_bits,
                                    int q_dtype, int kv_dtype, int causal, void* stream) {
  if (KVH <= 0 || H % KVH || H / KVH > P_ROWS || Dk <= 0 || Dv <= 0 || Dk > MAX_DIM ||
      Dv > MAX_DIM)
    return (int)cudaErrorInvalidValue;
  const float score_scale = from_bits(score_scale_bits), mask_value = from_bits(mask_bits);
  const float v_scale = ldexpf(1.f, -kv_frac_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool is_causal = causal != 0;
#define FP_ARGS \
  q, k, v, out, B, Sq, Skv, H, KVH, Dk, Dv, score_scale, v_scale, mask_value, is_causal, st
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_prefill<float, float>(FP_ARGS);
    if (kv_dtype == 1) return launch_prefill<float, __nv_bfloat16>(FP_ARGS);
    if (kv_dtype == 2) return launch_prefill<float, int8_t>(FP_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_prefill<__nv_bfloat16, float>(FP_ARGS);
    if (kv_dtype == 1) return launch_prefill<__nv_bfloat16, __nv_bfloat16>(FP_ARGS);
    if (kv_dtype == 2) return launch_prefill<__nv_bfloat16, int8_t>(FP_ARGS);
  }
#undef FP_ARGS
  return (int)cudaErrorInvalidValue;
}

// K6: the cache's S_max rows in `splits` chunks of `chunk` rows (the last
// shorter, none empty); pos is one int32 on the card, read by every block;
// ws holds (B, KVH, splits, H / KVH, Dv + 2) floats when splits > 1
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, void* out,
                                   void* ws, const int* pos, int B, int S_max, int H, int KVH,
                                   int Dk, int Dv, int splits, int chunk, int score_scale_bits,
                                   int kv_frac_bits, int mask_bits, int q_dtype, int kv_dtype,
                                   void* stream) {
  if (KVH <= 0 || H % KVH || H / KVH > D_MAX_GROUPS || Dk <= 0 || Dv <= 0 || Dk > MAX_DIM ||
      Dv > MAX_DIM || S_max <= 0 || pos == nullptr || splits <= 0 || chunk <= 0 ||
      (long long)(splits - 1) * chunk >= S_max || (long long)splits * chunk < S_max ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const float score_scale = from_bits(score_scale_bits), mask_value = from_bits(mask_bits);
  const float v_scale = ldexpf(1.f, -kv_frac_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_ARGS \
  q, k, v, out, ws, pos, B, S_max, H, KVH, Dk, Dv, splits, chunk, score_scale, v_scale, mask_value, st
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_decode<float, float>(FD_ARGS);
    if (kv_dtype == 1) return launch_decode<float, __nv_bfloat16>(FD_ARGS);
    if (kv_dtype == 2) return launch_decode<float, int8_t>(FD_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_decode<__nv_bfloat16, float>(FD_ARGS);
    if (kv_dtype == 1) return launch_decode<__nv_bfloat16, __nv_bfloat16>(FD_ARGS);
    if (kv_dtype == 2) return launch_decode<__nv_bfloat16, int8_t>(FD_ARGS);
  }
#undef FD_ARGS
  return (int)cudaErrorInvalidValue;
}
