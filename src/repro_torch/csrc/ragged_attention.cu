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
// (int8 codes: KVH * (Dk + Dv) bytes per visible position), plus q and out.
// At the serving sizes that is well under a megabyte a layer, so a launch
// is bound by its fixed cost, not by memory or arithmetic.
//
// Design (simple first).  One 128-thread block per (sequence, KV head,
// q tile) carries all `groups` query heads of that KV head, so each KV page
// is read once for the whole GQA group.  The block loads its own
// descriptors, walks block_tables[s, :] by pointer and stops at kv_len
// (pages past it are never read).  Each page is staged in shared memory,
// converted to the q type as the reference does (int8 codes and bf16 values
// convert exactly); each warp owns up to four (token, head) rows.  Per page
// and row, lanes score one kv row each (a full-depth dot product against
// the staged q row), the page max and sum reduce across the warp, and an
// fp32 online softmax rescales the running sum and accumulator; for P.V the
// lanes switch to head dims and P, rounded to the q type, is broadcast one
// kv row at a time.  Kv rows past a row's causal limit are not scored (the
// reference's masked scores contribute exactly 0).  The int8 grid 2^-n is
// folded into the score scale and into the final 1/l.  A block writes only
// its own rows; the wrapper zero-fills the output, so rows no descriptor
// covers stay exactly 0.  The Pallas design's whole-stream output block
// with read-modify-write windows is not carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // (token, head) rows per block
constexpr int DPL = 8;                       // head dims per lane: Dk, Dv <= 256
constexpr int MAX_BS = 128;                  // kv rows per pool block

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

template <typename QT, typename KT>
__global__ void __launch_bounds__(WARPS * 32)
ragged_paged_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                              const KT* __restrict__ v_pool, const int* __restrict__ block_tables,
                              const int* __restrict__ q_start, const int* __restrict__ q_len,
                              const int* __restrict__ kv_len, QT* __restrict__ out, int H,
                              int KVH, int Dk, int Dv, int nbmax, int bs, int tq,
                              float score_scale, float v_scale) {
  // shared: q rows [ROWS][Dk], K page [bs][Dk + 1] (padded: lanes read
  // different kv rows at one head dim), V page [bs][Dv]
  extern __shared__ float smem[];
  float* qsm = smem;
  float* ks = qsm + ROWS * Dk;
  float* vs = ks + bs * (Dk + 1);

  const int s = blockIdx.x, kh = blockIdx.y, tile = blockIdx.z;
  const int ql = q_len[s];
  if (ql <= 0 || tile * tq >= ql) return;  // uniform across the block
  const int qs = q_start[s], kl = kv_len[s];
  const int groups = H / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float acc[ROWS_PER_WARP][DPL];
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP];
  int pos[ROWS_PER_WARP];
  size_t orow[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp + WARPS * i;
    const int local = tile * tq + r / groups;
    const int h = kh * groups + r % groups;
    const bool valid = r < tq * groups && local < ql;
    pos[i] = valid ? kl - ql + local : -1;
    orow[i] = valid ? ((size_t)(qs + local) * H + h) : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
    for (int d = lane; d < Dk; d += 32) qsm[r * Dk + d] = valid ? to_f(q[orow[i] * Dk + d]) : 0.f;
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj) acc[i][jj] = 0.f;
  }

  const int n_pages = min((kl + bs - 1) / bs, nbmax);
  for (int ti = 0; ti < n_pages; ++ti) {
    const size_t base = (size_t)block_tables[(size_t)s * nbmax + ti] * bs;
    __syncthreads();  // q staged / the previous page consumed
    for (int e = threadIdx.x; e < bs * Dk; e += blockDim.x) {
      const int j = e / Dk, d = e % Dk;
      ks[j * (Dk + 1) + d] = round_q<QT>(to_f(k_pool[((base + j) * KVH + kh) * Dk + d]));
    }
    for (int e = threadIdx.x; e < bs * Dv; e += blockDim.x) {
      const int j = e / Dv, d = e % Dv;
      vs[e] = round_q<QT>(to_f(v_pool[((base + j) * KVH + kh) * Dv + d]));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int first = ti * bs;
      if (pos[i] < first) continue;  // warp-uniform: nothing visible here
      const int r = warp + WARPS * i;
      const int jmax = min(bs, pos[i] - first + 1);  // visible kv rows
      const float* qr = qsm + r * Dk;
      // lanes own kv rows: each lane scores the page rows lane, lane + 32, ...
      float page_max = -INFINITY;
      float sc[MAX_BS / 32];
#pragma unroll
      for (int jc = 0; jc < MAX_BS / 32; ++jc) {
        const int j = lane + 32 * jc;
        sc[jc] = -INFINITY;
        if (j < jmax) {
          const float* kr = ks + j * (Dk + 1);
          float dot = 0.f;
          for (int d = 0; d < Dk; ++d) dot += qr[d] * kr[d];
          sc[jc] = dot * score_scale;
          page_max = fmaxf(page_max, sc[jc]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        page_max = fmaxf(page_max, __shfl_xor_sync(0xffffffffu, page_max, off));
      const float m_new = fmaxf(m[i], page_max);
      const float alpha = expf(m[i] - m_new);
      float p_sum = 0.f;
      float p[MAX_BS / 32];
#pragma unroll
      for (int jc = 0; jc < MAX_BS / 32; ++jc) {
        p[jc] = lane + 32 * jc < jmax ? expf(sc[jc] - m_new) : 0.f;
        p_sum += p[jc];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      l[i] = l[i] * alpha + p_sum;
#pragma unroll
      for (int jj = 0; jj < DPL; ++jj) acc[i][jj] *= alpha;
      // P.V with lanes back on head dims; P rounded to the q type first
#pragma unroll
      for (int jc = 0; jc < MAX_BS / 32; ++jc) {
        const float pq_own = round_q<QT>(p[jc]);
        const int jn = min(32, jmax - 32 * jc);
        for (int jl = 0; jl < jn; ++jl) {
          const float pq = __shfl_sync(0xffffffffu, pq_own, jl);
          const float* vr = vs + (32 * jc + jl) * Dv;
#pragma unroll
          for (int jj = 0; jj < DPL; ++jj) {
            const int d = lane + 32 * jj;
            if (d < Dv) acc[i][jj] += pq * vr[d];
          }
        }
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    if (pos[i] < 0) continue;
    const float l_inv = l[i] == 0.f ? 1.f : 1.f / l[i];
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj) {
      const int d = lane + 32 * jj;
      if (d < Dv) out[orow[i] * Dv + d] = from_f<QT>(acc[i][jj] * l_inv * v_scale);
    }
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* bt,
           const void* q_start, const void* q_len, const void* kv_len, void* out, int H, int KVH,
           int Dk, int Dv, int S, int nbmax, int bs, int n_tiles, int tq, float score_scale,
           float v_scale, cudaStream_t stream) {
  auto kernel = ragged_paged_attention_kernel<QT, KT>;
  const size_t smem = ((size_t)ROWS * Dk + (size_t)bs * (Dk + 1 + Dv)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(S, KVH, n_tiles);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool), static_cast<const KT*>(v_pool),
      static_cast<const int*>(bt), static_cast<const int*>(q_start),
      static_cast<const int*>(q_len), static_cast<const int*>(kv_len), static_cast<QT*>(out), H,
      KVH, Dk, Dv, nbmax, bs, tq, score_scale, v_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry.  q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32,
// 1 bfloat16, 2 int8 codes on the 2^-kv_frac_bits grid (0 for float pools).
// score_scale arrives as the bits of a float32 (plain-int C interface).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ragged_paged_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* block_tables,
                                             const void* q_start, const void* q_len,
                                             const void* kv_len, void* out, int H, int KVH,
                                             int Dk, int Dv, int S, int nbmax, int bs,
                                             int n_tiles, int tq, int score_scale_bits,
                                             int kv_frac_bits, int q_dtype, int kv_dtype,
                                             void* stream) {
  float score_scale;
  static_assert(sizeof(float) == sizeof(int), "float32 bits travel as an int");
  memcpy(&score_scale, &score_scale_bits, sizeof(float));
  const float v_scale = ldexpf(1.f, -kv_frac_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPA_ARGS                                                                             \
  q, k_pool, v_pool, block_tables, q_start, q_len, kv_len, out, H, KVH, Dk, Dv, S, nbmax, bs, \
      n_tiles, tq, score_scale, v_scale, st
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch<float, float>(RPA_ARGS);
    if (kv_dtype == 1) return launch<float, __nv_bfloat16>(RPA_ARGS);
    if (kv_dtype == 2) return launch<float, int8_t>(RPA_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch<__nv_bfloat16, float>(RPA_ARGS);
    if (kv_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(RPA_ARGS);
    if (kv_dtype == 2) return launch<__nv_bfloat16, int8_t>(RPA_ARGS);
  }
#undef RPA_ARGS
  return (int)cudaErrorInvalidValue;
}
