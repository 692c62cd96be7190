// K5 and K6: flash attention over a dense (B, S, KVH, D) KV cache whose
// entries are int8 Eq.-1 codes or floats.
//
// Replaces the TPU kernels in repro/kernels/flash_attention.py:
//   flash_prefill_kernel <- _flash_prefill_kernel (K5, built by
//     make_flash_prefill, reached through kernels/ops.py::flash_attention:
//     the dense-cache prefill and calibration's forward under
//     attn_kernel='flash');
//   flash_decode_kernel  <- _flash_decode_kernel (K6, built by
//     make_flash_decode, reached through kernels/ops.py::flash_decode: every
//     decode step of the classic serve path).
// Both are causal with scores scaled by 2^-n / sqrt(Dk): the int8 grid's
// 2^-n of K is folded into the score scale and V's into the final 1/l, so
// no dequantized copy of the cache exists.  A masked score is the
// reference's finite DEFAULT_MASK_VALUE; the running max starts at -inf and
// alpha = exp(m_prev - m_next), exactly as the reference's online softmax.
// The softmax is fp32, K/V values and P are rounded to the q type before
// their products (int8 codes and bf16 values convert exactly), and a row
// whose l is 0 is written as 0.
//
// What bounds them on an H100.  K5 at a long prefill is bound by its
// operations (4 * Sq * Skv / 2 * H * D causal FLOPs); at the serving path's
// 32-token prompt it is a small launch.  K6 is bound by the bytes of the
// cache it reads up to pos (KVH * (Dk + Dv) bytes a position for int8).
//
// Design (simple first: fp32 FMAs from shared memory, no tensor cores, no
// TMA).  K5: one 256-thread block per (q tile, KV head, batch) carries all
// `groups` query heads of that KV head for TQ = 64 / groups positions
// (64 rows), so each K/V tile is loaded once for the whole group.  K/V
// tiles of 64 rows are staged in shared memory as floats (rows padded by
// one word so the strided reads fall on distinct banks); four threads own
// a row: each scores 16 kv rows of the tile, the quad reduces the row max
// and sum with shuffles, and for P.V each owns every fourth head dim of the
// row in registers.  Tiles wholly above the causal diagonal or at/after
// Skv are never read, so a prefill over a max_seq cache does not read its
// empty tail.  K6: one 256-thread block per (KV head, batch) carries the
// group's query heads, walks the cache in tiles up to pos and stops there
// (pos is a host int: no device sync); threads score one kv row each, a
// warp per head runs the softmax update, and the accumulator lives in
// shared memory.  A long cache gives K6 only B * KVH blocks (32 for the
// serving batch, on 132 SMs): splitting the kv axis across blocks with a
// second combine pass is the next speed step, not built yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int P_ROWS = THREADS / 4;   // K5: q rows a block carries (4 threads a row)
constexpr int P_BK = 64;              // K5: kv rows a tile
constexpr int P_SPT = P_BK / 4;       // K5: scores a thread computes per tile
constexpr int MAX_DIM = 256;
constexpr int D_MAX_GROUPS = 16;      // K6: query heads per KV head

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

// ---------------------------------------------------------------------------
// K5: causal prefill, q (B, Sq, H, Dk) over K/V (B, Skv, KVH, D), q_offset 0
// ---------------------------------------------------------------------------
// NPT: head dims of the output a thread owns (every fourth one), >= Dv / 4.
template <typename QT, typename KT, int NPT>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                     const KT* __restrict__ v, QT* __restrict__ out, int Sq, int Skv, int H,
                     int KVH, int Dk, int Dv, int tq, float score_scale, float v_scale,
                     float mask_value) {
  extern __shared__ float smem[];
  const int ldk = Dk + 1, ldv = Dv + 1, lds = P_BK + 1;
  float* q_s = smem;                     // [P_ROWS][Dk + 1]
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
  const int kv_end = min(Skv, q0 + tq);
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
      const bool live = kpos < Skv && kpos <= qpos;
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
// K6: one-token decode, q (B, 1, H, Dk) over the cache (B, S_max, KVH, D)
// masked at pos
// ---------------------------------------------------------------------------
template <typename QT, typename KT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, QT* __restrict__ out, int S_max, int H, int KVH,
                    int Dk, int Dv, int bk, int pos, float score_scale, float v_scale,
                    float mask_value) {
  extern __shared__ float smem[];
  const int groups = H / KVH;
  const int ldk = Dk + 1;
  float* q_s = smem;                       // [groups][Dk]
  float* k_s = q_s + groups * Dk;          // [bk][Dk + 1]
  float* v_s = k_s + bk * ldk;             // [bk][Dv]
  float* p_s = v_s + bk * Dv;              // [groups][bk]
  float* acc_s = p_s + groups * bk;        // [groups][Dv]
  float* m_s = acc_s + groups * Dv;        // [groups]
  float* l_s = m_s + groups;               // [groups]
  float* a_s = l_s + groups;               // [groups] this tile's alpha

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int idx = tid; idx < groups * Dk; idx += THREADS) {
    const int g = idx / Dk, d = idx - g * Dk;
    q_s[idx] = to_f(q[((size_t)b * H + kvh * groups + g) * Dk + d]);
  }
  for (int idx = tid; idx < groups * Dv; idx += THREADS) acc_s[idx] = 0.f;
  for (int g = tid; g < groups; g += THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  // tiles past pos are never read
  const int kv_end = min(S_max, pos + 1);
  for (int kv0 = 0; kv0 < kv_end; kv0 += bk) {
    __syncthreads();
    for (int idx = tid; idx < bk * Dk; idx += THREADS) {
      const int j = idx / Dk, d = idx - j * Dk;
      const int kp = kv0 + j;
      k_s[j * ldk + d] = kp < kv_end
          ? round_q<QT>(to_f(k[(((size_t)b * S_max + kp) * KVH + kvh) * Dk + d])) : 0.f;
    }
    for (int idx = tid; idx < bk * Dv; idx += THREADS) {
      const int j = idx / Dv, d = idx - j * Dv;
      const int kp = kv0 + j;
      v_s[idx] = kp < kv_end
          ? round_q<QT>(to_f(v[(((size_t)b * S_max + kp) * KVH + kvh) * Dv + d])) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < groups * bk; idx += THREADS) {
      const int g = idx / bk, j = idx - g * bk;
      const float* qr = q_s + g * Dk;
      const float* kr = k_s + j * ldk;
      float dot = 0.f;
      for (int d = 0; d < Dk; ++d) dot = fmaf(qr[d], kr[d], dot);
      p_s[idx] = kv0 + j <= pos && kv0 + j < S_max ? dot * score_scale : mask_value;
    }
    __syncthreads();
    // one warp per query head: the online-softmax update of its row
    for (int g = warp; g < groups; g += THREADS / 32) {
      float* pr = p_s + g * bk;
      float m_tile = -INFINITY;
      for (int j = lane; j < bk; j += 32) m_tile = fmaxf(m_tile, pr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, o));
      const float m_prev = m_s[g];
      const float m_next = fmaxf(m_prev, m_tile);
      float l_tile = 0.f;
      for (int j = lane; j < bk; j += 32) {
        const float p = expf(pr[j] - m_next);
        l_tile += p;
        pr[j] = round_q<QT>(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l_tile += __shfl_xor_sync(0xffffffffu, l_tile, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + l_tile;
        m_s[g] = m_next;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < groups * Dv; idx += THREADS) {
      const int g = idx / Dv, c = idx - g * Dv;
      const float* pr = p_s + g * bk;
      float a = acc_s[idx] * a_s[g];
      for (int j = 0; j < bk; ++j) a = fmaf(pr[j], v_s[j * Dv + c], a);
      acc_s[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < groups * Dv; idx += THREADS) {
    const int g = idx / Dv, c = idx - g * Dv;
    const float l = l_s[g];
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
    out[((size_t)b * H + kvh * groups + g) * Dv + c] = from_f<QT>(acc_s[idx] * l_inv * v_scale);
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename QT, typename KT, int NPT>
int launch_prefill(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Skv, int H, int KVH, int Dk, int Dv, float score_scale, float v_scale,
                   float mask_value, cudaStream_t stream) {
  auto kernel = flash_prefill_kernel<QT, KT, NPT>;
  const size_t smem = ((size_t)P_ROWS * (Dk + 1) + (size_t)P_BK * (Dk + 1) +
                       (size_t)P_BK * (Dv + 1) + (size_t)P_ROWS * (P_BK + 1)) * sizeof(float);
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const int tq = P_ROWS / (H / KVH);
  const dim3 grid((Sq + tq - 1) / tq, KVH, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<QT*>(out), Sq, Skv, H, KVH, Dk, Dv, tq, score_scale, v_scale, mask_value);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int launch_prefill_dv(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                      int Skv, int H, int KVH, int Dk, int Dv, float score_scale,
                      float v_scale, float mask_value, cudaStream_t stream) {
#define FP_ARGS q, k, v, out, B, Sq, Skv, H, KVH, Dk, Dv, score_scale, v_scale, mask_value, stream
  if (Dv <= 64) return launch_prefill<QT, KT, 16>(FP_ARGS);
  if (Dv <= 128) return launch_prefill<QT, KT, 32>(FP_ARGS);
  return launch_prefill<QT, KT, 64>(FP_ARGS);
#undef FP_ARGS
}

template <typename QT, typename KT>
int launch_decode(const void* q, const void* k, const void* v, void* out, int B, int S_max,
                  int H, int KVH, int Dk, int Dv, int bk, int pos, float score_scale,
                  float v_scale, float mask_value, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<QT, KT>;
  const int groups = H / KVH;
  const size_t smem = ((size_t)groups * Dk + (size_t)bk * (Dk + 1) + (size_t)bk * Dv +
                       (size_t)groups * bk + (size_t)groups * Dv + 3 * (size_t)groups) *
                      sizeof(float);
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const dim3 grid(KVH, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<QT*>(out), S_max, H, KVH, Dk, Dv, bk, pos, score_scale, v_scale, mask_value);
  return (int)cudaGetLastError();
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
// score_scale and mask_value arrive as the bits of float32s.  Every tensor
// is contiguous; out is allocated by the caller.  Each returns
// cudaGetLastError() after its launch (0 on success).
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* out,
                                    int B, int Sq, int Skv, int H, int KVH, int Dk, int Dv,
                                    int score_scale_bits, int kv_frac_bits, int mask_bits,
                                    int q_dtype, int kv_dtype, void* stream) {
  if (KVH <= 0 || H % KVH || H / KVH > P_ROWS || Dk > MAX_DIM || Dv > MAX_DIM)
    return (int)cudaErrorInvalidValue;
  const float score_scale = from_bits(score_scale_bits), mask_value = from_bits(mask_bits);
  const float v_scale = ldexpf(1.f, -kv_frac_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FP_ARGS q, k, v, out, B, Sq, Skv, H, KVH, Dk, Dv, score_scale, v_scale, mask_value, st
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_prefill_dv<float, float>(FP_ARGS);
    if (kv_dtype == 1) return launch_prefill_dv<float, __nv_bfloat16>(FP_ARGS);
    if (kv_dtype == 2) return launch_prefill_dv<float, int8_t>(FP_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_prefill_dv<__nv_bfloat16, float>(FP_ARGS);
    if (kv_dtype == 1) return launch_prefill_dv<__nv_bfloat16, __nv_bfloat16>(FP_ARGS);
    if (kv_dtype == 2) return launch_prefill_dv<__nv_bfloat16, int8_t>(FP_ARGS);
  }
#undef FP_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, void* out,
                                   int B, int S_max, int H, int KVH, int Dk, int Dv, int bk,
                                   int pos, int score_scale_bits, int kv_frac_bits,
                                   int mask_bits, int q_dtype, int kv_dtype, void* stream) {
  if (KVH <= 0 || H % KVH || H / KVH > D_MAX_GROUPS || Dk > MAX_DIM || Dv > MAX_DIM ||
      bk <= 0 || pos < 0)
    return (int)cudaErrorInvalidValue;
  const float score_scale = from_bits(score_scale_bits), mask_value = from_bits(mask_bits);
  const float v_scale = ldexpf(1.f, -kv_frac_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_ARGS \
  q, k, v, out, B, S_max, H, KVH, Dk, Dv, bk, pos, score_scale, v_scale, mask_value, st
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
