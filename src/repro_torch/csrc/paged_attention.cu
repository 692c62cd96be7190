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
// Arithmetic as the TPU kernel: fp32 online softmax with the running max
// from -inf; K and V values are rounded to the q type before their products
// (int8 codes and bf16 values convert exactly); P is rounded to the q type
// before P.V while l sums the unrounded P; int8's 2^-n folds into the score
// scale (K) and into the final acc / l (V).  A kv row past a query's
// position is not scored: every query sees position 0, so the running max
// is a real score before any masked one could count, and the TPU kernel's
// finite mask value contributes exp(mask - m) == 0 exactly there too.  A
// row whose l is 0 is written as 0.
//
// What bounds it on an H100: the bytes of the kv rows each slot reads
// (KVH * (Dk + Dv) bytes a position for int8), plus q and out.  At the
// engine's decode shape that is well under a megabyte a layer, so a launch
// is bound by its fixed cost; over a long cache by memory.
//
// Design (simple first: fp32 FMAs, no tensor cores, no split-KV).  One
// block per (slot, KV head, row tile) carries RB (2, 4 or 8: the fewest that
// hold C x groups, up to 8) (query, head) rows of that KV head's GQA group,
// so every kv row is read once for all of them.
// The block's warps split the slot's kv rows into 32-row slices (warp w
// takes slices w, w + n_warps, ...), each warp with its own online softmax
// state; one pass at the end merges the warps' (m, l, acc).  A warp stages
// its slice's K and V rows in shared memory with 16-byte loads (8 lanes a
// 128-byte int8 row, rows found by a pointer load of block_tables; no
// gathered copy exists), issued together as asynchronous copies (cp.async)
// into one of two buffers, so the next slice's rows arrive while this one
// is scored; rows padded by 16 bytes so the per-lane 16-byte reads fall on
// distinct banks.  Scores: a lane owns one kv row and dots it
// with the staged q rows.  P.V: a lane owns DPL consecutive head dims (4 up
// to Dv 128, else 8) and reads P from shared memory.  Kv rows past the
// largest position of the block's query rows are never read, so pool blocks
// wholly past it (the trash tail of a table) cost nothing.  Divisions happen once per 16-byte
// vector or kv row, never per element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_RB = 8;      // (query, head) rows a block carries, at most
constexpr int SLICE = 32;      // kv rows a warp scores per pass: one a lane
constexpr int MAX_WARPS = 8;
constexpr int MAX_SMEM = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

template <typename QT>
__device__ __forceinline__ float to_f(QT v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename QT>
__device__ __forceinline__ QT from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// value rounded to the q type (the reference casts K, V and P to it)
template <typename QT>
__device__ __forceinline__ float round_q(float v);
template <>
__device__ __forceinline__ float round_q<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_q<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one 32-bit word of pool values -> floats (int8 sign-extended bytes, bf16
// the high half of an fp32 word)
template <typename KT>
struct Word;
template <>
struct Word<int8_t> {
  static constexpr int N = 4;
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = (float)((int)(w << 24) >> 24);
    f[1] = (float)((int)(w << 16) >> 24);
    f[2] = (float)((int)(w << 8) >> 24);
    f[3] = (float)((int)w >> 24);
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

// K / V values need a rounding to the q type only when they are fp32 and
// q is bf16; int8 codes and bf16 values convert exactly
template <typename QT, typename KT>
__device__ __forceinline__ float kv_val(float f) {
  if (sizeof(KT) == 4 && sizeof(QT) == 2) return round_q<QT>(f);
  return f;
}

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

// stage the slice's rows [j0, j0 + SLICE) of one pool (row_bytes each,
// vpr 16-byte vectors a row) into dst (rows stride bytes apart), row rw at
// pool row prow of lane rw; rows at or past n_kv are zero-filled
__device__ __forceinline__ void stage_rows(unsigned char* dst, int stride,
                                           const unsigned char* base, size_t row_bytes,
                                           int vpr, int prow, int j0, int n_kv, int lane) {
  if (32 % vpr == 0) {  // a lane keeps its vector of the row: no division
    const int step = 32 / vpr, rw0 = lane / vpr, cv = lane - rw0 * vpr;
    for (int i = 0; i < vpr; ++i) {
      const int rw = rw0 + i * step;
      const int pr = __shfl_sync(FULL, prow, rw);
      const bool ok = j0 + rw < n_kv;
      copy16_async(dst + rw * stride + 16 * cv, ok ? base + (size_t)pr * row_bytes + 16 * cv : base,
                   ok);
    }
  } else {
    for (int e = lane; e < SLICE * vpr; e += 32) {
      const int rw = e / vpr, cv = e - rw * vpr;
      const int pr = __shfl_sync(FULL, prow, rw);
      const bool ok = j0 + rw < n_kv;
      copy16_async(dst + rw * stride + 16 * cv, ok ? base + (size_t)pr * row_bytes + 16 * cv : base,
                   ok);
    }
  }
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

// shared-memory layout, shared by the kernel and the launch
struct Layout {
  int stride_k, stride_v;  // bytes a staged K / V row (padded by 16)
  size_t q_bytes, warp_bytes, merge_bytes;
  __host__ __device__ Layout(int Dk, int Dv, int kv_size, int n_warps, int RB) {
    stride_k = Dk * kv_size + 16;
    stride_v = Dv * kv_size + 16;
    q_bytes = (size_t)RB * Dk * sizeof(float);
    // two (K, V) staging buffers (the next slice lands while this one is
    // scored) and the slice's P
    warp_bytes = 2 * (size_t)SLICE * (stride_k + stride_v) + (size_t)RB * SLICE * sizeof(float);
    merge_bytes = (size_t)n_warps * RB * (Dv + 2) * sizeof(float);
  }
  __host__ __device__ size_t total(int n_warps) const {
    const size_t stage = (size_t)n_warps * warp_bytes;
    return q_bytes + (stage > merge_bytes ? stage : merge_bytes);
  }
};

template <typename QT, typename KT, int DPL, int RB>
__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                       const KT* __restrict__ v_pool, const int* __restrict__ block_tables,
                       const int* __restrict__ q_positions, QT* __restrict__ out, int C, int H,
                       int KVH, int Dk, int Dv, int W, int bs, float score_scale,
                       float v_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_warps = blockDim.x / 32;
  const Layout lay(Dk, Dv, (int)sizeof(KT), n_warps, RB);
  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* stage = smem + lay.q_bytes;

  const int b = blockIdx.x, kh = blockIdx.y, tile = blockIdx.z;
  const int groups = H / KVH;
  const int n_rows = C * groups;
  const int r0 = tile * RB;
  const int nr = min(RB, n_rows - r0);  // live rows of this block (>= 1)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // this block's rows: (query c, head h) = (rr / groups, kh * groups + rr % groups)
  int pos[RB];
  int maxpos = -1;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    pos[r] = -1;
    if (r < nr) {
      const int c = (r0 + r) / groups;
      pos[r] = q_positions[(size_t)b * C + c];
      maxpos = max(maxpos, pos[r]);
    }
  }
  for (int r = warp; r < RB; r += n_warps) {
    const int c = (r0 + r) / groups, h = kh * groups + (r0 + r) % groups;
    const QT* qr = q + (((size_t)b * C + c) * H + h) * Dk;
    for (int d = lane; d < Dk; d += 32) qs[r * Dk + d] = r < nr ? to_f(qr[d]) : 0.f;
  }
  __syncthreads();

  // kv rows any of the block's queries sees: pool blocks past them are never read
  const int n_kv = min(maxpos + 1, W * bs);
  const int n_slices = (n_kv + SLICE - 1) / SLICE;
  const int vk = Dk * (int)sizeof(KT) / 16, vv = Dv * (int)sizeof(KT) / 16;
  const size_t buf_bytes = (size_t)SLICE * (lay.stride_k + lay.stride_v);
  unsigned char* wbuf = stage + (size_t)warp * lay.warp_bytes;  // [2][K rows, V rows]
  float* ps = reinterpret_cast<float*>(wbuf + 2 * buf_bytes);
  const int* bt = block_tables + (size_t)b * W;
  const size_t row_k = (size_t)KVH * Dk * sizeof(KT), row_v = (size_t)KVH * Dv * sizeof(KT);
  const unsigned char* kbase =
      reinterpret_cast<const unsigned char*>(k_pool) + (size_t)kh * Dk * sizeof(KT);
  const unsigned char* vbase =
      reinterpret_cast<const unsigned char*>(v_pool) + (size_t)kh * Dv * sizeof(KT);

  float m[RB], l[RB], acc[RB][DPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const bool own_dims = lane * DPL < Dv;

  // this lane's pool row in slice `slice` (read by pointer from the table)
  auto prow_of = [&](int slice) -> int {
    const int jr = slice * SLICE + lane;
    return slice < n_slices && jr < n_kv ? bt[jr / bs] * bs + jr % bs : 0;
  };
  // stage K and V of a slice into buffer `buf`: every 16-byte copy in
  // flight at once, neighbouring lanes on one row
  auto stage_slice = [&](int slice, int buf, int prow) {
    unsigned char* kd = wbuf + buf * buf_bytes;
    stage_rows(kd, lay.stride_k, kbase, row_k, vk, prow, slice * SLICE, n_kv, lane);
    stage_rows(kd + (size_t)SLICE * lay.stride_k, lay.stride_v, vbase, row_v, vv, prow,
               slice * SLICE, n_kv, lane);
    copies_commit();
  };
  if (warp < n_slices) stage_slice(warp, 0, prow_of(warp));
  int prow_next = prow_of(warp + n_warps);
  for (int sl = warp, it = 0; sl < n_slices; sl += n_warps, ++it) {
    // the next slice's copies go out before this one is scored
    if (sl + n_warps < n_slices) {
      stage_slice(sl + n_warps, (it + 1) & 1, prow_next);
      prow_next = prow_of(sl + 2 * n_warps);
      copies_wait<1>();
    } else {
      copies_wait<0>();
    }
    __syncwarp();
    const unsigned char* ks = wbuf + (it & 1) * buf_bytes;
    const unsigned char* vs = ks + (size_t)SLICE * lay.stride_k;
    const int j0 = sl * SLICE;
    const int j = j0 + lane;  // the kv row this lane scores
    const bool row_ok = j < n_kv;

    // scores: this lane's kv row against every live row of the block
    float dot[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) dot[r] = 0.f;
    const unsigned char* kr = ks + lane * lay.stride_k;
    constexpr int EPV = 16 / sizeof(KT);  // values a 16-byte vector holds
    for (int cv = 0; cv < vk; ++cv) {
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
          const float4* qv = reinterpret_cast<const float4*>(qs + r * Dk + cv * EPV);
#pragma unroll
          for (int i4 = 0; i4 < EPV / 4; ++i4) {
            const float4 q4 = qv[i4];
            dot[r] += q4.x * kf[4 * i4] + q4.y * kf[4 * i4 + 1] + q4.z * kf[4 * i4 + 2] +
                      q4.w * kf[4 * i4 + 3];
          }
        }
      }
    }

    // online softmax update, one (m, l, acc) per row and warp
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float p = 0.f;
      if (r < nr) {
        const bool vis = row_ok && j <= pos[r];
        const float s = vis ? dot[r] * score_scale : -INFINITY;
        const float smax = warp_max(s);
        if (smax != -INFINITY) {  // warp-uniform: some kv row of the slice is visible
          const float m_new = fmaxf(m[r], smax);
          const float alpha = expf(m[r] - m_new);
          p = vis ? expf(s - m_new) : 0.f;
          l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
          m[r] = m_new;
        }
      }
      ps[r * SLICE + lane] = round_q<QT>(p);
    }
    __syncwarp();

    // P.V: this lane's DPL head dims, four kv rows at a time
    const int jn = min(SLICE, n_kv - j0);
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
          const float4 p4 = *reinterpret_cast<const float4*>(ps + r * SLICE + jj);
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            acc[r][i] += p4.x * vf[0][i] + p4.y * vf[1][i] + p4.z * vf[2][i] + p4.w * vf[3][i];
        }
      }
    }
    __syncwarp();  // this buffer is consumed before the slice after next lands in it
  }

  // merge the warps' partial softmax states (the staging area is reused)
  __syncthreads();
  float* mrg = reinterpret_cast<float*>(stage);
  float* ml = mrg;                        // [n_warps][RB][2]: m, l
  float* accs = mrg + n_warps * RB * 2;   // [n_warps][RB][Dv]
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (lane == 0) {
      ml[(warp * RB + r) * 2] = m[r];
      ml[(warp * RB + r) * 2 + 1] = l[r];
    }
    if (own_dims) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) accs[((size_t)warp * RB + r) * Dv + lane * DPL + i] = acc[r][i];
    }
  }
  __syncthreads();
  for (int r = warp; r < nr; r += n_warps) {
    // lane w < n_warps holds warp w's weight exp(m_w - m) for this row
    const float mw = lane < n_warps ? ml[(lane * RB + r) * 2] : -INFINITY;
    const float mt = warp_max(mw);
    const float scale_w = mw == -INFINITY ? 0.f : expf(mw - mt);
    const float lt = warp_sum(lane < n_warps ? ml[(lane * RB + r) * 2 + 1] * scale_w : 0.f);
    const float l_inv = lt == 0.f ? 1.f : 1.f / lt;
    float sw[MAX_WARPS];
#pragma unroll
    for (int w = 0; w < MAX_WARPS; ++w) sw[w] = __shfl_sync(FULL, scale_w, w);
    const int c = (r0 + r) / groups, h = kh * groups + (r0 + r) % groups;
    QT* orow = out + (((size_t)b * C + c) * H + h) * Dv;
    for (int d = lane; d < Dv; d += 32) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < MAX_WARPS; ++w)
        if (w < n_warps) o += accs[((size_t)w * RB + r) * Dv + d] * sw[w];
      orow[d] = from_f<QT>(o * l_inv * v_scale);
    }
  }
}

template <typename QT, typename KT, int DPL, int RB>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* bt,
           const void* q_positions, void* out, int B, int C, int H, int KVH, int Dk, int Dv,
           int W, int bs, float score_scale, float v_scale, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QT, KT, DPL, RB>;
  int n_warps = MAX_WARPS;
  while (n_warps > 1 && Layout(Dk, Dv, (int)sizeof(KT), n_warps, RB).total(n_warps) > MAX_SMEM)
    --n_warps;
  const size_t smem = Layout(Dk, Dv, (int)sizeof(KT), n_warps, RB).total(n_warps);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_tiles = (C * (H / KVH) + RB - 1) / RB;
  const dim3 grid(B, KVH, n_tiles);
  kernel<<<grid, n_warps * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool), static_cast<const KT*>(v_pool),
      static_cast<const int*>(bt), static_cast<const int*>(q_positions), static_cast<QT*>(out),
      C, H, KVH, Dk, Dv, W, bs, score_scale, v_scale);
  return (int)cudaGetLastError();
}

// rows a block carries: the slot's whole GQA group times its queries, up
// to 8 (a decode row of qwen3's 2-head groups is 2 rows, not 8 with 6 idle)
template <typename QT, typename KT, int DPL>
int launch_rb(const void* q, const void* k_pool, const void* v_pool, const void* bt,
              const void* q_positions, void* out, int B, int C, int H, int KVH, int Dk, int Dv,
              int W, int bs, float score_scale, float v_scale, cudaStream_t stream) {
#define PA_ARGS \
  q, k_pool, v_pool, bt, q_positions, out, B, C, H, KVH, Dk, Dv, W, bs, score_scale, v_scale, stream
  const int rows = C * (H / KVH);
  if (rows <= 2) return launch<QT, KT, DPL, 2>(PA_ARGS);
  if (rows <= 4) return launch<QT, KT, DPL, 4>(PA_ARGS);
  return launch<QT, KT, DPL, MAX_RB>(PA_ARGS);
#undef PA_ARGS
}

template <typename QT, typename KT>
int launch_dv(const void* q, const void* k_pool, const void* v_pool, const void* bt,
              const void* q_positions, void* out, int B, int C, int H, int KVH, int Dk, int Dv,
              int W, int bs, float score_scale, float v_scale, cudaStream_t stream) {
#define PA_ARGS \
  q, k_pool, v_pool, bt, q_positions, out, B, C, H, KVH, Dk, Dv, W, bs, score_scale, v_scale, stream
  if (Dv <= 128) return launch_rb<QT, KT, 4>(PA_ARGS);
  return launch_rb<QT, KT, 8>(PA_ARGS);
#undef PA_ARGS
}

}  // namespace

// C entry.  q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32,
// 1 bfloat16, 2 int8 codes on the 2^-kv_frac_bits grid (0 for float pools).
// Head dims are multiples of 16 up to 256.  score_scale arrives as the bits
// of a float32 (plain-int C interface).  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* q_positions,
                                      void* out, int B, int C, int H, int KVH, int Dk, int Dv,
                                      int W, int bs, int score_scale_bits, int kv_frac_bits,
                                      int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || C <= 0 || KVH <= 0 || H % KVH || W <= 0 || bs <= 0 || Dk % 16 || Dv % 16 ||
      Dk <= 0 || Dv <= 0 || Dk > 256 || Dv > 256)
    return (int)cudaErrorInvalidValue;
  float score_scale;
  static_assert(sizeof(float) == sizeof(int), "float32 bits travel as an int");
  memcpy(&score_scale, &score_scale_bits, sizeof(float));
  const float v_scale = ldexpf(1.f, -kv_frac_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS \
  q, k_pool, v_pool, block_tables, q_positions, out, B, C, H, KVH, Dk, Dv, W, bs, score_scale, \
      v_scale, st
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_dv<float, float>(PA_ARGS);
    if (kv_dtype == 1) return launch_dv<float, __nv_bfloat16>(PA_ARGS);
    if (kv_dtype == 2) return launch_dv<float, int8_t>(PA_ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_dv<__nv_bfloat16, float>(PA_ARGS);
    if (kv_dtype == 1) return launch_dv<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
    if (kv_dtype == 2) return launch_dv<__nv_bfloat16, int8_t>(PA_ARGS);
  }
#undef PA_ARGS
  return (int)cudaErrorInvalidValue;
}
