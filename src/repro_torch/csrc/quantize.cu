// K3: elementwise Eq.-1 quantization, float -> integer codes.
//
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_kernel (built
// by make_quantize, reached through kernels/ops.py::quantize_act), whose own
// docstring gives it its job: quantizing activations at unified-module entry
// boundaries, before the int8 product.  Two entry points, one arithmetic
// (quant_one):
// * quantize_multi_launch: one launch reads a float32 or bfloat16 tensor
//   once and writes its codes on up to three grids, one int8 or uint8
//   output each.  The LM path's module input takes every grid of the
//   modules that read the same tensor (wq / wk / wv, w1 / w3; calibration
//   may give them different grids); the paper's ResNet (its image and its
//   pooled head input) and the weights quantized at run time take one.
// * quantize_scatter_launch: the LM path's K/V write.  K and V rows are
//   quantized on the pool's grid and stored straight to their pool rows,
//   pool[index[r]], both in one launch (no codes tensor, no index_copy_).
//
// What bounds it on an H100: bytes, and at the engine's shapes the launch.
// One pass reads each input once (4 bytes fp32, 2 bf16) and writes one code
// a grid (1 byte); a few float operations per element are far below the
// card's rate.  At the serving step's 24 x 2048 bf16 rows the bytes' bound is about 0.04 us against a launch floor of about 2 us, so
// the design is about launches and reads: one launch a module input (not an
// eight-kernel chain of fp32 intermediates), each activation read once for
// every module that consumes it.  No tensor cores: K3 does no multiply-
// accumulate, so neither wgmma nor TMA has anything to do here.
//
// Design (simple first).  Both forms load 16-byte vectors (8 bf16 or 4
// fp32 elements) and store 8- or 4-byte vectors of codes where the
// pointers are aligned for them, scalars otherwise and for the tail; the
// multi-grid form's grid covers the work in one wave of resident threads
// (the host passes the card's count) and strides beyond it.
//
// Arithmetic mirrors the reference bit for bit: s = x * 2^n in fp32, then
// trunc(s + (s >= 0 ? 0.5 : -0.5)) (round half away from zero, with the
// fp32 rounding of the add), then the clip and the cast.  The product and
// the add are written as __fmul_rn / __fadd_rn so that nvcc cannot contract
// them into one FMA, which would skip the add's rounding.  (qscheme.quant
// takes the half's sign from copysign, the JAX kernel from x >= 0: they
// differ only at -0.0, which rounds to 0 either way.)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* x, long long i) { return x[i]; }

// bf16 is the high half of an fp32 word
__device__ __forceinline__ float load_f(const uint16_t* x, long long i) {
  return __uint_as_float((uint32_t)x[i] << 16);
}

__device__ __forceinline__ int quant_one(float x, float scale, float lo, float hi) {
  const float s = __fmul_rn(x, scale);
  const float r = truncf(__fadd_rn(s, s >= 0.0f ? 0.5f : -0.5f));
  return (int)fminf(fmaxf(r, lo), hi);
}

// ---------------------------------------------------------------------------
// 16-byte loads, one byte a code
// ---------------------------------------------------------------------------
constexpr int MAX_GRIDS = 3;
constexpr int SCATTER_THREADS = 128;

// V elements of one 16-byte load: 8 bf16 or 4 fp32
template <typename Tin>
struct Vec16 {
  static constexpr int V = 16 / sizeof(Tin);
};

__device__ __forceinline__ void load16(const float* x, long long g, float (&f)[4]) {
  const float4 v = reinterpret_cast<const float4*>(x)[g];
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}

__device__ __forceinline__ void load16(const uint16_t* x, long long g, float (&f)[8]) {
  const uint4 v = reinterpret_cast<const uint4*>(x)[g];
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the V codes of f on one grid, stored as one V-byte word at out[g]
__device__ __forceinline__ void store_codes(uint8_t* out, long long g, const float (&f)[4],
                                            float scale, float lo, float hi) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= (uint32_t)(quant_one(f[i], scale, lo, hi) & 0xff) << (8 * i);
  reinterpret_cast<uint32_t*>(out)[g] = w;
}

__device__ __forceinline__ void store_codes(uint8_t* out, long long g, const float (&f)[8],
                                            float scale, float lo, float hi) {
  uint32_t w0 = 0, w1 = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w0 |= (uint32_t)(quant_one(f[i], scale, lo, hi) & 0xff) << (8 * i);
    w1 |= (uint32_t)(quant_one(f[4 + i], scale, lo, hi) & 0xff) << (8 * i);
  }
  reinterpret_cast<uint2*>(out)[g] = make_uint2(w0, w1);
}

struct Grids {
  float scale[MAX_GRIDS];
  uint8_t* out[MAX_GRIDS];
};

// every element of x (n) on G grids: codes to g.out[0..G)
template <typename Tin, int G>
__global__ void __launch_bounds__(THREADS)
quantize_multi_kernel(const Tin* __restrict__ x, long long n, Grids g, float lo, float hi,
                      int vec) {
  constexpr int V = Vec16<Tin>::V;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long groups = n / V;
    for (long long i = tid; i < groups; i += stride) {
      float f[V];
      load16(x, i, f);
#pragma unroll
      for (int j = 0; j < G; ++j) store_codes(g.out[j], i, f, g.scale[j], lo, hi);
    }
    done = groups * V;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float f = load_f(x, i);
#pragma unroll
    for (int j = 0; j < G; ++j) g.out[j][i] = (uint8_t)quant_one(f, g.scale[j], lo, hi);
  }
}

// row r of K and V (rows x width) to pool row index[r] of each pool (its
// rows of width codes).  Rows that name the same pool row (the trash block
// of padding rows) race: which one's codes land is unspecified, as with
// index_copy_: each 4- or 8-byte word holds one row's codes, a row may mix
// words of several; the trash block is never read unmasked.  An index outside
// the pool traps, as index_copy_'s device assert does.
template <typename Tin, typename Tidx>
__global__ void __launch_bounds__(SCATTER_THREADS)
quantize_scatter_kernel(const Tin* __restrict__ k, const Tin* __restrict__ v,
                        const Tidx* __restrict__ index, int rows, int width,
                        long long pool_rows, float scale, float lo, float hi,
                        uint8_t* __restrict__ k_pool, uint8_t* __restrict__ v_pool, int vec) {
  constexpr int V = Vec16<Tin>::V;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long dst = (long long)index[r];
    if (dst < 0 || dst >= pool_rows) __trap();
    const Tin* kr = k + (size_t)r * width;
    const Tin* vr = v + (size_t)r * width;
    uint8_t* kd = k_pool + dst * width;
    uint8_t* vd = v_pool + dst * width;
    const int start = blockIdx.x * SCATTER_THREADS + threadIdx.x;
    const int stride = gridDim.x * SCATTER_THREADS;
    if (vec) {
      for (int i = start; i < width / V; i += stride) {
        float f[V];
        load16(kr, i, f);
        store_codes(kd, i, f, scale, lo, hi);
        load16(vr, i, f);
        store_codes(vd, i, f, scale, lo, hi);
      }
    } else {
      for (int i = start; i < width; i += stride) {
        kd[i] = (uint8_t)quant_one(load_f(kr, i), scale, lo, hi);
        vd[i] = (uint8_t)quant_one(load_f(vr, i), scale, lo, hi);
      }
    }
  }
}

template <typename Tin>
int launch_multi(const void* x, long long n, const Grids& g, int n_grids, float lo, float hi,
                 int max_blocks, cudaStream_t st) {
  constexpr int V = Vec16<Tin>::V;
  int vec = (uintptr_t)x % 16 == 0;
  for (int j = 0; j < n_grids; ++j) vec = vec && (uintptr_t)g.out[j] % V == 0;
  long long blocks = ((vec ? n / V + n % V : n) + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : blocks > max_blocks ? max_blocks : blocks;
  const Tin* xs = static_cast<const Tin*>(x);
  switch (n_grids) {
    case 1: quantize_multi_kernel<Tin, 1><<<(int)blocks, THREADS, 0, st>>>(xs, n, g, lo, hi, vec); break;
    case 2: quantize_multi_kernel<Tin, 2><<<(int)blocks, THREADS, 0, st>>>(xs, n, g, lo, hi, vec); break;
    case 3: quantize_multi_kernel<Tin, 3><<<(int)blocks, THREADS, 0, st>>>(xs, n, g, lo, hi, vec); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tidx>
int launch_scatter(const void* k, const void* v, const void* index, int rows, int width,
                   long long pool_rows, float scale, float lo, float hi, void* k_pool,
                   void* v_pool, cudaStream_t st) {
  constexpr int V = Vec16<Tin>::V;
  const int vec = width % V == 0 && (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0 &&
                  (uintptr_t)k_pool % V == 0 && (uintptr_t)v_pool % V == 0;
  const int per_row = vec ? width / V : width;
  const dim3 grid((per_row + SCATTER_THREADS - 1) / SCATTER_THREADS, rows < 65535 ? rows : 65535);
  quantize_scatter_kernel<Tin, Tidx><<<grid, SCATTER_THREADS, 0, st>>>(
      static_cast<const Tin*>(k), static_cast<const Tin*>(v), static_cast<const Tidx*>(index),
      rows, width, pool_rows, scale, lo, hi, static_cast<uint8_t*>(k_pool),
      static_cast<uint8_t*>(v_pool), vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry: launches on `stream`; returns cudaGetLastError() (0 on success).
// x: n float32 (in_bf16 = 0) or bfloat16 elements; codes on n_grids (1..3)
// grids, scale_j = 2^n_j exact powers of two, one byte a code to out_j (int8
// or uint8, by the clip range lo..hi).  max_blocks: the blocks one wave of
// the card holds (more elements stride).
extern "C" int quantize_multi_launch(const void* x, long long n, int in_bf16, int n_grids,
                                     float scale0, float scale1, float scale2, void* out0,
                                     void* out1, void* out2, int lo, int hi, int max_blocks,
                                     void* stream) {
  if (n <= 0 || n_grids < 1 || n_grids > MAX_GRIDS || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Grids g{{scale0, scale1, scale2},
                {static_cast<uint8_t*>(out0), static_cast<uint8_t*>(out1),
                 static_cast<uint8_t*>(out2)}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch_multi<uint16_t>(x, n, g, n_grids, (float)lo, (float)hi, max_blocks, st);
  return launch_multi<float>(x, n, g, n_grids, (float)lo, (float)hi, max_blocks, st);
}

// C entry: launches on `stream`; returns cudaGetLastError() (0 on success).
// k, v: rows x width float32 or bfloat16 (row-major, contiguous); index:
// rows int32 (idx_i64 = 0) or int64 pool rows, read on the card; codes on
// the grid scale = 2^n to k_pool / v_pool, each pool_rows x width int8
// (or uint8, by lo..hi) row-major.
extern "C" int quantize_scatter_launch(const void* k, const void* v, const void* index,
                                       int idx_i64, int rows, int width, long long pool_rows,
                                       int in_bf16, float scale, int lo, int hi, void* k_pool,
                                       void* v_pool, void* stream) {
  if (rows <= 0 || width <= 0 || pool_rows <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float flo = (float)lo, fhi = (float)hi;
#define K3_SCATTER(TIN, TIDX) \
  launch_scatter<TIN, TIDX>(k, v, index, rows, width, pool_rows, scale, flo, fhi, k_pool, \
                            v_pool, st)
  if (in_bf16) return idx_i64 ? K3_SCATTER(uint16_t, int64_t) : K3_SCATTER(uint16_t, int32_t);
  return idx_i64 ? K3_SCATTER(float, int64_t) : K3_SCATTER(float, int32_t);
#undef K3_SCATTER
}
