// K3: elementwise Eq.-1 quantization, float -> integer codes.
//
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_kernel (built
// by make_quantize, reached through kernels/ops.py::quantize_act).  On the
// paper's ResNet path it quantizes the image at the network's input and the
// pooled features at the head (resnet_int_forward).
//
// What bounds it on an H100: bytes.  One pass reads each input once (4 bytes
// fp32, 2 bf16) and writes one code (1 byte, 4 for bits > 8); a few float
// operations per element are far below the card's rate.
//
// Design (simple first): a grid-stride loop over the flattened tensor, four
// elements per thread step, loaded as one 16-byte (fp32) or 8-byte (bf16)
// vector and stored as one 4-byte (int8/uint8) or 16-byte (int32) vector
// where every pointer is aligned for it; otherwise, and for the tail, one
// element at a time.
//
// Arithmetic mirrors the reference bit for bit: s = x * 2^n in fp32, then
// trunc(s + (s >= 0 ? 0.5 : -0.5)) (round half away from zero, with the
// fp32 rounding of the add), then the clip and the cast.  The product and
// the add are written as __fmul_rn / __fadd_rn so that nvcc cannot contract
// them into one FMA, which would skip the add's rounding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;
constexpr int MAX_BLOCKS = 4096;

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

template <typename Tin, typename Tout>
__device__ __forceinline__ void quant_vec(const Tin* x, Tout* out, long long g, float scale,
                                          float lo, float hi);

template <>
__device__ __forceinline__ void quant_vec<float, int8_t>(const float* x, int8_t* out,
                                                        long long g, float scale, float lo,
                                                        float hi) {
  const float4 v = reinterpret_cast<const float4*>(x)[g];
  const uint32_t w = (uint32_t)(quant_one(v.x, scale, lo, hi) & 0xff) |
                     ((uint32_t)(quant_one(v.y, scale, lo, hi) & 0xff) << 8) |
                     ((uint32_t)(quant_one(v.z, scale, lo, hi) & 0xff) << 16) |
                     ((uint32_t)(quant_one(v.w, scale, lo, hi) & 0xff) << 24);
  reinterpret_cast<uint32_t*>(out)[g] = w;
}

template <>
__device__ __forceinline__ void quant_vec<float, int32_t>(const float* x, int32_t* out,
                                                         long long g, float scale, float lo,
                                                         float hi) {
  const float4 v = reinterpret_cast<const float4*>(x)[g];
  reinterpret_cast<int4*>(out)[g] =
      make_int4(quant_one(v.x, scale, lo, hi), quant_one(v.y, scale, lo, hi),
                quant_one(v.z, scale, lo, hi), quant_one(v.w, scale, lo, hi));
}

template <>
__device__ __forceinline__ void quant_vec<uint16_t, int8_t>(const uint16_t* x, int8_t* out,
                                                           long long g, float scale,
                                                           float lo, float hi) {
  const uint2 v = reinterpret_cast<const uint2*>(x)[g];
  const float f0 = __uint_as_float(v.x << 16), f1 = __uint_as_float(v.x & 0xffff0000u);
  const float f2 = __uint_as_float(v.y << 16), f3 = __uint_as_float(v.y & 0xffff0000u);
  const uint32_t w = (uint32_t)(quant_one(f0, scale, lo, hi) & 0xff) |
                     ((uint32_t)(quant_one(f1, scale, lo, hi) & 0xff) << 8) |
                     ((uint32_t)(quant_one(f2, scale, lo, hi) & 0xff) << 16) |
                     ((uint32_t)(quant_one(f3, scale, lo, hi) & 0xff) << 24);
  reinterpret_cast<uint32_t*>(out)[g] = w;
}

template <>
__device__ __forceinline__ void quant_vec<uint16_t, int32_t>(const uint16_t* x, int32_t* out,
                                                            long long g, float scale,
                                                            float lo, float hi) {
  const uint2 v = reinterpret_cast<const uint2*>(x)[g];
  reinterpret_cast<int4*>(out)[g] = make_int4(
      quant_one(__uint_as_float(v.x << 16), scale, lo, hi),
      quant_one(__uint_as_float(v.x & 0xffff0000u), scale, lo, hi),
      quant_one(__uint_as_float(v.y << 16), scale, lo, hi),
      quant_one(__uint_as_float(v.y & 0xffff0000u), scale, lo, hi));
}

// Tout int8_t carries both 8-bit outputs: the clip range decides whether
// the byte is read back as int8 or uint8
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, long long n, float scale,
                float lo, float hi, int vec) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long groups = n / VEC;
    for (long long g = tid; g < groups; g += stride) quant_vec<Tin, Tout>(x, out, g, scale, lo, hi);
    done = groups * VEC;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = (Tout)quant_one(load_f(x, i), scale, lo, hi);
}

template <typename Tin, typename Tout>
void launch(const void* x, void* out, long long n, float scale, float lo, float hi,
            cudaStream_t st) {
  const uintptr_t in_align = VEC * sizeof(Tin), out_align = VEC * sizeof(Tout);
  const int vec = ((uintptr_t)x % in_align == 0) && ((uintptr_t)out % out_align == 0);
  long long blocks = (n / VEC + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  quantize_kernel<Tin, Tout><<<(int)blocks, THREADS, 0, st>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out), n, scale, lo, hi, vec);
}

}  // namespace

// C entry: launches on `stream`; returns cudaGetLastError() (0 on success).
// in_bf16: the input is bf16 (else fp32); out_i32: int32 codes (bits > 8),
// else one byte a code (int8 or uint8, by the clip range lo..hi).  scale is
// 2^n, an exact power of two.
extern "C" int quantize_launch(const void* x, void* out, long long n, int in_bf16, int out_i32,
                               float scale, int lo, int hi, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float flo = (float)lo, fhi = (float)hi;
  if (in_bf16) {
    if (out_i32)
      launch<uint16_t, int32_t>(x, out, n, scale, flo, fhi, st);
    else
      launch<uint16_t, int8_t>(x, out, n, scale, flo, fhi, st);
  } else {
    if (out_i32)
      launch<float, int32_t>(x, out, n, scale, flo, fhi, st);
    else
      launch<float, int8_t>(x, out, n, scale, flo, fhi, st);
  }
  return (int)cudaGetLastError();
}
