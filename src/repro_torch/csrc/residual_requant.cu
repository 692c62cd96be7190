// K7: fused residual add + grid alignment + requantization (Fig. 1(c)/(d)).
//
// Replaces the TPU kernel repro/kernels/residual_requant.py::
// residual_requant_kernel (built by make_residual_requant, reached through
// kernels/ops.py::residual_requant): integer_ops.int_residual_add on the
// card.  The ResNet's forward does not launch it: each block's conv2 adds
// its shortcut in the convolution kernel's epilogue (int_conv.cu).
//
// The branch and the shortcut arrive as 8-bit codes on two power-of-two
// grids (n_a, n_b); each operand is int8 or uint8 on its own (the identity
// shortcut is the previous block's uint8 output, a projection shortcut and
// the branch are int8).  Both are left-shifted onto the finer grid in
// int32, added, optionally ReLU'd (case c: the output is then uint8), and
// requantized with ONE round-half-away shift to n_o and a clip.  The int32
// sum never reaches device memory.
//
// A negative requant shift is a left shift, in two semantics, both kept
// (a compile-time flag): the TPU kernel and the JAX ref wrap (plain int32
// <<); integer_ops.int_residual_add goes through qscheme.shift_requant,
// which saturates to +-(2^31 - 1) >> |s| first.  They differ only where
// the int32 sum overflows under the shift.  All int32 arithmetic wraps as
// the reference's does, written with unsigned operations.  The arithmetic is
// residual_one() in int8_tile.cuh, which that epilogue calls too.
//
// What bounds it on an H100: bytes (two bytes in, one out per element, a
// handful of integer operations).  Design (simple first): a grid-stride
// loop over the flattened tensor, sixteen elements per thread step as one
// 16-byte load of each operand and one 16-byte store where all three
// pointers are 16-byte aligned; otherwise, and for the tail, one element at
// a time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;
constexpr int MAX_BLOCKS = 4096;

template <bool U8>
__device__ __forceinline__ int code(uint32_t byte) {
  return U8 ? (int)(byte & 0xffu) : (int)(int8_t)(byte & 0xffu);
}

template <bool AU8, bool BU8, bool SAT>
__device__ __forceinline__ uint32_t one(uint32_t a_byte, uint32_t b_byte, const ResParams& p) {
  return (uint32_t)residual_one<SAT>(code<AU8>(a_byte), code<BU8>(b_byte), p) & 0xffu;
}

template <bool AU8, bool BU8, bool SAT>
__device__ __forceinline__ uint32_t word(uint32_t a, uint32_t b, const ResParams& p) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) w |= one<AU8, BU8, SAT>(a >> (8 * e), b >> (8 * e), p) << (8 * e);
  return w;
}

template <bool AU8, bool BU8, bool SAT>
__global__ void __launch_bounds__(THREADS)
residual_requant_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                        uint8_t* __restrict__ out, long long n, ResParams p, int vec) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long groups = n / VEC;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long g = tid; g < groups; g += stride) {
      const uint4 va = a4[g], vb = b4[g];
      uint4 vo;
      vo.x = word<AU8, BU8, SAT>(va.x, vb.x, p);
      vo.y = word<AU8, BU8, SAT>(va.y, vb.y, p);
      vo.z = word<AU8, BU8, SAT>(va.z, vb.z, p);
      vo.w = word<AU8, BU8, SAT>(va.w, vb.w, p);
      o4[g] = vo;
    }
    done = groups * VEC;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = (uint8_t)one<AU8, BU8, SAT>(a[i], b[i], p);
}

template <bool AU8, bool BU8, bool SAT>
void launch(const void* a, const void* b, void* out, long long n, const ResParams& p,
            cudaStream_t st) {
  const int vec = ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  long long blocks = (n / VEC + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  residual_requant_kernel<AU8, BU8, SAT><<<(int)blocks, THREADS, 0, st>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<uint8_t*>(out), n, p, vec);
}

template <bool AU8, bool BU8>
void launch_sat(const void* a, const void* b, void* out, long long n, const ResParams& p,
                int saturate, cudaStream_t st) {
  if (saturate)
    launch<AU8, BU8, true>(a, b, out, n, p, st);
  else
    launch<AU8, BU8, false>(a, b, out, n, p, st);
}

}  // namespace

// C entry: launches on `stream`; returns cudaGetLastError() (0 on success).
// a_u8 / b_u8: the operand's codes are uint8 (else int8).  sa, sb in
// [0, 31]: the operands' left shifts onto the common grid; shift in
// [-31, 31]: the requant shift to n_o; the output byte is clipped to lo..hi
// (uint8 with relu, else int8).  saturate: a negative shift saturates first.
extern "C" int residual_requant_launch(const void* a, const void* b, void* out, long long n,
                                       int a_u8, int b_u8, int sa, int sb, int shift, int relu,
                                       int lo, int hi, int saturate, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ResParams p{sa, sb, shift, relu, lo, hi};
  if (a_u8) {
    if (b_u8)
      launch_sat<true, true>(a, b, out, n, p, saturate, st);
    else
      launch_sat<true, false>(a, b, out, n, p, saturate, st);
  } else {
    if (b_u8)
      launch_sat<false, true>(a, b, out, n, p, saturate, st);
    else
      launch_sat<false, false>(a, b, out, n, p, saturate, st);
  }
  return (int)cudaGetLastError();
}
