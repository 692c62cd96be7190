// The integer arithmetic and the int8 tensor-core tile shared by K2
// (int8_matmul.cu), the convolution kernel (int_conv.cu) and, for the
// arithmetic alone, K7 (residual_requant.cu).
//
// Arithmetic.  Integer semantics mirror the reference bit for bit, int32
// wrap-around included (written with unsigned operations): a right shift
// rounds half away from zero as a >= 0 ? (a + half) >> s : -(((-a) + half)
// >> s), and K2's negative requant shift saturates to +-(2^31 - 1) >> |s|
// before the left shift.  epilogue() is K2's: bias aligned onto the
// accumulator grid, optional ReLU, one shift-requant and a clip.
// residual_one() is K7's: two codes left-shifted onto a common grid, added,
// optional ReLU, one shift-requant (a negative shift saturating first when
// SAT, else wrapping as the TPU kernel's plain <<) and a clip.
//
// Tile.  mma.sync.aligned.m16n8k32 on int8 (s8.s8, or u8.s8 for uint8
// activations; no .satfinite: the reference's int32 sum wraps).  A block is
// WM x WN warps; a warp owns MT 16-row m-tiles and NJ n8 tiles (8 NJ
// columns), so a block tile is BM = 16 MT WM rows by BN = 8 NJ WN columns.
// K is walked in BK = 64-deep steps through a ring of NSTAGE shared-memory
// stages filled by cp.async, so NSTAGE - 1 stages are in flight while one
// is multiplied.  A fragments come by ldmatrix (an int8 16x32 A fragment is
// the b16 ldmatrix layout) from rows padded to LDA = 80 bytes
// (conflict-free).  B stays (K, N) row-major: the mma B operand wants four
// K-consecutive bytes of one column, so a lane reads NJ bytes (NJ columns)
// of four K rows and transposes them with __byte_perm (transpose4x4,
// transpose4x2); n-tile j's column g is the warp's column NJ g + j, so the
// accumulator fragment holds 2 NJ CONSECUTIVE columns a row.  Weight rows
// are padded to BN + 8 bytes, so the lanes' rows of a fragment load fall on
// distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_neg(int a) { return (int)(0u - (unsigned)a); }

__device__ __forceinline__ int wrap_shl(int a, int s) { return (int)((unsigned)a << s); }

// round-half-away arithmetic right shift, s in [1, 31]
__device__ __forceinline__ int shift_round(int a, int s) {
  const int half = 1 << (s - 1);
  if (a >= 0) return wrap_add(a, half) >> s;
  return wrap_neg(wrap_add(wrap_neg(a), half) >> s);
}

// a negative shift saturates before the left shift when SAT, else wraps
template <bool SAT>
__device__ __forceinline__ int requant_shift(int acc, int shift) {
  if (shift > 0) return shift_round(acc, shift);
  if (shift < 0) {
    const int ls = -shift;
    if (SAT) {
      const int bound = 0x7fffffff >> ls;
      acc = min(max(acc, -bound), bound);
    }
    acc = wrap_shl(acc, ls);
  }
  return acc;
}

__device__ __forceinline__ int requant(int acc, int shift, int lo, int hi) {
  return min(max(requant_shift<true>(acc, shift), lo), hi);
}

struct Epi {
  const int8_t* bias;
  int shift, bias_shift, relu, lo, hi, out_kind;
  float deq;
};

// column gn's bias code aligned onto the accumulator grid (0 without a
// bias)
__device__ __forceinline__ int aligned_bias(const Epi& e, int gn) {
  if (e.bias == nullptr) return 0;
  const int bb = e.bias[gn];
  return e.bias_shift >= 0 ? wrap_shl(bb, e.bias_shift) : shift_round(bb, -e.bias_shift);
}

// + aligned bias -> ReLU -> shift-requant -> clip
__device__ __forceinline__ int epilogue_aligned(int acc, int bias, const Epi& e) {
  acc = wrap_add(acc, bias);
  if (e.relu) acc = max(acc, 0);
  return requant(acc, e.shift, e.lo, e.hi);
}

// bias align -> ReLU -> shift-requant -> clip; the code's low byte is the
// int8 / uint8 output
__device__ __forceinline__ int epilogue(int acc, const Epi& e, int gn) {
  return epilogue_aligned(acc, aligned_bias(e, gn), e);
}

// K7's residual add: a (grid n_a) and b (grid n_b) shifted left by sa / sb
// onto n_hi = max(n_a, n_b), added, ReLU'd, requantized by shift = n_hi -
// n_o, clipped to lo..hi
struct ResParams {
  int sa, sb, shift, relu, lo, hi;
};

template <bool SAT>
__device__ __forceinline__ int residual_one(int a, int b, const ResParams& p) {
  int acc = wrap_add(wrap_shl(a, p.sa), wrap_shl(b, p.sb));
  if (p.relu) acc = max(acc, 0);
  return min(max(requant_shift<SAT>(acc, p.shift), p.lo), p.hi);
}

// ---------------------------------------------------------------------------
// the tensor-core tile
// ---------------------------------------------------------------------------
constexpr int BK = 64;       // K rows a stage
constexpr int NSTAGE = 4;    // ring depth
constexpr int LDA = BK + 16; // bytes a staged activation row (80: ldmatrix rows on distinct banks)

__device__ __forceinline__ void copy_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async8(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16x32, row) * b (32x8, col), int32 accumulate, wrapping
template <bool XU8>
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (XU8) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// r_i holds K row i's codes of four columns; c_j gets column j's codes of
// the four K rows, K row 0 in the low byte (an mma B register)
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

// the same for two columns (r_i's low two bytes)
__device__ __forceinline__ void transpose4x2(const uint32_t (&r)[4], uint32_t (&c)[2]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
}

template <int MT, int WM, int WN, int NJ = 4>
struct Tile {
  static_assert(NJ == 2 || NJ == 4, "a warp owns 16 or 32 columns");
  static constexpr int BM = 16 * MT * WM;
  static constexpr int BN = 8 * NJ * WN;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int LDB = BN + 8;  // bytes a staged weight row
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int B_BYTES = BK * LDB;
  static constexpr int SMEM = NSTAGE * (A_BYTES + B_BYTES);
};

}  // namespace
