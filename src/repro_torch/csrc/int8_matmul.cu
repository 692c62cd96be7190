// K2: int8 x int8 -> int32 matmul with the fused bit-shift requant epilogue.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul_kernel
// (built by make_int8_matmul, reached through kernels/ops.py::int8_matmul
// from every qlinear in INT mode: 7 projections per layer plus the LM head).
//
// What bounds it on an H100: at the serving shapes (M = 8..128 stream rows,
// K = 2048/6144, N = 1024..151936) the product is bound by the bytes of the
// int8 weight codes, read once (a decode step's 197 launches read 1.72 GB,
// about 0.51 ms at 3.35 TB/s).  This kernel does not reach that bound yet:
// see the rows kernel's note on repeated weight passes.  The int32
// accumulator never reaches device memory: bias align, ReLU, shift-requant
// and clip run in registers before a single int8/uint8 store, which is the
// paper's requant unit placed between the MAC array and memory.
//
// Design (simple first), two kernels sharing one epilogue:
// * rows kernel, for up to 64 stream rows with K and N multiples of 4 (every
//   serving shape): a 256-thread block owns 32 output columns and 16 rows,
//   and splits K over 32 groups of 8 lanes; each lane streams 4x4-byte
//   weight words (four K rows of its four columns, 128 contiguous bytes per
//   K row across the group), transposes them in registers with __byte_perm
//   so four K codes pack into one word, and accumulates with __dp4a.  Eight
//   such loads are in flight per lane.  The 32 partial sums are added in
//   shared memory (integer adds: exact in any order) before the epilogue.
//   The grid is (N/32, ceil(M/16)): each 16-row slice reads the whole
//   weight matrix again, so the engine's 24-row step bucket makes 2 passes
//   over the codes and a 64-row stream 4 (from L2 where the matrix fits
//   there, from device memory for the 311 MB LM head).  At 192 registers a
//   block fills an SM, so the extra slices also add waves.  Covering the
//   bucket's rows in one block row (fewer accumulator registers per lane,
//   or tensor-core mma) is later work.
// * tiled kernel, for everything else: one block per 64x64 output tile, K
//   walked in 32-deep steps through shared-memory operand tiles (the weight
//   tile transposed), a 4x4 __dp4a sub-tile per thread.  Ragged edges in
//   M, N and K are zero-filled; zero codes add nothing.
// Tensor cores (mma/wgmma) and TMA pipelining are later work.
//
// Integer semantics mirror the reference bit for bit, int32 wrap-around
// included: a right shift rounds half away from zero as
// a >= 0 ? (a + half) >> s : -(((-a) + half) >> s), and a negative requant
// shift saturates to +-(2^31 - 1) >> |s| before the left shift.
//
// Unsigned activations: the paper's ResNet feeds post-ReLU uint8 codes on
// [0, 255] into every convolution after the stem (as an im2col matrix).
// Both kernels take them in a compile-time variant (XU8) whose dot product
// is PTX dp4a.u32.s32 (unsigned activation bytes, signed weight bytes), so
// the codes go in as they are, with no offset; the int8 variant's code is
// unchanged.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int LDS = BK + 4;  // shared row stride in bytes (multiple of 4)

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_neg(int a) { return (int)(0u - (unsigned)a); }

// round-half-away arithmetic right shift, s in [1, 31]
__device__ __forceinline__ int shift_round(int a, int s) {
  const int half = 1 << (s - 1);
  if (a >= 0) return wrap_add(a, half) >> s;
  return wrap_neg(wrap_add(wrap_neg(a), half) >> s);
}

__device__ __forceinline__ int requant(int acc, int shift, int lo, int hi) {
  if (shift > 0) {
    acc = shift_round(acc, shift);
  } else if (shift < 0) {
    const int ls = -shift;
    const int bound = 0x7fffffff >> ls;
    acc = min(max(acc, -bound), bound);
    acc = (int)((unsigned)acc << ls);
  }
  return min(max(acc, lo), hi);
}

// four activation bytes (unsigned when XU8) . four int8 weight bytes + c
template <bool XU8>
__device__ __forceinline__ int dot4(int a, int b, int c) {
  if constexpr (XU8) {
    int d;
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
  } else {
    return __dp4a(a, b, c);
  }
}

// bias align -> ReLU -> shift-requant -> clip, then the 8-bit store
__device__ __forceinline__ void epilogue_store(int acc, const int8_t* __restrict__ bias, int gn,
                                               size_t o, void* __restrict__ out, int shift,
                                               int bias_shift, int relu, int lo, int hi,
                                               int out_u8) {
  if (bias != nullptr) {
    int bb = bias[gn];
    bb = bias_shift >= 0 ? (int)((unsigned)bb << bias_shift) : shift_round(bb, -bias_shift);
    acc = wrap_add(acc, bb);
  }
  if (relu) acc = max(acc, 0);
  acc = requant(acc, shift, lo, hi);
  if (out_u8)
    static_cast<uint8_t*>(out)[o] = (uint8_t)acc;
  else
    static_cast<int8_t*>(out)[o] = (int8_t)acc;
}

// rows kernel (see the header): K % 4 == 0, N % 4 == 0, 4-byte aligned
constexpr int RK_THREADS = 256;
constexpr int RK_BN = 32;      // columns per block: 8 lanes x 4 columns
constexpr int RK_BM = 16;      // stream rows per block
constexpr int RK_GROUPS = 32;  // K groups per block: 8 warps x 4 lane rows
constexpr int RK_UNROLL = 8;   // weight words in flight per lane and K row
constexpr int RK_MAX_ROWS = 64;

// r_i holds K row i's codes of four columns; c_j gets column j's codes of
// the four K rows, K row 0 in the low byte (the layout __dp4a pairs with
// four consecutive K codes of an activation row)
__device__ __forceinline__ void transpose4x4(int r0, int r1, int r2, int r3, int& c0, int& c1,
                                             int& c2, int& c3) {
  const int t0 = __byte_perm(r0, r1, 0x5140);
  const int t1 = __byte_perm(r2, r3, 0x5140);
  const int t2 = __byte_perm(r0, r1, 0x7362);
  const int t3 = __byte_perm(r2, r3, 0x7362);
  c0 = __byte_perm(t0, t1, 0x5410);
  c1 = __byte_perm(t0, t1, 0x7632);
  c2 = __byte_perm(t2, t3, 0x5410);
  c3 = __byte_perm(t2, t3, 0x7632);
}

template <bool XU8>
__global__ void __launch_bounds__(RK_THREADS)
int8_matmul_rows_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const int8_t* __restrict__ bias, void* __restrict__ out, int M, int N,
                        int K, int shift, int bias_shift, int relu, int lo, int hi, int out_u8) {
  __shared__ int red[RK_BM][RK_BN];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col4 = lane % 8;
  const int g = warp * 4 + lane / 8;  // this lane's K group
  const int n0 = blockIdx.x * RK_BN;
  const int n = n0 + 4 * col4;        // first of this lane's four columns
  const int m0 = blockIdx.y * RK_BM;
  const int rows = min(RK_BM, M - m0);
  const bool col_ok = n < N;          // N % 4 == 0: all four in, or out
  const int chunks = K / 4;           // groups of four K rows
  const int* xw = reinterpret_cast<const int*>(x) + (size_t)m0 * chunks;

  for (int i = tid; i < RK_BM * RK_BN; i += RK_THREADS) red[i / RK_BN][i % RK_BN] = 0;

  int acc[RK_BM][4];
#pragma unroll
  for (int m = 0; m < RK_BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

  for (int c0 = g; c0 < chunks; c0 += RK_GROUPS * RK_UNROLL) {
    int wv[RK_UNROLL][4];
#pragma unroll
    for (int u = 0; u < RK_UNROLL; ++u) {
      const int c = c0 + u * RK_GROUPS;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wv[u][r] = (col_ok && c < chunks)
                       ? __ldg(reinterpret_cast<const int*>(w + (size_t)(4 * c + r) * N + n))
                       : 0;
    }
#pragma unroll
    for (int u = 0; u < RK_UNROLL; ++u) {
      const int c = c0 + u * RK_GROUPS;
      if (c >= chunks) break;
      int b[4];
      transpose4x4(wv[u][0], wv[u][1], wv[u][2], wv[u][3], b[0], b[1], b[2], b[3]);
#pragma unroll
      for (int m = 0; m < RK_BM; ++m) {
        if (m < rows) {
          const int a = __ldg(xw + (size_t)m * chunks + c);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = dot4<XU8>(a, b[j], acc[m][j]);
        }
      }
    }
  }
  __syncthreads();  // red is zeroed
  if (col_ok) {
#pragma unroll
    for (int m = 0; m < RK_BM; ++m)
      if (m < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(&red[m][4 * col4 + j], acc[m][j]);
  }
  __syncthreads();
  for (int i = tid; i < rows * RK_BN; i += RK_THREADS) {
    const int m = i / RK_BN, gn = n0 + i % RK_BN;
    if (gn < N)
      epilogue_store(red[m][i % RK_BN], bias, gn, (size_t)(m0 + m) * N + gn, out, shift,
                     bias_shift, relu, lo, hi, out_u8);
  }
}

template <bool XU8>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const int8_t* __restrict__ bias, void* __restrict__ out,
                   int M, int N, int K, int shift, int bias_shift, int relu,
                   int lo, int hi, int out_u8, int vec) {
  __shared__ __align__(16) int8_t xs[BM][LDS];  // [m][k]
  __shared__ __align__(16) int8_t ws[BN][LDS];  // [n][k]: transposed tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (vec) {
      // K % 4 == 0 and N % 4 == 0: 4-byte chunks are wholly in or out
      for (int i = tid; i < BM * (BK / 4); i += THREADS) {
        const int r = i / (BK / 4), c = i % (BK / 4);
        const int gm = m0 + r, gk = k0 + 4 * c;
        int v = 0;
        if (gm < M && gk < K) v = *reinterpret_cast<const int*>(x + (size_t)gm * K + gk);
        *reinterpret_cast<int*>(&xs[r][4 * c]) = v;
      }
      for (int i = tid; i < BK * (BN / 4); i += THREADS) {
        const int kk = i / (BN / 4), c = i % (BN / 4);
        const int gk = k0 + kk, gn = n0 + 4 * c;
        int v = 0;
        if (gk < K && gn < N) v = *reinterpret_cast<const int*>(w + (size_t)gk * N + gn);
#pragma unroll
        for (int e = 0; e < 4; ++e) ws[4 * c + e][kk] = (int8_t)(v >> (8 * e));
      }
    } else {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, kk = i % BK;
        const int gm = m0 + r, gk = k0 + kk;
        xs[r][kk] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : (int8_t)0;
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, c = i % BN;
        const int gk = k0 + kk, gn = n0 + c;
        ws[c][kk] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : (int8_t)0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const int*>(&xs[ty + 16 * i][4 * kq]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const int*>(&ws[tx + 16 * j][4 * kq]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dot4<XU8>(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue in registers
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= N) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm < M)
        epilogue_store(acc[i][j], bias, gn, (size_t)gm * N + gn, out, shift, bias_shift, relu,
                       lo, hi, out_u8);
    }
  }
}

template <bool XU8>
void launch(const int8_t* xs, const int8_t* ws, const int8_t* bs, void* out, int M, int N, int K,
            int shift, int bias_shift, int relu, int lo, int hi, int out_u8, int vec,
            cudaStream_t st) {
  if (vec && M <= RK_MAX_ROWS) {
    const dim3 grid((N + RK_BN - 1) / RK_BN, (M + RK_BM - 1) / RK_BM);
    int8_matmul_rows_kernel<XU8><<<grid, RK_THREADS, 0, st>>>(xs, ws, bs, out, M, N, K, shift,
                                                              bias_shift, relu, lo, hi, out_u8);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int8_matmul_kernel<XU8><<<grid, THREADS, 0, st>>>(xs, ws, bs, out, M, N, K, shift,
                                                      bias_shift, relu, lo, hi, out_u8, vec);
  }
}

}  // namespace

// C entry: launches on `stream`; returns cudaGetLastError() (0 on success).
// vec: K % 4 == 0, N % 4 == 0 and both operands 4-byte aligned.
// x_u8: the activation codes are uint8 (else int8); weights are int8.
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* bias, void* out,
                                  int M, int N, int K, int shift, int bias_shift, int relu,
                                  int lo, int hi, int out_u8, int vec, int x_u8, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  const int8_t* bs = static_cast<const int8_t*>(bias);
  if (x_u8)
    launch<true>(xs, ws, bs, out, M, N, K, shift, bias_shift, relu, lo, hi, out_u8, vec, st);
  else
    launch<false>(xs, ws, bs, out, M, N, K, shift, bias_shift, relu, lo, hi, out_u8, vec, st);
  return (int)cudaGetLastError();
}
