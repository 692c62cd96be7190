// K2: int8 x int8 -> int32 matmul with the fused bit-shift requant epilogue.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul_kernel
// (built by make_int8_matmul, reached through kernels/ops.py::int8_matmul
// from every qlinear in INT / W8A8 mode: 7 projections per layer plus the
// LM head; and from the ResNet's head, whose convolutions run in
// int_conv.cu).
//
// What bounds it on an H100: bytes.  At the serving shapes (M = 1..128
// stream rows, K = 2048 / 6144, N = 1024..151936) the product does at most
// 2M = 256 int8 operations per weight byte, under the card's int8 ridge of
// 1979e12 / 3.35e12 ~ 590, so the work is to stream the (K, N) weight codes
// once at full bandwidth on every SM (one engine step's 197 launches read
// 1.75 GB, 0.52 ms at 3.35 TB/s).  Large-M products (a long prefill, a
// calibration batch) stream their activation rows instead.  The int32
// accumulator never reaches device memory unsplit: bias
// align, ReLU, shift-requant and clip run in registers before one 8-byte
// store of eight int8/uint8 codes, the paper's requant unit between the
// MAC array and memory.  The LM path's projections store the dequantized
// activation instead (out_kind bf16 or fp32): each code times 2^-n_o,
// written as the activation's float type.  That value is exact in both
// (an 8-bit code times a power of two fits bf16's 8-bit significand), so
// it equals qscheme.dequant of the codes bit for bit, and the module's
// output needs no second pass over the codes.
//
// Design (mma_kernel).  Tensor cores through mma.sync.aligned.m16n8k32
// (s8.s8, or u8.s8 for the ResNet's post-ReLU uint8 activations, no
// .satfinite: the reference's int32 sum wraps).  wgmma was not chosen: it
// needs 64-row tiles while the serving path's rows are 1..128 (the
// engine's bucket is 24), the products are bound by bytes, not by the
// tensor cores' rate, and the warp-level product keeps the weight
// operand's byte transpose in registers.  A block is WM x WN warps; a warp
// owns MT 16-row m-tiles and 32 columns (four n8 tiles), so a block tile is
// BM = 16 MT WM rows by BN = 32 WN columns.  K is walked in 64-deep steps
// through a ring of NSTAGE shared-memory stages filled by cp.async (16-byte
// copies of activation rows, 8-byte copies of weight rows), so NSTAGE - 1
// stages are in flight while one is multiplied.
// * The weights stay in their public (K, N) row-major layout: no second
//   copy exists (the LM head alone is 311 MB).  The mma B operand wants
//   four K-consecutive bytes of one column, so a lane reads four 4-byte
//   words (four K rows of four columns) and transposes them with
//   __byte_perm.  The four columns become the four n8 tiles, so n-tile j's
//   column g is the tile's column 4g + j; the accumulator fragment then
//   holds eight CONSECUTIVE columns a row, stored as one 8-byte word.
//   Weight rows are padded to BN + 8 bytes, so the four lanes' rows of a
//   fragment load fall on distinct banks.
// * Activation fragments come by ldmatrix (an int8 16x32 A fragment is the
//   b16 ldmatrix layout), rows padded to 80 bytes (conflict-free).
// * Serving (M <= 128): one block row covers every stream row (M padded to
//   16 / 32 / 64 / 128 inside the block), so each launch streams the weight
//   codes once; BN = 128.  Where the column tiles are fewer than about two
//   waves the host splits K (kernels/int8_matmul.py::plan_int8_matmul, from
//   the shapes alone): each split writes its int32 partial sums to a
//   workspace the wrapper allocated, and finish_kernel adds them (integer
//   adds: exact and order-free) and runs the epilogue once on the full sum
//   (shift-requant is not linear, so it never runs per split).
// * The rank-split form (a row-cut module, wo or w2, on one rank of a
//   tensor-parallel mesh: each rank holds some of K's rows) is the same
//   two passes across processes: int8_matmul_launch with out_kind OUT_I32
//   stores this rank's int32 sums (no epilogue), the ranks' sums are
//   added in int32 by an all-reduce (exact in any order, like the split-K
//   workspace), and int8_matmul_finish_launch runs finish_kernel once over
//   the reduced buffer, bias included.  So the module's output is the one
//   rank's bit for bit.
// * Large M: a tall tile (BM 64..256) and a narrow BN of 32 / 64 for
//   narrow N, so an N = 16 / 32 / 64 product wastes at most half an
//   n-tile; K is zero-filled to the step.
// * Anything else (K % 16 != 0, N % 8 != 0 or misaligned operands: the
//   ResNet head's N 10) takes dp4a_kernel: one block per
//   64x64 output tile, K walked in 32-deep steps through shared memory, a
//   4x4 __dp4a sub-tile per thread.  Ragged edges are zero-filled.
//
// The integer arithmetic (epilogue()) and the tensor-core tile (Tile, the
// cp.async ring's copies, ldmatrix, mma_s8, transpose4x4) live in
// int8_tile.cuh, shared with the convolution kernel (int_conv.cu).
// Integer semantics mirror the reference bit for bit, int32 wrap-around
// included.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

// what a store writes: one byte a code, or the code times deq (2^-n_o) as
// bf16 / fp32, or (the rank-split form's first pass) the raw int32 sum
enum OutKind { OUT_CODES = 0, OUT_BF16 = 1, OUT_F32 = 2, OUT_I32 = 3 };

// an accumulator's stored value: the epilogue's code, or the sum itself
// when the epilogue runs later (OUT_I32)
__device__ __forceinline__ int finish_one(int v, const Epi& e, int gn) {
  return e.out_kind == OUT_I32 ? v : epilogue(v, e, gn);
}

__device__ __forceinline__ float deq_code(int code, const Epi& e) {
  return __fmul_rn((float)code, e.deq);
}

__device__ __forceinline__ uint32_t bf16_pair(int c0, int c1, const Epi& e) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(deq_code(c0, e))) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(deq_code(c1, e))) << 16;
}

// NC (4 or 8) consecutive outputs c from element offset off: one 4- / 8-byte
// word of codes, or 8- / 16-byte words of bf16, or 16-byte words of fp32 or
// int32 (off a multiple of NC, the output 16-byte aligned)
template <int NC>
__device__ __forceinline__ void store_out(void* out, size_t off, const int (&c)[NC],
                                          const Epi& e) {
  if (e.out_kind == OUT_I32) {
    int4* p = reinterpret_cast<int4*>(static_cast<int*>(out) + off);
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) p[q] = make_int4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
  } else if (e.out_kind == OUT_CODES) {
    uint32_t w[NC / 4];
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      w[q] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) w[q] |= ((uint32_t)c[4 * q + i] & 0xffu) << (8 * i);
    }
    int8_t* p = static_cast<int8_t*>(out) + off;
    if constexpr (NC == 8)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if (e.out_kind == OUT_BF16) {
    uint32_t w[NC / 2];
#pragma unroll
    for (int q = 0; q < NC / 2; ++q) w[q] = bf16_pair(c[2 * q], c[2 * q + 1], e);
    uint16_t* p = static_cast<uint16_t*>(out) + off;
    if constexpr (NC == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
#pragma unroll
    for (int q = 0; q < NC / 4; ++q)
      p[q] = make_float4(deq_code(c[4 * q], e), deq_code(c[4 * q + 1], e),
                         deq_code(c[4 * q + 2], e), deq_code(c[4 * q + 3], e));
  }
}

// one output, for the dp4a tile's scalar stores
__device__ __forceinline__ void store_one(void* out, size_t off, int c, const Epi& e) {
  if (e.out_kind == OUT_I32)
    static_cast<int*>(out)[off] = c;
  else if (e.out_kind == OUT_CODES)
    static_cast<int8_t*>(out)[off] = (int8_t)c;
  else if (e.out_kind == OUT_BF16)
    static_cast<uint16_t*>(out)[off] = __bfloat16_as_ushort(__float2bfloat16_rn(deq_code(c, e)));
  else
    static_cast<float*>(out)[off] = deq_code(c, e);
}

// ---------------------------------------------------------------------------
// mma_kernel (see the header)
// ---------------------------------------------------------------------------
// Block (blockIdx.x, blockIdx.y, blockIdx.z) computes output columns
// [BN x, BN x + BN), rows [BM y, BM y + BM) over K rows [k_chunk z,
// min(K, k_chunk (z + 1))).  One split (gridDim.z == 1): the epilogue and
// the 8-bit store; else int32 partials to ws[z] (M x N).  K % 16 == 0,
// N % 8 == 0, x 16-byte and w 8-byte aligned, k_chunk a multiple of BK.
//
// GROUPED (the experts' form): x and w are the (E, C, K) and (E, K, N)
// stacks (M = C) and out (E, C, N).  Each expert's C rows are `segs`
// segments of `seg_stride` rows (the data shards' slices of its capacity,
// the reference's (E, D * cap_l) exchange layout; one segment of C rows
// without a data cut).  blockIdx.z is the segment z = e * segs + s, whose
// live rows are its first min(counts[z], rows_cap) (counts (E, segs)
// int32, read on the card), and a block whose first row lies past them
// exits at once.  Rows past a segment's count are LEFT UNWRITTEN (never
// 0): no consumer reads them.  One split of K.  Offsets are 64-bit (a
// stack may exceed 2^31 elements).
template <int MT, int WM, int WN, bool XU8, bool GROUPED>
__global__ void __launch_bounds__(Tile<MT, WM, WN>::THREADS)
mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, void* __restrict__ out,
           int* __restrict__ ws, int M, int N, int K, int k_chunk, Epi epi,
           const int* __restrict__ counts, int rows_cap, int segs, int seg_stride) {
  using T = Tile<MT, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_s = smem;                          // [NSTAGE][BM][LDA]
  unsigned char* b_s = smem + NSTAGE * T::A_BYTES;    // [NSTAGE][BK][LDB]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp / WN, warp_n = warp % WN;
  const int gid = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  size_t out_base = 0;  // the expert's first output element
  int kb = 0, ke = K;
  if constexpr (GROUPED) {
    const size_t e = blockIdx.z / segs;
    const size_t row0 = e * (size_t)M + (size_t)(blockIdx.z % segs) * seg_stride;
    const int rows = min(max(counts[blockIdx.z], 0), rows_cap);
    if (m0 >= rows) return;  // the whole block past the segment's rows
    x += row0 * K;
    w += e * (size_t)K * N;
    out_base = row0 * N;
    M = rows;
  } else {
    kb = blockIdx.z * k_chunk;
    ke = min(K, kb + k_chunk);
  }
  const int n_tiles = (ke - kb + BK - 1) / BK;

  auto load = [&](int t, int slot) {
    const int k0 = kb + t * BK;
    unsigned char* as = a_s + slot * T::A_BYTES;
    unsigned char* bs = b_s + slot * T::B_BYTES;
#pragma unroll
    for (int i = tid; i < T::BM * (BK / 16); i += T::THREADS) {
      const int r = i / (BK / 16), c = i % (BK / 16);
      const int gm = m0 + r, gk = k0 + 16 * c;
      const bool ok = gm < M && gk < ke;
      copy_async16(as + r * LDA + 16 * c, ok ? x + (size_t)gm * K + gk : x, ok);
    }
#pragma unroll
    for (int i = tid; i < BK * (T::BN / 8); i += T::THREADS) {
      const int r = i / (T::BN / 8), c = i % (T::BN / 8);
      const int gk = k0 + r, gn = n0 + 8 * c;
      const bool ok = gk < ke && gn < N;
      copy_async8(bs + r * T::LDB + 8 * c, ok ? w + (size_t)gk * N + gn : w, ok);
    }
  };

  int acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_tiles) load(s, s);
    copies_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    copies_wait<NSTAGE - 2>();
    __syncthreads();  // stage t visible; the slot refilled below was consumed at t - 1
    if (t + NSTAGE - 1 < n_tiles) load(t + NSTAGE - 1, (t + NSTAGE - 1) % NSTAGE);
    copies_commit();
    const int slot = t % NSTAGE;
    const unsigned char* as = a_s + slot * T::A_BYTES + (warp_m * MT * 16) * LDA;
    const unsigned char* bs = b_s + slot * T::B_BYTES + warp_n * 32 + 4 * gid;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t r0[4], r1[4], b0[4], b1[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        r0[r] = *reinterpret_cast<const uint32_t*>(bs + (kk * 32 + 4 * tig + r) * T::LDB);
        r1[r] = *reinterpret_cast<const uint32_t*>(bs + (kk * 32 + 16 + 4 * tig + r) * T::LDB);
      }
      transpose4x4(r0, b0);
      transpose4x4(r1, b1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, as + (mt * 16 + lane % 16) * LDA + kk * 32 + (lane / 16) * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8<XU8>(acc[mt][j], a, b0[j], b1[j]);
      }
    }
  }
  copies_wait<0>();

  // n-tile j's fragment element (row gid + 8h, column 2 tig + e) is the
  // block column 32 warp_n + 8 tig + 4e + j: eight consecutive columns
  const int gc = n0 + warp_n * 32 + 8 * tig;
  if (gc >= N) return;  // N % 8 == 0: all eight in, or out
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + warp_m * MT * 16 + mt * 16 + gid + 8 * h;
      if (gm >= M) continue;
      int v[8];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[4 * e + j] = acc[mt][j][2 * h + e];
      if (GROUPED || gridDim.z == 1) {
        int c[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) c[i] = finish_one(v[i], epi, gc + i);
        store_out<8>(out, out_base + (size_t)gm * N + gc, c, epi);
      } else {
        int4* p = reinterpret_cast<int4*>(ws + ((size_t)blockIdx.z * M + gm) * N + gc);
        p[0] = make_int4(v[0], v[1], v[2], v[3]);
        p[1] = make_int4(v[4], v[5], v[6], v[7]);
      }
    }
}

// split-K's second pass: four outputs a thread, the splits' partials added
// in int32 (wrapping, exact in any order), then the epilogue once (or, for
// the rank-split form's first pass, the sum stored as int32).  With one
// "split" it is the rank-split form's finish: the epilogue once over the
// int32 sums the ranks' partials were reduced into.
__global__ void __launch_bounds__(256)
finish_kernel(const int* __restrict__ ws, void* __restrict__ out, int M, int N, int splits,
              Epi epi) {
  const size_t quads = (size_t)M * N / 4;
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  int4 s = reinterpret_cast<const int4*>(ws)[q];
  for (int z = 1; z < splits; ++z) {
    const int4 p = reinterpret_cast<const int4*>(ws)[(size_t)z * quads + q];
    s.x = wrap_add(s.x, p.x);
    s.y = wrap_add(s.y, p.y);
    s.z = wrap_add(s.z, p.z);
    s.w = wrap_add(s.w, p.w);
  }
  const int gn = (int)((4 * q) % N);
  const int c[4] = {finish_one(s.x, epi, gn), finish_one(s.y, epi, gn + 1),
                    finish_one(s.z, epi, gn + 2), finish_one(s.w, epi, gn + 3)};
  store_out<4>(out, 4 * q, c, epi);
}

// ---------------------------------------------------------------------------
// dp4a_kernel: any shape and alignment (see the header)
// ---------------------------------------------------------------------------
constexpr int DBM = 64;
constexpr int DBN = 64;
constexpr int DBK = 32;
constexpr int DTHREADS = 256;
constexpr int DLDS = DBK + 4;  // shared row stride in bytes (multiple of 4)

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

template <bool XU8>
__global__ void __launch_bounds__(DTHREADS)
dp4a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, void* __restrict__ out,
            int M, int N, int K, int vec, Epi epi) {
  __shared__ __align__(16) int8_t xs[DBM][DLDS];  // [m][k]
  __shared__ __align__(16) int8_t ws[DBN][DLDS];  // [n][k]: transposed tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * DBM, n0 = blockIdx.x * DBN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += DBK) {
    if (vec) {
      // K % 4 == 0 and N % 4 == 0: 4-byte chunks are wholly in or out
      for (int i = tid; i < DBM * (DBK / 4); i += DTHREADS) {
        const int r = i / (DBK / 4), c = i % (DBK / 4);
        const int gm = m0 + r, gk = k0 + 4 * c;
        int v = 0;
        if (gm < M && gk < K) v = *reinterpret_cast<const int*>(x + (size_t)gm * K + gk);
        *reinterpret_cast<int*>(&xs[r][4 * c]) = v;
      }
      for (int i = tid; i < DBK * (DBN / 4); i += DTHREADS) {
        const int kk = i / (DBN / 4), c = i % (DBN / 4);
        const int gk = k0 + kk, gn = n0 + 4 * c;
        int v = 0;
        if (gk < K && gn < N) v = *reinterpret_cast<const int*>(w + (size_t)gk * N + gn);
#pragma unroll
        for (int e = 0; e < 4; ++e) ws[4 * c + e][kk] = (int8_t)(v >> (8 * e));
      }
    } else {
      for (int i = tid; i < DBM * DBK; i += DTHREADS) {
        const int r = i / DBK, kk = i % DBK;
        const int gm = m0 + r, gk = k0 + kk;
        xs[r][kk] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : (int8_t)0;
      }
      for (int i = tid; i < DBK * DBN; i += DTHREADS) {
        const int kk = i / DBN, c = i % DBN;
        const int gk = k0 + kk, gn = n0 + c;
        ws[c][kk] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : (int8_t)0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < DBK / 4; ++kq) {
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
      if (gm < M) store_one(out, (size_t)gm * N + gn, finish_one(acc[i][j], epi, gn), epi);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
// GROUPED: `splits` segments (the grid's z: E experts x segs), M = C rows
// an expert, of which the grid covers rows_cap a segment
template <int MT, int WM, int WN, bool XU8, bool GROUPED>
int launch_mma(const int8_t* x, const int8_t* w, void* out, int* ws, int M, int N, int K,
               int splits, int k_chunk, const Epi& epi, cudaStream_t st,
               const int* counts, int rows_cap, int segs, int seg_stride) {
  using T = Tile<MT, WM, WN>;
  auto kernel = mma_kernel<MT, WM, WN, XU8, GROUPED>;
  // the limit is raised once per instantiation, not per launch
  static const int smem_err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (smem_err != 0) return smem_err;
  const int rows = GROUPED ? rows_cap : M;
  const dim3 grid((N + T::BN - 1) / T::BN, (rows + T::BM - 1) / T::BM, splits);
  kernel<<<grid, T::THREADS, T::SMEM, st>>>(x, w, out, ws, M, N, K, k_chunk, epi, counts,
                                            rows_cap, segs, seg_stride);
  int err = (int)cudaGetLastError();
  if (err != 0 || GROUPED || splits == 1) return err;
  const size_t quads = (size_t)M * N / 4;
  finish_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(ws, out, M, N, splits, epi);
  return (int)cudaGetLastError();
}

// the tile configurations, by the index plan_int8_matmul returns
// (kernels/int8_matmul.py::MMA_TILES mirrors this table)
template <bool XU8, bool GROUPED = false>
int launch_cfg(int cfg, const int8_t* x, const int8_t* w, void* out, int* ws, int M, int N,
               int K, int splits, int k_chunk, const Epi& epi, cudaStream_t st,
               const int* counts = nullptr, int rows_cap = 0, int segs = 1,
               int seg_stride = 0) {
#define K2_ARGS x, w, out, ws, M, N, K, splits, k_chunk, epi, st, counts, rows_cap, segs, \
                seg_stride
  switch (cfg) {
    case 0: return launch_mma<1, 1, 4, XU8, GROUPED>(K2_ARGS);  // M <= 16:  16 x 128
    case 1: return launch_mma<2, 1, 4, XU8, GROUPED>(K2_ARGS);  // M <= 32:  32 x 128
    case 2: return launch_mma<4, 1, 4, XU8, GROUPED>(K2_ARGS);  // M <= 64:  64 x 128
    case 3: return launch_mma<8, 1, 4, XU8, GROUPED>(K2_ARGS);  // M <= 128: 128 x 128
    case 4: return launch_mma<2, 8, 1, XU8, GROUPED>(K2_ARGS);  // 256 x 32
    case 5: return launch_mma<1, 8, 1, XU8, GROUPED>(K2_ARGS);  // 128 x 32
    case 6: return launch_mma<2, 4, 2, XU8, GROUPED>(K2_ARGS);  // 128 x 64
    case 7: return launch_mma<1, 4, 2, XU8, GROUPED>(K2_ARGS);  // 64 x 64
    case 8: return launch_mma<4, 2, 4, XU8, GROUPED>(K2_ARGS);  // 128 x 128
    case 9: return launch_mma<2, 2, 4, XU8, GROUPED>(K2_ARGS);  // 64 x 128
  }
#undef K2_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry: launches on `stream`; returns cudaGetLastError() (0 on success).
// cfg: a tile configuration of the mma kernel (0..9), or -1 for the dp4a
// kernel.  The mma kernel takes K % 16 == 0, N % 8 == 0, x 16-byte and w
// 8-byte aligned, k_chunk a multiple of 64 with every one of `splits`
// splits nonempty, and ws (splits x M x N int32) when splits > 1.
// x_u8: the activation codes are uint8 (else int8); weights are int8.
// out_kind: 0 one byte a code, 1 bf16 / 2 fp32 values code * deq (deq =
// 2^-n_o), 3 the raw int32 sums with no epilogue (the rank-split form's
// first pass: bias and the epilogue's arguments unread), the output 16-byte
// aligned unless it holds codes.
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* bias, void* out,
                                  void* ws, int M, int N, int K, int shift, int bias_shift,
                                  int relu, int lo, int hi, int x_u8, int cfg, int splits,
                                  int k_chunk, int out_kind, float deq, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  const Epi epi{static_cast<const int8_t*>(bias), shift, bias_shift, relu, lo, hi, out_kind,
                deq};
  if (M <= 0 || N <= 0 || K <= 0 || out_kind < OUT_CODES || out_kind > OUT_I32 ||
      (out_kind != OUT_CODES && ((uintptr_t)out & 15u)))
    return (int)cudaErrorInvalidValue;
  if (cfg < 0) {
    const int vec =
        K % 4 == 0 && N % 4 == 0 && ((uintptr_t)x & 3u) == 0 && ((uintptr_t)w & 3u) == 0;
    const dim3 grid((N + DBN - 1) / DBN, (M + DBM - 1) / DBM);
    if (x_u8)
      dp4a_kernel<true><<<grid, DTHREADS, 0, st>>>(xs, wt, out, M, N, K, vec, epi);
    else
      dp4a_kernel<false><<<grid, DTHREADS, 0, st>>>(xs, wt, out, M, N, K, vec, epi);
    return (int)cudaGetLastError();
  }
  if (K % 16 || N % 8 || ((uintptr_t)x & 15u) || ((uintptr_t)w & 7u) || splits <= 0 ||
      k_chunk <= 0 || k_chunk % BK || (long long)(splits - 1) * k_chunk >= K ||
      (long long)splits * k_chunk < K || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  int* wsi = static_cast<int*>(ws);
  if (x_u8) return launch_cfg<true>(cfg, xs, wt, out, wsi, M, N, K, splits, k_chunk, epi, st);
  return launch_cfg<false>(cfg, xs, wt, out, wsi, M, N, K, splits, k_chunk, epi, st);
}

// C entry of the RANK-SPLIT form's finish: K2's epilogue once over the
// (M, N) int32 sums `acc` (16-byte aligned; N % 4 == 0) -- bias, ReLU,
// shift-requant, clip -- stored as out_kind says (codes, or bf16 / fp32
// values code * deq, the output 16-byte aligned).
extern "C" int int8_matmul_finish_launch(const void* acc, const void* bias, void* out, int M,
                                         int N, int shift, int bias_shift, int relu, int lo,
                                         int hi, int out_kind, float deq, void* stream) {
  if (M <= 0 || N <= 0 || N % 4 || out_kind < OUT_CODES || out_kind > OUT_F32 ||
      ((uintptr_t)acc & 15u) || (out_kind != OUT_CODES && ((uintptr_t)out & 15u)) ||
      (out_kind == OUT_CODES && ((uintptr_t)out & 3u)))
    return (int)cudaErrorInvalidValue;
  const Epi epi{static_cast<const int8_t*>(bias), shift, bias_shift, relu, lo, hi, out_kind,
                deq};
  const size_t quads = (size_t)M * N / 4;
  finish_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(acc), out, M, N, 1, epi);
  return (int)cudaGetLastError();
}

// C entry of the grouped form (the experts' (E, C, K) x (E, K, N)
// products, one launch).  Expert e's C rows are `segs` segments of
// `seg_stride` rows (segs * seg_stride <= C): segment s's first
// min(counts[e * segs + s], rows_cap) rows (counts: E x segs int32 on the
// card) are multiplied by the expert's weight codes and stored as
// out_kind says -- K2's epilogue (no bias, no ReLU) to codes or their bf16
// / fp32 values, or (OUT_I32) the raw int32 sums, whose epilogue
// int8_matmul_finish_launch runs once after they are summed over the
// ranks that hold the other rows of K -- and rows past them are left
// unwritten.  One segment (segs 1, seg_stride C) is the one-shard layout.
// int8 activations; the mma kernel's conditions (K % 16 == 0, N % 8 ==
// 0, x 16-byte and w 8-byte aligned); rows_cap <= seg_stride;
// E * segs <= 65535.
extern "C" int int8_matmul_grouped_launch(const void* x, const void* w, const void* counts,
                                          void* out, int E, int C, int rows_cap, int N, int K,
                                          int shift, int lo, int hi, int cfg, int out_kind,
                                          float deq, int segs, int seg_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epi epi{nullptr, shift, 0, 0, lo, hi, out_kind, deq};
  if (E <= 0 || C <= 0 || segs <= 0 || (long long)E * segs > 65535 || seg_stride <= 0 ||
      (long long)segs * seg_stride > C || rows_cap <= 0 || rows_cap > seg_stride || N <= 0 ||
      K <= 0 || cfg < 0 || counts == nullptr || out_kind < OUT_CODES || out_kind > OUT_I32 ||
      (out_kind != OUT_CODES && ((uintptr_t)out & 15u)) || K % 16 || N % 8 ||
      ((uintptr_t)x & 15u) || ((uintptr_t)w & 7u))
    return (int)cudaErrorInvalidValue;
  return launch_cfg<false, true>(cfg, static_cast<const int8_t*>(x),
                                 static_cast<const int8_t*>(w), out, nullptr, C, N, K, E * segs,
                                 K, epi, st, static_cast<const int*>(counts), rows_cap, segs,
                                 seg_stride);
}
