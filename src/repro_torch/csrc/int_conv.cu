// Integer convolution: NHWC int8 / uint8 codes x HWIO int8 weights -> NHWC
// int8 / uint8 codes, int32 accumulation and the bit-shift requant
// epilogue, in one kernel (implicit GEMM).  Optionally the residual
// epilogue: the branch's code added to a shortcut's on a common grid, ReLU
// and one requant, as K7 computes it, so the residual add never launches.
//
// Replaces no Pallas kernel: the JAX package computes the convolution with
// XLA (lax.conv_general_dilated, repro/core/integer_ops.py::int_conv2d)
// and its residual add in jnp (int_residual_add), whose Pallas twin is K7
// (repro/kernels/residual_requant.py::residual_requant_kernel).  It takes
// every convolution of the ResNet's integer forward
// (models/resnet.py::resnet_int_forward), each block's conv2 with the
// residual epilogue: K7's redesign on the path.
//
// What bounds it on an H100: bytes.  M = B H' W' output pixels, N = Cout,
// K = KH KW Cin; the ResNet's N of 16 / 32 / 64 gives 2N <= 128 int8
// operations per activation byte, under the card's int8 ridge of about
// 590.  Its bytes are the input read once, the weights, the output (and
// the shortcut) once: no im2col matrix exists in device memory, and the
// residual epilogue saves the branch's write, its read-back and a launch a
// block.
//
// Design (the tile of int8_tile.cuh, as K2's mma_kernel): a block computes
// BM output pixels x BN output channels; K is walked in 64-deep stages
// through a 4-stage cp.async ring.  The A stage is gathered from the NHWC
// codes through the convolution's index map: row r's pixel (b, oh, ow) is
// decoded once a block into shared memory (the first input row and column
// its window touches, XLA's "SAME" padding applied), and K column k =
// (kh KW + kw) Cin + c (the order of an HWIO weight reshaped to (K, Cout))
// reads input (b, ih0 + kh, iw0 + kw, c).  Where Cin % 16 == 0 (every
// convolution past the stem) a 16-byte chunk of a stage row is 16 channels
// of one tap: one cp.async.ca (through L1, where the block's overlapping
// windows find the taps they share), zero-filled (src-size 0) on a padding
// tap.  Otherwise (the stem: Cin 3, K 27) a thread owns a run of one row's
// columns and walks its taps incrementally, byte by byte, storing four
// bytes at a time.  A's columns past K are not written: B's rows past K
// are zero-filled, so whatever they hold adds 0.  The ring holds only the
// stages K needs (the stem one, the first stage's convolutions three), so
// more blocks fit an SM.  B is the (K, N) weight matrix as it lies, 8-byte
// copies of a row (bytes where N % 8 != 0), zero past K and N.  A warp owns
// 16 columns (N = 16: two n8 tiles, transpose4x2) or 32 (four, as K2), so
// the narrow Cout of the ResNet's first stage wastes no tensor-core work.
// Tiles: 16 / 32 / 64 columns by Cout, and the taller of two row counts
// while it still gives every SM a block (256 rows on eight warps or 128 on
// four for 16 / 32 columns; 128 or 64 rows on eight warps for 64), chosen
// on the host from the shapes alone (kernels/int_conv.py::plan_int_conv;
// its CONV_TILES mirror launch_cfg).
//
// Epilogue in registers, per accumulator: K2's epilogue() (bias aligned,
// optional ReLU, one shift-requant, clip to the branch's int8 / uint8
// range).  With a shortcut, the branch code is then handed to
// residual_one<true>() (K7's arithmetic, the saturating form of
// integer_ops.int_residual_add) with the shortcut's code read at the
// output's own offset (int8 or uint8), and the sum's code is stored.  A
// lane stores 2 NJ consecutive codes of a row as one 4- / 8-byte word
// where aligned, else byte by byte.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

// NHWC input (B, H, W, C) and HWIO weights (KH, KW, C, N) read as the
// (K = KH KW C, N) matrix; the output (B, HO, WO, N) is M = B HO WO rows
struct Geom {
  int H, W, C, HO, WO, N, KW, stride, pad_t, pad_l, M, K;
  int b_vec;  // 8-byte weight copies (w 8-byte aligned, N % 8 == 0)
  int o_vec;  // word stores and shortcut loads (8-byte aligned, N % 8 == 0)
};

// the residual epilogue's shortcut (nullptr: the plain epilogue)
struct Res {
  const uint8_t* sc;
  int sc_u8;
  ResParams p;
};

// a row past M gets this first input row: every tap falls outside the image
constexpr int ROW_PAST_M = -(1 << 28);

// cp.async.ca: the copy also fills L1, where a block's neighbouring
// windows find the taps they share (a 3x3 window reads each input pixel
// up to nine times)
__device__ __forceinline__ void copy_async16_l1(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

template <int MT, int WM, int WN, int NJ, bool XU8, bool AVEC>
__global__ void __launch_bounds__(Tile<MT, WM, WN, NJ>::THREADS)
conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            uint8_t* __restrict__ out, Geom g, Epi epi, Res res) {
  using T = Tile<MT, WM, WN, NJ>;
  constexpr int NC = 2 * NJ;  // consecutive columns a lane holds in a row
  const int n_tiles = (g.K + BK - 1) / BK;
  const int ns = min(NSTAGE, n_tiles);  // ring slots in use: a short K takes less memory
  extern __shared__ __align__(16) unsigned char smem[];
  int4* rows = reinterpret_cast<int4*>(smem);           // [BM]
  unsigned char* a_s = smem + T::BM * sizeof(int4);     // [ns][BM][LDA]
  unsigned char* b_s = a_s + ns * T::A_BYTES;           // [ns][BK][LDB]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp / WN, warp_n = warp % WN;
  const int gid = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;

  // row r: (first pixel of its image, first input row, first input column)
  for (int r = tid; r < T::BM; r += T::THREADS) {
    const int gm = m0 + r;
    int4 info = make_int4(0, ROW_PAST_M, ROW_PAST_M, 0);
    if (gm < g.M) {
      const int hw = g.HO * g.WO;
      const int b = gm / hw, rem = gm - b * hw;
      const int oh = rem / g.WO, ow = rem - oh * g.WO;
      info = make_int4(b * g.H * g.W, oh * g.stride - g.pad_t, ow * g.stride - g.pad_l, 0);
    }
    rows[r] = info;
  }
  __syncthreads();

  // the input element of tap (kh, kw), channel ci for row info, or nullptr
  // (a padding tap)
  auto tap_src = [&](const int4& info, int kh, int kw, int ci) -> const int8_t* {
    const int ih = info.y + kh, iw = info.z + kw;
    if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return nullptr;
    return x + (size_t)(info.x + ih * g.W + iw) * g.C + ci;
  };

  auto load = [&](int t, int slot) {
    const int k0 = t * BK;
    unsigned char* as = a_s + slot * T::A_BYTES;
    unsigned char* bs = b_s + slot * T::B_BYTES;
    if constexpr (AVEC) {
      // a thread's chunks all sit at one column of the stage (THREADS is a
      // multiple of BK / 16), so their tap is found once a stage
      static_assert(T::THREADS % (BK / 16) == 0, "a thread keeps one chunk column");
      const int c = tid % (BK / 16), gk = k0 + 16 * c;
      const int tap = gk / g.C, kh = tap / g.KW, kw = tap - kh * g.KW, ci = gk - tap * g.C;
      if (gk < g.K) {
#pragma unroll
        for (int i = tid; i < T::BM * (BK / 16); i += T::THREADS) {
          const int r = i / (BK / 16);
          const int8_t* src = tap_src(rows[r], kh, kw, ci);
          copy_async16_l1(as + r * LDA + 16 * c, src != nullptr ? src : x, src != nullptr);
        }
      }
    } else {
      // a row's stage is cut into PARTS runs of PER columns; a thread
      // owns a run and walks its taps incrementally, four bytes a
      // shared-memory store
      constexpr int PARTS = T::THREADS >= T::BM ? T::THREADS / T::BM : 1;
      constexpr int PER = BK / PARTS;
      for (int idx = tid; idx < T::BM * PARTS; idx += T::THREADS) {
        const int r = idx % T::BM, kk0 = (idx / T::BM) * PER;
        const int4 info = rows[r];
        int gk = k0 + kk0;
        int tap = gk / g.C, ci = gk - tap * g.C;
        int kh = tap / g.KW, kw = tap - kh * g.KW;
#pragma unroll 4
        for (int j = 0; j < PER && gk < g.K; j += 4) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e, ++gk) {
            const int8_t* src = gk < g.K ? tap_src(info, kh, kw, ci) : nullptr;
            if (src != nullptr) word |= (uint32_t)(uint8_t)*src << (8 * e);
            if (++ci == g.C) {
              ci = 0;
              if (++kw == g.KW) {
                kw = 0;
                ++kh;
              }
            }
          }
          *reinterpret_cast<uint32_t*>(as + r * LDA + kk0 + j) = word;
        }
      }
    }
    if (g.b_vec) {
#pragma unroll
      for (int i = tid; i < BK * (T::BN / 8); i += T::THREADS) {
        const int r = i / (T::BN / 8), c = i % (T::BN / 8);
        const int gk = k0 + r, gn = n0 + 8 * c;
        const bool ok = gk < g.K && gn < g.N;
        copy_async8(bs + r * T::LDB + 8 * c, ok ? w + (size_t)gk * g.N + gn : w, ok);
      }
    } else {
      for (int i = tid; i < BK * T::BN; i += T::THREADS) {
        const int r = i / T::BN, c = i % T::BN;
        const int gk = k0 + r, gn = n0 + c;
        bs[r * T::LDB + c] =
            gk < g.K && gn < g.N ? (unsigned char)w[(size_t)gk * g.N + gn] : 0;
      }
    }
  };

  int acc[MT][NJ][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_tiles) load(s, s);
    copies_commit();
  }
  // slot t % NSTAGE: with fewer than NSTAGE stages in all, slots past ns
  // are never touched
  for (int t = 0; t < n_tiles; ++t) {
    copies_wait<NSTAGE - 2>();
    __syncthreads();  // stage t visible; the slot refilled below was consumed at t - 1
    if (t + NSTAGE - 1 < n_tiles) load(t + NSTAGE - 1, (t + NSTAGE - 1) % NSTAGE);
    copies_commit();
    const int slot = t % NSTAGE;
    const unsigned char* as = a_s + slot * T::A_BYTES + (warp_m * MT * 16) * LDA;
    const unsigned char* bs = b_s + slot * T::B_BYTES + warp_n * 8 * NJ + NJ * gid;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      if (t * BK + kk * 32 >= g.K) break;  // a zero-filled step (the stem's, a short K's)
      uint32_t r0[4], r1[4], b0[NJ], b1[NJ];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const unsigned char* p0 = bs + (kk * 32 + 4 * tig + r) * T::LDB;
        const unsigned char* p1 = p0 + 16 * T::LDB;
        if constexpr (NJ == 4) {
          r0[r] = *reinterpret_cast<const uint32_t*>(p0);
          r1[r] = *reinterpret_cast<const uint32_t*>(p1);
        } else {
          r0[r] = *reinterpret_cast<const uint16_t*>(p0);
          r1[r] = *reinterpret_cast<const uint16_t*>(p1);
        }
      }
      if constexpr (NJ == 4) {
        transpose4x4(r0, b0);
        transpose4x4(r1, b1);
      } else {
        transpose4x2(r0, b0);
        transpose4x2(r1, b1);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, as + (mt * 16 + lane % 16) * LDA + kk * 32 + (lane / 16) * 16);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_s8<XU8>(acc[mt][j], a, b0[j], b1[j]);
      }
    }
  }
  copies_wait<0>();

  // n-tile j's fragment element (row gid + 8h, column 2 tig + e) is the
  // block column 8 NJ warp_n + 2 NJ tig + NJ e + j: NC consecutive columns
  const int gc = n0 + warp_n * 8 * NJ + NC * tig;
  if (gc >= g.N) return;
  const bool full = gc + NC <= g.N;
  const bool words = full && g.o_vec;
  int bias[NC];  // the lane's columns' aligned bias, the same on every row
#pragma unroll
  for (int i = 0; i < NC; ++i) bias[i] = gc + i < g.N ? aligned_bias(epi, gc + i) : 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + warp_m * MT * 16 + mt * 16 + gid + 8 * h;
      if (gm >= g.M) continue;
      const size_t off = (size_t)gm * g.N + gc;
      int c[NC];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int i = NJ * e + j;
          c[i] = epilogue_aligned(acc[mt][j][2 * h + e], bias[i], epi);
        }
      if (res.sc != nullptr) {
        uint32_t s[NC / 4];
        if (words) {
          if constexpr (NC == 8) {
            const uint2 v = *reinterpret_cast<const uint2*>(res.sc + off);
            s[0] = v.x;
            s[1] = v.y;
          } else {
            s[0] = *reinterpret_cast<const uint32_t*>(res.sc + off);
          }
        } else {
#pragma unroll
          for (int q = 0; q < NC / 4; ++q) {
            s[q] = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (gc + 4 * q + i < g.N) s[q] |= (uint32_t)res.sc[off + 4 * q + i] << (8 * i);
          }
        }
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const uint32_t byte = (s[i / 4] >> (8 * (i % 4))) & 0xffu;
          const int b = res.sc_u8 ? (int)byte : (int)(int8_t)byte;
          c[i] = residual_one<true>(c[i], b, res.p);
        }
      }
      if (words) {
        uint32_t q[NC / 4];
#pragma unroll
        for (int k = 0; k < NC / 4; ++k) {
          q[k] = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) q[k] |= ((uint32_t)c[4 * k + i] & 0xffu) << (8 * i);
        }
        if constexpr (NC == 8)
          *reinterpret_cast<uint2*>(out + off) = make_uint2(q[0], q[1]);
        else
          *reinterpret_cast<uint32_t*>(out + off) = q[0];
      } else {
#pragma unroll
        for (int i = 0; i < NC; ++i)
          if (gc + i < g.N) out[off + i] = (uint8_t)(c[i] & 0xff);
      }
    }
}

template <int MT, int WM, int WN, int NJ, bool XU8, bool AVEC>
int launch(const int8_t* x, const int8_t* w, uint8_t* out, const Geom& g, const Epi& epi,
           const Res& res, cudaStream_t st) {
  using T = Tile<MT, WM, WN, NJ>;
  constexpr int ROWS = T::BM * (int)sizeof(int4);
  auto kernel = conv_kernel<MT, WM, WN, NJ, XU8, AVEC>;
  // the limit is raised once per instantiation, not per launch
  static const int smem_err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ROWS + T::SMEM);
  if (smem_err != 0) return smem_err;
  const int ns = min(NSTAGE, (g.K + BK - 1) / BK);
  const int smem = ROWS + ns * (T::A_BYTES + T::B_BYTES);
  const dim3 grid((g.M + T::BM - 1) / T::BM, (g.N + T::BN - 1) / T::BN);
  kernel<<<grid, T::THREADS, smem, st>>>(x, w, out, g, epi, res);
  return (int)cudaGetLastError();
}

// the tile configurations, by the index plan_int_conv returns
// (kernels/int_conv.py::CONV_TILES mirrors this table)
template <bool XU8, bool AVEC>
int launch_cfg(int cfg, const int8_t* x, const int8_t* w, uint8_t* out, const Geom& g,
               const Epi& epi, const Res& res, cudaStream_t st) {
#define CONV_ARGS x, w, out, g, epi, res, st
  switch (cfg) {
    case 0: return launch<2, 8, 1, 2, XU8, AVEC>(CONV_ARGS);  // 256 x 16
    case 1: return launch<2, 4, 1, 2, XU8, AVEC>(CONV_ARGS);  // 128 x 16
    case 2: return launch<2, 8, 1, 4, XU8, AVEC>(CONV_ARGS);  // 256 x 32
    case 3: return launch<2, 4, 1, 4, XU8, AVEC>(CONV_ARGS);  // 128 x 32
    case 4: return launch<2, 4, 2, 4, XU8, AVEC>(CONV_ARGS);  // 128 x 64
    case 5: return launch<1, 4, 2, 4, XU8, AVEC>(CONV_ARGS);  // 64 x 64
  }
#undef CONV_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry: launches on `stream`; returns cudaGetLastError() (0 on success).
// x (B, H, W, C) int8 codes, or uint8 with x_u8; w (KH, KW, C, N) int8;
// bias (N,) int8 or null; out (B, HO, WO, N) one byte a code.  The plain
// epilogue: bias shifted by bias_shift, ReLU with relu, shift-requant by
// shift, clipped to lo..hi.  sc (B, HO, WO, N) codes (uint8 with sc_u8,
// else int8) or null: then the clipped code a and the shortcut's b become
// requant(ReLU((a << sa) + (b << sb)), res_shift) clipped to 0..255 (the
// reference's add: ReLU, 8-bit unsigned codes whatever the convolution's
// bit width), a negative res_shift saturating first.  cfg indexes the tile
// table of launch_cfg.
extern "C" int int_conv_launch(const void* x, const void* w, const void* bias, void* out,
                               const void* sc, int B, int H, int W, int C, int N, int KH,
                               int KW, int stride, int pad_t, int pad_l, int HO, int WO,
                               int shift, int bias_shift, int relu, int lo, int hi, int x_u8,
                               int sc_u8, int sa, int sb, int res_shift, int cfg,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long m = (long long)B * HO * WO;
  const long long k = (long long)KH * KW * C;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || KH <= 0 || KW <= 0 || stride <= 0 ||
      HO <= 0 || WO <= 0 || m > 0x7fffffffLL || k > 0x7fffffffLL ||
      (long long)B * H * W * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int o_vec = N % 8 == 0 && ((uintptr_t)out & 7u) == 0 && ((uintptr_t)sc & 7u) == 0;
  const Geom g{H, W, C, HO, WO, N, KW, stride, pad_t, pad_l, (int)m, (int)k,
               N % 8 == 0 && ((uintptr_t)w & 7u) == 0, o_vec};
  const Epi epi{static_cast<const int8_t*>(bias), shift, bias_shift, relu, lo, hi, 0, 1.0f};
  const Res res{static_cast<const uint8_t*>(sc), sc_u8,
                ResParams{sa, sb, res_shift, 1, 0, 255}};
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int8_t* ws = static_cast<const int8_t*>(w);
  uint8_t* o = static_cast<uint8_t*>(out);
  const bool avec = C % 16 == 0 && ((uintptr_t)x & 15u) == 0;
  if (x_u8) {
    if (avec) return launch_cfg<true, true>(cfg, xs, ws, o, g, epi, res, st);
    return launch_cfg<true, false>(cfg, xs, ws, o, g, epi, res, st);
  }
  if (avec) return launch_cfg<false, true>(cfg, xs, ws, o, g, epi, res, st);
  return launch_cfg<false, false>(cfg, xs, ws, o, g, epi, res, st);
}
