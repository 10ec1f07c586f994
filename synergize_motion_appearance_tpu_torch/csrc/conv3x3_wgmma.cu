// 3x3, stride-1, pad-1 convolution plus bias on Hopper's warpgroup tensor
// cores (sm_90a): bfloat16, NCHW or NHWC.
//
// Replaces, for bf16 inputs whose layout TMA can read (ops/conv3x3.py::plan),
// the same two TPU kernels as conv3x3.cu, and computes their function as
// that file's bf16 kernel does:
// - `_conv_wl_kernel` (synergize_motion_appearance_tpu/ops/
//   pallas_conv_wl.py:39, launched by `conv3x3_wl` at :144, its VJP
//   `conv3x3_wl_ad` at :175-193; kernel K3): NCHW x, (Cout, C, 3, 3)
//   weights, a bf16 bias; the input gradient is the same conv on the
//   rotated, channel-swapped weights (packing mode 1);
// - `_conv_kernel` (synergize_motion_appearance_tpu/ops/pallas_conv.py:39,
//   launched by `conv3x3_pallas` at :96; kernel K4): NHWC x, HWIO weights
//   rounded to bf16 by the caller, a float32 bias.
//   y[b, o, h, w] = bias[o] + sum_{c, ky, kx} x[b, c, h+ky-1, w+kx-1]
//                                             * wt[o, c, ky, kx]
// with zero padding, f32 accumulation and one rounding to bf16. The
// mma.sync kernel of conv3x3.cu keeps the bf16 shapes this one does not
// take (NCHW rows or NHWC pixels whose byte stride is not a multiple of 16,
// bases not 16-byte aligned), and float32.
//
// What bounds it: at the training step's decoder shapes (C, Cout 64..256,
// 64^2..256^2 pixels, batch 2) a conv does 2*9*C FLOP per output value
// against a few bytes per value moved, so it is bound by the tensor cores'
// bf16 rate (989 TFLOP/s), as chip_smoke.py states the bound. Only `wgmma`
// reaches that rate (mma.sync about half); the rest of the design keeps the
// warpgroup's operands in shared memory and its issue slots free.
//
// The design: an implicit GEMM with M = output pixels (a tile of TH rows of
// 64, one m64 wgmma per row), N = BN output channels (64 or 128), K = 9 taps
// x C, walked in chunks of 64 input channels.
// - Roles: one consumer warpgroup runs the wgmmas (f32 accumulators in
//   registers) and the epilogue; one producer warp issues every copy by TMA
//   from one lane; in NCHW a warpgroup of transposers beside them. The roles
//   split on a warp-uniform index taken with __shfl_sync (a split on
//   threadIdx.x made ptxas serialize wgmmas, note C7520, in the attention
//   kernel). One block an SM (its rings take 139-231 KB of shared memory),
//   but for the paired NCHW 64-channel tiles (ConvGeometry).
// - The input halo tile of a chunk, (TH+2) rows of kPW pixels, is staged
//   once and serves all 9 taps: pixel-major, one 128-byte row of 64
//   channels per pixel, in the 128-byte swizzle. NHWC: one 4-d TMA box (64
//   channels, 72 pixels, TH+2 rows) at (c0, x0-1, y0-1, b) lands in that
//   layout. NCHW: TH+2 boxes of (80 pixels, 64 channels) at x0-8, one per
//   halo row, land channel-major in a staging area (a box's innermost start
//   must be 16-byte aligned: from x0-1 the copy faulted); the transposers
//   turn it into the pixel-major tile with `ldmatrix.trans` (8 channels x 8
//   pixels, a pixel's channel pair to each lane) and `stmatrix` (8 swizzled
//   pixel rows), while the consumer multiplies the previous chunk. TMA
//   fills coordinates outside the tensor with zeros: the padding, and
//   channels past C, cost no branch.
// - The A operand of output row t at tap (ky, kx) is the 64 pixel rows that
//   start at row (t+ky)*kPW + kLeft-1 + kx of the tile: a wgmma shared-
//   memory descriptor whose start moves by whole 128-byte rows (`a_desc`),
//   so no tap copies or reloads the tile. A k16 step is 32 bytes further
//   along the swizzled rows, as for any K-major operand.
// - Weights: the packed (9, Coutp, Cp) copy of conv3x3_pack.cuh, written
//   just before by `conv3x3_kernel_wpack` (layout, rotation and padding
//   folded in), is already K-major B tiles: a 3-d TMA box (64 channels, BN
//   output channels, one tap) per step into a ring of its own.
// - Each step (one tap of one chunk) issues TH x 4 wgmmas m64nBNk16 as one
//   group; the wait for the previous group releases its weight stage (and,
//   at a chunk's first tap, the previous chunk's tile; with one tile, the
//   chunk's end waits for its last group and releases it). Every ring has
//   a full and an empty mbarrier; a wait that outlasts 2^26 polls traps.
// - Epilogue: bias in f32, one rounding to bf16, through shared memory so
//   that the stores run in 16-byte vectors along W (NCHW) or along the
//   channels (NHWC).
// The kernel allocates nothing and runs on the caller's stream.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3x3_pack.cuh"
#include "hopper_async.cuh"

namespace {

constexpr int kKc = 64;        // input channels per chunk
constexpr int kRowBytes = 128;  // a staged pixel row: kKc bf16, swizzled
constexpr int kTW = 64;        // output columns per tile: wgmma's m
constexpr int kConsumers = 128;  // the consumer warpgroup
constexpr int kSwizzle128 = 1;   // wgmma layout type of the 128-byte swizzle
constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8-row core-matrix group
static_assert(kPackCi % 8 == 0, "a packed row is whole 16-byte units");

// Shared memory of a block, from a base aligned to 1024 bytes (the
// swizzle's period): the input ring (NHWC: pixel-major tiles; NCHW: the
// channel-major halo rows as loaded), in NCHW the pixel-major tiles, the
// weight ring, the barriers. A channel-major halo row (64 channels x kPW
// pixels) and a pixel-major one (kPW pixels x 64 channels) are both
// kPW * 128 bytes. The epilogue's output tile reuses the rings.
template <int TH, int BN, bool NHWC, bool PAIR>
struct ConvGeometry {
  // a staged halo row: kPW pixels from x0 - kLeft (NHWC: the tile's 64
  // columns and both neighbours, to a multiple of 8; NCHW: from the 8-pixel
  // run before the tile, since a box's innermost start must be 16-byte
  // aligned: a box from x0 - 1 faulted, "illegal instruction"). The A
  // operand of tap kx starts kLeft - 1 + kx pixels into a row.
  static constexpr int kPW = NHWC ? 72 : 80;
  static constexpr int kLeft = NHWC ? 1 : 8;
  static constexpr int kHaloRowBytes = kPW * kRowBytes;
  static constexpr int kTileBytes = (TH + 2) * kHaloRowBytes;
  static constexpr int kWBytes = BN * kRowBytes;
  // Ring depths: stages of the input ring (kXS), NCHW pixel tiles (kPX),
  // weight stages of one tap each (kWS). PAIR (NCHW 64-channel tiles): one
  // of each input kind and 3 weight stages, so that two blocks share an SM
  // and one block's copies, transposition and epilogue run under the
  // other's wgmmas, at the price of a block's chunks running one after
  // another; else one block an SM with deeper rings (NHWC's 64-channel
  // tiles fit two an SM as they are).
  static_assert(!PAIR || (!NHWC && BN == 64), "paired tiles");
  static constexpr int kXS = PAIR ? 1 : 2;
  static constexpr int kPX = NHWC ? 0 : PAIR ? 1 : 2;
  static constexpr int kWS = PAIR ? 3 : 4;
  static constexpr int kBlocks = PAIR ? 2 : 1;  // resident on an SM
  static constexpr int kPix0 = kXS * kTileBytes;
  static constexpr int kW0 = kPix0 + kPX * kTileBytes;
  static constexpr int kBars = kW0 + kWS * kWBytes;
  static constexpr int kSmem =
      kBars + 8 * 2 * (kXS + kPX + kWS) + 1024;
  static constexpr int kThreads = kConsumers + 32 + (NHWC ? 0 : 128);
  static constexpr int kM = TH * kTW;
  // output tile, bf16: NCHW [BN][kM + 8], NHWC [kM][BN + 8]
  static constexpr int kOutBytes = 2 * (NHWC ? kM * (BN + 8) : BN * (kM + 8));
  static_assert(kOutBytes <= kBars, "the output tile fits in the rings");
  static_assert(kSmem <= 232448 && kBlocks * (kSmem + 1024) <= 233472,
                "the blocks' shared memory on an SM");
};

// A operand: 64 pixel rows of a staged tile from byte address `addr`, at
// any row. The hardware swizzles by address (bits 4-6 XOR bits 7-9), as TMA
// wrote the tile, so the descriptor's matrix base offset stays 0: set to
// the start's row within the 1024-byte pattern, it gave wrong products at
// every start that is not a multiple of 8 rows, on an H100.
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return make_desc(addr, kGroupBytes, kSwizzle128);
}

// d (64 x 128) += a (64 x 16) * b (16 x 128), a and b in shared memory,
// both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (BN == 128) {
    wgmma_ss_n128(d, a, b);
  } else {
    wgmma_ss_n64(d, a, b, 1);
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr,
                                            const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ float bias_at(const __nv_bfloat16* b, int o) {
  return __bfloat162float(b[o]);
}
__device__ __forceinline__ float bias_at(const float* b, int o) {
  return b[o];
}

// TH output rows x 64 columns x BN output channels a block. xmap: NHWC the
// 4-d map (C, W, H, B) in boxes (64, 72, TH+2, 1), swizzled; NCHW the 4-d
// map (W, H, C, B) in boxes (80, 1, 64, 1). wmap: the packed weights
// (Cp, Coutp, 9) in boxes (64, BN, 1), swizzled. TB is the bias type: bf16
// in NCHW (K3), float in NHWC (K4).
template <int TH, int BN, bool NHWC, bool PAIR, typename TB>
__global__ void __launch_bounds__(ConvGeometry<TH, BN, NHWC, PAIR>::kThreads,
                                  ConvGeometry<TH, BN, NHWC, PAIR>::kBlocks)
conv3x3_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const TB* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int C, int H, int W,
                     int Cout, int tiles_w) {
  using G = ConvGeometry<TH, BN, NHWC, PAIR>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t x_full = base + G::kBars;  // input stage s: + 8 s
  const uint32_t x_empty = x_full + 8 * G::kXS;
  const uint32_t pix_full = x_empty + 8 * G::kXS;  // NCHW pixel tile p: + 8 p
  const uint32_t pix_empty = pix_full + 8 * G::kPX;
  const uint32_t w_full = pix_empty + 8 * G::kPX;  // weight stage s: + 8 s
  const uint32_t w_empty = w_full + 8 * G::kWS;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * kTW;
  const int nchunks = (C + kKc - 1) / kKc;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kXS; ++s) {
      mbar_init(x_full + 8 * s, 1);                // the producer's expect
      mbar_init(x_empty + 8 * s, NHWC ? 1 : 128);  // consumer / transposers
    }
    for (int p = 0; p < G::kPX; ++p) {
      mbar_init(pix_full + 8 * p, 128);  // the transposers
      mbar_init(pix_empty + 8 * p, 1);   // one consumer thread
    }
    for (int s = 0; s < G::kWS; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (warp == 4) {
    // ---- producer warp: lane 0 issues every copy, in the order the
    // consumer takes them; chunk k+1's tile after chunk k's first tap, whose
    // wait frees that tile's stage ----
    if (lane != 0) return;
    const CUtensorMap* xm = &xmap;
    auto load_x = [&](int k) {
      const int st = k % G::kXS;
      if (k >= G::kXS) mbar_wait(x_empty + 8 * st, (k / G::kXS - 1) & 1);
      const uint32_t bar = x_full + 8 * st;
      const uint32_t dst = base + st * G::kTileBytes;
      mbar_expect(bar, G::kTileBytes);
      if constexpr (NHWC) {
        tma_load_4d(dst, xm, bar, k * kKc, x0 - G::kLeft, y0 - 1, b);
      } else {
        for (int hy = 0; hy < TH + 2; ++hy) {
          tma_load_4d(dst + hy * G::kHaloRowBytes, xm, bar, x0 - G::kLeft,
                      y0 - 1 + hy, k * kKc, b);
        }
      }
    };
    load_x(0);
    int s = 0;
    for (int k = 0; k < nchunks; ++k) {
      for (int tap = 0; tap < 9; ++tap, ++s) {
        const int ws = s % G::kWS;
        if (s >= G::kWS) mbar_wait(w_empty + 8 * ws, (s / G::kWS - 1) & 1);
        mbar_expect(w_full + 8 * ws, G::kWBytes);
        tma_load(base + G::kW0 + ws * G::kWBytes, &wmap, w_full + 8 * ws,
                 k * kKc, n0, tap);
        if (tap == 0 && k + 1 < nchunks) load_x(k + 1);
      }
    }
    return;
  }
  if (warp > 4) {
    // ---- NCHW transposers: chunk k's channel-major rows -> pixel tile
    // k % kPX. A step takes one 8-pixel run of a halo row for 32 channels:
    // four 8 x 8 blocks (channels x pixels), each written as 8 swizzled
    // pixel rows of 16 bytes (pixel row p lies at p % 8 in its pattern,
    // p = hy * kPW + 8 run + r) ----
    if constexpr (!NHWC) {
      const int mat = lane >> 3;  // the block this lane addresses a row of
      const int r = lane & 7;
      for (int k = 0; k < nchunks; ++k) {
        const int st = k % G::kXS;
        const int pb = k % G::kPX;
        mbar_wait(x_full + 8 * st, (k / G::kXS) & 1);
        if (k >= G::kPX) {
          mbar_wait(pix_empty + 8 * pb, (k / G::kPX - 1) & 1);
        }
        const uint32_t src = base + st * G::kTileBytes;
        const uint32_t dst = base + G::kPix0 + pb * G::kTileBytes;
        constexpr int kRuns = G::kPW / 8;
        for (int it = warp - 5; it < (TH + 2) * kRuns * 2; it += 4) {
          const int hy = it / (2 * kRuns);
          const int run = (it % (2 * kRuns)) >> 1;
          const int g = (it & 1) * 4 + mat;  // 8-channel group
          uint32_t v[4];
          ldmatrix_x4_trans(v, src + hy * G::kHaloRowBytes +
                                   (g * 8 + r) * (2 * G::kPW) + run * 16);
          const int p = hy * G::kPW + run * 8 + r;
          stmatrix_x4(dst + p * kRowBytes + ((g ^ r) << 4), v);
        }
        // the tile is read by wgmma, through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(pix_full + 8 * pb);
        mbar_arrive(x_empty + 8 * st);
      }
    }
    return;
  }

  // ---- the consumer warpgroup ----
  const int tid = threadIdx.x;
  float acc[TH][BN / 2];
#pragma unroll
  for (int t = 0; t < TH; ++t)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0.f;

  // the tiles the wgmmas read: NHWC the input ring, NCHW the pixel tiles
  constexpr int kTiles = NHWC ? G::kXS : G::kPX;
  const uint32_t tile_full = NHWC ? x_full : pix_full;
  const uint32_t tile_empty = NHWC ? x_empty : pix_empty;
  const uint32_t tile0 = NHWC ? base : base + G::kPix0;
  int s = 0;
  for (int k = 0; k < nchunks; ++k) {
    mbar_wait(tile_full + 8 * (k % kTiles), (k / kTiles) & 1);
    const uint32_t tile = tile0 + (k % kTiles) * G::kTileBytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap, ++s) {
      const int ws = s % G::kWS;
      mbar_wait(w_full + 8 * ws, (s / G::kWS) & 1);
      const uint64_t bd =
          make_desc(base + G::kW0 + ws * G::kWBytes, kGroupBytes, kSwizzle128);
      hold(acc);
      wg_fence();
#pragma unroll
      for (int t = 0; t < TH; ++t) {
        const uint64_t ad =
            a_desc(tile + ((t + tap / 3) * G::kPW + G::kLeft - 1 + tap % 3) *
                              kRowBytes);
#pragma unroll
        for (int kk = 0; kk < kKc / 16; ++kk) {
          // the next 16 channels: 32 bytes further along each row
          wgmma_ss<BN>(acc[t], ad + 2 * kk, bd + 2 * kk);
        }
      }
      wg_commit();
      wg_wait<1>();
      hold(acc);
      // the previous step's group is done: its weight stage, and at a
      // chunk's first tap the previous chunk's tile, are free
      if (tid == 0) {
        if (s > 0) mbar_arrive(w_empty + 8 * ((s - 1) % G::kWS));
        if (kTiles > 1 && tap == 0 && k > 0) {
          mbar_arrive(tile_empty + 8 * ((k - 1) % kTiles));
        }
      }
    }
    if constexpr (kTiles == 1) {
      // one tile: free it as soon as the chunk's last group is done, so
      // that the next chunk's copy or transposition can start
      wg_wait<0>();
      hold(acc);
      if (tid == 0) mbar_arrive(tile_empty);
    }
  }
  wg_wait<0>();
  hold(acc);
  // every consumer warp is past its last wgmma, and every copy and
  // transposition has been consumed: the rings are free for the output tile
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  // epilogue: bias in f32, one rounding to bf16, through shared memory. A
  // thread holds rows 16 w + g and + 8 of each m64 tile, columns 8 j + 2 q
  // and + 1 of each n8 block.
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float b0 = bias && n0 + col < Cout ? bias_at(bias, n0 + col) : 0.f;
    const float b1 =
        bias && n0 + col + 1 < Cout ? bias_at(bias, n0 + col + 1) : 0.f;
#pragma unroll
    for (int t = 0; t < TH; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = t * kTW + warp * 16 + g + 8 * h;
        const __nv_bfloat16 v0 = __float2bfloat16(acc[t][4 * j + 2 * h] + b0);
        const __nv_bfloat16 v1 =
            __float2bfloat16(acc[t][4 * j + 2 * h + 1] + b1);
        if constexpr (NHWC) {
          __nv_bfloat162 v;
          v.x = v0;
          v.y = v1;
          *reinterpret_cast<__nv_bfloat162*>(os + p * (BN + 8) + col) = v;
        } else {
          os[col * (G::kM + 8) + p] = v0;
          os[(col + 1) * (G::kM + 8) + p] = v1;
        }
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  if constexpr (NHWC) {
    // a pixel's BN channels are contiguous in y: 16-byte runs of 8
    const bool vec = Cout % 8 == 0;
    for (int i = tid; i < G::kM * (BN / 8); i += kConsumers) {
      const int p = i / (BN / 8);
      const int v = i % (BN / 8);
      const int oy = y0 + p / kTW;
      const int ox = x0 + p % kTW;
      const int o = n0 + v * 8;
      if (oy >= H || ox >= W || o >= Cout) continue;
      const __nv_bfloat16* src = os + p * (BN + 8) + v * 8;
      __nv_bfloat16* dst =
          y + ((static_cast<long long>(b) * H + oy) * W + ox) * Cout + o;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && o + e < Cout; ++e) dst[e] = src[e];
      }
    }
  } else {
    // a row of one output channel is contiguous in y: 16-byte runs of 8
    // pixels (W is a multiple of 8)
    const long long plane = static_cast<long long>(H) * W;
    for (int i = tid; i < BN * TH * (kTW / 8); i += kConsumers) {
      const int n = i / (TH * (kTW / 8));
      const int r = (i / (kTW / 8)) % TH;
      const int v = i % (kTW / 8);
      const int o = n0 + n;
      const int oy = y0 + r;
      const int ox = x0 + v * 8;
      if (o >= Cout || oy >= H || ox >= W) continue;
      *reinterpret_cast<uint4*>(y + (static_cast<long long>(b) * Cout + o) *
                                        plane +
                                static_cast<long long>(oy) * W + ox) =
          *reinterpret_cast<const uint4*>(os + n * (G::kM + 8) + r * kTW +
                                          v * 8);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A bf16 tensor map of `rank` dimensions (innermost first; byte strides of
// dimensions 1.. in `strides`) read in boxes `box`, swizzled by 128 bytes or
// not at all.
bool encode(CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TH, int BN, bool NHWC, bool PAIR, typename TB>
cudaError_t launch_tile(const void* x, const void* wp, const void* bias,
                        void* y, int B, int C, int H, int W, int Cout,
                        cudaStream_t stream) {
  using G = ConvGeometry<TH, BN, NHWC, PAIR>;
  using u64 = cuuint64_t;
  const u64 Cp = round_up(C, kPackCi);
  const u64 Coutp = round_up(Cout, kPackCo);
  const u64 wdims[3] = {Cp, Coutp, 9};
  const u64 wstrides[2] = {2 * Cp, 2 * Cp * Coutp};
  const cuuint32_t wbox[3] = {kKc, BN, 1};
  const u64 b = B, c = C, h = H, w = W;
  CUtensorMap xm, wm;
  bool ok = encode(&wm, wp, 3, wdims, wstrides, wbox, true);
  if constexpr (NHWC) {
    const u64 dims[4] = {c, w, h, b};
    const u64 strides[3] = {2 * c, 2 * c * w, 2 * c * w * h};
    const cuuint32_t box[4] = {kKc, G::kPW, TH + 2, 1};
    ok = ok && encode(&xm, x, 4, dims, strides, box, true);
  } else {
    const u64 dims[4] = {w, h, c, b};
    const u64 strides[3] = {2 * w, 2 * w * h, 2 * w * h * c};
    const cuuint32_t box[4] = {G::kPW, 1, kKc, 1};
    ok = ok && encode(&xm, x, 4, dims, strides, box, false);
  }
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = conv3x3_kernel_wgmma<TH, BN, NHWC, PAIR, TB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (Cout + BN - 1) / BN, B);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      xm, wm, static_cast<const TB*>(bias), static_cast<__nv_bfloat16*>(y), C,
      H, W, Cout, tiles_w);
  return cudaGetLastError();
}

// The four tile shapes; ops/conv3x3.py::WGMMA_TILES mirrors this list.
//   0: 2 x 64 pixels x 128 channels   1: 2 x 64 pixels x 64 channels
//   2: 1 x 64 pixels x 128 channels   3: 1 x 64 pixels x 64 channels
// pair: NCHW tiles 1 and 3 in their two-blocks-an-SM geometry.
template <bool NHWC, typename TB>
cudaError_t launch_layout(const void* x, const void* wp, const void* bias,
                          void* y, int B, int C, int H, int W, int Cout,
                          int tile, bool pair, cudaStream_t s) {
  if (pair) {
    if constexpr (!NHWC) {
      if (tile == 1) {
        return launch_tile<2, 64, false, true, TB>(x, wp, bias, y, B, C, H, W,
                                                   Cout, s);
      }
      if (tile == 3) {
        return launch_tile<1, 64, false, true, TB>(x, wp, bias, y, B, C, H, W,
                                                   Cout, s);
      }
    }
    return cudaErrorInvalidValue;
  }
  switch (tile) {
    case 0:
      return launch_tile<2, 128, NHWC, false, TB>(x, wp, bias, y, B, C, H, W,
                                                  Cout, s);
    case 1:
      return launch_tile<2, 64, NHWC, false, TB>(x, wp, bias, y, B, C, H, W,
                                                 Cout, s);
    case 2:
      return launch_tile<1, 128, NHWC, false, TB>(x, wp, bias, y, B, C, H, W,
                                                  Cout, s);
    case 3:
      return launch_tile<1, 64, NHWC, false, TB>(x, wp, bias, y, B, C, H, W,
                                                 Cout, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry, bound with ctypes: bfloat16 only. layout 0 (K3): x (B, C, H, W),
// bias (Cout) bf16 or null, y (B, Cout, H, W); wt (Cout, C, 3, 3) with mode
// 0, or with mode 1 (C, Cout, 3, 3), the weights of the conv whose input
// gradient this call computes. layout 1 (K4): x (B, H, W, C), wt (3, 3, C,
// Cout) HWIO with mode 2, bias (Cout) float32 or null, y (B, H, W, Cout).
// All contiguous; x, y and wpack 16-byte aligned, and W (layout 0) or C
// (layout 1) a multiple of 8, as TMA's tensor maps need. wpack: bf16
// scratch of 9 * round_up(Cout, 128) * round_up(C, 16) values for the
// packed weights; tile: the tile shape 0-3; pair (layout 0, tiles 1 and 3
// only): two blocks an SM. Returns the CUDA error of the launches (0 on
// success), cudaErrorInvalidValue for what the kernel does not take or a
// tensor map that cannot be encoded.
extern "C" int samt_conv3x3_wgmma(const void* x, const void* wt,
                                  const void* bias, void* y, void* wpack,
                                  int B, int C, int H, int W, int Cout,
                                  int layout, int mode, int tile, int pair,
                                  void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool layout_ok = layout == 0 ? (mode == 0 || mode == 1) && W % 8 == 0
                                     : layout == 1 && mode == 2 && C % 8 == 0;
  if (!layout_ok || B <= 0 || C <= 0 || H <= 0 || W <= 0 || Cout <= 0 ||
      B > 65535 || Cout > 65535 || !aligned(x) || !aligned(y) ||
      !aligned(wpack)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_wpack(wt, wpack, C, Cout, round_up(C, kPackCi),
                                 round_up(Cout, kPackCo), mode, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = layout == 0
            ? launch_layout<false, __nv_bfloat16>(x, wpack, bias, y, B, C, H,
                                                  W, Cout, tile, pair != 0, s)
            : launch_layout<true, float>(x, wpack, bias, y, B, C, H, W, Cout,
                                         tile, pair != 0, s);
  return static_cast<int>(err);
}
