// 3x3, stride-1, pad-1 convolution plus bias for Hopper (sm_90a), in NCHW
// or NHWC.
//
// Replaces two TPU kernels that compute one function in two layouts:
// - `_conv_wl_kernel` (synergize_motion_appearance_tpu/ops/
//   pallas_conv_wl.py:39, launched by `conv3x3_wl` at :144, its VJP
//   `conv3x3_wl_ad` at :175-193; kernel K3 of the port), here in the
//   port's NCHW layout with (Cout, C, 3, 3) weights instead of the TPU's
//   (B, H, C, W) W-in-lanes layout, which only served the TPU's vector
//   registers;
// - `_conv_kernel` (synergize_motion_appearance_tpu/ops/pallas_conv.py:39,
//   launched by `conv3x3_pallas` at :96; kernel K4): NHWC x, HWIO
//   (3, 3, C, Cout) weights, NHWC y, and a float32 bias.
// The function, written for NCHW:
//   y[b, o, h, w] = bias[o] + sum_{c, ky, kx} x[b, c, h+ky-1, w+kx-1]
//                                             * wt[o, c, ky, kx]
// with zero padding, f32 accumulation whatever the input type (f32 or
// bf16), and the output rounded once to the input type. Any B, C, H, W and
// Cout. The input gradient of the same conv is this conv applied to dy
// with the weights rotated 180 degrees and their channels swapped; the
// `flip` argument folds that into the weight staging, so no rotated copy
// of the weights is made first.
//
// What bounds it on this card: at the training step's decoder shapes
// (C, Cout in 64..256, 64^2..256^2 pixels, batch 2) a conv does 2*9*C
// FLOP per output value against a few bytes per value moved, far above
// the card's ridge point, so it is bound by arithmetic: in bf16 by the
// tensor cores' rate, which is what chip_smoke.py states the bound
// against.
//
// bf16 (the training step's type): an implicit GEMM on the tensor cores,
// `conv3x3_kernel_tc`. A block computes a tile of TH output rows x TW
// columns (M = TH*TW pixels) x BN output channels (N); K = 9 taps x C is
// walked in chunks of 16 input channels. For each chunk the block stages,
// as bf16, the tile's input with its 1-pixel halo ((TH+2) x (TW+2)
// pixels) once, pixel-major with a pixel's 16 channels in one 32-byte row,
// and the chunk's weights of its BN channels for all 9 taps, one 32-byte
// row per (tap, output channel). The A operand of each tap is a window of
// the one staged input tile shifted by (ky, kx) pixels: `ldmatrix` takes
// one 16-byte row address per pixel, so a shift by one pixel stays a
// legal address and no im2col tensor exists anywhere. Both arrays XOR the
// 16-byte half of a row with bit 2 of the row index, so that the 8 rows of
// every `ldmatrix` phase fall in 8 distinct bank groups, for any shift.
// Each warp owns one output row (TW pixels = TW/16 m16 tiles) and BN/WN
// output channels, and runs `mma.sync.m16n8k16` bf16 -> f32 with its
// accumulators in registers. The bf16 shapes whose input TMA can read (an
// NCHW row or an NHWC pixel of whole 16-byte units, aligned bases) run on
// `wgmma` instead, in conv3x3_wgmma.cu, whose A descriptors start at any
// pixel row of a swizzled tile (ops/conv3x3.py::plan picks); this kernel
// keeps the other bf16 shapes.
// Copies are asynchronous in a ring of 3 stages, so that chunk k+2 loads
// while chunk k is multiplied. The weights come from a packed copy
// (tap, Cout padded to 128, C padded to 16), written by
// `conv3x3_kernel_wpack` (conv3x3_pack.cuh) just before (layout, rotation
// and padding folded in), with 16-byte `cp.async.cg` copies. NHWC input with C a multiple of
// 8 takes 16-byte `cp.async` copies too, zero-filled outside the image.
// NCHW input with W a multiple of 8 is copied as it lies, 16-byte runs of
// 8 pixels along W, by `cp.async` into a channel-major area of the stage;
// when it has landed, each warp transposes runs into the pixel-major
// tile in shared memory: `ldmatrix.trans` reads an 8-channel x 8-pixel
// block and hands each lane a pixel's channel pair, `stmatrix` writes
// the block back as 8 pixel rows. No NCHW<->NHWC pass through device
// memory exists. Input whose rows or pixels are not 16-byte aligned (W,
// or in NHWC C, not a multiple of 8) is read through registers instead:
// a warp reads 32 neighbouring pixels of one channel row, a thread packs
// its pixel's 8 channels into one 16-byte shared-memory store; those
// loads are issued before chunk k's multiplies and stored after them, in
// the same kernel. Ragged C, Cout, H and W are zero-filled in the staged
// tiles and masked at the store. The epilogue adds the bias in f32, rounds
// once to bf16, and goes through shared memory so that the stores run
// along W (NCHW) or along the channels (NHWC) in 16-byte vectors. The
// wrapper picks one of three tile shapes from the problem's shape
// (ops/conv3x3.py::choose_tile).
//
// float32: `conv3x3_kernel` on the CUDA cores, as before, so that f32
// stays exact f32 (no TF32): a block computes 64 output channels x 8 rows
// x 32 columns; 8-channel chunks of input and weights are staged as f32
// and each thread accumulates an 8 channel x 8 pixel register tile.
// Neither kernel allocates anything; both run on the caller's stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3x3_pack.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTileW = 32;   // output columns per block
constexpr int kTileH = 8;    // output rows per block
constexpr int kTileCo = 64;  // output channels per block
constexpr int kChunk = 8;    // input channels per shared-memory stage
constexpr int kThreads = 256;
constexpr int kPix = 8;      // pixels per thread: a run of 8 in one row
constexpr int kCo = 8;       // output channels per thread
constexpr int kInH = kTileH + 2;
constexpr int kInW = kTileW + 2;

template <bool NHWC>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ wt,
               const float* __restrict__ bias, float* __restrict__ y, int C,
               int H, int W, int Cout, int tiles_w, bool flip) {
  __shared__ float xs[kChunk][kInH][kInW];
  __shared__ __align__(16) float ws[kChunk][9][kTileCo];

  const int b = blockIdx.z;
  const int co0 = blockIdx.y * kTileCo;
  const int y0 = (blockIdx.x / tiles_w) * kTileH;
  const int x0 = (blockIdx.x % tiles_w) * kTileW;
  const int t = threadIdx.x;
  const int pg = t % 32;           // pixel group: one per lane
  const int cg = t / 32;           // channel group: one per warp
  const int py = pg / (kTileW / kPix);
  const int px = (pg % (kTileW / kPix)) * kPix;

  float acc[kCo][kPix];
#pragma unroll
  for (int j = 0; j < kCo; ++j)
#pragma unroll
    for (int i = 0; i < kPix; ++i) acc[j][i] = 0.f;

  const long long plane = static_cast<long long>(H) * W;
  const float* xb = x + static_cast<long long>(b) * C * plane;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    if constexpr (NHWC) {
      for (int idx = t; idx < kChunk * kInH * kInW; idx += kThreads) {
        const int c = idx % kChunk;  // channels fastest, as they lie in x
        const int r = (idx / kChunk) / kInW;
        const int q = (idx / kChunk) % kInW;
        const int gy = y0 - 1 + r;
        const int gx = x0 - 1 + q;
        float v = 0.f;
        if (c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
          v = xb[(static_cast<long long>(gy) * W + gx) * C + c0 + c];
        }
        xs[c][r][q] = v;
      }
      for (int idx = t; idx < kTileCo * kChunk * 9; idx += kThreads) {
        const int o = idx % kTileCo;  // HWIO: output channels fastest
        const int c = (idx / kTileCo) % kChunk;
        const int k = idx / (kTileCo * kChunk);
        float v = 0.f;
        if (co0 + o < Cout && c0 + c < C) {
          v = wt[(static_cast<long long>(k) * C + c0 + c) * Cout + co0 + o];
        }
        ws[c][k][o] = v;
      }
    } else {
      for (int idx = t; idx < kChunk * kInH * kInW; idx += kThreads) {
        const int c = idx / (kInH * kInW);
        const int r = (idx / kInW) % kInH;
        const int q = idx % kInW;
        const int gy = y0 - 1 + r;
        const int gx = x0 - 1 + q;
        float v = 0.f;
        if (c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
          v = xb[(c0 + c) * plane + static_cast<long long>(gy) * W + gx];
        }
        xs[c][r][q] = v;
      }
      for (int idx = t; idx < kTileCo * kChunk * 9; idx += kThreads) {
        const int o = idx / (kChunk * 9);
        const int c = (idx / 9) % kChunk;
        const int k = idx % 9;
        float v = 0.f;
        if (co0 + o < Cout && c0 + c < C) {
          // flip: wt is (C, Cout, 3, 3), rotated and channel-swapped here
          v = wt[flip ? (static_cast<long long>(c0 + c) * Cout + co0 + o) *
                                9 + 8 - k
                      : (static_cast<long long>(co0 + o) * C + c0 + c) * 9 +
                            k];
        }
        ws[c][k][o] = v;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kChunk; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float row[kPix + 2];
#pragma unroll
        for (int i = 0; i < kPix + 2; ++i) row[i] = xs[c][py + ky][px + i];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wp =
              reinterpret_cast<const float4*>(&ws[c][ky * 3 + kx][cg * kCo]);
          const float4 wa = wp[0];
          const float4 wb = wp[1];
          const float wv[kCo] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < kCo; ++j)
#pragma unroll
            for (int i = 0; i < kPix; ++i)
              acc[j][i] = fmaf(wv[j], row[i + kx], acc[j][i]);
        }
      }
    }
  }

  const int oy = y0 + py;
  if (oy >= H) return;
#pragma unroll
  for (int j = 0; j < kCo; ++j) {
    const int o = co0 + cg * kCo + j;
    if (o >= Cout) break;
    const float bv = bias ? bias[o] : 0.f;
    if constexpr (NHWC) {
      float* yp = y + (static_cast<long long>(b) * H + oy) * W * Cout + o;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int ox = x0 + px + i;
        if (ox < W) yp[static_cast<long long>(ox) * Cout] = acc[j][i] + bv;
      }
    } else {
      float* yp = y + (static_cast<long long>(b) * Cout + o) * plane +
                  static_cast<long long>(oy) * W;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int ox = x0 + px + i;
        if (ox < W) yp[ox] = acc[j][i] + bv;
      }
    }
  }
}

template <bool NHWC>
cudaError_t launch_f32(const void* x, const void* wt, const void* bias,
                       void* y, int B, int C, int H, int W, int Cout,
                       bool flip, cudaStream_t stream) {
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_w * tiles_h, (Cout + kTileCo - 1) / kTileCo, B);
  conv3x3_kernel<NHWC><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<float*>(y), C, H, W, Cout,
      tiles_w, flip);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kKc = 16;        // input channels per pipeline stage
static_assert(kPackCi % kKc == 0, "packed C is whole chunks");
constexpr int kRow = 32;       // bytes of one staged row: kKc bf16
constexpr int kStages = 3;     // cp.async ring depth

// Byte offset of 16-byte half `half` of staged row `row`: the half is XORed
// with bit 2 of the row, so 8 consecutive rows hit 8 distinct bank groups.
__device__ __forceinline__ uint32_t swz(int row, int half) {
  return static_cast<uint32_t>(row * kRow + ((half ^ ((row >> 2) & 1)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros (and reads none)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block geometry: TH output rows x TW columns x BN output channels; warp
// (wm, wn) computes output row wm, all TW columns, channels
// [wn*BN/WN, (wn+1)*BN/WN). A stage holds the pixel-major input tile, the
// weights and, in NCHW (RAW), the chunk's input as it lies in x: per
// channel, TH+2 rows of TW+16 pixels (x0-8 .. x0+TW+7) in 16-byte runs,
// each channel padded by 16 bytes so that 8 channels' runs fall in 8
// distinct bank groups.
template <int TH, int TW, int BN, int WN, bool RAW>
struct Tile {
  static constexpr int kWarps = TH * WN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kInW = TW + 2;
  static constexpr int kInPix = (TH + 2) * kInW;
  static constexpr int kXBytes = kInPix * kRow;
  static constexpr int kWRows = 9 * BN;
  static constexpr int kWBytes = kWRows * kRow;
  static constexpr int kRuns = TW / 8 + 2;  // 16-byte runs of a raw row
  static constexpr int kRawCh = (TH + 2) * kRuns * 16 + 16;
  static constexpr int kRawBytes = RAW ? kKc * kRawCh : 0;
  static constexpr int kStageBytes = kXBytes + kWBytes + kRawBytes;
  static constexpr int kMT = TW / 16;        // m16 tiles of a warp
  static constexpr int kNT = BN / WN / 8;    // n8 tiles of a warp
  static constexpr int kXItems = kInPix * 2;  // (pixel, 8-channel half)
  static constexpr int kXPer = (kXItems + kThreads - 1) / kThreads;
  static constexpr int kWItems = kWRows * 2;
  static constexpr int kM = TH * TW;
  // epilogue tile, bf16: NCHW [BN][kM + 8], NHWC [kM][BN + 8]
  static constexpr int kOutBytes = 2 * (BN * (kM + 8) > kM * (BN + 8)
                                            ? BN * (kM + 8)
                                            : kM * (BN + 8));
  static constexpr int kTrash = kStages * kStageBytes > kOutBytes
                                    ? kStages * kStageBytes
                                    : kOutBytes;
  // plus one 32-byte row that takes the stores of pixels outside the tile
  static constexpr int kSmem = kTrash + kRow;
  static_assert(TW % 16 == 0 && BN % (WN * 16) == 0, "tile");
};

// The three tile shapes; ops/conv3x3.py::TILES mirrors this list.
//   0: 2 x 64 pixels x 128 channels, 8 warps (Cout > 64)
//   1: 4 x 64 pixels x  64 channels, 8 warps (Cout <= 64)
//   2: 2 x 32 pixels x  64 channels, 4 warps (grids too small to fill the
//      card with 0 or 1)

__device__ __forceinline__ float bias_at(const __nv_bfloat16* b, int o) {
  return __bfloat162float(b[o]);
}
__device__ __forceinline__ float bias_at(const float* b, int o) {
  return b[o];
}

// wp: (9, Coutp, Cp) bf16, packed by conv3x3_kernel_wpack. TB is the bias
// type: bf16 in NCHW (K3), float in NHWC (K4).
template <int TH, int TW, int BN, int WN, bool NHWC, typename TB>
__global__ void __launch_bounds__(Tile<TH, TW, BN, WN, !NHWC>::kThreads)
conv3x3_kernel_tc(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ wp,
                  const TB* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                  int C, int H, int W, int Cout, int Cp, int Coutp,
                  int tiles_w) {
  using G = Tile<TH, TW, BN, WN, !NHWC>;
  extern __shared__ __align__(128) uint8_t smem[];

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) / WN;
  const int wn = (tid >> 5) % WN;
  const long long plane = static_cast<long long>(H) * W;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x) +
                       static_cast<long long>(b) * C * plane;
  const long long cstride = NHWC ? 1 : plane;
  const int nchunks = Cp / kKc;
  // NHWC pixels start 16-byte aligned only when C is a multiple of 8, and
  // NCHW rows only when W is; else the input goes through registers
  const bool vec_x = NHWC && (C % 8 == 0);
  const bool raw_x = !NHWC && (W % 8 == 0);
  const uint32_t sbase = smem_u32(smem);

  // the input item i of a chunk: staged pixel i/2, channels 8*(i%2)..+7
  auto x_item = [&](int i, int& gy, int& gx) {
    const int pix = i >> 1;
    gy = y0 - 1 + pix / G::kInW;
    gx = x0 - 1 + pix % G::kInW;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  auto x_pix_offset = [&](int gy, int gx) {
    const long long p = static_cast<long long>(gy) * W + gx;
    return NHWC ? p * C : p;
  };

  // weights and (NHWC, C % 8 == 0) input of chunk k into stage s, async
  auto stage_async = [&](int s, int k) {
    const int c0 = k * kKc;
    const uint32_t xs = sbase + s * G::kStageBytes;
    const uint32_t ws = xs + G::kXBytes;
    for (int i = tid; i < G::kWItems; i += G::kThreads) {
      const int row = i >> 1;  // tap * BN + n
      const int tap = row / BN;
      const int n = row % BN;
      const __nv_bfloat16* src =
          wp + (static_cast<long long>(tap) * Coutp + n0 + n) * Cp + c0 +
          (i & 1) * 8;
      cp_async16(ws + swz(row, i & 1), src, 16);
    }
    if (raw_x) {
      const uint32_t raw = ws + G::kWBytes;
      for (int i = tid; i < kKc * (TH + 2) * G::kRuns; i += G::kThreads) {
        const int run = i % G::kRuns;
        const int r = (i / G::kRuns) % (TH + 2);
        const int c = c0 + i / (G::kRuns * (TH + 2));
        const int gy = y0 - 1 + r;
        const int gx = x0 - 8 + 8 * run;
        const bool ok = c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
        const uint16_t* src =
            ok ? xb + c * plane + static_cast<long long>(gy) * W + gx : xb;
        cp_async16(raw + (c - c0) * G::kRawCh + (r * G::kRuns + run) * 16,
                   src, ok ? 16 : 0);
      }
    }
    if (vec_x) {
      for (int i = tid; i < G::kXItems; i += G::kThreads) {
        int gy, gx;
        const int c = c0 + (i & 1) * 8;
        const bool ok = x_item(i, gy, gx) && c < C;
        const uint16_t* src = ok ? xb + x_pix_offset(gy, gx) + c : xb;
        cp_async16(xs + swz(i >> 1, i & 1), src, ok ? 16 : 0);
      }
    }
  };

  // input of chunk k through registers: 8 channels of one pixel per item,
  // neighbouring threads on neighbouring pixels (NCHW: along W)
  uint32_t xr[G::kXPer][4];
  auto load_x = [&](int k) {
    const int c0 = k * kKc;
#pragma unroll
    for (int j = 0; j < G::kXPer; ++j) {
      const int i = tid + j * G::kThreads;
      xr[j][0] = xr[j][1] = xr[j][2] = xr[j][3] = 0u;
      int gy, gx;
      if (i < G::kXItems && x_item(i, gy, gx)) {
        const uint16_t* src = xb + x_pix_offset(gy, gx);
        const int c = c0 + (i & 1) * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (c + e < C) {
            xr[j][e >> 1] |= static_cast<uint32_t>(__ldg(src + (c + e) *
                                                             cstride))
                             << (16 * (e & 1));
          }
        }
      }
    }
  };
  auto store_x = [&](int s) {
    uint8_t* xs = smem + s * G::kStageBytes;
#pragma unroll
    for (int j = 0; j < G::kXPer; ++j) {
      const int i = tid + j * G::kThreads;
      if (i < G::kXItems) {
        *reinterpret_cast<uint4*>(xs + swz(i >> 1, i & 1)) =
            make_uint4(xr[j][0], xr[j][1], xr[j][2], xr[j][3]);
      }
    }
  };

  // NCHW: the raw chunk in stage s, transposed to the stage's pixel-major
  // tile. Per step a warp takes two neighbouring 8-pixel runs of one row
  // for all 16 channels: `ldmatrix.trans` reads them as four 8x8 blocks
  // (channels x pixels) and hands each lane one pixel's channel pairs,
  // which `stmatrix` writes as 16-byte pixel rows. The first and last run
  // of a row hold one halo pixel each; their other pixels go to the trash
  // row.
  const uint32_t trash = sbase + G::kTrash;
  auto transpose_x = [&](int s) {
    const uint32_t xs = sbase + s * G::kStageBytes;
    const uint32_t raw = xs + G::kXBytes + G::kWBytes;
    const int mat = lane >> 3;  // (channel half, run) of this lane's row
    const int row = lane & 7;
    for (int it = tid >> 5; it < (TH + 2) * (G::kRuns / 2);
         it += G::kWarps) {
      const int r = it / (G::kRuns / 2);
      const int run = (it % (G::kRuns / 2)) * 2 + (mat >> 1);
      uint32_t v[4];
      ldmatrix_x4_trans(v, raw + ((mat & 1) * 8 + row) * G::kRawCh +
                               (r * G::kRuns + run) * 16);
      const int q = 8 * run + row - 7;
      stmatrix_x4(q >= 0 && q < G::kInW ? xs + swz(r * G::kInW + q, mat & 1)
                                        : trash,
                  v);
    }
  };

  float acc[G::kMT][G::kNT][4];
#pragma unroll
  for (int m = 0; m < G::kMT; ++m)
#pragma unroll
    for (int n = 0; n < G::kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // ldmatrix lane roles. A (pixels x channels): lanes 0-7 rows 0-7 of the
  // first 8 channels, 8-15 rows 8-15, 16-23 rows 0-7 of the second 8,
  // 24-31 rows 8-15. B (output channels x input channels): lanes 0-7 rows
  // 0-7 first half, 8-15 rows 0-7 second half, 16-31 the same for rows
  // 8-15.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_half = (lane >> 3) & 1;
  const int a_pix0 = wm * G::kInW + a_row;
  const int b_row0 = wn * (BN / WN) + b_row;

  auto compute = [&](int s) {
    const uint32_t xs = sbase + s * G::kStageBytes;
    const uint32_t ws = xs + G::kXBytes;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int tap = ky * 3 + kx;
        uint32_t bf[G::kNT][2];
#pragma unroll
        for (int j = 0; j < G::kNT / 2; ++j) {
          uint32_t r[4];
          const int row = tap * BN + b_row0 + j * 16;
          ldmatrix_x4(r, ws + swz(row, b_half));
          bf[2 * j][0] = r[0];
          bf[2 * j][1] = r[1];
          bf[2 * j + 1][0] = r[2];
          bf[2 * j + 1][1] = r[3];
        }
#pragma unroll
        for (int m = 0; m < G::kMT; ++m) {
          uint32_t af[4];
          const int pix = a_pix0 + ky * G::kInW + kx + m * 16;
          ldmatrix_x4(af, xs + swz(pix, a_half));
#pragma unroll
          for (int n = 0; n < G::kNT; ++n)
            mma_bf16(acc[m][n], af, bf[n][0], bf[n][1]);
        }
      }
    }
  };

  // prologue: chunks 0 .. kStages-2
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) {
      stage_async(s, s);
      if (!vec_x && !raw_x) {
        load_x(s);
        store_x(s);
      }
    }
    cp_async_commit();
  }
  const bool reg_x = !vec_x && !raw_x;
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<kStages - 2>();  // chunk k's copies have landed
    __syncthreads();  // ... for every thread; stage (k-1)%S is free
    if (raw_x) transpose_x(k % kStages);
    const int next = k + kStages - 1;
    const bool more = next < nchunks;
    if (more) {
      stage_async(next % kStages, next);
      if (reg_x) load_x(next);
    }
    cp_async_commit();
    if (raw_x) __syncthreads();  // the transposed tile is complete
    compute(k % kStages);
    if (more && reg_x) store_x(next % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the output tile

  // epilogue: bias in f32, one rounding to bf16, through shared memory
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int n = 0; n < G::kNT; ++n) {
    const int col = wn * (BN / WN) + n * 8 + 2 * (lane & 3);
    const float b0 = bias && n0 + col < Cout ? bias_at(bias, n0 + col) : 0.f;
    const float b1 =
        bias && n0 + col + 1 < Cout ? bias_at(bias, n0 + col + 1) : 0.f;
#pragma unroll
    for (int m = 0; m < G::kMT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wm * TW + m * 16 + (lane >> 2) + 8 * h;
        const __nv_bfloat16 v0 = __float2bfloat16(acc[m][n][2 * h] + b0);
        const __nv_bfloat16 v1 = __float2bfloat16(acc[m][n][2 * h + 1] + b1);
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
  __syncthreads();

  if constexpr (NHWC) {
    // a pixel's BN channels are contiguous in y: 16-byte runs of 8
    const bool vec = Cout % 8 == 0;
    for (int i = tid; i < G::kM * (BN / 8); i += G::kThreads) {
      const int p = i / (BN / 8);
      const int v = i % (BN / 8);
      const int oy = y0 + p / TW;
      const int ox = x0 + p % TW;
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
    // a row of one output channel is contiguous in y: runs of 8 along W
    const bool vec = W % 8 == 0;
    for (int i = tid; i < BN * TH * (TW / 8); i += G::kThreads) {
      const int n = i / (TH * (TW / 8));
      const int r = (i / (TW / 8)) % TH;
      const int v = i % (TW / 8);
      const int o = n0 + n;
      const int oy = y0 + r;
      const int ox = x0 + v * 8;
      if (o >= Cout || oy >= H || ox >= W) continue;
      const __nv_bfloat16* src = os + n * (G::kM + 8) + r * TW + v * 8;
      __nv_bfloat16* dst =
          y + (static_cast<long long>(b) * Cout + o) * plane +
          static_cast<long long>(oy) * W + ox;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && ox + e < W; ++e) dst[e] = src[e];
      }
    }
  }
}

template <int TH, int TW, int BN, int WN, bool NHWC, typename TB>
cudaError_t launch_tc_tile(const void* x, const void* wp, const void* bias,
                           void* y, int B, int C, int H, int W, int Cout,
                           cudaStream_t stream) {
  using G = Tile<TH, TW, BN, WN, !NHWC>;
  auto kernel = conv3x3_kernel_tc<TH, TW, BN, WN, NHWC, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (Cout + BN - 1) / BN, B);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const TB*>(bias),
      static_cast<__nv_bfloat16*>(y), C, H, W, Cout, round_up(C, kPackCi),
      round_up(Cout, kPackCo), tiles_w);
  return cudaGetLastError();
}

// packs the weights into wpack (mode as conv3x3_kernel_wpack), then runs
// the tensor-core conv with tile shape `tile`
template <bool NHWC, typename TB>
cudaError_t launch_tc(const void* x, const void* wt, const void* bias,
                      void* y, void* wpack, int B, int C, int H, int W,
                      int Cout, int mode, int tile, cudaStream_t stream) {
  cudaError_t err = launch_wpack(wt, wpack, C, Cout, round_up(C, kPackCi),
                                 round_up(Cout, kPackCo), mode, stream);
  if (err != cudaSuccess) return err;
  switch (tile) {
    case 0:
      return launch_tc_tile<2, 64, 128, 4, NHWC, TB>(x, wpack, bias, y, B, C,
                                                     H, W, Cout, stream);
    case 1:
      return launch_tc_tile<4, 64, 64, 2, NHWC, TB>(x, wpack, bias, y, B, C,
                                                    H, W, Cout, stream);
    case 2:
      return launch_tc_tile<2, 32, 64, 2, NHWC, TB>(x, wpack, bias, y, B, C,
                                                    H, W, Cout, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_sizes(int B, int C, int H, int W, int Cout) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || Cout <= 0 || B > 65535 ||
         (Cout + kTileCo - 1) / kTileCo > 65535;
}

}  // namespace

// C entry, bound with ctypes. x (B, C, H, W), bias (Cout) or null, y
// (B, Cout, H, W), all contiguous and of one type: dtype 0 = float32,
// 1 = bfloat16. wt is (Cout, C, 3, 3), or with flip != 0 (C, Cout, 3, 3):
// the weights of the conv whose input gradient this call computes, rotated
// and channel-swapped inside. wpack: bfloat16 scratch of
// 9 * round_up(Cout, 128) * round_up(C, 16) values for the packed weights
// (unused in float32); tile: the tile
// shape 0-2 of the bfloat16 kernel. Returns the CUDA error of the launches
// (0 on success); the caller checks shapes before calling.
extern "C" int samt_conv3x3(const void* x, const void* wt, const void* bias,
                            void* y, void* wpack, int B, int C, int H, int W,
                            int Cout, int dtype, int flip, int tile,
                            void* stream) {
  if (bad_sizes(B, C, H, W, Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32<false>(x, wt, bias, y, B, C, H, W, Cout, flip != 0, s);
  } else if (dtype == 1 && wpack != nullptr) {
    err = launch_tc<false, __nv_bfloat16>(x, wt, bias, y, wpack, B, C, H, W,
                                          Cout, flip ? 1 : 0, tile, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// C entry of the NHWC layout (kernel K4), bound with ctypes. x (B, H, W, C),
// wt (3, 3, C, Cout) HWIO in x's type, bias (Cout) float32 or null, y
// (B, H, W, Cout), all contiguous; dtype 0 = float32, 1 = bfloat16; wpack
// and tile as for samt_conv3x3. Returns the CUDA error of the launches (0
// on success).
extern "C" int samt_conv3x3_nhwc(const void* x, const void* wt,
                                 const void* bias, void* y, void* wpack,
                                 int B, int H, int W, int C, int Cout,
                                 int dtype, int tile, void* stream) {
  if (bad_sizes(B, C, H, W, Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32<true>(x, wt, bias, y, B, C, H, W, Cout, false, s);
  } else if (dtype == 1 && wpack != nullptr) {
    err = launch_tc<true, float>(x, wt, bias, y, wpack, B, C, H, W, Cout, 2,
                                 tile, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
