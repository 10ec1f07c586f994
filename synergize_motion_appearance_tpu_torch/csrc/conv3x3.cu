// 3x3, stride-1, pad-1 convolution plus bias for Hopper (sm_90a), in NCHW
// or NHWC.
//
// Replaces two TPU kernels that compute one function in two layouts:
// - `_conv_wl_kernel` (synergize_motion_appearance_tpu/ops/
//   pallas_conv_wl.py:39, launched by `conv3x3_wl` at :144; kernel K3 of
//   the port), here in the port's NCHW layout with (Cout, C, 3, 3) weights
//   instead of the TPU's (B, H, C, W) W-in-lanes layout, which only served
//   the TPU's vector registers;
// - `_conv_kernel` (synergize_motion_appearance_tpu/ops/pallas_conv.py:39,
//   launched by `conv3x3_pallas` at :96; kernel K4): NHWC x, HWIO
//   (3, 3, C, Cout) weights, NHWC y, and a float32 bias.
// The function, written for NCHW:
//   y[b, o, h, w] = bias[o] + sum_{c, ky, kx} x[b, c, h+ky-1, w+kx-1]
//                                             * wt[o, c, ky, kx]
// with zero padding, f32 accumulation whatever the input type (f32 or
// bf16), and the output rounded once to the input type. Any B, C, H, W and
// Cout. The input gradient of the same conv is this kernel applied to dy
// with the weights rotated 180 degrees and their channels swapped; the
// wrapper (ops/conv3x3.py) prepares those weights and passes no bias.
//
// What bounds it on this card: at the training step's decoder shapes
// (C, Cout in 64..256, 64^2..256^2 pixels, batch 2) a conv does 2*9*C
// FLOP per output value against a few bytes per value moved, far above
// the card's ridge point, so it is bound by arithmetic. This first version
// runs the multiply-adds on the CUDA cores in f32 (a tensor-core version
// with wgmma is later work), so its ceiling is the f32 FMA rate, not the
// bf16 tensor-core rate the bound in chip_smoke.py is stated against.
//
// The layout is a template parameter, and each layout has its own staging
// and store code, so the NCHW instantiation is the one K3 had before NHWC
// was added. In NHWC the staging loops walk the channels fastest, so
// neighbouring threads read neighbouring channels; a pixel's channel chunk
// is 16 or 32 bytes, so these loads are not coalesced across pixels (a
// faster NHWC design is later work).
//
// Design: one block computes a tile of 64 output channels x 8 rows x 32
// columns of one image. Input channels are walked in chunks of 8: the
// chunk's 10 x 34 input tile with its 1-pixel halo and the 64 x 8 x 9
// weights are staged in shared memory as f32 (zero where the image or the
// channel count ends), then each of the 256 threads accumulates an 8
// channel x 8 pixel register tile. For one input channel and kernel row a
// thread reads 10 input values and 24 weights and does 192 FMAs; the
// threads of a warp share one channel group, so their weight reads are
// broadcasts. The kernel allocates nothing and runs on the caller's stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;   // output columns per block
constexpr int kTileH = 8;    // output rows per block
constexpr int kTileCo = 64;  // output channels per block
constexpr int kChunk = 8;    // input channels per shared-memory stage
constexpr int kThreads = 256;
constexpr int kPix = 8;      // pixels per thread: a run of 8 in one row
constexpr int kCo = 8;       // output channels per thread
constexpr int kInH = kTileH + 2;
constexpr int kInW = kTileW + 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as .to(bfloat16)
}

// TB is the bias type: T in NCHW (K3), float in NHWC (K4).
template <typename T, typename TB, bool NHWC>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wt,
               const TB* __restrict__ bias, T* __restrict__ y, int C, int H,
               int W, int Cout, int tiles_w) {
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
  const T* xb = x + static_cast<long long>(b) * C * plane;

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
          v = to_f32(xb[(static_cast<long long>(gy) * W + gx) * C + c0 + c]);
        }
        xs[c][r][q] = v;
      }
      for (int idx = t; idx < kTileCo * kChunk * 9; idx += kThreads) {
        const int o = idx % kTileCo;  // HWIO: output channels fastest
        const int c = (idx / kTileCo) % kChunk;
        const int k = idx / (kTileCo * kChunk);
        float v = 0.f;
        if (co0 + o < Cout && c0 + c < C) {
          v = to_f32(wt[(static_cast<long long>(k) * C + c0 + c) * Cout +
                        co0 + o]);
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
          v = to_f32(xb[(c0 + c) * plane + static_cast<long long>(gy) * W +
                        gx]);
        }
        xs[c][r][q] = v;
      }
      for (int idx = t; idx < kTileCo * kChunk * 9; idx += kThreads) {
        const int o = idx / (kChunk * 9);
        const int c = (idx / 9) % kChunk;
        const int k = idx % 9;
        float v = 0.f;
        if (co0 + o < Cout && c0 + c < C) {
          v = to_f32(wt[(static_cast<long long>(co0 + o) * C + c0 + c) * 9 +
                        k]);
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
    const float bv = bias ? to_f32(bias[o]) : 0.f;
    if constexpr (NHWC) {
      T* yp = y + (static_cast<long long>(b) * H + oy) * W * Cout + o;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int ox = x0 + px + i;
        if (ox < W) store(yp + static_cast<long long>(ox) * Cout,
                          acc[j][i] + bv);
      }
    } else {
      T* yp = y + (static_cast<long long>(b) * Cout + o) * plane +
              static_cast<long long>(oy) * W;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int ox = x0 + px + i;
        if (ox < W) store(yp + ox, acc[j][i] + bv);
      }
    }
  }
}

template <typename T, typename TB, bool NHWC>
cudaError_t launch(const void* x, const void* wt, const void* bias, void* y,
                   int B, int C, int H, int W, int Cout,
                   cudaStream_t stream) {
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_w * tiles_h, (Cout + kTileCo - 1) / kTileCo, B);
  conv3x3_kernel<T, TB, NHWC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt),
      static_cast<const TB*>(bias), static_cast<T*>(y), C, H, W, Cout,
      tiles_w);
  return cudaGetLastError();
}

bool bad_sizes(int B, int C, int H, int W, int Cout) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || Cout <= 0 || B > 65535 ||
         (Cout + kTileCo - 1) / kTileCo > 65535;
}

}  // namespace

// C entry, bound with ctypes. x (B, C, H, W), wt (Cout, C, 3, 3), bias
// (Cout) or null, y (B, Cout, H, W), all contiguous and of one type:
// dtype 0 = float32, 1 = bfloat16. Returns the CUDA error of the launch
// (0 on success); the caller checks shapes before calling.
extern "C" int samt_conv3x3(const void* x, const void* wt, const void* bias,
                            void* y, int B, int C, int H, int W, int Cout,
                            int dtype, void* stream) {
  if (bad_sizes(B, C, H, W, Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, float, false>(x, wt, bias, y, B, C, H, W, Cout, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16, false>(x, wt, bias, y, B, C,
                                                      H, W, Cout, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// C entry of the NHWC layout (kernel K4), bound with ctypes. x (B, H, W, C),
// wt (3, 3, C, Cout) HWIO in x's type, bias (Cout) float32 or null, y
// (B, H, W, Cout), all contiguous; dtype 0 = float32, 1 = bfloat16.
// Returns the CUDA error of the launch (0 on success).
extern "C" int samt_conv3x3_nhwc(const void* x, const void* wt,
                                 const void* bias, void* y, int B, int H,
                                 int W, int C, int Cout, int dtype,
                                 void* stream) {
  if (bad_sizes(B, C, H, W, Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, float, true>(x, wt, bias, y, B, C, H, W, Cout, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, float, true>(x, wt, bias, y, B, C, H, W,
                                             Cout, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
