// The bf16 3x3 conv kernels' weight packing, shared by conv3x3.cu
// (mma.sync) and conv3x3_wgmma.cu (wgmma): the weights of every layout and
// rotation as K-major B tiles, one row of input channels per (tap, output
// channel). Each including file gets its own copy (anonymous namespace).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPackCo = 128;  // packed weights: Cout padded to this
constexpr int kPackCi = 16;   // packed weights: C padded to this

// Packs bf16 weights as wp[tap][o][c] (9, Coutp, Cp), zero where o >= Cout
// or c >= C. mode 0: w (Cout, C, 3, 3); mode 1: w (C, Cout, 3, 3), the
// weights of the conv whose input gradient this is, rotated 180 degrees and
// channel-swapped here; mode 2: w (3, 3, C, Cout), HWIO.
__global__ void conv3x3_kernel_wpack(const __nv_bfloat16* __restrict__ w,
                                     __nv_bfloat16* __restrict__ wp, int C,
                                     int Cout, int Cp, int Coutp, int mode) {
  const long long total = 9LL * Coutp * Cp;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % Cp);
    const int o = static_cast<int>((i / Cp) % Coutp);
    const int tap = static_cast<int>(i / (static_cast<long long>(Cp) * Coutp));
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (o < Cout && c < C) {
      long long src;
      if (mode == 0) {
        src = (static_cast<long long>(o) * C + c) * 9 + tap;
      } else if (mode == 1) {
        src = (static_cast<long long>(c) * Cout + o) * 9 + 8 - tap;
      } else {
        src = (static_cast<long long>(tap) * C + c) * Cout + o;
      }
      v = w[src];
    }
    wp[i] = v;
  }
}

int round_up(int a, int m) { return (a + m - 1) / m * m; }

// packs w into wp (9, Coutp, Cp) on `stream`, mode as conv3x3_kernel_wpack
cudaError_t launch_wpack(const void* w, void* wp, int C, int Cout, int Cp,
                         int Coutp, int mode, cudaStream_t stream) {
  const long long total = 9LL * Coutp * Cp;
  const int blocks = static_cast<int>((total + 255) / 256);
  conv3x3_kernel_wpack<<<blocks < 1024 ? blocks : 1024, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wp),
      C, Cout, Cp, Coutp, mode);
  return cudaGetLastError();
}

}  // namespace
