// Softmax attention at the head widths the other attention kernels do not
// take, in both layouts, on three kernels:
// - float32 at d = 65..1024: `attn_packed_kernel_f32wide<C>` (plan kernel
//   "f32wide"), a block all output columns of its query rows, so q.k and
//   every exponential run once a head;
// - d = 1, either dtype: `attn_packed_kernel_chunked_f32<1, 1, T>` (plan
//   kernel "d1"), one query row a thread on the CUDA cores, bf16 loads
//   widened to f32 (the name says its arithmetic);
// - the rest (plan kernel "chunked"): bfloat16 above 64 at d % 8 != 0,
//   at a pointer TMA cannot take or above 512, on
//   `attn_packed_kernel_chunked_tc`; float32 above 1024 on
//   `attn_packed_kernel_chunked_f32<16, 64, float>`, whose blocks of 64
//   output columns each repeat their head's q.k.
// No shipped config reaches these widths; a generator at n_head 32 (d = 1
// in the motion transformer) or a float32 one at n_head 1 or 2 (d = 256,
// 128 in the appearance transformer) does. bfloat16 at d = 65..512 with
// d % 8 = 0 at aligned pointers runs the wgmma kernels (PERF.md section 6
// has the times).
//
// Replaces, for those widths, the same two TPU kernels as
// fused_attention_packed.cu (synergize_motion_appearance_tpu/ops/
// fused_attention.py: `_attn_kernel_packed` at :227, kernel K1 of the port,
// token-major; `_attn_kernel` at :56, kernel K2, head-split), which slice
// heads by d and take any width; it computes their function as the other
// kernels do: scores q.k * 1/sqrt(d) in f32 (a bf16 x bf16 product
// accumulated in f32 for bfloat16), plus the optional (B, K) f32 bias where
// -1e30 masks a key; an f32 max-subtracted softmax; p.v with f32 weights;
// 0 for a row whose every key is masked; the output in q's dtype and
// layout, rounded once. ops/fused_attention.py::plan routes a call here.
//
// The float32 wide kernel. f32 is exact FMAs on the CUDA cores (no TF32),
// so the bound is the FMAs: 2d a score, q.k and p.v, at 128 a clock an SM.
// A block owns all d columns of R query rows of one head (256 threads; d
// rounded up to C = 128, 256, .., 1024; R = 16384 / C up to 256, 32 up to
// 768, 16 past it, where q of 32 rows would not fit beside p and the
// ring), so q.k and every exponential run once a head. q is staged once
// (up to C = 256 times scale * log2(e); past it each score is scaled after
// q.k, in one FMA with the bias: the pre-scaled q's rounding moved the
// output by up to 3e-5 at d = 384); keys come in super-tiles of C (512
// past 256, 256 at C = 640 and 768): k in depth chunks, v in key chunks,
// each about 32 KiB (up to 56 KiB past C = 512), through a 2-slot ring
// filled by `cp.async` (16 bytes a thread where d and the pointers allow,
// else 4), each chunk landing while the one before it is used. Each
// thread holds an 8 x 8 register tile of the scores and one of O (8 x 6
// at C = 384), so each float4 it reads from shared memory feeds 16 FMAs:
// one byte a FMA, which is the rate at which shared memory returns data
// to an SM's threads (128 bytes a clock), so the two bind together. Past
// C = 512 the score tile is 8 rows x 4 keys and O's 8 rows x C / 64 (up
// to 768) or C / 128 columns: the 8 q float4s a step are one broadcast
// for a warp's lanes, so a warp's step is 24 shared-memory wavefronts for
// 128 FMAs a lane. The lanes of a row (a warp at C = 256, a half-warp at
// 128) take its max and sum by shuffles; past 256 a row's 64 lanes are two
// warps (128 lanes, four, past 768), whose maxima and sums meet in shared
// memory (two more barriers a super-tile). p goes through shared memory
// (keys x R rows). 206.0 KiB of shared memory at C = 256, 202.0 at 128,
// 217.5 at 512, 201.5 at 384, 198.0 at 640, 205.5 at 768, 209.5 at 896,
// 185.0 at 1024: one block an SM. Padding columns cost FMAs (d = 160:
// three eighths of them), in p.v only: the q.k loop stops at d. Unrolled,
// the q.k loop took ptxas past 255 registers into a spill; rolled, 250 and
// no spill, at the same time (247 at C = 384, 255 at 512, 640 and 768,
// 221 at 896, 217 at 1024, no spill).
//
// The d-chunked kernels (a simple design that is right; no shipped config
// runs them): a block owns a tile of query rows of one head and one chunk
// of at most 64 of its output columns. It computes the full q.k over d in
// chunks of columns, staging each chunk of q and k in shared memory, runs
// the online softmax over key tiles (the accumulator rescaled once a
// tile), and accumulates p.v for its own columns only. So the ceil(d / 64)
// blocks of a head each repeat its q.k and its exponentials: at d = 256
// four times. Copies are plain loads through registers (16 bytes a thread
// where the rows and pointers allow, else element by element: a bf16 row
// of d = 1 is 2 bytes, which no cp.async takes), one tile at a time
// between two barriers; the other blocks of the SM hide the loads'
// latency.
// - bfloat16 (`attn_packed_kernel_chunked_tc`): 64 query rows a block, 16
//   a warp; q.k on `mma.sync.m16n8k16` with q and k read by `ldmatrix` from
//   64-column chunks (zero past d, so only the k16 steps that hold columns
//   of d run), p.v the same way with p split into bf16 hi + lo (two
//   products into one f32 accumulator, ~16 bits of each weight, as
//   fused_attention_packed.cu's tensor-core kernel) on 64-key tiles.
// - `attn_packed_kernel_chunked_f32<QC, VC, T>`: exact f32 FMAs on the
//   CUDA cores (no TF32), one query row a thread, 128 a block; q (times
//   scale * log2(e)) and k staged QC columns at a time, the block's VC
//   output columns of v once a key tile. d = 1 runs <1, 1, T> in both
//   dtypes, so no FMA is spent on padding (fused_attention_packed.cu's
//   float32 kernel also takes d = 1, zero-padded to 4, and took 1.24
//   times as long at the n_head 32 motion shapes on an H100 at 700 W:
//   chip_attention_choice.py); at bf16 d = 1 the tensor-core kernel's
//   k16 steps held one column of data in 16. Float32 above 1024 runs
//   <16, 64, float>.
// What bounds them: above d = 64 the q.k and p.v products, which grow
// with d while the exponentials do not, times the ceil(d / 64) repeats of
// q.k; at d = 1 the exponentials and the issue slots of the softmax. No
// kernel here allocates anything; all run on the caller's stream, and the
// (L, K) scores never leave the SM.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block: d-chunked, d = 1
constexpr int kCols = 64;      // output columns a block; q.k chunk (bf16)

// ---------------------------------------------------------------------------
// bfloat16: mma.sync
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;   // query rows a block: 16 a warp
constexpr int kTcKeys = 64;   // keys a tile
constexpr int kChunkBytes = 64 * kCols * 2;  // a staged 64 x 64 bf16 tile
constexpr int kTcSmem = 3 * kChunkBytes + kTcKeys * 4;

// Stage rows 0..63 of a 64-column bf16 chunk (columns col0..col0+63 of the
// row at src + r * stride) into a swizzled tile, zero past `rows` and past
// d. vec: d and every stride are multiples of 8 and the pointers 16-byte
// aligned, so each 8 columns are one 16-byte load.
__device__ __forceinline__ void stage_bf16(uint8_t* tile,
                                           const uint16_t* src,
                                           long long stride, int rows,
                                           int col0, int d, bool vec) {
  for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
    const int r = i >> 3;
    const int c8 = i & 7;
    const int col = col0 + 8 * c8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && col < d) {
      const uint16_t* p = src + r * stride + col;
      if (vec) {
        x = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t lo = col + 2 * j < d ? p[2 * j] : 0u;
          const uint32_t hi = col + 2 * j + 1 < d ? p[2 * j + 1] : 0u;
          w[j] = lo | (hi << 16);
        }
        x = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(tile + swz<8>(r, c8)) = x;
  }
}

// scale_log2 = log2(e) / sqrt(d). Block (query tile, head * nc + output
// chunk, batch row), nc = ceil(d / 64).
__global__ void __launch_bounds__(kThreads)
attn_packed_kernel_chunked_tc(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ out, int L, int K,
                              int d, Strides st, float scale_log2, int vec) {
  __shared__ __align__(128) uint8_t smem[kTcSmem];
  uint8_t* const qs = smem;
  uint8_t* const ks = smem + kChunkBytes;
  uint8_t* const vs = smem + 2 * kChunkBytes;
  float* const bs = reinterpret_cast<float*>(smem + 3 * kChunkBytes);

  const int nc = (d + kCols - 1) / kCols;
  const int b = blockIdx.z;
  const int h = blockIdx.y / nc;
  const int col_o = (blockIdx.y % nc) * kCols;  // this block's columns
  const int wo = min(kCols, d - col_o);
  const int q0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair
  const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) +
                       b * st.q_batch + h * st.q_head + q0 * st.q_row;
  const long long kv_off = b * st.kv_batch + h * st.kv_head;
  const uint16_t* kb = reinterpret_cast<const uint16_t*>(k) + kv_off;
  const uint16_t* vb = reinterpret_cast<const uint16_t*>(v) + kv_off;
  const float* biasb = bias ? bias + static_cast<long long>(b) * K : nullptr;
  const uint32_t qs_u = smem_u32(qs), ks_u = smem_u32(ks),
                 vs_u = smem_u32(vs);
  // ldmatrix lane roles: q (rows x depth) lanes 0-15 rows 0-15 of the
  // first 8 depth values, 16-31 the next 8; k (keys x depth) lanes 0-7 keys
  // 0-7 of the first 8, 8-15 the same keys' next 8, 16-31 keys 8-15
  const int q_row = warp * 16 + (lane & 15);
  const int q_half = lane >> 4;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_half = (lane >> 3) & 1;

  float m[2] = {-FLT_MAX, -FLT_MAX};  // running max (log2 units)
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  float acc[8][4];          // p.v of the block's columns, f32
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTcKeys) {
    const int nk = min(kTcKeys, K - k0);
    float sc[8][4];  // S: 16 rows x 64 keys of this warp
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kCols) {
      __syncthreads();  // the tiles are no longer read
      if (k0 == 0 || nc > 1) {  // one chunk of q stays for every tile
        stage_bf16(qs, qb, st.q_row, L - q0, c0, d, vec);
      }
      stage_bf16(ks, kb + k0 * st.kv_row, st.kv_row, nk, c0, d, vec);
      if (c0 == 0) {
        stage_bf16(vs, vb + k0 * st.kv_row, st.kv_row, nk, col_o, d, vec);
        if (threadIdx.x < kTcKeys) {
          const int j = threadIdx.x;
          bs[j] = j >= nk ? -INFINITY
                          : (biasb ? biasb[k0 + j] * kLog2e : 0.f);
        }
      }
      __syncthreads();
      const int wq = min(kCols, d - c0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= wq) break;  // columns past d are zero
        uint32_t a[4];
        ldmatrix_x4(a, qs_u + swz<8>(q_row, 2 * kk + q_half));
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t r[4];
          ldmatrix_x4(r, ks_u + swz<8>(16 * jp + k_row, 2 * kk + k_half));
          mma_bf16(sc[2 * jp], a, r[0], r[1]);
          mma_bf16(sc[2 * jp + 1], a, r[2], r[3]);
        }
      }
    }

    // scores in log2 units: s * scale * log2(e) + bias * log2(e), -inf
    // past K (the staged bias)
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = fmaf(sc[j][e], scale_log2, bs[8 * j + 2 * t + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = mx[r];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float mn = fmaxf(m[r], x);
      const float c = ex2(m[r] - mn);  // 1 when the max held
      m[r] = mn;
      l[r] *= c;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][2 * r] *= c;
        acc[n][2 * r + 1] *= c;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = ex2(sc[j][e] - m[e >> 1]);
        l[e >> 1] += sc[j][e];
      }

    // O += p.v over the block's columns, p as hi + lo; S's fragments of
    // keys 16kk..16kk+15 are the A fragment of that k16 step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (16 * np >= wo) break;  // columns past d are zero
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, vs_u + swz<8>(16 * kk + (lane & 15), 2 * np + (lane >> 4)));
        mma_bf16(acc[2 * np], ah, r[0], r[1]);
        mma_bf16(acc[2 * np + 1], ah, r[2], r[3]);
        mma_bf16(acc[2 * np], al, r[0], r[1]);
        mma_bf16(acc[2 * np + 1], al, r[2], r[3]);
      }
    }
  }

  // out: O / row sum, one rounding to bf16; all keys masked gives 0, as
  // the TPU kernel's (m > -1e29) factor (here in log2 units)
  __nv_bfloat16* ob = out + b * st.q_batch + h * st.q_head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= L) continue;
    const bool keep = biasb == nullptr || m[r] > -1e29f * kLog2e;
    const float inv = keep ? 1.f / den : 0.f;
    __nv_bfloat16* op = ob + static_cast<long long>(row) * st.q_row;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col_o + 8 * n + 2 * t + e;
        if (col < col_o + wo) {
          op[col] = __float2bfloat16(acc[n][2 * r + e] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores, f32 arithmetic: the d-chunked kernel and the d = 1 kernel
// ---------------------------------------------------------------------------

constexpr int kF32Keys = 64;  // keys a tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // to nearest even, once
}

// QC: columns of d a q.k chunk; VC: output columns a block (d = 1:
// <1, 1, T> in either dtype; float32 above 1024: <16, 64, float>); T the
// element type of q, k, v and out, widened to f32 as it is staged. Block
// (tile of 128 query rows, head * nc + output chunk, batch row), nc =
// ceil(d / VC); thread i owns row i of the tile. Scores are in log2 units
// from the start: q is staged times scale_log2, and the staged bias times
// log2(e) (-inf past K) is added to each dot product, so the exponent's
// argument is one subtraction of the running max (fused_attention_packed.
// cu's float32 kernel says why not an FMA with it).
template <int QC, int VC, typename T>
__global__ void __launch_bounds__(kThreads)
attn_packed_kernel_chunked_f32(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ bias,
                               T* __restrict__ out, int L, int K, int d,
                               Strides st, float scale_log2) {
  __shared__ float qs[kThreads][QC + 1];  // +1: a thread's row, no conflict
  __shared__ __align__(16) float ks[kF32Keys][QC];
  __shared__ __align__(16) float vs[kF32Keys][VC];
  __shared__ __align__(16) float bs[kF32Keys];

  const int nc = (d + VC - 1) / VC;
  const int b = blockIdx.z;
  const int h = blockIdx.y / nc;
  const int col_o = (blockIdx.y % nc) * VC;
  const int q0 = blockIdx.x * kThreads;
  const int tid = threadIdx.x;
  const T* qb = q + b * st.q_batch + h * st.q_head;
  const long long kv_off = b * st.kv_batch + h * st.kv_head;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  const float* biasb = bias ? bias + static_cast<long long>(b) * K : nullptr;

  float acc[VC];
#pragma unroll
  for (int i = 0; i < VC; ++i) acc[i] = 0.f;
  float m = -FLT_MAX;  // running max, log2 units
  float l = 0.f;       // running sum of exp2(score - m)

  for (int k0 = 0; k0 < K; k0 += kF32Keys) {
    const int nk = min(kF32Keys, K - k0);
    float s[kF32Keys];
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += QC) {
      __syncthreads();  // the tiles are no longer read
      if (k0 == 0 || d > QC) {  // one chunk of q stays for every tile
        for (int i = tid; i < kThreads * QC; i += kThreads) {
          const int r = i / QC, c = c0 + i % QC;
          qs[r][i % QC] =
              q0 + r < L && c < d
                  ? to_f32(qb[static_cast<long long>(q0 + r) * st.q_row +
                              c]) * scale_log2
                  : 0.f;
        }
      }
      for (int i = tid; i < kF32Keys * QC; i += kThreads) {
        const int j = i / QC, c = c0 + i % QC;
        ks[j][i % QC] =
            j < nk && c < d
                ? to_f32(kb[static_cast<long long>(k0 + j) * st.kv_row + c])
                : 0.f;
      }
      if (c0 == 0) {
        for (int i = tid; i < kF32Keys * VC; i += kThreads) {
          const int j = i / VC, c = col_o + i % VC;
          vs[j][i % VC] =
              j < nk && c < d
                  ? to_f32(vb[static_cast<long long>(k0 + j) * st.kv_row +
                              c])
                  : 0.f;
        }
        if (tid < kF32Keys) {
          bs[tid] = tid >= nk ? -INFINITY
                              : (biasb ? biasb[k0 + tid] * kLog2e : 0.f);
        }
      }
      __syncthreads();
      float qr[QC];
#pragma unroll
      for (int i = 0; i < QC; ++i) qr[i] = qs[tid][i];
#pragma unroll
      for (int j = 0; j < kF32Keys; ++j)
#pragma unroll
        for (int i = 0; i < QC; ++i) s[j] = fmaf(qr[i], ks[j][i], s[j]);
    }

    float mx = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      s[j] += bs[j];
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float c = ex2(m - mn);  // 1 when the max held
    m = mn;
    l *= c;
#pragma unroll
    for (int i = 0; i < VC; ++i) acc[i] *= c;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      const float p = ex2(s[j] - m);
      l += p;
#pragma unroll
      for (int i = 0; i < VC; ++i) acc[i] = fmaf(p, vs[j][i], acc[i]);
    }
  }

  const int row = q0 + tid;
  if (row >= L) return;
  // all keys masked: 0, as the TPU kernel's (m > -1e29) factor gives
  const bool keep = biasb == nullptr || m > -1e29f * kLog2e;
  const float inv = keep ? 1.f / l : 0.f;
  T* op = out + b * st.q_batch + h * st.q_head +
          static_cast<long long>(row) * st.q_row;
#pragma unroll
  for (int i = 0; i < VC; ++i) {
    if (col_o + i < d) op[col_o + i] = from_f32<T>(acc[i] * inv);
  }
}

// ---------------------------------------------------------------------------
// float32, d = 65..1024: one block all columns of its rows
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 256;
constexpr int kWideMaxD = 1024;

// C: d rounded up to 128 (128 .. 1024). A block owns R query rows and
// takes keys in super-tiles of KS: up to C = 256, R = 16384 / C and KS =
// C, so that q (R x C) and p (KS x R) each fill 64 KiB; past it (WIDE), KS
// = 512 and R = 32, q 64 KiB at most and p 72 KiB; past C = 512 (HUGE),
// KS = 256 and R = 32 up to C = 768 (q up to 96.5 KiB, p 36 KiB), KS =
// 512 and R = 16 past it (q up to 64 KiB, p 40 KiB). k comes in depth
// chunks of DK columns of the KS keys, v in chunks of VK keys of all C
// columns (VK dividing KS), each at most about 56 KiB, through a 2-slot
// ring. Each thread holds an 8 x KJ register tile of the R x KS scores
// (rows rg + TR i, keys kg + TK j; KJ = 8, and 4 past C = 512) and one of
// O (rows rg + TR i, 4 columns at 4 kg and W2 more: at 4 TK + W2 kg, 4 at
// C = 512 and up to 256, 2 at 384; past 512 at 4 TK + TK e + kg, e < W2 =
// C / TK - 4). Each float4 a thread reads from shared memory feeds 16
// FMAs up to C = 512 (one byte a FMA, the rate at which shared memory
// returns data) and at least 10 past it, where the q rows' float4s are
// the same for a warp's 32 lanes (one broadcast). A row's TK lanes are one
// warp (or a half-warp) up to C = 256, two warps up to 768, four past it.
// Rows are padded by 4 floats: 8 consecutive rows at one float4 fall in
// distinct banks.
template <int C>
struct Wide {
  static constexpr bool kWide = C > 256;
  static constexpr bool kHuge = C > 512;
  // R: past C = 512, 32 rows up to 768 (k and v staged once for twice
  // the rows of a block of 16, which took longer on an H100: PERF.md
  // section 6)
  static constexpr int kRows = kHuge ? (C <= 768 ? 32 : 16)
                               : kWide ? 32
                                       : 16384 / C;
  static constexpr int kKeys = kHuge && C <= 768 ? 256 : kWide ? 512 : C;
  static constexpr int kKj = kHuge ? 4 : 8;             // KJ
  // DK: 32 at C = 640 and 768, where k chunks of 16 columns (twice the
  // units, each with its two barriers) took longer on an H100 (PERF.md
  // section 6)
  static constexpr int kDk = kHuge && C <= 768 ? 32 : kWide ? 16 : 8192 / C;
  static constexpr int kTr = kRows / 8;    // row groups
  static constexpr int kTk = kKeys / kKj;  // key groups (lanes of a row)
  static constexpr int kRowWarps = kTk / 32;  // warps of a row, past 256
  static constexpr int kQs = C + 4;        // row strides, floats
  static constexpr int kKs = kDk + 4;
  static constexpr int kPs = kRows + 4;
  static constexpr int kVk = C == 768 || C == 1024 ? 8
                             : kWide                ? 16
                                                    : 8192 / C;  // VK
  static constexpr int kW2 = (C - 4 * kTk) / kTk;  // O's second columns
  static constexpr int kSlot = kKeys * kKs > kVk * kQs ? kKeys * kKs
                                                       : kVk * kQs;
  // q, p, two slots; each row's running max, running sum, rescale and
  // 1 / sum, and past 256 each of its warps' max and sum
  static constexpr int kFloats =
      kRows * kQs + kKeys * kPs + 2 * kSlot +
      (kWide ? 4 + 2 * kRowWarps : 4) * kRows;
  static constexpr int kSmem = 4 * kFloats;
  static_assert(kTr * kTk == kWideThreads, "a thread a score tile");
  static_assert(kTk * (4 + kW2) == C &&
                    (kW2 == 4 || kW2 == 2 || (kHuge && kW2 >= 1)),
                "a thread an O tile");
  static_assert(kSmem <= 232448, "shared memory of a block");
  static_assert(kTk <= 32 || kTk == 64 || kTk == 128,
                "a row's lanes: a warp, two or four");
  static_assert(kKeys % kVk == 0, "v chunks stay in their super-tile");
};

// the largest of a row's warps' maxima past C = 256, from part[w * R +
// row]
template <int NW, int R>
__device__ __forceinline__ float warps_max(const float* part, int row) {
  if constexpr (NW == 2)
    return fmaxf(part[row], part[R + row]);
  else
    return fmaxf(fmaxf(part[row], part[R + row]),
                 fmaxf(part[2 * R + row], part[3 * R + row]));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of a rows x cols box (row r, column c at src + r * stride
// + c; columns c0.. of the tensor) into `tile` (row stride ts floats),
// zero-filled at rows >= nrows and at columns c0 + c >= d. vec: d and
// every stride are multiples of 4 and the pointers 16-byte aligned, so
// each 4 columns are one 16-byte copy; else one copy a value.
template <int ROWS, int COLS>
__device__ __forceinline__ void wide_stage(float* tile, int ts,
                                           const float* src,
                                           long long stride, int nrows,
                                           int c0, int d, bool vec) {
  const uint32_t base = smem_u32(tile);
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * COLS / 4; i += kWideThreads) {
      const int r = i / (COLS / 4);
      const int c = 4 * (i % (COLS / 4));
      const bool ok = r < nrows && c0 + c < d;
      cp_async16(base + 4 * (r * ts + c), ok ? src + r * stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kWideThreads) {
      const int r = i / COLS;
      const int c = i % COLS;
      const bool ok = r < nrows && c0 + c < d;
      cp_async4(base + 4 * (r * ts + c), ok ? src + r * stride + c : src,
                ok ? 4 : 0);
    }
  }
}

// Block (tile of R query rows, head, batch row). scale_log2 = log2(e) /
// sqrt(d). vec as wide_stage's, for out too.
template <int C>
__global__ void __launch_bounds__(kWideThreads, 1)
attn_packed_kernel_f32wide(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int L, int K, int d,
                           Strides st, float scale_log2, int vec) {
  using G = Wide<C>;
  constexpr int R = G::kRows;
  extern __shared__ __align__(16) float wsm[];
  float* const qs = wsm;                       // R x C, times scale_log2
  float* const ps = qs + R * G::kQs;           // p[key][8 rg + i]
  float* const slots = ps + G::kKeys * G::kPs;  // k or v chunks
  float* const mrow = slots + 2 * G::kSlot;  // each row's running max (log2)
  float* const lrow = mrow + R;       // each row's running sum
  float* const corr = lrow + R;       // each row's rescale this super-tile
  float* const linv = corr + R;       // each row's 1 / sum
  float* const mpart = linv + R;      // past 256: each warp's max, then
  float* const spart = mpart + G::kRowWarps * R;  // sum, of each row
                                                  // ([warp][row])

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int rg = tid / G::kTk;  // rows rg + TR i, of q.k and of p.v
  const int kg = tid % G::kTk;  // q.k: keys kg + TK j; p.v: column group
  const float* qb = q + b * st.q_batch + h * st.q_head + q0 * st.q_row;
  const long long kv_off = b * st.kv_batch + h * st.kv_head;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;
  const float* biasb = bias ? bias + static_cast<long long>(b) * K : nullptr;
  const int nkd = (d + G::kDk - 1) / G::kDk;  // k chunks a super-tile
  const int tiles = (K + G::kKeys - 1) / G::kKeys;
  // units a super-tile: nkd k chunks, then its v chunks
  const auto units = [&](int t) {
    return nkd + (min(G::kKeys, K - t * G::kKeys) + G::kVk - 1) / G::kVk;
  };
  // start the copy of unit i of super-tile t into slot n
  const auto issue = [&](int t, int i, int n) {
    const int k0 = t * G::kKeys;
    float* const slot = slots + n * G::kSlot;
    if (i < nkd) {
      wide_stage<G::kKeys, G::kDk>(slot, G::kKs,
                                   kb + k0 * st.kv_row + i * G::kDk,
                                   st.kv_row, K - k0, i * G::kDk, d, vec);
    } else {
      const int j0 = k0 + (i - nkd) * G::kVk;
      wide_stage<G::kVk, C>(slot, G::kQs, vb + j0 * st.kv_row, st.kv_row,
                            K - j0, 0, d, vec);
    }
  };

  // q and the first unit, then the second, each its own group
  wide_stage<R, C>(qs, G::kQs, qb, st.q_row, L - q0, 0, d, vec);
  int nt = 0, ni = 0;  // the next unit to copy
  for (int n = 0; n < 2; ++n) {
    if (nt < tiles) {
      issue(nt, ni, n);
      if (++ni == units(nt)) ni = 0, ++nt;
    }
    cp_async_commit();
  }

  if (tid < R) {
    mrow[tid] = -FLT_MAX;
    lrow[tid] = 0.f;
  }
  constexpr int NO = 4 + G::kW2;  // O columns a thread
  constexpr int KJ = G::kKj;      // keys a thread
  float s[8][KJ];  // scores of the super-tile, then its p
  float o[8][NO];  // O: rows rg + TR i, columns 4 kg .. and W2 more
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < NO; ++e) o[i][e] = 0.f;

  int n = 0;  // the slot of the current unit
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * G::kKeys;
    const int nu = units(t);
    for (int i = 0; i < nu; ++i, n ^= 1) {
      cp_async_wait<1>();  // this unit (and q) landed; the next may not
      __syncthreads();
      const float* slot = slots + n * G::kSlot;
      if (!G::kWide && t == 0 && i == 0) {  // scores in log2 units
        for (int x = tid; x < R * G::kQs; x += kWideThreads) {
          qs[x] *= scale_log2;
        }
        __syncthreads();
      }
      if (i < nkd) {
        // S += q.k over this chunk's DK columns, in column order
        if (i == 0) {
#pragma unroll
          for (int x = 0; x < 8; ++x)
#pragma unroll
            for (int j = 0; j < KJ; ++j) s[x][j] = 0.f;
        }
        const float* qr = qs + rg * G::kQs + i * G::kDk;
        const float* kr = slot + kg * G::kKs;
#pragma unroll 1  // unrolled, ptxas spills (see the note at the top)
        for (int c = 0; c < G::kDk; c += 4) {
          float4 qv[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            qv[x] = *reinterpret_cast<const float4*>(
                qr + x * G::kTr * G::kQs + c);
          }
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const float4 kv = *reinterpret_cast<const float4*>(
                kr + j * G::kTk * G::kKs + c);
#pragma unroll
            for (int x = 0; x < 8; ++x) {
              s[x][j] = fmaf(qv[x].x, kv.x, s[x][j]);
              s[x][j] = fmaf(qv[x].y, kv.y, s[x][j]);
              s[x][j] = fmaf(qv[x].z, kv.z, s[x][j]);
              s[x][j] = fmaf(qv[x].w, kv.w, s[x][j]);
            }
          }
        }
      } else {
        if (i == nkd && G::kWide) {
          // online softmax over the super-tile, a row's TK lanes in two
          // warps (four past C = 512): the scores to log2 units (one FMA with the bias: q
          // scaled before q.k, rounded to float32, moved the output by up
          // to 3e-5 at d = 384), each warp's max of each row through shared
          // memory, then p, O's rescale in this thread's registers, and
          // each warp's sum; one thread a row updates the running max and
          // sum after the second barrier (no thread reads them again this
          // super-tile)
          float bl[KJ];
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const int key = k0 + kg + G::kTk * j;
            bl[j] = key >= K ? -INFINITY
                             : (biasb ? __ldg(biasb + key) * kLog2e : 0.f);
          }
          const int wh = kg / 32;  // which of the row's warps
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            float mx = -FLT_MAX;
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
              s[x][j] = fmaf(s[x][j], scale_log2, bl[j]);
              mx = fmaxf(mx, s[x][j]);
            }
#pragma unroll
            for (int off = 1; off < 32; off *= 2) {
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            }
            if (kg % 32 == 0) mpart[wh * R + rg + G::kTr * x] = mx;
          }
          __syncthreads();  // the warps' maxima written
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int row = rg + G::kTr * x;
            const float mo = mrow[row];
            const float mn =
                fmaxf(mo, warps_max<G::kRowWarps, R>(mpart, row));
            const float c = ex2(mo - mn);  // 1 when the max held
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
              s[x][j] = ex2(s[x][j] - mn);
              sum += s[x][j];
            }
#pragma unroll
            for (int off = 1; off < 32; off *= 2) {
              sum += __shfl_xor_sync(0xffffffffu, sum, off);
            }
            if (kg % 32 == 0) spart[wh * R + row] = sum;
#pragma unroll
            for (int e = 0; e < NO; ++e) o[x][e] *= c;
          }
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            float* const pp = ps + (kg + G::kTk * j) * G::kPs + 8 * rg;
            *reinterpret_cast<float4*>(pp) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
            *reinterpret_cast<float4*>(pp + 4) =
                make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
          }
          __syncthreads();  // p and the sums written, mrow read
          if (tid < R) {
            const float mo = mrow[tid];
            const float mn =
                fmaxf(mo, warps_max<G::kRowWarps, R>(mpart, tid));
            mrow[tid] = mn;
            float sum = lrow[tid] * ex2(mo - mn);
#pragma unroll
            for (int w = 0; w < G::kRowWarps; ++w) sum += spart[w * R + tid];
            lrow[tid] = sum;
          }
        } else if (i == nkd) {
          // online softmax over the super-tile: each row's max and sum
          // over its TK lanes (one warp or half-warp); the running max and
          // sum, and the rescale of O (below), kept in shared memory. The
          // bias of this thread's keys (times log2(e); -inf past K) comes
          // straight from device memory, once a super-tile.
          float bl[KJ];
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const int key = k0 + kg + G::kTk * j;
            bl[j] = key >= K ? -INFINITY
                             : (biasb ? __ldg(biasb + key) * kLog2e : 0.f);
          }
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int row = rg + G::kTr * x;
            float mx = -FLT_MAX;
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
              s[x][j] += bl[j];
              mx = fmaxf(mx, s[x][j]);
            }
#pragma unroll
            for (int off = 1; off < G::kTk; off *= 2) {
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            }
            const float mo = mrow[row];
            const float mn = fmaxf(mo, mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
              s[x][j] = ex2(s[x][j] - mn);
              sum += s[x][j];
            }
#pragma unroll
            for (int off = 1; off < G::kTk; off *= 2) {
              sum += __shfl_xor_sync(0xffffffffu, sum, off);
            }
            if (kg == 0) {  // the row's lanes read mrow before the shuffles
              const float c = ex2(mo - mn);  // 1 when the max held
              mrow[row] = mn;
              lrow[row] = lrow[row] * c + sum;
              corr[row] = c;
            }
          }
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            float* const pp = ps + (kg + G::kTk * j) * G::kPs + 8 * rg;
            *reinterpret_cast<float4*>(pp) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
            *reinterpret_cast<float4*>(pp + 4) =
                make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
          }
          __syncthreads();  // p and the rescales written
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const float c = corr[rg + G::kTr * x];
#pragma unroll
            for (int e = 0; e < NO; ++e) o[x][e] *= c;
          }
        }
        // O += p.v over this chunk's VK keys
        const float* pr = ps + ((i - nkd) * G::kVk) * G::kPs + 8 * rg;
        const float* vr = slot + 4 * kg;
        // past C = 512 the second columns at 4 TK + TK e + kg, e < W2
        const float* vr2 =
            slot + 4 * G::kTk + (G::kHuge ? 1 : G::kW2) * kg;
#pragma unroll 8
        for (int j = 0; j < G::kVk; ++j) {
          const float4 p0 = *reinterpret_cast<const float4*>(pr + j * G::kPs);
          const float4 p1 =
              *reinterpret_cast<const float4*>(pr + j * G::kPs + 4);
          const float4 w0 = *reinterpret_cast<const float4*>(vr + j * G::kQs);
          float w[NO] = {w0.x, w0.y, w0.z, w0.w};
          if constexpr (G::kHuge) {
#pragma unroll
            for (int e = 0; e < G::kW2; ++e)
              w[4 + e] = vr2[j * G::kQs + G::kTk * e];
          } else if constexpr (G::kW2 == 4) {
            const float4 w1 =
                *reinterpret_cast<const float4*>(vr2 + j * G::kQs);
            w[4] = w1.x, w[5] = w1.y, w[6] = w1.z, w[7] = w1.w;
          } else {
            const float2 w1 =
                *reinterpret_cast<const float2*>(vr2 + j * G::kQs);
            w[4] = w1.x, w[5] = w1.y;
          }
          const float pv[8] = {p0.x, p0.y, p0.z, p0.w,
                               p1.x, p1.y, p1.z, p1.w};
#pragma unroll
          for (int x = 0; x < 8; ++x)
#pragma unroll
            for (int e = 0; e < NO; ++e) o[x][e] = fmaf(pv[x], w[e], o[x][e]);
        }
      }
      __syncthreads();  // the slot (and p) read
      if (nt < tiles) {
        issue(nt, ni, n);
        if (++ni == units(nt)) ni = 0, ++nt;
      }
      cp_async_commit();  // (empty at the end: the count stays even)
    }
  }
  cp_async_wait<0>();

  // 1 / sum, or 0 where every key was masked, as the TPU kernel's
  // (m > -1e29) factor (in log2 units)
  if (tid < R) {
    const bool keep = biasb == nullptr || mrow[tid] > -1e29f * kLog2e;
    linv[tid] = keep ? 1.f / lrow[tid] : 0.f;
  }
  __syncthreads();

  float* ob = out + b * st.q_batch + h * st.q_head;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int row = q0 + rg + G::kTr * x;
    if (row >= L) continue;
    const float inv = linv[rg + G::kTr * x];
    float* op = ob + static_cast<long long>(row) * st.q_row;
    // columns 4 kg .. + 3, then 4 TK + W2 kg .. + W2 - 1 (past C = 512,
    // 4 TK + TK e + kg, e < W2)
    if constexpr (G::kHuge) {
      const int c = 4 * kg;
      if (vec && c < d) {
        *reinterpret_cast<float4*>(op + c) =
            make_float4(o[x][0] * inv, o[x][1] * inv, o[x][2] * inv,
                        o[x][3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < d) op[c + e] = o[x][e] * inv;
        }
      }
#pragma unroll
      for (int e = 0; e < G::kW2; ++e) {
        const int c2 = 4 * G::kTk + G::kTk * e + kg;
        if (c2 < d) op[c2] = o[x][4 + e] * inv;
      }
    } else {
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        const int n = hn ? G::kW2 : 4;
        const int c = hn ? 4 * G::kTk + G::kW2 * kg : 4 * kg;
        if (c >= d) continue;
        float rv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rv[e] = e < n ? o[x][4 * hn + e] * inv : 0.f;
        if (vec && n == 4) {
          *reinterpret_cast<float4*>(op + c) =
              make_float4(rv[0], rv[1], rv[2], rv[3]);
        } else if (vec) {
          *reinterpret_cast<float2*>(op + c) = make_float2(rv[0], rv[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e < n && c + e < d) op[c + e] = rv[e];
          }
        }
      }
    }
  }
}

template <int C>
int launch_wide(const float* q, const float* k, const float* v,
                const float* bias, float* out, int B, int H, int L, int K,
                int d, const Strides& st, float sl2, int vec,
                cudaStream_t s) {
  auto kernel = attn_packed_kernel_f32wide<C>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Wide<C>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + Wide<C>::kRows - 1) / Wide<C>::kRows, H, B);
  kernel<<<grid, kWideThreads, Wide<C>::kSmem, s>>>(q, k, v, bias, out, L, K,
                                                    d, st, sl2, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes: q, k, v and out share dtype 0 (float32) or 1
// (bfloat16); bias is a float32 (B, K) or null. layout 0, token-major
// (kernel K1): q, out (B, L, H*d); k, v (B, K, H*d), or a shared (K, H*d)
// when kv_shared is 1. layout 1, head-split (kernel K2): q, out (B, H, L,
// d); k, v (B, H, K, d), or a shared (1, H, K, d). kernel (plan's kernel):
// 0 the d-chunked kernels (any d >= 1: attn_packed_kernel_chunked_tc for
// bfloat16, attn_packed_kernel_chunked_f32<16, 64> for float32); 1 the
// d = 1 kernel attn_packed_kernel_chunked_f32<1, 1, T> (d = 1, either
// dtype); 2 attn_packed_kernel_f32wide (float32, d = 65..1024). Returns the
// CUDA error of the launch (0 on success), cudaErrorInvalidValue for what
// the kernel named does not take.
extern "C" int samt_attention_chunked(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, int B, int H, int L, int K,
                                      int d, int layout, int kv_shared,
                                      float scale, int dtype, int kernel,
                                      void* stream) {
  if (d < 1 || B <= 0 || H <= 0 || L <= 0 || K <= 0 || B > 65535 ||
      (layout != 0 && layout != 1) || (dtype != 0 && dtype != 1) ||
      (kernel == 1 && d != 1) ||
      (kernel == 2 && (dtype != 0 || d <= 64 || d > kWideMaxD)) ||
      kernel < 0 || kernel > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long E = static_cast<long long>(H) * d;
  const long long kv_head = static_cast<long long>(K) * d;
  const Strides st =
      layout == 0
          ? Strides{L * E, E, d, kv_shared ? 0 : K * E, E, d}
          : Strides{H * static_cast<long long>(L) * d, d,
                    static_cast<long long>(L) * d, kv_shared ? 0 : H * kv_head,
                    d, kv_head};
  const int nc = kernel == 0 ? (d + kCols - 1) / kCols : 1;
  const float* bb = static_cast<const float*>(bias);
  const float sl2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(H) * nc > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (kernel == 2) {
    const int vec = d % 4 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                    aligned(out);
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(out);
    if (d <= 128)
      return launch_wide<128>(qf, kf, vf, bb, of, B, H, L, K, d, st, sl2,
                              vec, s);
    if (d <= 256)
      return launch_wide<256>(qf, kf, vf, bb, of, B, H, L, K, d, st, sl2,
                              vec, s);
    if (d <= 384)
      return launch_wide<384>(qf, kf, vf, bb, of, B, H, L, K, d, st, sl2,
                              vec, s);
    if (d <= 512)
      return launch_wide<512>(qf, kf, vf, bb, of, B, H, L, K, d, st, sl2,
                              vec, s);
    if (d <= 640)
      return launch_wide<640>(qf, kf, vf, bb, of, B, H, L, K, d, st, sl2,
                              vec, s);
    if (d <= 768)
      return launch_wide<768>(qf, kf, vf, bb, of, B, H, L, K, d, st, sl2,
                              vec, s);
    if (d <= 896)
      return launch_wide<896>(qf, kf, vf, bb, of, B, H, L, K, d, st, sl2,
                              vec, s);
    return launch_wide<1024>(qf, kf, vf, bb, of, B, H, L, K, d, st, sl2, vec,
                             s);
  }
  if (kernel == 1) {
    const dim3 grid((L + kThreads - 1) / kThreads, H, B);
    if (dtype == 1) {
      attn_packed_kernel_chunked_f32<1, 1, __nv_bfloat16>
          <<<grid, kThreads, 0, s>>>(
              static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v), bb,
              static_cast<__nv_bfloat16*>(out), L, K, d, st, sl2);
    } else {
      attn_packed_kernel_chunked_f32<1, 1, float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), bb, static_cast<float*>(out), L, K,
          d, st, sl2);
    }
  } else if (dtype == 1) {
    const int vec = d % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
    const dim3 grid((L + kTcRows - 1) / kTcRows, H * nc, B);
    attn_packed_kernel_chunked_tc<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bb,
        static_cast<__nv_bfloat16*>(out), L, K, d, st, sl2, vec);
  } else {
    const dim3 grid((L + kThreads - 1) / kThreads, H * nc, B);
    attn_packed_kernel_chunked_f32<16, kCols, float>
        <<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), bb, static_cast<float*>(out), L,
            K, d, st, sl2);
  }
  return static_cast<int>(cudaGetLastError());
}
