// Softmax attention at the head widths the other attention kernels do not
// take, in both layouts: d = 1 and every d > 64 outside the wgmma kernels
// (bfloat16 at 65..127, 129..255 and above 256, or at 128 and 256 with a
// pointer TMA cannot take; float32 above 64), in bfloat16 and in float32.
// No shipped config reaches these widths; a generator at n_head 32 (d = 1
// in the motion transformer) does. bfloat16 d = 256 (the appearance
// transformer at n_head 1) runs fused_attention_wgmma256.cu, which runs q.k
// and the exponentials once a head where this kernel runs them four times
// (PERF.md section 6 has both times).
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
// The design (a simple one that is right; no shipped config runs it): a
// block owns a tile of query rows of one head and one chunk of at
// most 64 of its output columns. It computes the full q.k over d in chunks
// of columns, staging each chunk of q and k in shared memory, runs the
// online softmax over key tiles (the accumulator rescaled once a tile), and
// accumulates p.v for its own columns only. So the ceil(d / 64) blocks of a
// head each repeat its q.k and its exponentials: at d = 256 four times.
// Copies are plain loads through registers (16 bytes a thread where the
// rows and pointers allow, else element by element: a bf16 row of d = 1 is
// 2 bytes, which no cp.async takes), one tile at a time between two
// barriers; the other blocks of the SM hide the loads' latency.
// - bfloat16 (`attn_packed_kernel_chunked_tc`): 64 query rows a block, 16
//   a warp; q.k on `mma.sync.m16n8k16` with q and k read by `ldmatrix` from
//   64-column chunks (zero past d, so only the k16 steps that hold columns
//   of d run), p.v the same way with p split into bf16 hi + lo (two
//   products into one f32 accumulator, ~16 bits of each weight, as
//   fused_attention_packed.cu's tensor-core kernel) on 64-key tiles.
// - float32 (`attn_packed_kernel_chunked_f32<QC, VC>`): exact f32 FMAs on
//   the CUDA cores (no TF32), one query row a thread, 128 a block; q (times
//   scale * log2(e)) and k staged QC columns at a time, the block's VC
//   output columns of v once a key tile. d = 1 runs <1, 1>, so no FMA is
//   spent on padding (fused_attention_packed.cu's float32 kernel also
//   takes d = 1, zero-padded to 4, and took 1.24 times as long at the
//   n_head 32 motion shapes on an H100 at 700 W: chip_attention_choice.py);
//   d > 64 runs <16, 64>.
// What bounds it: at d > 64 the q.k and p.v products, which grow with d
// while the exponentials do not (4d FLOP a score: at d = 128 the
// tensor cores' time passes the exponentials'), times the ceil(d / 64)
// repeats of q.k; at d = 1 the exponentials and the issue slots of the
// softmax. Neither kernel allocates anything; both run on the caller's
// stream, and the (L, K) scores never leave the SM.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block, both kernels
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
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Keys = 64;  // keys a tile

// QC: columns of d a q.k chunk; VC: output columns a block (d = 1: <1, 1>;
// d > 64: <16, 64>). Block (tile of 128 query rows, head * nc + output
// chunk, batch row), nc = ceil(d / VC); thread i owns row i of the tile.
// Scores are in log2 units from the start: q is staged times scale_log2,
// and the staged bias times log2(e) (-inf past K) is added to each dot
// product, so the exponent's argument is one subtraction of the running max
// (fused_attention_packed.cu's float32 kernel says why not an FMA with it).
template <int QC, int VC>
__global__ void __launch_bounds__(kThreads)
attn_packed_kernel_chunked_f32(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int L, int K, int d,
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
  const float* qb = q + b * st.q_batch + h * st.q_head;
  const long long kv_off = b * st.kv_batch + h * st.kv_head;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;
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
          qs[r][i % QC] = q0 + r < L && c < d
                              ? qb[static_cast<long long>(q0 + r) * st.q_row
                                   + c] * scale_log2
                              : 0.f;
        }
      }
      for (int i = tid; i < kF32Keys * QC; i += kThreads) {
        const int j = i / QC, c = c0 + i % QC;
        ks[j][i % QC] =
            j < nk && c < d
                ? kb[static_cast<long long>(k0 + j) * st.kv_row + c]
                : 0.f;
      }
      if (c0 == 0) {
        for (int i = tid; i < kF32Keys * VC; i += kThreads) {
          const int j = i / VC, c = col_o + i % VC;
          vs[j][i % VC] =
              j < nk && c < d
                  ? vb[static_cast<long long>(k0 + j) * st.kv_row + c]
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
  float* op = out + b * st.q_batch + h * st.q_head +
              static_cast<long long>(row) * st.q_row;
#pragma unroll
  for (int i = 0; i < VC; ++i) {
    if (col_o + i < d) op[col_o + i] = acc[i] * inv;
  }
}

}  // namespace

// C entry, bound with ctypes: q, k, v and out share dtype 0 (float32) or 1
// (bfloat16); bias is a float32 (B, K) or null; any d >= 1. layout 0,
// token-major (kernel K1): q, out (B, L, H*d); k, v (B, K, H*d), or a shared
// (K, H*d) when kv_shared is 1. layout 1, head-split (kernel K2): q, out
// (B, H, L, d); k, v (B, H, K, d), or a shared (1, H, K, d). Returns the
// CUDA error of the launch (0 on success), cudaErrorInvalidValue for what
// the kernels do not take.
extern "C" int samt_attention_chunked(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, int B, int H, int L, int K,
                                      int d, int layout, int kv_shared,
                                      float scale, int dtype, void* stream) {
  if (d < 1 || B <= 0 || H <= 0 || L <= 0 || K <= 0 || B > 65535 ||
      (layout != 0 && layout != 1) || (dtype != 0 && dtype != 1)) {
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
  const int nc = (d + kCols - 1) / kCols;
  const float* bb = static_cast<const float*>(bias);
  const float sl2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(H) * nc > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1) {
    const auto aligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const int vec = d % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
    const dim3 grid((L + kTcRows - 1) / kTcRows, H * nc, B);
    attn_packed_kernel_chunked_tc<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bb,
        static_cast<__nv_bfloat16*>(out), L, K, d, st, sl2, vec);
  } else if (d == 1) {
    const dim3 grid((L + kThreads - 1) / kThreads, H, B);
    attn_packed_kernel_chunked_f32<1, 1><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bb, static_cast<float*>(out), L, K, d,
        st, sl2);
  } else {
    const dim3 grid((L + kThreads - 1) / kThreads, H * nc, B);
    attn_packed_kernel_chunked_f32<16, kCols><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bb, static_cast<float*>(out), L, K, d,
        st, sl2);
  }
  return static_cast<int>(cudaGetLastError());
}
