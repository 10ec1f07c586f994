// Fused softmax attention for Hopper (sm_90a), in two layouts.
//
// Replaces two TPU kernels that compute one function in two layouts:
// - `_attn_kernel_packed` (synergize_motion_appearance_tpu/ops/
//   fused_attention.py:227, launched by `_fused_attention_packed_pallas` at
//   :266; kernel K1 of the port): q (B, L, E) token-major, H heads of
//   d = E / H read as the column slice [h*d, (h+1)*d) of each row; k, v
//   (B, K, E), or one (K, E) context shared by every batch row;
// - `_attn_kernel` (same file, :56, launched by `_fused_attention_pallas`
//   at :100; kernel K2): q (B, H, L, d) head-split; k, v (B, H, K, d), or
//   one (1, H, K, d) context shared by every batch row.
// Shared k/v is read at batch stride 0, never broadcast in memory. Optional
// (B, K) f32 additive bias where -1e30 masks a key. Scores q.k * 1/sqrt(d)
// in f32, f32 max-subtracted softmax, f32 accumulation of p.v, output in
// q's dtype and q's layout. With a bias, a row whose max score is <= -1e29
// (every key masked) outputs 0, never NaN. The two layouts differ only in
// the batch, row and head strides the kernel is given (`Strides`).
//
// What bounds it on this card: at the main path's shapes (L = 1024 queries,
// K <= 1024 keys) the inputs are a few MB while the work is B*H*L*K scores,
// each costing 2d FMAs and one exp. With d = 4 (motion layers) that is far
// below a tensor-core tile, so the kernel is bound by exp and FMA issue on
// the CUDA cores, not by HBM bytes; with d = 32 (appearance layers) it is
// FMA-bound on the CUDA cores (a tensor-core version is later work).
//
// Design: one block per (tile of 128 query rows, head, batch row), one query
// row per thread. The thread keeps its q row and its f32 accumulator in
// registers and runs an online softmax over the keys, which arrive in tiles
// of 64 staged in shared memory as f32 (every thread reads the same key at
// once, a broadcast). Scores are taken 8 keys at a time so the running max
// rescales the accumulator once per 8 keys. Only q, k, v and the bias are
// read from device memory and only the output is written: the
// (L, K) score tile never leaves the SM, and the token-major layout is
// never copied to a head-split one or back. The kernel allocates nothing
// and runs on the caller's stream.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // query rows per block: one per thread
constexpr int kKeys = 64;   // keys per shared-memory tile
constexpr int kChunk = 8;   // keys per running-max update

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

// Element strides of a layout: q and out share (q_batch, q_row, q_head);
// k and v share (kv_batch, kv_row, kv_head), with kv_batch 0 for a context
// shared by the batch. Within a head the d values are contiguous.
struct Strides {
  long long q_batch, q_row, q_head;
  long long kv_batch, kv_row, kv_head;
};

// DMAX is the head width rounded up to a power of two; d is the real one.
// Shared-memory columns d..DMAX-1 hold zeros, so the unrolled loops over
// DMAX add nothing for them.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kRows)
attn_packed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   T* __restrict__ out, int L, int K, int d, Strides st,
                   float scale) {
  __shared__ __align__(16) float ks[kKeys][DMAX];
  __shared__ __align__(16) float vs[kKeys][DMAX];
  __shared__ float bs[kKeys];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < L;
  const long long q_off =
      b * st.q_batch + static_cast<long long>(row) * st.q_row +
      h * st.q_head;

  float qr[DMAX];
  float acc[DMAX];
  const T* qp = q + q_off;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    qr[i] = (active && i < d) ? to_f32(qp[i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -FLT_MAX;  // running max of the scores
  float l = 0.f;       // running sum of exp(score - m)

  const long long kv_off = b * st.kv_batch + h * st.kv_head;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  const float* biasb =
      bias ? bias + static_cast<long long>(b) * K : nullptr;

  for (int k0 = 0; k0 < K; k0 += kKeys) {
    const int nk = min(kKeys, K - k0);
    // rows nk..nk_pad-1 are zero-filled so the last chunk reads no stale
    // shared memory (0 * NaN would poison the accumulator)
    const int nk_pad = (nk + kChunk - 1) / kChunk * kChunk;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < nk_pad * DMAX; idx += kRows) {
      const int j = idx / DMAX;
      const int i = idx % DMAX;
      float kx = 0.f, vx = 0.f;
      if (j < nk && i < d) {
        const long long off =
            static_cast<long long>(k0 + j) * st.kv_row + i;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      ks[j][i] = kx;
      vs[j][i] = vx;
    }
    if (threadIdx.x < kKeys) {
      bs[threadIdx.x] =
          (biasb && threadIdx.x < nk) ? biasb[k0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    for (int j0 = 0; j0 < nk_pad; j0 += kChunk) {
      float sc[kChunk];
      float mc = m;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = j0 + u;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DMAX; ++i) s = fmaf(qr[i], ks[j][i], s);
        s = s * scale + bs[j];
        sc[u] = (j < nk) ? s : -INFINITY;
        mc = fmaxf(mc, sc[u]);
      }
      const float c = __expf(m - mc);  // 1 when the max did not move
      l *= c;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) acc[i] *= c;
      m = mc;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float p = __expf(sc[u] - m);
        l += p;
#pragma unroll
        for (int i = 0; i < DMAX; ++i) acc[i] = fmaf(p, vs[j0 + u][i], acc[i]);
      }
    }
  }

  if (!active) return;
  // all keys masked: 0, as the TPU kernel's (m > -1e29) factor gives
  const bool keep = (biasb == nullptr) || (m > -1e29f);
  const float inv = keep ? 1.f / l : 0.f;
  T* op = out + q_off;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    if (i < d) store(op + i, keep ? acc[i] * inv : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, int B, int L, int K, int H,
                   int d, const Strides& st, float scale,
                   cudaStream_t stream) {
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define SAMT_LAUNCH(DM)                                                    \
  attn_packed_kernel<T, DM><<<grid, kRows, 0, stream>>>(                   \
      qt, kt, vt, bias, ot, L, K, d, st, scale)
  if (d <= 4) {
    SAMT_LAUNCH(4);
  } else if (d <= 8) {
    SAMT_LAUNCH(8);
  } else if (d <= 16) {
    SAMT_LAUNCH(16);
  } else if (d <= 32) {
    SAMT_LAUNCH(32);
  } else {
    SAMT_LAUNCH(64);
  }
#undef SAMT_LAUNCH
  return cudaGetLastError();
}

// Both layouts' entries: checks the sizes, then launches in dtype 0
// (float32) or 1 (bfloat16).
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* bias, void* out, int B, int L, int K, int H,
                     int d, const Strides& st, float scale, int dtype,
                     void* stream) {
  if (d < 2 || d > 64 || B <= 0 || L <= 0 || K <= 0 || H <= 0 ||
      B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, b, out, B, L, K, H, d, st, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, b, out, B, L, K, H, d, st, scale,
                                 s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entries, bound with ctypes. dtype: 0 = float32, 1 = bfloat16 (q, k, v
// and out share it; bias is float32 or null). Each returns the CUDA error
// of the launch (0 on success); the caller checks shapes before calling.

// Token-major (kernel K1): q, out (B, L, E); k, v (B, K, E) with
// kv_batch_stride K*E, or a shared (K, E) with kv_batch_stride 0.
extern "C" int samt_fused_attention_packed(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int L, int K, int E, int H, long long kv_batch_stride, float scale,
    int dtype, void* stream) {
  if (H <= 0 || E % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int d = E / H;
  const Strides st{static_cast<long long>(L) * E, E, d,
                   kv_batch_stride, E, d};
  return static_cast<int>(
      dispatch(q, k, v, bias, out, B, L, K, H, d, st, scale, dtype, stream));
}

// Head-split (kernel K2): q, out (B, H, L, d); k, v (B, H, K, d), or a
// shared (1, H, K, d) when kv_shared is 1.
extern "C" int samt_fused_attention_split(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int H, int L, int K, int d, int kv_shared, float scale, int dtype,
    void* stream) {
  const long long kv_head = static_cast<long long>(K) * d;
  const Strides st{H * static_cast<long long>(L) * d, d,
                   static_cast<long long>(L) * d,
                   kv_shared ? 0 : H * kv_head, d, kv_head};
  return static_cast<int>(
      dispatch(q, k, v, bias, out, B, L, K, H, d, st, scale, dtype, stream));
}
