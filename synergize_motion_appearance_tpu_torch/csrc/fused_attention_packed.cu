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
// q's dtype and q's layout, rounded once. With a bias, a row whose max
// score is <= -1e29 (every key masked) outputs 0, never NaN. The two
// layouts differ only in the batch, row and head strides the kernel is
// given (`Strides`).
//
// What bounds it on this card: at the main path's shapes (L = 1024 queries,
// K <= 1024 keys, d = 4 or 32) the inputs are a few MB while the work is
// B*H*L*K scores, each costing 2d multiply-adds for q.k and for p.v and
// one exponential. On the tensor cores the products cost little at d <= 64;
// the exponentials go to the special-function units, 16 results per SM per
// clock, about 4.2e12/s on the H100 SXM, which is the floor (the bytes take
// a tenth of it). Everything else done per score (scale, max, subtract,
// sum, the split of p below) runs on the f32 pipes beside them. No one of
// these pipes is full in practice: per key tile a warp runs a chain of
// dependent steps (q.k products, max, exponentials, split, p.v products),
// so the kernel is bound by how much independent work each SM has to
// interleave, which is what the two m16 tiles per warp of the mma.sync
// kernel below add, and what the wgmma kernel's warp specialisation and
// the f32 kernel's rows per thread address.
//
// bfloat16 at d = 16, 32, 64 and 128 (the appearance transformer's d = 32
// among them) runs `attn_packed_kernel_wgmma` of fused_attention_wgmma.cu,
// on Hopper's warpgroup tensor cores; d = 1 and the widths above 64, in
// either dtype, the d-chunked kernels of fused_attention_chunked.cu. The
// other bfloat16 widths here (2 <= d <= 64: d <= 8, d not a multiple of 16;
// no shipped path runs them in bf16) run `attn_packed_kernel_tc` on
// `mma.sync`, and float32 up to 64 the CUDA-core kernel below;
// ops/fused_attention.py::plan picks by shape. In
// `attn_packed_kernel_tc` a block is one (tile of 64 or 128 query rows,
// head, batch row); each warp owns 32 query rows as kMTiles = 2 m16
// tiles, whose q fragments it loads once into registers, zero beyond d up
// to the mma depth of 16; every k and v fragment it loads serves both
// tiles, as in FlashAttention-2. Keys arrive in tiles of 64 through a
// 3-stage `cp.async` ring in shared memory,
// k and v kept as bf16, with copies of 16, 8 or 4 bytes per key row (d =
// 32, 4 and 2 take one copy a row each; the wrapper picks the widest that
// the head width and the pointers allow, ops/fused_attention.py::
// copy_bytes; a head whose row is not 4-byte aligned is copied through
// registers). Rows of a key tile are 16, 32, 64 or 128 bytes; the 16-byte
// chunks of a row are XORed with the row's place among the 8 rows of a
// 128-byte span, so the 8 rows of every `ldmatrix` phase fall in 8
// distinct bank groups. S = q.k^T is `mma.sync.m16n8k16` bf16 x bf16 -> f32
// with k read by `ldmatrix`: exactly the TPU kernel's bf16 dot with f32
// accumulation (bf16 products are exact in f32). `mma.sync` and not
// `wgmma`: a warp's fragments map one to one onto the TPU kernel's per-row
// arithmetic, and `wgmma` with warp specialisation is later work. The
// softmax stays in registers: scale * log2(e) is folded into one FMA with
// the bias (also taken times log2(e)), keys past K get -inf through that
// bias term (a zero key would score 0 and enter the softmax), exponentials
// are `ex2.approx`, one running max per row is reduced across the quad of
// threads that holds the row, and the accumulator is rescaled once per key
// tile. The running max starts at -FLT_MAX, not -inf, so the first tile's
// rescale is exp2(-FLT_MAX - m) = 0 and never exp2(nan).
// P.V keeps the TPU kernel's f32 weights (its note at :31-35 records that
// a bf16 p was tried there and rejected): p is split as hi = bf16(p) and
// lo = bf16(p - hi) and both are multiplied into the same f32 accumulator,
// which keeps about 16 significant bits of each weight, against the 8 that
// bf16(p) alone would. The S accumulator fragment is the A fragment of P.V
// by the layout identity of FlashAttention-2, so p never goes through
// shared memory; v is read by `ldmatrix.trans`. The P.V width is d rounded
// up to 8, 16, 32 or 64. Where that leaves a spare column (d = 2, 4: d < 8)
// v's staged tile holds ones in column d and the tensor cores return the
// row sum with the product, as the TPU kernel's ones column does (:253-259);
// where it does not (d = 8, 32, 64) each thread sums its p in f32 and the
// quad adds its four partial sums once at the end: the f32 pipes have room
// beside the exponentials, and a ones tile would add a quarter to the d = 32
// products.
// Small heads (d = 2, 4, 8) are zero-padded to the mma depth in the staged
// key tile and in the q fragments. A block serves one head: in the token-
// major layout a d = 4 head is 8 bytes of each 64-byte token row, and the
// 8 heads' blocks read the same rows from L2, which is cheap next to the
// 64 x 16 exponentials per row of a key tile; one 8-byte `cp.async` per key
// row keeps the copy simple.
//
// float32 (the motion transformer's d = 4 on every path: the JAX graph
// promotes it): `attn_packed_kernel<DMAX, R>` on the CUDA cores, exact f32
// (no TF32). Keys in tiles of 64 staged in shared memory as f32 with the
// tile's bias; each thread owns R query rows (4 at d <= 8, 2 at d = 16, 1
// above, for registers: ops/fused_attention.py::f32_rows), so every staged
// k and v value serves R rows and each thread has R independent chains;
// scores are taken 16 keys at a time so the running max rescales the
// accumulator once per 16 keys. Scores are in log2 units: q taken times
// scale * log2(e) once, each score a chain of d FMAs from the staged bias
// times log2(e), the exponent's argument one subtraction of the running
// max; the row sum stays an f32 add.
// What bounds it: per score and row, d FMAs for q.k, a max, the
// exponent's subtraction, the exponential (on the special-function
// units), the row sum and d FMAs for p.v: at d = 4, 11 f32 instructions and one exponential issue,
// plus 3 shared loads per key shared by the R rows and a rescale per 16
// keys (~13 issue slots a score at R = 4). A sub-partition issues one
// instruction a clock, so an SM issues 128 thread-instructions a clock and
// the issue slots take ~0.10 clocks a score where the exponentials take
// 1/16: the issue slots, not the special-function units, bound the f32
// half, at ~1.6 times the exponential bound.
// Neither kernel allocates anything; both run on the caller's stream, and
// only q, k, v and the bias are read and only the output written: the
// (L, K) score tile never leaves the SM, and the token-major layout is
// never copied to a head-split one or back.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // threads per block
constexpr int kKeys = 64;      // keys per shared-memory tile
constexpr int kChunk = 16;     // keys per running-max update

// DMAX is the head width rounded up to a power of two; d is the real one.
// Shared-memory columns d..DMAX-1 hold zeros, so the unrolled loops over
// DMAX add nothing for them. Each thread owns R query rows, rows
// blockIdx.x * R * kThreads + i * kThreads + threadIdx.x for i < R: every
// staged key and value serves R rows, and the R rows' scores are R
// independent chains. scale_log2 = log2(e) / sqrt(d). Scores are in log2
// units from the start: q is taken times scale_log2 once, and each score's
// dot product starts from the staged bias times log2(e) (-inf past K), so
// the exponent's argument is one subtraction of the running max. (Folding
// the scale into an FMA with the max instead would leave that FMA's exact
// product of a -1e30-biased score minus its rounding, up to 2^76, in the
// exponent of an all-masked row.)
template <int DMAX, int R>
__global__ void __launch_bounds__(kThreads)
attn_packed_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ out, int L, int K, int d, Strides st,
                   float scale_log2) {
  __shared__ __align__(16) float ks[kKeys][DMAX];
  __shared__ __align__(16) float vs[kKeys][DMAX];
  __shared__ float bs[kKeys];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * R * kThreads + threadIdx.x;
  const float* qb = q + b * st.q_batch + h * st.q_head;

  float qr[R][DMAX];
  float acc[R][DMAX];
  float m[R];  // running max, scaled to log2 units
  float l[R];  // running sum of exp2(score - m)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * kThreads;
    const float* qp = qb + static_cast<long long>(row) * st.q_row;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      qr[r][i] = (row < L && i < d) ? qp[i] * scale_log2 : 0.f;
      acc[r][i] = 0.f;
    }
    m[r] = -FLT_MAX;
    l[r] = 0.f;
  }

  const long long kv_off = b * st.kv_batch + h * st.kv_head;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;
  const float* biasb =
      bias ? bias + static_cast<long long>(b) * K : nullptr;

  for (int k0 = 0; k0 < K; k0 += kKeys) {
    const int nk = min(kKeys, K - k0);
    // rows nk..nk_pad-1 hold zeros and a -inf bias, so the last chunk needs
    // no test and reads no stale shared memory
    const int nk_pad = (nk + kChunk - 1) / kChunk * kChunk;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < nk_pad * DMAX; idx += kThreads) {
      const int j = idx / DMAX;
      const int i = idx % DMAX;
      float kx = 0.f, vx = 0.f;
      if (j < nk && i < d) {
        const long long off =
            static_cast<long long>(k0 + j) * st.kv_row + i;
        kx = kb[off];
        vx = vb[off];
      }
      ks[j][i] = kx;
      vs[j][i] = vx;
    }
    if (threadIdx.x < nk_pad) {
      const int j = threadIdx.x;
      bs[j] = j >= nk ? -INFINITY
                      : (biasb ? biasb[k0 + j] * kLog2e : 0.f);
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk_pad; j0 += kChunk) {
      float sc[R][kChunk];
      float mc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) mc[r] = -FLT_MAX;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = j0 + u;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = bs[j];
#pragma unroll
          for (int i = 0; i < DMAX; ++i) s = fmaf(qr[r][i], ks[j][i], s);
          sc[r][u] = s;
          mc[r] = fmaxf(mc[r], s);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float mn = fmaxf(m[r], mc[r]);
        const float c = ex2(m[r] - mn);  // 1 when the max did not move
        m[r] = mn;
        l[r] *= c;
#pragma unroll
        for (int i = 0; i < DMAX; ++i) acc[r][i] *= c;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = ex2(sc[r][u] - m[r]);
          l[r] += p;
#pragma unroll
          for (int i = 0; i < DMAX; ++i)
            acc[r][i] = fmaf(p, vs[j0 + u][i], acc[r][i]);
        }
      }
    }
  }

  float* ob = out + b * st.q_batch + h * st.q_head;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * kThreads;
    if (row >= L) continue;
    // all keys masked: 0, as the TPU kernel's (m > -1e29) factor gives
    // (here in log2 units)
    const bool keep =
        (biasb == nullptr) || (m[r] > -1e29f * kLog2e);
    const float inv = keep ? 1.f / l[r] : 0.f;
    float* op = ob + static_cast<long long>(row) * st.q_row;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) op[i] = acc[r][i] * inv;
    }
  }
}

// rows_per_thread: R, ops/fused_attention.py::f32_rows (4 at d <= 8, 2 at
// d <= 16, 1 above; 1, 2 and 4 are built for d <= 8)
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* bias, void* out, int B, int L, int K,
                       int H, int d, const Strides& st, float scale,
                       int rows_per_thread, cudaStream_t stream) {
  const int R = rows_per_thread;
  const dim3 grid((L + R * kThreads - 1) / (R * kThreads), H, B);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(out);
  const float sl2 = scale * kLog2e;
#define SAMT_LAUNCH(DM, RR)                                                \
  attn_packed_kernel<DM, RR><<<grid, kThreads, 0, stream>>>(               \
      qt, kt, vt, bias, ot, L, K, d, st, sl2)
#define SAMT_ROWS(DM)              \
  if (R == 1) {                    \
    SAMT_LAUNCH(DM, 1);            \
  } else if (R == 2) {             \
    SAMT_LAUNCH(DM, 2);            \
  } else if (R == 4) {             \
    SAMT_LAUNCH(DM, 4);            \
  } else {                         \
    return cudaErrorInvalidValue;  \
  }
  if (d <= 4) {
    SAMT_ROWS(4)
  } else if (d <= 8) {
    SAMT_ROWS(8)
  } else if (d <= 16) {
    if (R == 1) {
      SAMT_LAUNCH(16, 1);
    } else if (R == 2) {
      SAMT_LAUNCH(16, 2);
    } else {
      return cudaErrorInvalidValue;
    }
  } else if (R != 1) {
    return cudaErrorInvalidValue;
  } else if (d <= 32) {
    SAMT_LAUNCH(32, 1);
  } else {
    SAMT_LAUNCH(64, 1);
  }
#undef SAMT_ROWS
#undef SAMT_LAUNCH
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcKeys = 64;   // keys per pipeline stage
constexpr int kMTiles = 2;    // m16 tiles (16 query rows each) per warp
constexpr int kStages = 3;    // cp.async ring depth
// the largest block: 128 query rows (ops/fused_attention.py::tc_plan
// takes 64 or 128)
constexpr int kMaxThreads = 32 * 128 / (16 * kMTiles);

// Shared-memory geometry of the variant whose P.V width is NV n8 tiles.
// A stage holds the key tile (64 rows of KD bf16: d zero-padded to the mma
// depth), the value tile (64 rows of 8*NV bf16, zero beyond d, ones in
// column d where d < 8*NV) and the tile's 64 f32 bias values.
template <int NV>
struct TcTile {
  static constexpr int kKD = NV * 8 < 16 ? 16 : NV * 8;  // q.k depth
  static constexpr int kKC = kKD / 8;  // 16-byte chunks of a key row
  static constexpr int kKBytes = kTcKeys * kKD * 2;
  static constexpr int kVBytes = kTcKeys * NV * 16;
  static constexpr int kStageBytes = kKBytes + kVBytes + kTcKeys * 4;
  static constexpr int kSmem = kStages * kStageBytes;
};

// global -> shared copy of `bytes` (16, 8 or 4); ok false writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool ok) {
  const int n = ok ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// NV: n8 tiles of P.V (8*NV >= d); ONES: column d of the value tile holds
// ones and P.V's column d is the row sum (d < 8*NV). A warp owns MT m16
// tiles, 16*MT query rows, so that every k and v fragment it loads serves
// MT tiles and each phase has MT independent chains of work. copy_bytes:
// 16, 8 or 4 bytes per cp.async of a key row's d values, or 0 to copy them
// through registers. scale_log2 = log2(e) / sqrt(d).
template <int NV, bool ONES>
__global__ void __launch_bounds__(kMaxThreads)
attn_packed_kernel_tc(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int L, int K, int d,
                      Strides st, float scale_log2, int copy_bytes) {
  using G = TcTile<NV>;
  constexpr int MT = kMTiles;
  constexpr int KC = G::kKC;
  constexpr int KS = G::kKD / 16;    // k16 steps of q.k
  constexpr int NT = kTcKeys / 8;    // n8 tiles of S
  extern __shared__ __align__(128) uint8_t smem[];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row of a fragment (and row + 8)
  const int t = lane & 3;   // column pair of a fragment
  // rows qrow + 16*mt and qrow + 16*mt + 8 for mt < MT
  const int qrow = (blockIdx.x * (nthreads >> 5) + (tid >> 5)) * 16 * MT + g;
  const uint32_t sbase = smem_u32(smem);
  const long long kv_off = b * st.kv_batch + h * st.kv_head;
  const uint16_t* kb = reinterpret_cast<const uint16_t*>(k) + kv_off;
  const uint16_t* vb = reinterpret_cast<const uint16_t*>(v) + kv_off;
  const float* biasb = bias ? bias + static_cast<long long>(b) * K : nullptr;
  const int ntiles = (K + kTcKeys - 1) / kTcKeys;

  // every stage zeroed, then the ones column; copies write only columns
  // 0..d-1, so padding and ones stay for the whole kernel
  for (int i = tid; i < G::kSmem / 16; i += nthreads) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (ONES) {
    for (int i = tid; i < kStages * kTcKeys; i += nthreads) {
      const int r = i % kTcKeys;
      *reinterpret_cast<__nv_bfloat16*>(
          smem + (i / kTcKeys) * G::kStageBytes + G::kKBytes +
          swz<NV>(r, d >> 3) + (d & 7) * 2) = __float2bfloat16(1.f);
    }
  }
  __syncthreads();

  // key tile `tile` into stage s: k, v and the bias
  auto issue = [&](int s, int tile) {
    const int k0 = tile * kTcKeys;
    const uint32_t ks = sbase + s * G::kStageBytes;
    const uint32_t vs = ks + G::kKBytes;
    if (copy_bytes != 0) {
      const int per_row = 2 * d / copy_bytes;
      for (int i = tid; i < 2 * kTcKeys * per_row; i += nthreads) {
        const bool is_v = i >= kTcKeys * per_row;
        const int r = (i / per_row) % kTcKeys;
        const int col = (i % per_row) * (copy_bytes / 2);
        const bool ok = k0 + r < K;
        const uint16_t* src =
            (is_v ? vb : kb) +
            (ok ? static_cast<long long>(k0 + r) * st.kv_row + col : 0);
        const uint32_t off = (col & 7) * 2;
        cp_async(is_v ? vs + swz<NV>(r, col >> 3) + off
                      : ks + swz<KC>(r, col >> 3) + off,
                 src, copy_bytes, ok);
      }
    } else {
      uint8_t* kp = smem + s * G::kStageBytes;
      uint8_t* vp = kp + G::kKBytes;
      for (int i = tid; i < kTcKeys * d; i += nthreads) {
        const int r = i / d;
        const int col = i % d;
        uint16_t kx = 0, vx = 0;
        if (k0 + r < K) {
          const long long off = static_cast<long long>(k0 + r) * st.kv_row;
          kx = kb[off + col];
          vx = vb[off + col];
        }
        const uint32_t off = (col & 7) * 2;
        *reinterpret_cast<uint16_t*>(kp + swz<KC>(r, col >> 3) + off) = kx;
        *reinterpret_cast<uint16_t*>(vp + swz<NV>(r, col >> 3) + off) = vx;
      }
    }
    if (biasb) {
      const uint32_t bs = vs + G::kVBytes;
      for (int r = tid; r < kTcKeys; r += nthreads) {
        const bool ok = k0 + r < K;
        cp_async(bs + 4 * r, biasb + (ok ? k0 + r : 0), 4, ok);
      }
    }
  };

  // q fragments (A of m16n8k16): rows qrow + 16*mt (+8), columns
  // 16*kk + 2t (+1) and + 8, zero past d and past L
  uint32_t qf[MT][KS][4];
  {
    const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) +
                         b * st.q_batch + h * st.q_head;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = qrow + 16 * mt + (e & 1) * 8;
          const int col = kk * 16 + (e >> 1) * 8 + 2 * t;
          uint32_t lo = 0, hi = 0;
          if (row < L) {
            const uint16_t* p = qb + static_cast<long long>(row) * st.q_row;
            if (col < d) lo = p[col];
            if (col + 1 < d) hi = p[col + 1];
          }
          qf[mt][kk][e] = lo | (hi << 16);
        }
      }
    }
  }

  // per m16 tile and its rows g, g + 8: running max and this thread's
  // share of the row sum (unused with ONES)
  float m[MT][2], l[MT][2];
  float acc[MT][NV][4];  // P.V, f32
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -FLT_MAX;
      l[mt][r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }

  // ldmatrix lane roles for k (keys x depth): lanes 0-7 keys 0-7 of the
  // first 8 depth values, 8-15 the same keys' next 8, 16-31 keys 8-15
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_half = (lane >> 3) & 1;

  auto compute = [&](int s, int tile) {
    const uint32_t ks = sbase + s * G::kStageBytes;
    const uint32_t vs = ks + G::kKBytes;
    const float* bsp = reinterpret_cast<const float*>(
        smem + s * G::kStageBytes + G::kKBytes + G::kVBytes);
    const int k0 = tile * kTcKeys;

    // S = q k^T: 16 rows x 64 keys per m16 tile, each k fragment loaded
    // once for all MT tiles
    float sc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + swz<KC>(16 * jp + k_row, 2 * kk + k_half));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sc[mt][2 * jp], qf[mt][kk], r[0], r[1]);
          mma_bf16(sc[mt][2 * jp + 1], qf[mt][kk], r[2], r[3]);
        }
      }
    }

    // scores in log2 units: s * scale * log2(e) + bias * log2(e); keys
    // past K get -inf
    float mx[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mx[mt][0] = mx[mt][1] = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * j + 2 * t + e;
        float bl = biasb ? bsp[key] * kLog2e : 0.f;
        if (k0 + key >= K) bl = -INFINITY;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          sc[mt][j][e] = fmaf(sc[mt][j][e], scale_log2, bl);
          sc[mt][j][e + 2] = fmaf(sc[mt][j][e + 2], scale_log2, bl);
          mx[mt][0] = fmaxf(mx[mt][0], sc[mt][j][e]);
          mx[mt][1] = fmaxf(mx[mt][1], sc[mt][j][e + 2]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = mx[mt][r];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float mnew = fmaxf(m[mt][r], x);
        const float c = ex2(m[mt][r] - mnew);  // 1 when the max held
        m[mt][r] = mnew;
        l[mt][r] *= c;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          acc[mt][n][2 * r] *= c;
          acc[mt][n][2 * r + 1] *= c;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[mt][j][e] = ex2(sc[mt][j][e] - m[mt][e >> 1]);
          if (!ONES) l[mt][e >> 1] += sc[mt][j][e];
        }
      }
    }

    // O += P V, P as hi + lo; the S fragments of keys 16kk..16kk+15 are
    // the A fragment of that k16 step, and each v fragment serves all MT
    // tiles
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_bf16(sc[mt][2 * kk][0], sc[mt][2 * kk][1], ah[mt][0],
                   al[mt][0]);
        split_bf16(sc[mt][2 * kk][2], sc[mt][2 * kk][3], ah[mt][1],
                   al[mt][1]);
        split_bf16(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1], ah[mt][2],
                   al[mt][2]);
        split_bf16(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3], ah[mt][3],
                   al[mt][3]);
      }
      if constexpr (NV == 1) {
        uint32_t r[2];
        ldmatrix_x2_trans(r, vs + swz<1>(16 * kk + (lane & 15), 0));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][0], ah[mt], r[0], r[1]);
          mma_bf16(acc[mt][0], al[mt], r[0], r[1]);
        }
      } else {
#pragma unroll
        for (int np = 0; np < NV / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(
              r, vs + swz<NV>(16 * kk + (lane & 15), 2 * np + (lane >> 4)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * np], ah[mt], r[0], r[1]);
            mma_bf16(acc[mt][2 * np + 1], ah[mt], r[2], r[3]);
            mma_bf16(acc[mt][2 * np], al[mt], r[0], r[1]);
            mma_bf16(acc[mt][2 * np + 1], al[mt], r[2], r[3]);
          }
        }
      }
    }
  };

  // prologue: tiles 0 .. kStages-2
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) issue(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile it's copies have landed
    __syncthreads();  // ... for every thread; stage (it-1)%S is free
    const int next = it + kStages - 1;
    if (next < ntiles) issue(next % kStages, next);
    cp_async_commit();
    compute(it % kStages, it);
  }
  cp_async_wait<0>();

  __nv_bfloat16* ob = out + b * st.q_batch + h * st.q_head;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // row sums: P.V's column d, held by the quad's thread t = (d % 8) / 2,
    // or the sum of the quad's f32 partial sums
    float den[2];
    if constexpr (ONES) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool here = 8 * n + 2 * t + e == d;
          s0 += here ? acc[mt][n][e] : 0.f;
          s1 += here ? acc[mt][n][e + 2] : 0.f;
        }
      }
      const int src = (lane & ~3) | ((d & 7) >> 1);
      den[0] = __shfl_sync(0xffffffffu, s0, src);
      den[1] = __shfl_sync(0xffffffffu, s1, src);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = l[mt][r];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        den[r] = x;
      }
    }

    // out: one rounding to bf16; all keys masked gives 0, as the TPU
    // kernel's (m > -1e29) factor (here in log2 units)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 16 * mt + 8 * r;
      if (row >= L) continue;
      const bool keep = (biasb == nullptr) || (m[mt][r] > -1e29f * kLog2e);
      const float inv = keep ? 1.f / den[r] : 0.f;
      __nv_bfloat16* op = ob + static_cast<long long>(row) * st.q_row;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int col = 8 * n + 2 * t;
        const float o0 = keep ? acc[mt][n][2 * r] * inv : 0.f;
        const float o1 = keep ? acc[mt][n][2 * r + 1] * inv : 0.f;
        if (col + 1 < d && (d & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(op + col) =
              __floats2bfloat162_rn(o0, o1);
        } else {
          if (col < d) op[col] = __float2bfloat16(o0);
          if (col + 1 < d) op[col + 1] = __float2bfloat16(o1);
        }
      }
    }
  }
}

template <int NV, bool ONES>
cudaError_t launch_tc_variant(const void* q, const void* k, const void* v,
                              const float* bias, void* out, int B, int L,
                              int K, int H, int d, const Strides& st,
                              float scale, int rows, int copy_bytes,
                              cudaStream_t stream) {
  auto kernel = attn_packed_kernel_tc<NV, ONES>;
  const int smem = TcTile<NV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + rows - 1) / rows, H, B);
  kernel<<<grid, 32 * rows / (16 * kMTiles), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias,
      static_cast<__nv_bfloat16*>(out), L, K, d, st, scale * kLog2e,
      copy_bytes);
  return cudaGetLastError();
}

// nv, rows, copy_bytes: the variant ops/fused_attention.py::tc_plan chose
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* bias, void* out, int B, int L, int K,
                      int H, int d, const Strides& st, float scale, int nv,
                      int rows, int copy_bytes, cudaStream_t stream) {
  const bool copy_ok =
      copy_bytes == 0 ||
      ((copy_bytes == 4 || copy_bytes == 8 || copy_bytes == 16) &&
       (2 * d) % copy_bytes == 0 &&
       reinterpret_cast<uintptr_t>(k) % copy_bytes == 0 &&
       reinterpret_cast<uintptr_t>(v) % copy_bytes == 0 &&
       (2 * st.kv_row) % copy_bytes == 0 &&
       (2 * st.kv_head) % copy_bytes == 0 &&
       (2 * st.kv_batch) % copy_bytes == 0);
  if (d > 8 * nv || (rows != 64 && rows != 128) || !copy_ok) {
    return cudaErrorInvalidValue;
  }
  const bool ones = d < 8 * nv;
#define SAMT_TC(NV)                                                        \
  return ones ? launch_tc_variant<NV, true>(q, k, v, bias, out, B, L, K, H, \
                                            d, st, scale, rows, copy_bytes, \
                                            stream)                         \
              : launch_tc_variant<NV, false>(q, k, v, bias, out, B, L, K,   \
                                             H, d, st, scale, rows,         \
                                             copy_bytes, stream)
  switch (nv) {
    case 1:
      SAMT_TC(1);
    case 2:
      SAMT_TC(2);
    case 4:
      SAMT_TC(4);
    case 8:
      SAMT_TC(8);
    default:
      return cudaErrorInvalidValue;
  }
#undef SAMT_TC
}

// Both layouts' entries: checks the sizes, then launches in dtype 0
// (float32, CUDA cores; d = 1..64, d = 1 zero-padded to 4) or 1 (bfloat16,
// tensor cores; d = 2..64).
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* bias, void* out, int B, int L, int K, int H,
                     int d, const Strides& st, float scale, int dtype, int nv,
                     int rows, int copy_bytes, void* stream) {
  if (d < (dtype == 0 ? 1 : 2) || d > 64 || B <= 0 || L <= 0 || K <= 0 ||
      H <= 0 || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_f32(q, k, v, b, out, B, L, K, H, d, st, scale, rows, s);
  }
  if (dtype == 1) {
    return launch_tc(q, k, v, b, out, B, L, K, H, d, st, scale, nv, rows,
                     copy_bytes, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entries, bound with ctypes. dtype: 0 = float32, 1 = bfloat16 (q, k, v
// and out share it; bias is float32 or null). nv, rows and copy_bytes pick
// the bfloat16 kernel's variant (ops/fused_attention.py::tc_plan): P.V
// width 8*nv >= d, query rows per block (64 or 128), bytes per cp.async of
// a key row (16, 8, 4, or 0 for copies through registers); float32 takes
// rows as its query rows per thread (1, 2 or 4) and ignores the others.
// Each returns the CUDA error of the launch (0 on success); the caller
// checks shapes before calling.

// Token-major (kernel K1): q, out (B, L, E); k, v (B, K, E) with
// kv_batch_stride K*E, or a shared (K, E) with kv_batch_stride 0.
extern "C" int samt_fused_attention_packed(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int L, int K, int E, int H, long long kv_batch_stride, float scale,
    int dtype, int nv, int rows, int copy_bytes, void* stream) {
  if (H <= 0 || E % H != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int d = E / H;
  const Strides st{static_cast<long long>(L) * E, E, d,
                   kv_batch_stride, E, d};
  return static_cast<int>(dispatch(q, k, v, bias, out, B, L, K, H, d, st,
                                   scale, dtype, nv, rows, copy_bytes,
                                   stream));
}

// Head-split (kernel K2): q, out (B, H, L, d); k, v (B, H, K, d), or a
// shared (1, H, K, d) when kv_shared is 1.
extern "C" int samt_fused_attention_split(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int H, int L, int K, int d, int kv_shared, float scale, int dtype,
    int nv, int rows, int copy_bytes, void* stream) {
  const long long kv_head = static_cast<long long>(K) * d;
  const Strides st{H * static_cast<long long>(L) * d, d,
                   static_cast<long long>(L) * d,
                   kv_shared ? 0 : H * kv_head, d, kv_head};
  return static_cast<int>(dispatch(q, k, v, bias, out, B, L, K, H, d, st,
                                   scale, dtype, nv, rows, copy_bytes,
                                   stream));
}
