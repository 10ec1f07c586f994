// Softmax attention on Hopper's warpgroup tensor cores (sm_90a): bfloat16
// at head widths d = 16, 32 and 64, in both layouts of
// csrc/fused_attention_packed.cu.
//
// Replaces, for those widths, the same two TPU kernels as
// fused_attention_packed.cu (synergize_motion_appearance_tpu/ops/
// fused_attention.py: `_attn_kernel_packed` at :227, kernel K1 of the port,
// token-major; `_attn_kernel` at :56, kernel K2, head-split), and computes
// their function as that file's bf16 kernel does: scores as a bf16 x bf16
// product accumulated in f32, times 1/sqrt(d), plus the optional (B, K) f32
// bias where -1e30 masks a key; an f32 max-subtracted softmax; p.v with f32
// weights (p as bf16 hi + lo, the TPU kernel's note at :31-35 records that a
// bf16 p was rejected there); 0 for a row whose every key is masked; the
// output in q's dtype and layout, rounded once. The layouts differ only in
// the tensor maps and coordinates the entry builds (`Coords`). The mma.sync
// kernel of fused_attention_packed.cu keeps the other widths up to 64 (d <=
// 8, or d not 16, 32 or 64): a TMA box row must hold at least 16 bytes and
// wgmma's depth is 16; fused_attention_wgmma128.cu d = 128 and
// fused_attention_wgmma256.cu d = 256, with the helpers of
// attention_wgmma.cuh that this file shares; fused_attention_chunked.cu the
// rest (d = 1, d > 64 but 128 and 256). ops/fused_attention.py::plan picks
// between them by shape.
//
// What bounds it: per score one exponential on the special-function units
// (16 per SM per clock, the floor), about seven f32-pipe instructions (the
// running max, the exponent's FMA, the row sum, the split of p into hi and
// lo; with a bias one more, its FMA with the scale) and, at d = 32, 64
// tensor-core multiply-adds for q.k and 128 for p.v (hi and lo). Per SM
// sub-partition an exponential takes 1/4 clock a lane and an instruction
// issue 1/32, so the exponentials and the issue slots bound it about
// equally, and the tensor cores sit near 3/4 of that: the design's work is
// to keep the three busy at once, which the number of warpgroups resident
// on an SM decides.
//
// The design:
// - A block is one (tile of 64 query rows, head, batch row): one consumer
//   warpgroup and one producer warp (160 threads), split on a warp-uniform
//   index. Three blocks share an SM (106-128 registers a thread), so three
//   warpgroups' softmaxes and products interleave.
// - Copies by TMA (`cp.async.bulk.tensor.3d`), issued by one lane of the
//   producer warp: the query tile once, then key and value tiles of 64 keys
//   into a ring of 3 stages, each with a full and an empty `mbarrier`. The
//   tensor maps (`cuTensorMapEncodeTiled`, reached through
//   `cudaGetDriverEntryPoint`, so no -lcuda) are kernel parameters
//   (`__grid_constant__`). A shared (K, E) codebook is a map whose batch
//   extent is 1, read at coordinate 0: never broadcast in memory. A row of
//   a head is 2d bytes (32, 64, 128), and the maps swizzle it by that width,
//   the wgmma descriptors' layout type. TMA zero-fills rows past L and K.
// - The producer warp also stages each tile's bias times log2(e), -inf for
//   keys past K (a zero key would score 0 and enter the softmax); without a
//   bias the consumers set keys past K to -inf themselves, on the last tile.
// - S = q.k^T: `wgmma.mma_async` m64n64k16, q and k both read from shared
//   memory (K-major). Softmax in registers: the scale times log2(e) folded
//   into one FMA with the bias (with no bias, into the exponent's FMA with
//   the running max), `ex2.approx`, a running max per row from -FLT_MAX
//   (the first tile's rescale is exp2(-FLT_MAX - m) = 0, never exp2(nan))
//   reduced over the quad of threads that holds the row, the row sum in f32.
// - O += p.v: wgmma m64n{d}k16 with A = p from registers, split as hi =
//   bf16(p) and lo = bf16(p - hi) into one f32 accumulator. The S
//   accumulator's layout is the A fragment's (FlashAttention-2's identity),
//   so p never passes through shared memory. v is the B operand in MN-major
//   with the transpose bit.
// - Overlap: within the warpgroup, tile j + 1's q.k is issued with tile j's
//   p.v, and its softmax runs while that p.v is on the tensor cores; across
//   the SM, the other blocks' warpgroups fill the gaps.
// Measured on an H100 SXM (700 W) at the appearance transformer's 16
// calls of a frame batch, against this layout's 1.15 ms: 128-key tiles
// made ptxas serialize every wgmma (the S, p and O registers of two tiles
// do not fit), 1.69 ms; two consumer warpgroups a block taking turns by
// named barriers, with `setmaxnreg` moving a producer warpgroup's registers
// to them, 1.37-1.48 ms (ptxas allocated the consumers within the launch
// bound's 168 or 128 registers, and the turns added waits without adding
// warpgroups to an SM); four blocks an SM, 1.47 ms (too few registers:
// serialized).
// The kernel allocates nothing and runs on the caller's stream; the (L, K)
// scores never leave the SM. A wait on an mbarrier that outlasts ~2^26
// polls traps, so a fault in the pipeline fails the launch instead of
// hanging the card.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_wgmma.cuh"

namespace {

constexpr int kKeys = 64;     // keys per stage: the n of q.k's wgmma
constexpr int kRows = 64;     // query rows per block: one warpgroup's m
constexpr int kThreads = 160;  // the consumer warpgroup, the producer warp

// Shared memory of a block, from a base aligned to 1024 bytes (the largest
// swizzle's period): the query tile, the stages (k tile, then v tile), the
// stages' bias, the barriers. A tile is one TMA box whose rows (at most 128
// bytes: the widest swizzle) lie kRowBytes apart.
template <int D>
struct Geometry {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kKeys * kRowBytes;
  static constexpr int kStages = 3;  // depth of the k/v ring
  static constexpr int kBlocks = 3;  // blocks an SM
  static constexpr int kStage0 = kQBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBias = kStage0 + kStages * kStageBytes;
  static constexpr int kBars = kBias + kStages * kKeys * 4;
  static constexpr int kSmem = kBars + (2 * kStages + 1) * 8 + 1024;
  // wgmma descriptor: swizzle of 32, 64 or 128 bytes (the box row) is
  // layout type 3, 2 or 1; 8 rows of one core-matrix group lie kRowBytes
  // apart
  static constexpr int kLayout = D == 16 ? 3 : D == 32 ? 2 : 1;
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;
};

// o (64 x D) += a (64 x 16) * v (16 x D), v's descriptor b
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 16) {
    wgmma_rs_n16(o, a, b);
  } else if constexpr (D == 32) {
    wgmma_rs_n32(o, a, b);
  } else {
    wgmma_rs_n64(o, a, b);
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// D: head width (16, 32, 64); BIAS: a (B, K) bias is given.
// scale_log2 = log2(e) / sqrt(d).
template <int D, bool BIAS>
__global__ void __launch_bounds__(kThreads, Geometry<D>::kBlocks)
attn_packed_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int L, int K,
                         Coords co, float scale_log2) {
  using G = Geometry<D>;
  constexpr int kStages = G::kStages;
  constexpr int KS = D / 16;      // k16 steps of q.k
  constexpr int NS = kKeys / 16;  // k16 steps of p.v
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t full0 = base + G::kBars;  // full barrier of stage s: +8s
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t qbar = empty0 + 8 * kStages;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int ntiles = (K + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty0 + 8 * s, 1);  // one consumer thread
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The roles split by warp, on a warp index read from lane 0 so that
  // ptxas sees the branch warp-uniform: on threadIdx.x itself it
  // serialized the bias instantiations' wgmmas (its note C7520, "WG.AR in
  // divergent path").
  if (__shfl_sync(0xffffffffu, threadIdx.x / 32, 0) >= 4) {
    // ---- producer warp: lane 0 issues the copies, all lanes the bias ----
    const int lane = threadIdx.x % 32;
    const int kv_col = h * co.kv_col_h;
    const int kv_z = b * co.kv_z_b + h * co.kv_z_h;
    if (lane == 0) {
      mbar_expect(qbar, G::kQBytes);
      tma_load(base, &qmap, qbar, h * co.q_col_h, q0,
               b * co.q_z_b + h * co.q_z_h);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
      if constexpr (BIAS) {
        float* bs =
            reinterpret_cast<float*>(smem + G::kBias + s * kKeys * 4);
        const float* bb = bias + static_cast<long long>(b) * K;
#pragma unroll
        for (int c = lane; c < kKeys; c += 32) {
          const int key = t * kKeys + c;
          const float x = __ldg(bb + min(key, K - 1));  // no branch
          bs[c] = key < K ? x * kLog2e : -INFINITY;
        }
      }
      if (lane == 0) {
        mbar_expect(full0 + 8 * s, 2 * G::kTileBytes);
        const uint32_t ks = base + G::kStage0 + s * G::kStageBytes;
        tma_load(ks, &kmap, full0 + 8 * s, kv_col, t * kKeys, kv_z);
        tma_load(ks + G::kTileBytes, &vmap, full0 + 8 * s, kv_col,
                 t * kKeys, kv_z);
      } else {
        mbar_arrive(full0 + 8 * s);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: query rows q0 .. q0 + 63 ----
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row (and row + 8) within the warp
  const int t4 = lane % 4;  // fragment column pair
  const uint64_t dq = make_desc(base, G::kGroupBytes, G::kLayout);

  float s[kKeys / 2];             // S (then p) of this thread: rows g, g + 8
  float o[D / 2];                 // O, f32
  uint32_t ph[NS][4], pl[NS][4];  // p's A fragments, bf16 hi and lo
  float m[2] = {-FLT_MAX, -FLT_MAX};  // running max (log2 units) per row
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  float c[2] = {1.f, 1.f};  // rescale of O owed by the last softmax
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;  // (q.k overwrites it)

  auto issue_s = [&](int st) {
    const uint64_t dk = make_desc(base + G::kStage0 + st * G::kStageBytes,
                                  G::kGroupBytes, G::kLayout);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // the next 16 of d: 32 bytes further along each swizzled row
      wgmma_ss_n64(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    }
  };
  auto issue_pv = [&](int st) {
    const uint64_t dv = make_desc(
        base + G::kStage0 + st * G::kStageBytes + G::kTileBytes,
        G::kGroupBytes, G::kLayout);
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      // keys 16 kk .. 16 kk + 15: 16 rows further
      const uint64_t dvk = dv + kk * (16 * G::kRowBytes >> 4);
      wgmma_pv<D>(o, ph[kk], dvk);
      wgmma_pv<D>(o, pl[kk], dvk);
    }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= c[(i >> 1) & 1];
  };
  // scores of key tile `tile` (in stage st) -> p, in place; running max,
  // row sums and the rescale c owed by O
  auto softmax = [&](int tile, int st) {
    float mx[2] = {-FLT_MAX, -FLT_MAX};
    if constexpr (BIAS) {
      const float* bs =
          reinterpret_cast<const float*>(smem + G::kBias + st * kKeys * 4);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const float2 bl =
            *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] =
              fmaf(s[4 * j + e], scale_log2, (e & 1) ? bl.y : bl.x);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
        }
      }
    } else {
      const int past = K - tile * kKeys;  // this key on is masked
      if (past < kKeys) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t4 + (e & 1) >= past) s[4 * j + e] = -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      mx[0] *= scale_log2;
      mx[1] *= scale_log2;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = mx[r];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float mn = fmaxf(m[r], x);
      c[r] = ex2(m[r] - mn);  // 1 when the max held
      m[r] = mn;
      l[r] *= c[r];
    }
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = BIAS ? ex2(s[i] - m[r])
                           : ex2(fmaf(s[i], scale_log2, -m[r]));
      l[r] += p;
      s[i] = p;
    }
  };
  // p -> A fragments: keys 16 kk .. 16 kk + 15 are S's n8 tiles 2 kk and
  // 2 kk + 1, rows g and g + 8
  auto split = [&]() {
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], ph[kk][e],
                   pl[kk][e]);
  };

  mbar_wait(qbar, 0);
  // tile 0: q.k, softmax
  mbar_wait(full0, 0);
  wg_fence();
  issue_s(0);
  wg_commit();
  wg_wait<0>();
  hold(s);
  softmax(0, 0);
  split();
  // tile t: q.k of t with p.v of t - 1, then t's softmax under that p.v
  for (int t = 1; t < ntiles; ++t) {
    const int st = t % kStages;
    const int prev = (t - 1) % kStages;
    mbar_wait(full0 + 8 * st, (t / kStages) & 1);
    rescale_o();
    wg_fence();
    issue_s(st);
    wg_commit();
    issue_pv(prev);
    wg_commit();
    wg_wait<1>();
    hold(s);
    softmax(t, st);
    wg_wait<0>();
    hold(o);
    hold(ph);
    hold(pl);
    // stage prev is read: its q.k and p.v are done, and so are all four
    // warps' softmax reads of its bias (each issued that p.v after them)
    if (tid == 0) mbar_arrive(empty0 + 8 * prev);
    split();
  }
  // the last tile's p.v
  rescale_o();
  wg_fence();
  issue_pv((ntiles - 1) % kStages);
  wg_commit();
  wg_wait<0>();
  hold(o);
  hold(ph);
  hold(pl);

  // out: O / row sum, rounded once to bf16; a row whose every key is masked
  // gives 0, as the TPU kernel's (m > -1e29) factor (here in log2 units);
  // rows past L are not stored
  __nv_bfloat16* ob = out + b * co.o_batch + h * co.o_head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= L) continue;
    const bool keep = !BIAS || m[r] > -1e29f * kLog2e;
    const float inv = keep ? 1.f / den : 0.f;
    __nv_bfloat16* op = ob + static_cast<long long>(row) * co.o_row;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int D, bool BIAS>
cudaError_t launch_variant(const CUtensorMap& qm, const CUtensorMap& km,
                           const CUtensorMap& vm, const float* bias,
                           void* out, int B, int H, int L, int K,
                           const Coords& co, float scale_log2,
                           cudaStream_t stream) {
  auto kernel = attn_packed_kernel_wgmma<D, BIAS>;
  constexpr int smem = Geometry<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      qm, km, vm, bias, static_cast<__nv_bfloat16*>(out), L, K, co,
      scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_width(const CUtensorMap& qm, const CUtensorMap& km,
                         const CUtensorMap& vm, const float* bias, void* out,
                         int B, int H, int L, int K, const Coords& co,
                         float scale_log2, cudaStream_t stream) {
  return bias ? launch_variant<D, true>(qm, km, vm, bias, out, B, H, L, K,
                                        co, scale_log2, stream)
              : launch_variant<D, false>(qm, km, vm, bias, out, B, H, L, K,
                                         co, scale_log2, stream);
}

}  // namespace

// C entry, bound with ctypes: bfloat16 q, k, v and out, optional float32
// (B, K) bias (null for none), d in {16, 32, 64}, q, k, v and out 16-byte
// aligned. layout 0, token-major (kernel K1): q, out (B, L, H*d);
// k, v (B, K, H*d), or a shared (K, H*d) when kv_shared is 1. layout 1,
// head-split (kernel K2): q, out (B, H, L, d); k, v (B, H, K, d), or a
// shared (1, H, K, d). Returns the CUDA error of the launch (0 on success),
// cudaErrorInvalidValue for what the kernel does not take or a tensor map
// that cannot be encoded.
extern "C" int samt_attention_wgmma(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, int B, int H, int L, int K,
                                    int d, int layout, int kv_shared,
                                    float scale, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if ((d != 16 && d != 32 && d != 64) ||
      (layout != 0 && layout != 1) ||
      B <= 0 || H <= 0 || L <= 0 || K <= 0 ||
      B > 65535 || H > 65535 || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap qm, km, vm;
  Coords co;
  const bool ok = layout_maps(q, k, v, B, H, L, K, d, layout, kv_shared,
                              kRows, kKeys, &qm, &km, &vm, &co);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* bb = static_cast<const float*>(bias);
  const float sl2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 16:
      err = launch_width<16>(qm, km, vm, bb, out, B, H, L, K, co, sl2, s);
      break;
    case 32:
      err = launch_width<32>(qm, km, vm, bb, out, B, H, L, K, co, sl2, s);
      break;
    default:
      err = launch_width<64>(qm, km, vm, bb, out, B, H, L, K, co, sl2, s);
  }
  return static_cast<int>(err);
}
