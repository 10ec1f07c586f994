// Softmax attention on Hopper's warpgroup tensor cores (sm_90a): bfloat16
// at head width d = 256 (the appearance transformer at n_head 1), in both
// layouts of csrc/fused_attention_wgmma.cu.
//
// Replaces, at that width, the same two TPU kernels as
// fused_attention_wgmma.cu (synergize_motion_appearance_tpu/ops/
// fused_attention.py: `_attn_kernel_packed` at :227, kernel K1 of the port,
// token-major; `_attn_kernel` at :56, kernel K2, head-split), and computes
// their function as that file's kernel does: scores as a bf16 x bf16
// product accumulated in f32, times 1/sqrt(d), plus the optional (B, K) f32
// bias where -1e30 masks a key; an f32 max-subtracted online softmax in
// log2 units; p.v with p split into bf16 hi + lo; 0 for a row whose every
// key is masked; the output rounded once to bf16. A shared (K, E) codebook
// is a tensor map whose batch extent is 1, read at plane 0: never broadcast
// in memory. ops/fused_attention.py::plan sends bf16 d = 256 here where q,
// k, v and out are 16-byte aligned; fused_attention_chunked.cu keeps d = 256
// at other pointers and in float32.
//
// What bounds it: the tensor cores and shared memory, about equally. Per
// score q.k takes 256 multiply-adds and p.v 2 x 256 (hi and lo) against one
// exponential: at 2048 bf16 multiply-adds and 16 exponentials per SM per
// clock, 0.375 clocks a score against 0.0625. A 64-row x 64-key tile of one
// warpgroup takes 1536 clocks of products, and moves 192 KiB through shared
// memory: q.k re-reads the 32 KiB q tile and the 32 KiB k tile once each,
// p.v reads the 32 KiB v tile twice (hi and lo), TMA writes 64 KiB of k and
// v; at the SM's 128 bytes a clock that is 1536 clocks too. Registers bind
// the shape: O, 64 rows x 256 columns in f32, is 128 registers a thread of
// a warpgroup before S, p and the row state.
//
// The design: one block computes all 256 output columns of its query rows,
// so q.k runs once and each exponential once (the d-chunked kernel it
// replaces ran both in each of a head's four 64-column blocks).
// - A tile is four 64-column TMA boxes (a 512-byte head row, past the
//   128-byte swizzle); q.k runs its 16 k16 steps across the four, p.v is
//   four n64 wgmmas a k16 step, one into each quarter of O (hi and lo
//   each), with p from registers (the S accumulator's layout is the A
//   fragment's).
// - A warpgroup issues tile t's q.k, rescales O under it, issues tile
//   t - 1's p.v, and runs t's softmax while that p.v is on the tensor
//   cores.
// - One producer warp issues the copies by TMA into a 3-stage mbarrier
//   ring of 64-key K+V tiles and stages each tile's bias times log2(e)
//   (-inf past K); one consumer warpgroup of 64 query rows; 225.8 KiB of
//   shared memory, one block an SM, 218 registers a thread (237 with a
//   bias), no spill.
// - Other blocks were built and timed against this one on the card
//   (PERF.md section 6 has the times), each as a share of this one's time
//   over a frame batch: two stages 1.25x; 32-key stages at two blocks an
//   SM 2.32x, and two consumer warpgroups of 64 rows each 1.26x, both held
//   by ptxas to 168 registers, where they spill; k and v in rings of their
//   own refilled by thread 0, with no producer warp, at one consumer
//   warpgroup 1.42x, at two 1.02x (faster at K = 256 and 512, slower at
//   1024).
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

constexpr int kD = 256;
constexpr int kParts = 4;         // 64-column boxes of a head row
constexpr int kCols = kD / kParts;
constexpr int kRowBytes = 2 * kCols;  // a box row: the 128-byte swizzle
constexpr int kRows = 64;         // query rows of the consumer warpgroup
constexpr int kKeys = 64;         // keys a tile
static_assert(kKeys == 64, "tile_softmax and tile_split take 64-key tiles");
constexpr int kStages = 3;        // K+V stages of the ring
constexpr int kThreads = 160;     // the consumer warpgroup, the producer warp
constexpr int kQPart = kRows * kRowBytes;  // the query tile's rows of a part
constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8-row core-matrix groups

// Shared memory of a block, from a base aligned to 1024 bytes (the
// swizzle's period): the query tile (four 64-row parts), the stages (k
// tile, then v tile, each four 64-key parts), the stages' bias, the
// barriers (full and empty of each stage, then q's).
constexpr int kQBytes = kParts * kQPart;
constexpr int kTilePart = kKeys * kRowBytes;
constexpr int kTileBytes = kParts * kTilePart;
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kBias = kQBytes + kStages * kStageBytes;
constexpr int kBars = kBias + kStages * kKeys * 4;
constexpr int kSmem = kBars + (2 * kStages + 1) * 8 + 1024;
static_assert(kSmem <= 232448, "shared memory of a block");

// quarter p of O (columns 64p .. 64p + 63)
__device__ __forceinline__ float (&quarter(float (&o)[kD / 2], int p))[32] {
  return *reinterpret_cast<float(*)[32]>(&o[32 * p]);
}

// The consumer warpgroup's 64 query rows: S (then p), O in four quarters,
// p's A fragments, the running max (log2 units), this thread's share of
// each row's sum and the rescale O owes. A thread holds rows g and g + 8
// of its warp's 16 (g = lane / 4), columns 2 (lane % 4) and + 1 of each n8
// tile.
template <bool BIAS>
struct Rows {
  static constexpr int NS = kKeys / 16;  // k16 steps of p.v
  float s[kKeys / 2];
  float o[kD / 2];
  uint32_t ph[NS][4], pl[NS][4];  // p as bf16 hi and lo
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};
  float c[2] = {1.f, 1.f};

  __device__ __forceinline__ Rows() {
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;  // (q.k overwrites it)
  }
  // issues S = q.k^T: 16 k16 steps across the four parts, each 32 bytes
  // further along the swizzled rows; dq and dk at part 0, parts kQPart and
  // kTilePart bytes apart
  __device__ __forceinline__ void qk(uint64_t dq, uint64_t dk) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int p = kk / 4, step = 2 * (kk % 4);
      wgmma_ss_n64(s, dq + p * (kQPart >> 4) + step,
                   dk + p * (kTilePart >> 4) + step, kk > 0);
    }
  }
  // issues O += p.v: keys 16 kk .. 16 kk + 15 are 16 rows further, quarter
  // p one part further; successive wgmmas go to different quarters
  __device__ __forceinline__ void pv(uint64_t dv) {
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const uint64_t dvk = dv + kk * (16 * kRowBytes >> 4);
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        wgmma_rs_n64(quarter(o, p), ph[kk], dvk + p * (kTilePart >> 4));
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        wgmma_rs_n64(quarter(o, p), pl[kk], dvk + p * (kTilePart >> 4));
    }
  }
  __device__ __forceinline__ void hold_all() {
    hold(o);
    hold(ph);
    hold(pl);
  }
  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] *= c[(i >> 1) & 1];
  }
  // out: O / row sum, rounded once to bf16; a row whose every key is masked
  // gives 0, as the TPU kernel's (m > -1e29) factor (here in log2 units);
  // rows past L are not stored. row0: this thread's row g.
  __device__ __forceinline__ void store(__nv_bfloat16* ob, long long o_row,
                                        int row0, int L, int t4) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float den = l[r];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      const int row = row0 + 8 * r;
      if (row >= L) continue;
      const bool keep = !BIAS || m[r] > -1e29f * kLog2e;
      const float inv = keep ? 1.f / den : 0.f;
      __nv_bfloat16* op = ob + static_cast<long long>(row) * o_row;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
};

// scale_log2 = log2(e) / sqrt(d). Block (tile of 64 query rows, head,
// batch row).
template <bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
attn_packed_kernel_wgmma256(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out, int L, int K,
                            Coords co, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t full0 = base + kBars;  // full barrier of stage s: +8s
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t qbar = empty0 + 8 * kStages;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int ntiles = (K + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty0 + 8 * s, 1);  // one thread of the consumers
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // roles by warpgroup and warp indices read from lane 0, so that ptxas
  // sees the branch warp-uniform (on threadIdx.x it serializes wgmma: C7520)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0) % 4;
  const int lane = threadIdx.x % 32;
  if (wg == 1) {
    // ---- producer warp: lane 0 issues the copies, all lanes the bias ----
    const int kv_col = h * co.kv_col_h;
    const int kv_z = b * co.kv_z_b + h * co.kv_z_h;
    if (lane == 0) {
      mbar_expect(qbar, kQBytes);
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        tma_load(base + p * kQPart, &qmap, qbar, h * co.q_col_h + p * kCols,
                 q0, b * co.q_z_b + h * co.q_z_h);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
      if constexpr (BIAS) {
        float* bs = reinterpret_cast<float*>(smem + kBias + s * kKeys * 4);
        const float* bb = bias + static_cast<long long>(b) * K;
#pragma unroll
        for (int c = lane; c < kKeys; c += 32) {
          const int key = t * kKeys + c;
          const float x = __ldg(bb + min(key, K - 1));  // no branch
          bs[c] = key < K ? x * kLog2e : -INFINITY;
        }
      }
      if (lane == 0) {
        mbar_expect(full0 + 8 * s, 2 * kTileBytes);
        const uint32_t ks = base + kQBytes + s * kStageBytes;
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
          tma_load(ks + p * kTilePart, &kmap, full0 + 8 * s,
                   kv_col + p * kCols, t * kKeys, kv_z);
          tma_load(ks + kTileBytes + p * kTilePart, &vmap, full0 + 8 * s,
                   kv_col + p * kCols, t * kKeys, kv_z);
        }
      } else {
        mbar_arrive(full0 + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroup: query rows q0 .. q0 + 63 ----
  const int t4 = lane % 4;
  const uint64_t dq = make_desc(base, kGroupBytes, 1);
  const auto dk = [&](int st) {
    return make_desc(base + kQBytes + st * kStageBytes, kGroupBytes, 1);
  };
  const auto dv = [&](int st) {
    return make_desc(base + kQBytes + st * kStageBytes + kTileBytes,
                     kGroupBytes, 1);
  };
  Rows<BIAS> x;
  // tile t's softmax, its bias from stage st
  const auto softmax = [&](int t, int st) {
    const float* bs =
        reinterpret_cast<const float*>(smem + kBias + st * kKeys * 4);
    tile_softmax<BIAS>(
        x.s, x.m, x.l, x.c,
        [&](int j) {
          return *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t4);
        },
        K - t * kKeys, t4, scale_log2);
  };

  mbar_wait(qbar, 0);
  // tile 0: q.k, softmax
  mbar_wait(full0, 0);
  wg_fence();
  x.qk(dq, dk(0));
  wg_commit();
  wg_wait<0>();
  hold(x.s);
  softmax(0, 0);
  tile_split(x.s, x.ph, x.pl);
  // tile t: q.k of t, then p.v of t - 1, then t's softmax under that p.v
  for (int t = 1; t < ntiles; ++t) {
    const int st = t % kStages;
    const int prev = (t - 1) % kStages;
    mbar_wait(full0 + 8 * st, (t / kStages) & 1);
    wg_fence();
    x.qk(dq, dk(st));
    wg_commit();
    x.rescale();  // under t's q.k, which does not touch O
    wg_fence();
    x.pv(dv(prev));
    wg_commit();
    wg_wait<1>();
    hold(x.s);
    softmax(t, st);
    wg_wait<0>();
    x.hold_all();
    // stage prev is read: its q.k and p.v are done, and so are all four
    // warps' softmax reads of its bias (each issued that p.v after them)
    if (threadIdx.x == 0) mbar_arrive(empty0 + 8 * prev);
    tile_split(x.s, x.ph, x.pl);
  }
  // the last tile's p.v
  x.rescale();
  wg_fence();
  x.pv(dv((ntiles - 1) % kStages));
  wg_commit();
  wg_wait<0>();
  x.hold_all();
  x.store(out + b * co.o_batch + h * co.o_head, co.o_row,
          q0 + warp * 16 + lane / 4, L, t4);
}

template <bool BIAS>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const float* bias, void* out, int B,
                   int H, int L, int K, const Coords& co, float scale_log2,
                   cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(attn_packed_kernel_wgmma256<BIAS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  attn_packed_kernel_wgmma256<BIAS><<<grid, kThreads, kSmem, stream>>>(
      qm, km, vm, bias, static_cast<__nv_bfloat16*>(out), L, K, co,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes: bfloat16 q, k, v and out at d = 256, optional
// float32 (B, K) bias (null for none), q, k, v and out 16-byte aligned;
// layouts as samt_attention_wgmma's (0 token-major, kernel K1; 1
// head-split, kernel K2; kv_shared 1 for a context shared by the batch).
// Returns the CUDA error of the launch (0 on success),
// cudaErrorInvalidValue for what the kernel does not take or a tensor map
// that cannot be encoded.
extern "C" int samt_attention_wgmma256(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* out, int B, int H, int L, int K,
                                       int layout, int kv_shared, float scale,
                                       void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  CUtensorMap qm, km, vm;
  Coords co;
  if ((layout != 0 && layout != 1) || B <= 0 || H <= 0 || L <= 0 || K <= 0 ||
      B > 65535 || H > 65535 || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(out) ||
      !layout_maps(q, k, v, B, H, L, K, kD, layout, kv_shared, kRows, kKeys,
                   &qm, &km, &vm, &co)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bb = static_cast<const float*>(bias);
  const float sl2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bias ? launch<true>(qm, km, vm, bb, out, B, H, L, K, co, sl2, s)
           : launch<false>(qm, km, vm, bb, out, B, H, L, K, co, sl2, s));
}
