// Softmax attention on Hopper's warpgroup tensor cores (sm_90a): bfloat16
// at head width d = 256 (the appearance transformer at n_head 1) and at
// d = 129..255 with d % 8 = 0, in both layouts of
// csrc/fused_attention_wgmma.cu.
//
// Replaces, at those widths, the same two TPU kernels as
// fused_attention_wgmma.cu (synergize_motion_appearance_tpu/ops/
// fused_attention.py: `_attn_kernel_packed` at :227, kernel K1 of the port,
// token-major; `_attn_kernel` at :56, kernel K2, head-split), and computes
// their function as that file's kernel does: scores as a bf16 x bf16
// product accumulated in f32, times 1/sqrt(d), plus the optional (B, K) f32
// bias where -1e30 masks a key; an f32 max-subtracted online softmax in
// log2 units; p.v with p split into bf16 hi + lo; 0 for a row whose every
// key is masked; the output rounded once to bf16. A shared (K, E) codebook
// is a tensor map whose batch extent is 1, read at plane 0: never broadcast
// in memory. ops/fused_attention.py::plan sends bf16 d = 129..256 with
// d % 8 = 0 here where q, k, v and out are 16-byte aligned;
// fused_attention_chunked.cu keeps these widths at other pointers and in
// float32.
//
// The column count D (d rounded up to 32: 160, 192, 224 or 256) is a
// template parameter, with the d = 128 design's parts (fused_attention_
// wgmma128.cu): D / 64 full 64-column parts and, at D = 160 and 224, a
// 32-column part with the 64-byte swizzle; 4-d maps of head rows at every
// width but d = D = 256 (3-d, the kernel as it was), and the output's
// columns past d left unstored. The ring takes as many stages as fit
// beside the query tile: 3 at D = 256 and 224, 4 at 192, 5 at 160. At
// d = 192 (a frame batch's appearance launch) the kernel takes 0.65x
// SDPA's time and 0.13x the d-chunked kernel's on an H100 at 700 W
// (chip_smoke.py's timed widths, PERF.md section 6).
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

constexpr int kCols = 64;             // columns of a full part (TMA box)
constexpr int kRowBytes = 2 * kCols;  // a box row: the 128-byte swizzle
constexpr int kRows = 64;         // query rows of the consumer warpgroup
constexpr int kKeys = 64;         // keys a tile
static_assert(kKeys == 64, "tile_softmax and tile_split take 64-key tiles");
constexpr int kThreads = 160;     // the consumer warpgroup, the producer warp
constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8-row core-matrix groups

// The block's shared memory at D columns (d rounded up to 32: 160, 192,
// 224 or 256), from a base aligned to 1024 bytes (the swizzle's period):
// the query tile (each full part 64 rows of 64 columns, then a 32-column
// tail part where D % 64 = 32), the stages (k tile, then v tile, each 64
// keys in parts), the stages' bias, the barriers (full and empty of each
// stage, then q's). As many stages as fit: 3 at D = 256 and 224, 4 at
// 192, 5 at 160. Every part starts at a multiple of 1024 bytes.
template <int D>
struct Geo {
  static_assert(D % 32 == 0 && D > 128 && D <= 256,
                "the d = 256 design takes D 160..256");
  static constexpr int kFull = D / 64;        // full 64-column parts
  static constexpr bool kTail = D % 64 != 0;  // and a 32-column part
  static constexpr int kQPart = kRows * kRowBytes;  // a part's query rows
  static constexpr int kQBytes = kRows * 2 * D;
  static constexpr int kTilePart = kKeys * kRowBytes;
  static constexpr int kTileBytes = kKeys * 2 * D;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages =
      (232448 - 1024 - kQBytes - 64) / (kStageBytes + kKeys * 4 + 16);
  static constexpr int kBias = kQBytes + kStages * kStageBytes;
  static constexpr int kBars = kBias + kStages * kKeys * 4;
  static constexpr int kSmem = kBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(kStages >= 3 && kSmem <= 232448, "shared memory of a block");
};
static_assert(Geo<256>::kStages == 3 && Geo<160>::kStages == 5,
              "the stages the header note states");

// part p of O (columns 64p .. 64p + 63), and the 32-column tail part
template <int N>
__device__ __forceinline__ float (&quarter(float (&o)[N], int p))[32] {
  return *reinterpret_cast<float(*)[32]>(&o[32 * p]);
}
template <int N>
__device__ __forceinline__ float (&tail(float (&o)[N]))[16] {
  return *reinterpret_cast<float(*)[16]>(&o[N - 16]);
}

// The consumer warpgroup's 64 query rows: S (then p), O in its parts,
// p's A fragments, the running max (log2 units), this thread's share of
// each row's sum and the rescale O owes. A thread holds rows g and g + 8
// of its warp's 16 (g = lane / 4), columns 2 (lane % 4) and + 1 of each n8
// tile.
template <int D, bool BIAS>
struct Rows {
  using G = Geo<D>;
  static constexpr int NS = kKeys / 16;  // k16 steps of p.v
  static constexpr int KF = 4 * G::kFull;  // k16 steps of q.k in full parts
  float s[kKeys / 2];
  float o[D / 2];
  uint32_t ph[NS][4], pl[NS][4];  // p as bf16 hi and lo
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};
  float c[2] = {1.f, 1.f};

  __device__ __forceinline__ Rows() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;  // (q.k overwrites it)
  }
  // issues S = q.k^T: 4 k16 steps a full part, each 32 bytes further along
  // the swizzled rows; dq and dk at part 0, parts kQPart and kTilePart
  // bytes apart
  __device__ __forceinline__ void qk(uint64_t dq, uint64_t dk) {
#pragma unroll
    for (int kk = 0; kk < KF; ++kk) {
      const int p = kk / 4, step = 2 * (kk % 4);
      wgmma_ss_n64(s, dq + p * (G::kQPart >> 4) + step,
                   dk + p * (G::kTilePart >> 4) + step, kk > 0);
    }
  }
  // and the tail part's 2 k16 steps of its 64-byte rows (dqt, dkt)
  __device__ __forceinline__ void qk_tail(uint64_t dqt, uint64_t dkt) {
#pragma unroll
    for (int kk = KF; kk < D / 16; ++kk)
      wgmma_ss_n64(s, dqt + 2 * (kk - KF), dkt + 2 * (kk - KF), 1);
  }
  // issues O += p.v: keys 16 kk .. 16 kk + 15 are 16 rows further, part p
  // one part further, the tail part at dvt; successive wgmmas go to
  // different parts
  __device__ __forceinline__ void pv(uint64_t dv, uint64_t dvt = 0) {
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const uint64_t dvk = dv + kk * (16 * kRowBytes >> 4);
#pragma unroll
      for (int p = 0; p < G::kFull; ++p)
        wgmma_rs_n64(quarter(o, p), ph[kk], dvk + p * (G::kTilePart >> 4));
      if constexpr (G::kTail)
        wgmma_rs_n32(tail(o), ph[kk], dvt + kk * (16 * 64 >> 4));
#pragma unroll
      for (int p = 0; p < G::kFull; ++p)
        wgmma_rs_n64(quarter(o, p), pl[kk], dvk + p * (G::kTilePart >> 4));
      if constexpr (G::kTail)
        wgmma_rs_n32(tail(o), pl[kk], dvt + kk * (16 * 64 >> 4));
    }
  }
  __device__ __forceinline__ void hold_all() {
    hold(o);
    hold(ph);
    hold(pl);
  }
  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= c[(i >> 1) & 1];
  }
  // out: O / row sum, rounded once to bf16; a row whose every key is masked
  // gives 0, as the TPU kernel's (m > -1e29) factor (here in log2 units);
  // rows past L, and with CLIP (every width but d = D = 256) the columns
  // past d, are not stored: they are the next head's or the next row's.
  // row0: this thread's row g.
  template <bool CLIP>
  __device__ __forceinline__ void store(__nv_bfloat16* ob, long long o_row,
                                        int row0, int L, int t4, int d = D) {
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
      for (int j = 0; j < D / 8; ++j) {
        if (CLIP && 8 * j >= d) continue;  // d % 8 = 0: whole n8 tiles
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
};

// a box of the map at column c of head h's row, row `row`, plane z: 3-d
// maps take the column within the token row, 4-d ones the column within
// the head row and the head coordinate (Coords' col_h)
template <bool M4>
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col_h, int c,
                                         int row, int z) {
  if constexpr (M4)
    tma_load_4d(dst, map, bar, c, col_h, row, z);
  else
    tma_load(dst, map, bar, col_h + c, row, z);
}

// scale_log2 = log2(e) / sqrt(d). Block (tile of 64 query rows, head,
// batch row). D: d rounded up to 32; M4: the maps are 4-d (encode4), as
// every width but d = 256 needs. The tail part's maps (qtail, ktail,
// vtail) are read where D % 64 = 32 only, d where D > d.
template <int D, bool M4, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
attn_packed_kernel_wgmma256(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out, int L, int K,
                            Coords co, float scale_log2,
                            const __grid_constant__ CUtensorMap qtail,
                            const __grid_constant__ CUtensorMap ktail,
                            const __grid_constant__ CUtensorMap vtail,
                            int d) {
  using G = Geo<D>;
  constexpr int kStages = G::kStages;
  static_assert(M4 || D == 256, "a 3-d map takes d = D = 256 only");
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
      mbar_expect(qbar, G::kQBytes);
#pragma unroll
      for (int p = 0; p < G::kFull; ++p)
        load_box<M4>(base + p * G::kQPart, &qmap, qbar, h * co.q_col_h,
                     p * kCols, q0, b * co.q_z_b + h * co.q_z_h);
      if constexpr (G::kTail)
        load_box<M4>(base + G::kFull * G::kQPart, &qtail, qbar,
                     h * co.q_col_h, G::kFull * kCols, q0,
                     b * co.q_z_b + h * co.q_z_h);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
      if constexpr (BIAS) {
        float* bs = reinterpret_cast<float*>(smem + G::kBias + s * kKeys * 4);
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
        const uint32_t ks = base + G::kQBytes + s * G::kStageBytes;
#pragma unroll
        for (int p = 0; p < G::kFull; ++p) {
          load_box<M4>(ks + p * G::kTilePart, &kmap, full0 + 8 * s, kv_col,
                       p * kCols, t * kKeys, kv_z);
          load_box<M4>(ks + G::kTileBytes + p * G::kTilePart, &vmap,
                       full0 + 8 * s, kv_col, p * kCols, t * kKeys, kv_z);
        }
        if constexpr (G::kTail) {
          const int pt = G::kFull * G::kTilePart;
          load_box<M4>(ks + pt, &ktail, full0 + 8 * s, kv_col,
                       G::kFull * kCols, t * kKeys, kv_z);
          load_box<M4>(ks + G::kTileBytes + pt, &vtail, full0 + 8 * s,
                       kv_col, G::kFull * kCols, t * kKeys, kv_z);
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
    return make_desc(base + G::kQBytes + st * G::kStageBytes, kGroupBytes,
                     1);
  };
  const auto dv = [&](int st) {
    return make_desc(base + G::kQBytes + st * G::kStageBytes + G::kTileBytes,
                     kGroupBytes, 1);
  };
  // the tail part of q and of stage st's k and v tiles (64-byte rows)
  const auto dqt = [&]() {
    return make_tail_desc(base + G::kFull * G::kQPart);
  };
  const auto dkt = [&](int st) {
    return make_tail_desc(base + G::kQBytes + st * G::kStageBytes +
                          G::kFull * G::kTilePart);
  };
  const auto dvt = [&](int st) {
    return make_tail_desc(base + G::kQBytes + st * G::kStageBytes +
                          G::kTileBytes + G::kFull * G::kTilePart);
  };
  Rows<D, BIAS> x;
  // tile t's softmax, its bias from stage st
  const auto softmax = [&](int t, int st) {
    const float* bs =
        reinterpret_cast<const float*>(smem + G::kBias + st * kKeys * 4);
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
  if constexpr (G::kTail) x.qk_tail(dqt(), dkt(0));
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
    if constexpr (G::kTail) x.qk_tail(dqt(), dkt(st));
    wg_commit();
    x.rescale();  // under t's q.k, which does not touch O
    wg_fence();
    if constexpr (G::kTail)
      x.pv(dv(prev), dvt(prev));
    else
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
  if constexpr (G::kTail)
    x.pv(dv((ntiles - 1) % kStages), dvt((ntiles - 1) % kStages));
  else
    x.pv(dv((ntiles - 1) % kStages));
  wg_commit();
  wg_wait<0>();
  x.hold_all();
  if constexpr (M4)
    x.template store<true>(out + b * co.o_batch + h * co.o_head, co.o_row,
                           q0 + warp * 16 + lane / 4, L, t4, d);
  else
    x.template store<false>(out + b * co.o_batch + h * co.o_head, co.o_row,
                            q0 + warp * 16 + lane / 4, L, t4);
}

template <int D, bool M4, bool BIAS>
cudaError_t launch(const CUtensorMap (&maps)[6], const float* bias,
                   void* out, int B, int H, int L, int K, int d,
                   const Coords& co, float scale_log2, cudaStream_t stream) {
  const auto kernel = attn_packed_kernel_wgmma256<D, M4, BIAS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, Geo<D>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], bias, static_cast<__nv_bfloat16*>(out), L,
      K, co, scale_log2, maps[3], maps[4], maps[5], d);
  return cudaGetLastError();
}

template <int D, bool M4>
cudaError_t launch_d(const CUtensorMap (&maps)[6], const float* bias,
                     void* out, int B, int H, int L, int K, int d,
                     const Coords& co, float scale_log2,
                     cudaStream_t stream) {
  return bias ? launch<D, M4, true>(maps, bias, out, B, H, L, K, d, co,
                                    scale_log2, stream)
              : launch<D, M4, false>(maps, bias, out, B, H, L, K, d, co,
                                     scale_log2, stream);
}

}  // namespace

// C entry, bound with ctypes: bfloat16 q, k, v and out at d = 129..256 with
// d % 8 = 0, optional float32 (B, K) bias (null for none), q, k, v and out
// 16-byte aligned; layouts as samt_attention_wgmma's (0 token-major,
// kernel K1; 1 head-split, kernel K2; kv_shared 1 for a context shared by
// the batch). d = 256 runs on 3-d maps of whole token rows, the other
// widths on 4-d maps of head rows, in D = d rounded up to 32 columns.
// Returns the CUDA error of the launch (0 on success),
// cudaErrorInvalidValue for what the kernel does not take or a tensor map
// that cannot be encoded.
extern "C" int samt_attention_wgmma256(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* out, int B, int H, int L, int K,
                                       int d, int layout, int kv_shared,
                                       float scale, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if ((layout != 0 && layout != 1) || B <= 0 || H <= 0 || L <= 0 || K <= 0 ||
      B > 65535 || H > 65535 || d < 129 || d > 256 || d % 8 != 0 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[6];  // q, k, v, then the tail part's q, k, v
  Coords co;
  const int D = (d + 31) / 32 * 32;
  const bool ok =
      d == 256
          ? layout_maps(q, k, v, B, H, L, K, d, layout, kv_shared, kRows,
                        kKeys, &maps[0], &maps[1], &maps[2], &co)
          : layout_maps4(q, k, v, nullptr, B, H, L, K, d, layout, kv_shared,
                         kCols, kRows, kKeys, 0, &maps[0], &maps[1],
                         &maps[2], nullptr, &co) &&
                (D % 64 == 0 ||
                 layout_maps4(q, k, v, nullptr, B, H, L, K, d, layout,
                              kv_shared, 32, kRows, kKeys, 0, &maps[3],
                              &maps[4], &maps[5], nullptr, &co));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* bb = static_cast<const float*>(bias);
  const float sl2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (D) {
    case 160:
      e = launch_d<160, true>(maps, bb, out, B, H, L, K, d, co, sl2, s);
      break;
    case 192:
      e = launch_d<192, true>(maps, bb, out, B, H, L, K, d, co, sl2, s);
      break;
    case 224:
      e = launch_d<224, true>(maps, bb, out, B, H, L, K, d, co, sl2, s);
      break;
    default:
      e = d == 256
              ? launch_d<256, false>(maps, bb, out, B, H, L, K, d, co, sl2, s)
              : launch_d<256, true>(maps, bb, out, B, H, L, K, d, co, sl2, s);
  }
  return static_cast<int>(e);
}
