// Softmax attention on Hopper's warpgroup tensor cores (sm_90a): bfloat16
// at head width d = 257..512 with d % 8 = 0, in both layouts of
// csrc/fused_attention_wgmma.cu.
//
// Replaces, at those widths, the same two TPU kernels as
// fused_attention_wgmma.cu (synergize_motion_appearance_tpu/ops/
// fused_attention.py: `_attn_kernel_packed` at :227, kernel K1 of the port,
// token-major; `_attn_kernel` at :56, kernel K2, head-split), and computes
// their function as the d = 256 design (fused_attention_wgmma256.cu) does:
// scores as a bf16 x bf16 product accumulated in f32, times 1/sqrt(d), plus
// the optional (B, K) f32 bias where -1e30 masks a key; an f32
// max-subtracted online softmax in log2 units; p.v with p split into bf16
// hi + lo; 0 for a row whose every key is masked; the output rounded once
// to bf16. A shared (K, E) codebook is a tensor map whose batch extent is
// 1, read at plane 0: never broadcast in memory. ops/fused_attention.py::
// plan sends bf16 d = 257..512 with d % 8 = 0 here where q, k, v and out
// are 16-byte aligned; fused_attention_chunked.cu keeps these widths at
// other pointers, and bf16 above 512.
//
// Why not the d = 256 design with more columns: O of 64 rows x 512 columns
// in f32 is 256 registers a thread of a warpgroup, and at d = 512 the
// 64-row q tile is 64 KiB and one 64-key k + v stage 128 KiB, so not even
// two stages fit the SM's 227 KiB.
//
// The design: a head row's output columns come in two parts of W columns
// (W = d rounded up to 64, halved: 160, 192, 224 or 256), and each part is
// a block of its own that runs the whole q.k over the head's depth and
// every exponential, then p.v into its W columns only. So q.k and each
// exponential run twice a head (ceil(d / 256)), not ceil(d / 64) times as
// on the d-chunked kernel, and O is at most the d = 256 design's 128
// registers a thread.
// - q is staged once, as two depth halves of W columns; k of a 64-key tile
//   comes as two depth halves of W columns, v as the block's part of W
//   columns: three units of 64 rows x W columns, through one mbarrier ring
//   of such units (5 at W = 256, 6 at 224, 7 at 192, 9 at 160: as many as
//   fit beside q). A unit is W / 64 TMA boxes of 64 columns (the 128-byte
//   swizzle) and, where W % 64 = 32, one box of 32 (the 64-byte swizzle).
//   The maps are 4-d, of head rows (attention_wgmma.cuh::encode4), so
//   that TMA zero-fills q's, k's and v's columns past d (a box wholly past
//   d reads zeros).
// - One producer warp issues the copies and stages each tile's bias times
//   log2(e) (-inf past K) beside its first k unit; one consumer warpgroup
//   of 64 query rows issues tile t's q.k across both k units, rescales O
//   under it, issues tile t - 1's p.v (per k16 step one n64 wgmma into each
//   64-column part of O, hi and lo each, and an n32 one into the 32-column
//   part), runs t's softmax while that p.v is on the tensor cores, and
//   releases each unit once it is read: the second k unit after q.k, the
//   first after the softmax has read its bias, v after p.v.
// - Parts of a q tile are neighbouring blocks (the part index is the
//   lowest of blockIdx.x), so both read the same k tiles out of L2.
// - The store writes bf16 pairs straight from registers, rows past L and
//   columns past d left unstored.
//
// What bounds it: per score q.k takes 2W multiply-adds in each of the two
// part blocks and p.v 2 x 2W (hi and lo) over both: 8W against one
// exponential a block, so the tensor cores, at 2048 bf16 multiply-adds per
// SM per clock, and shared memory, which q.k's operands from shared memory
// load at 128 bytes a clock: per 64-row x 64-key tile of one part, q.k
// 4W / 16 wgmmas of 4 KiB, p.v 2 x 4W / 64 of 2 KiB and the copies of
// three W-column units.
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

constexpr int kCols = 64;             // columns of a full box
constexpr int kRowBytes = 2 * kCols;  // a box row: the 128-byte swizzle
constexpr int kRows = 64;         // query rows of the consumer warpgroup
constexpr int kKeys = 64;         // keys a tile
static_assert(kKeys == 64, "tile_softmax and tile_split take 64-key tiles");
constexpr int kParts = 2;         // output parts of a head row
constexpr int kUnitsPerTile = 3;  // k's two depth halves, then v's part
constexpr int kThreads = 160;     // the consumer warpgroup, the producer warp
constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8-row core-matrix groups

// The block's shared memory at part width W (d rounded up to 64, halved:
// 160, 192, 224 or 256), from a base aligned to 1024 bytes (the swizzle's
// period): q's two depth halves, the ring's slots (each one unit: 64 rows
// of W columns, W / 64 full boxes, then a 32-column box where W % 64 =
// 32), each slot's bias, the barriers (full and empty of each slot, then
// q's). Every box starts at a multiple of 1024 bytes.
template <int W>
struct Geo {
  static_assert(W % 32 == 0 && W >= 160 && W <= 256,
                "the d = 512 design takes W 160..256");
  static constexpr int kFull = W / 64;        // full 64-column boxes
  static constexpr bool kTail = W % 64 != 0;  // and a 32-column box
  static constexpr int kBox = kKeys * kRowBytes;  // a full box of 64 rows
  static constexpr int kUnit = kKeys * 2 * W;
  static constexpr int kQBytes = 2 * kUnit;
  static constexpr int kSlots =
      (232448 - 1024 - kQBytes - 8) / (kUnit + kKeys * 4 + 16);
  static constexpr int kBias = kQBytes + kSlots * kUnit;
  static constexpr int kBars = kBias + kSlots * kKeys * 4;
  static constexpr int kSmem = kBars + (2 * kSlots + 1) * 8 + 1024;
  static_assert(kSlots >= 5 && kSmem <= 232448, "shared memory of a block");
};
static_assert(Geo<256>::kSlots == 5 && Geo<224>::kSlots == 6 &&
                  Geo<192>::kSlots == 7 && Geo<160>::kSlots == 9,
              "the slots the header note states");

// part p of O (columns 64p .. 64p + 63), and the 32-column part
template <int N>
__device__ __forceinline__ float (&quarter(float (&o)[N], int p))[32] {
  return *reinterpret_cast<float(*)[32]>(&o[32 * p]);
}
template <int N>
__device__ __forceinline__ float (&tail(float (&o)[N]))[16] {
  return *reinterpret_cast<float(*)[16]>(&o[N - 16]);
}

// The consumer warpgroup's 64 query rows, one part of W output columns:
// S (then p), O, p's A fragments, the running max (log2 units), this
// thread's share of each row's sum and the rescale O owes. A thread holds
// rows g and g + 8 of its warp's 16 (g = lane / 4), columns 2 (lane % 4)
// and + 1 of each n8 tile.
template <int W, bool BIAS>
struct Rows {
  using G = Geo<W>;
  static constexpr int NS = kKeys / 16;  // k16 steps of p.v
  static constexpr int KF = 4 * G::kFull;  // k16 steps of a unit's full boxes
  float s[kKeys / 2];
  float o[W / 2];
  uint32_t ph[NS][4], pl[NS][4];  // p as bf16 hi and lo
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};
  float c[2] = {1.f, 1.f};

  __device__ __forceinline__ Rows() {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;  // (q.k overwrites it)
  }
  // issues S (+)= q.k^T over one depth half: q's half at qa, k's unit at
  // ka; 4 k16 steps a full box, each 32 bytes further along the swizzled
  // rows, then the 32-column box's 2; `first`: S starts from 0. The
  // addresses are opaque to the compiler here, so that it derives each
  // step's descriptors at the issue instead of hoisting q's out of the
  // tile loop: without that, ptxas held W = 256 at 255 registers and
  // spilled 24 bytes; with it, 250 and no spill.
  __device__ __forceinline__ void qk_half(uint32_t qa, uint32_t ka,
                                          bool first) {
    asm volatile("" : "+r"(qa), "+r"(ka));
    const uint64_t dq = make_desc(qa, kGroupBytes, 1);
    const uint64_t dk = make_desc(ka, kGroupBytes, 1);
#pragma unroll
    for (int kk = 0; kk < KF; ++kk) {
      const int p = kk / 4, step = 2 * (kk % 4);
      wgmma_ss_n64(s, dq + p * (G::kBox >> 4) + step,
                   dk + p * (G::kBox >> 4) + step, !first || kk > 0);
    }
    if constexpr (G::kTail) {
      const uint64_t dqt = make_tail_desc(qa + G::kFull * G::kBox);
      const uint64_t dkt = make_tail_desc(ka + G::kFull * G::kBox);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_ss_n64(s, dqt + 2 * kk, dkt + 2 * kk, 1);
    }
  }
  // issues O += p.v from v's unit at va: keys 16 kk .. 16 kk + 15 are 16
  // rows further, box p one box further; successive wgmmas go to
  // different parts of O
  __device__ __forceinline__ void pv(uint32_t va) {
    const uint64_t dv = make_desc(va, kGroupBytes, 1);
    const uint32_t vt = va + G::kFull * G::kBox;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const uint64_t dvk = dv + kk * (16 * kRowBytes >> 4);
#pragma unroll
      for (int p = 0; p < G::kFull; ++p)
        wgmma_rs_n64(quarter(o, p), ph[kk], dvk + p * (G::kBox >> 4));
      if constexpr (G::kTail)
        wgmma_rs_n32(tail(o), ph[kk], make_tail_desc(vt + kk * 16 * 64));
#pragma unroll
      for (int p = 0; p < G::kFull; ++p)
        wgmma_rs_n64(quarter(o, p), pl[kk], dvk + p * (G::kBox >> 4));
      if constexpr (G::kTail)
        wgmma_rs_n32(tail(o), pl[kk], make_tail_desc(vt + kk * 16 * 64));
    }
  }
  __device__ __forceinline__ void hold_all() {
    hold(o);
    hold(ph);
    hold(pl);
  }
  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] *= c[(i >> 1) & 1];
  }
  // out: O / row sum, rounded once to bf16, at columns c0 .. c0 + W - 1 of
  // the head row; a row whose every key is masked gives 0, as the TPU
  // kernel's (m > -1e29) factor (here in log2 units); rows past L and
  // columns past d are not stored (d % 8 = 0: whole n8 tiles). row0: this
  // thread's row g.
  __device__ __forceinline__ void store(__nv_bfloat16* ob, long long o_row,
                                        int row0, int L, int t4, int c0,
                                        int d) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float den = l[r];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      const int row = row0 + 8 * r;
      if (row >= L) continue;
      const bool keep = !BIAS || m[r] > -1e29f * kLog2e;
      const float inv = keep ? 1.f / den : 0.f;
      __nv_bfloat16* op = ob + static_cast<long long>(row) * o_row + c0;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        if (c0 + 8 * j >= d) continue;
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
};

// The boxes of one unit (or one half of q) into dst: columns c0 .. c0 + W
// - 1 of head row col_h's rows row .. row + 63 of plane z, full boxes from
// map, the 32-column box from tmap; all complete on bar.
template <int W>
__device__ __forceinline__ void load_unit(uint32_t dst, const CUtensorMap* map,
                                          const CUtensorMap* tmap,
                                          uint32_t bar, int col_h, int c0,
                                          int row, int z) {
  using G = Geo<W>;
#pragma unroll
  for (int p = 0; p < G::kFull; ++p)
    tma_load_4d(dst + p * G::kBox, map, bar, c0 + p * kCols, col_h, row, z);
  if constexpr (G::kTail)
    tma_load_4d(dst + G::kFull * G::kBox, tmap, bar, c0 + G::kFull * kCols,
                col_h, row, z);
}

// scale_log2 = log2(e) / sqrt(d). Block (2 x tile of 64 query rows + part,
// head, batch row); W: d rounded up to 64, halved. The maps are 4-d
// (encode4), the 32-column ones (qtail, ktail, vtail) read where W % 64 =
// 32 only.
template <int W, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
attn_packed_kernel_wgmma512(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out, int L, int K,
                            Coords co, float scale_log2,
                            const __grid_constant__ CUtensorMap qtail,
                            const __grid_constant__ CUtensorMap ktail,
                            const __grid_constant__ CUtensorMap vtail,
                            int d) {
  using G = Geo<W>;
  constexpr int kSlots = G::kSlots;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t full0 = base + G::kBars;  // full barrier of slot s: +8s
  const uint32_t empty0 = full0 + 8 * kSlots;
  const uint32_t qbar = empty0 + 8 * kSlots;
  const uint32_t slot0 = base + G::kQBytes;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int part = blockIdx.x % kParts;
  const int q0 = blockIdx.x / kParts * kRows;
  const int ntiles = (K + kKeys - 1) / kKeys;
  const int nunits = kUnitsPerTile * ntiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full0 + 8 * s, 32);    // the producer warp's lanes
      mbar_init(empty0 + 8 * s, 128);  // every consumer thread
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
      for (int half = 0; half < 2; ++half)
        load_unit<W>(base + half * G::kUnit, &qmap, &qtail, qbar,
                     h * co.q_col_h, half * W, q0,
                     b * co.q_z_b + h * co.q_z_h);
    }
    // unit u: tile u / 3; k's depth half u % 3, or (u % 3 = 2) v's part
    for (int u = 0; u < nunits; ++u) {
      const int s = u % kSlots;
      const int t = u / kUnitsPerTile;
      const int r = u % kUnitsPerTile;
      if (u >= kSlots) mbar_wait(empty0 + 8 * s, (u / kSlots - 1) & 1);
      if (BIAS && r == 0) {
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
        mbar_expect(full0 + 8 * s, G::kUnit);
        const bool is_v = r == kUnitsPerTile - 1;
        load_unit<W>(slot0 + s * G::kUnit, is_v ? &vmap : &kmap,
                     is_v ? &vtail : &ktail, full0 + 8 * s, kv_col,
                     (is_v ? part : r) * W, t * kKeys, kv_z);
      } else {
        mbar_arrive(full0 + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroup: query rows q0 .. q0 + 63, columns of part ----
  const int t4 = lane % 4;
  const auto slot = [&](int u) { return u % kSlots; };
  const auto wait_unit = [&](int u) {
    mbar_wait(full0 + 8 * slot(u), (u / kSlots) & 1);
  };
  const auto release = [&](int u) { mbar_arrive(empty0 + 8 * slot(u)); };
  const auto unit = [&](int u) { return slot0 + slot(u) * G::kUnit; };
  Rows<W, BIAS> x;
  // q.k of tile t, from its two k units
  const auto qk = [&](int t) {
    const int u = kUnitsPerTile * t;
    x.qk_half(base, unit(u), true);
    x.qk_half(base + G::kUnit, unit(u + 1), false);
  };
  // tile t's softmax, its bias from its first k unit's slot
  const auto softmax = [&](int t) {
    const float* bs = reinterpret_cast<const float*>(
        smem + G::kBias + slot(kUnitsPerTile * t) * kKeys * 4);
    tile_softmax<BIAS>(
        x.s, x.m, x.l, x.c,
        [&](int j) {
          return *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t4);
        },
        K - t * kKeys, t4, scale_log2);
  };

  mbar_wait(qbar, 0);
  // tile 0: q.k, softmax
  wait_unit(0);
  wait_unit(1);
  wg_fence();
  qk(0);
  wg_commit();
  wg_wait<0>();
  hold(x.s);
  release(1);
  softmax(0);
  release(0);
  tile_split(x.s, x.ph, x.pl);
  // tile t: q.k of t, then p.v of t - 1, then t's softmax under that p.v
  for (int t = 1; t < ntiles; ++t) {
    const int u = kUnitsPerTile * t;
    const int uv = u - 1;  // tile t - 1's v
    wait_unit(u);
    wait_unit(u + 1);
    wait_unit(uv);
    wg_fence();
    qk(t);
    wg_commit();
    x.rescale();  // under t's q.k, which does not touch O
    wg_fence();
    x.pv(unit(uv));
    wg_commit();
    wg_wait<1>();
    hold(x.s);
    release(u + 1);  // q.k read both k units; the first holds t's bias
    softmax(t);
    release(u);
    wg_wait<0>();
    x.hold_all();
    release(uv);
    tile_split(x.s, x.ph, x.pl);
  }
  // the last tile's p.v (no unit is refilled after it)
  wait_unit(nunits - 1);
  x.rescale();
  wg_fence();
  x.pv(unit(nunits - 1));
  wg_commit();
  wg_wait<0>();
  x.hold_all();
  x.store(out + b * co.o_batch + h * co.o_head, co.o_row,
          q0 + warp * 16 + lane / 4, L, t4, part * W, d);
}

template <int W, bool BIAS>
cudaError_t launch(const CUtensorMap (&maps)[6], const float* bias,
                   void* out, int B, int H, int L, int K, int d,
                   const Coords& co, float scale_log2, cudaStream_t stream) {
  const auto kernel = attn_packed_kernel_wgmma512<W, BIAS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<W>::kSmem);
  if (err != cudaSuccess) return err;
  const long long nx = static_cast<long long>(kParts) * ((L + kRows - 1) /
                                                         kRows);
  if (nx > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(nx), H, B);
  kernel<<<grid, kThreads, Geo<W>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], bias, static_cast<__nv_bfloat16*>(out), L,
      K, co, scale_log2, maps[3], maps[4], maps[5], d);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_w(const CUtensorMap (&maps)[6], const float* bias,
                     void* out, int B, int H, int L, int K, int d,
                     const Coords& co, float scale_log2,
                     cudaStream_t stream) {
  return bias ? launch<W, true>(maps, bias, out, B, H, L, K, d, co,
                                scale_log2, stream)
              : launch<W, false>(maps, bias, out, B, H, L, K, d, co,
                                 scale_log2, stream);
}

}  // namespace

// C entry, bound with ctypes: bfloat16 q, k, v and out at d = 257..512 with
// d % 8 = 0, optional float32 (B, K) bias (null for none), q, k, v and out
// 16-byte aligned; layouts as samt_attention_wgmma's (0 token-major,
// kernel K1; 1 head-split, kernel K2; kv_shared 1 for a context shared by
// the batch), on 4-d maps of head rows, in two parts of W = d rounded up
// to 64, halved, columns. Returns the CUDA error of the launch (0 on
// success), cudaErrorInvalidValue for what the kernel does not take or a
// tensor map that cannot be encoded.
extern "C" int samt_attention_wgmma512(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* out, int B, int H, int L, int K,
                                       int d, int layout, int kv_shared,
                                       float scale, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if ((layout != 0 && layout != 1) || B <= 0 || H <= 0 || L <= 0 || K <= 0 ||
      B > 65535 || H > 65535 || d < 257 || d > 512 || d % 8 != 0 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[6];  // q, k, v, then their 32-column boxes' maps
  Coords co;
  const int W = (d + 63) / 64 * 32;
  const bool ok =
      layout_maps4(q, k, v, nullptr, B, H, L, K, d, layout, kv_shared, kCols,
                   kRows, kKeys, 0, &maps[0], &maps[1], &maps[2], nullptr,
                   &co) &&
      (W % 64 == 0 ||
       layout_maps4(q, k, v, nullptr, B, H, L, K, d, layout, kv_shared, 32,
                    kRows, kKeys, 0, &maps[3], &maps[4], &maps[5], nullptr,
                    &co));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* bb = static_cast<const float*>(bias);
  const float sl2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (W) {
    case 160:
      e = launch_w<160>(maps, bb, out, B, H, L, K, d, co, sl2, s);
      break;
    case 192:
      e = launch_w<192>(maps, bb, out, B, H, L, K, d, co, sl2, s);
      break;
    case 224:
      e = launch_w<224>(maps, bb, out, B, H, L, K, d, co, sl2, s);
      break;
    default:
      e = launch_w<256>(maps, bb, out, B, H, L, K, d, co, sl2, s);
  }
  return static_cast<int>(e);
}
