// Softmax attention on Hopper's warpgroup tensor cores (sm_90a): bfloat16
// at head width d = 128 (the appearance transformer at n_head 2) and at
// d = 65..127 with d % 8 = 0, in both layouts of
// csrc/fused_attention_wgmma.cu.
//
// Replaces, at those widths, the same two TPU kernels as
// fused_attention_wgmma.cu (synergize_motion_appearance_tpu/ops/
// fused_attention.py: `_attn_kernel_packed` at :227, kernel K1 of the port,
// token-major; `_attn_kernel` at :56, kernel K2, head-split), and computes
// their function as that file's kernel does: scores as a bf16 x bf16
// product accumulated in f32, times 1/sqrt(d), plus the optional (B, K) f32
// bias where -1e30 masks a key; an f32 max-subtracted online softmax in
// log2 units; p.v with f32 weights, p split into bf16 hi + lo (the TPU
// kernel takes v in f32, :244-258, and its note at :31-35 records a bf16 p
// as rejected); 0 for a row whose every key is masked; the output rounded
// once to bf16. A shared (K, E) codebook is a tensor map whose batch extent
// is 1, read at plane 0: never broadcast in memory.
// ops/fused_attention.py::plan sends bf16 d = 65..128 with d % 8 = 0 here
// where q, k, v and out are 16-byte aligned; fused_attention_chunked.cu
// keeps these widths at other pointers, and its float32 wide kernel
// float32.
//
// The column count D (d rounded up to 32: 96 or 128) is a template
// parameter: a head row is D / 64 full parts of 64 columns (TMA boxes
// with the 128-byte swizzle) and, at D = 96, one part of 32 columns (the
// 64-byte swizzle, wgmma descriptors of layout type 2; q.k's last two k16
// steps and one n32 p.v product a k16 step). At d = D = 128 the maps are
// 3-d, of whole token rows (the kernel as it was, SASS unchanged); at
// every other width they are 4-d, of head rows (attention_wgmma.cuh::
// encode4), so that TMA zero-fills q's, k's and v's columns past d and
// clips the output's: a 3-d box past d would read, and store into, the
// next head's columns. A head row is then 2d bytes, a TMA stride, hence
// d % 8 = 0. The scale is 1/sqrt(d) of the true d. At d = 96 (a frame
// batch's appearance launch, B 16, L = K = 1024) the kernel takes 0.81x
// SDPA's time and 0.13x the d-chunked kernel's on an H100 at 700 W
// (chip_smoke.py's timed widths, PERF.md section 6); padding D to 128
// instead took 1.12x the time (chip_attention_cols.py).
//
// What bounds it: the tensor cores, and the softmax that has to fit under
// them. Per score q.k takes 128 multiply-adds and p.v 2 x 128 (hi and lo)
// against one exponential: at 2048 bf16 multiply-adds and 16 exponentials
// per SM per clock, 0.1875 clocks a score against 0.0625. A 64-row x
// 64-key tile of one warpgroup is 768 clocks of products; its softmax and
// the split of p into hi and lo take one warp a scheduler some 1100 clocks
// (a clock64 trace of the loop, PERF.md), longer than the products, so a
// warpgroup's softmax must run under the other's products. Shared memory:
// per warpgroup-tile p.v reads the 16 KiB v tile twice and q.k the 16 KiB
// k tile, and TMA writes the 32 KiB of k and v once for the block's 128
// rows. Device memory: q read and the output written once, 16 MiB a
// launch of the flagship's frame batch, 5 us at 3.35 TB/s, which a block
// that finished its rows and then stored them spent without products.
//
// The design (FlashAttention-3's warp specialisation and ping-pong):
// - A persistent block an SM (a grid of at most the SMs' count) walks items
//   (tile of 128 query rows, head, batch row) blockIdx.x, + gridDim.x, ...
//   in two consumer warpgroups of 64 rows and a producer warpgroup, 384
//   threads. Each k/v tile that TMA brings serves 128 rows: half the L2
//   and shared-memory traffic a row of a 64-row block.
// - The roles split in one if / else on a warp-uniform index and never
//   reconverge, so that `setmaxnreg` takes effect (ptxas ignores it, note
//   C7508, where they do): the producer warpgroup gives its registers up
//   (kProducerRegs), the consumers take kConsumerRegs, out of the 168 a
//   thread the launch bound gives the block (2 x 128 x 232 + 128 x 40 =
//   384 x 168); the consumers use up to 195 (R194 in SASS; q's fragments
//   take 32).
// - The producer warpgroup's first warp issues the copies
//   (`cp.async.bulk.tensor.3d`): an item's query tile (a 64-column box of
//   128 rows per half of the head row) into the q buffer once both
//   consumers hold the last item's q in registers, then k and v tiles of 64
//   keys into a ring of kStages stages, each with a full and an empty
//   `mbarrier`, the copies first and then each tile's bias times log2(e),
//   -inf past K, staged by its lanes. Without a bias the consumers mask keys
//   past K on the last tile themselves. TMA zero-fills rows past L and K.
//   Its second warp stores each item's output tiles by TMA
//   (`cp.async.bulk.tensor.3d.global.shared`, which clips rows past L), so
//   that a consumer warpgroup goes on to the next item once its bf16 output
//   is in shared memory.
// - A consumer warpgroup: q's A fragments from the swizzled q tile into
//   registers once an item; S = q.k^T by wgmma m64n64k16 with q from
//   registers (8 k16 steps across the two 64-column boxes of k); softmax in
//   registers (the scale folded into one FMA with the bias or the running
//   max, ex2, the running max from -FLT_MAX, the row sum in f32); O += p.v
//   by wgmma m64n64k16 with p from registers as bf16 hi and lo, two n64
//   halves of O a k16 step. Within the warpgroup tile t + 1's q.k is issued
//   with tile t's p.v (O's rescale between the two), and t + 1's softmax
//   runs while that p.v is on the tensor cores.
// - The two consumer warpgroups take turns issuing their products (two
//   named barriers), so that one warpgroup's softmax runs while the
//   other's q.k and p.v are on the tensor cores.
// - Shared memory: q 32 KiB, the two output tiles 32 KiB, 4 stages of
//   32 KiB, the bias 1 KiB, 198,768 bytes with the barriers and the
//   1024-byte alignment: one block an SM.
// Each element was timed on the card against the design without it
// (PERF.md section 6): the persistent grid, q in registers, the fourth
// stage, the TMA store and the turns each gained.
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
constexpr int kConsumers = 2;         // consumer warpgroups
constexpr int kWgRows = 64;           // query rows of a consumer warpgroup
constexpr int kRows = kConsumers * kWgRows;  // query rows of an item
constexpr int kKeys = 64;             // keys a tile
static_assert(kKeys == 64, "tile_softmax and tile_split take 64-key tiles");
constexpr int kStages = 4;            // K+V stages of the ring
// and the producer warpgroup, of which two warps work (copies in, output
// out): setmaxnreg moves registers between whole warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8-row core-matrix groups

// The block's shared memory at D columns (d rounded up to 32: 96 or 128),
// from a base aligned to 1024 bytes (the swizzle's period): the query tile
// (each full part 128 rows of 64 columns, then a 32-column tail part where
// D % 64 = 32), the output tiles (each consumer warpgroup's 64 rows, its
// parts kOPart apart), the stages (k tile, then v tile, each 64 keys in
// parts), the stages' bias, the barriers (full and empty of each stage,
// q's full and empty, each output tile's staged and read). Every part
// starts at a multiple of 1024 bytes.
template <int D>
struct Geo {
  static_assert(D == 96 || D == 128, "the d = 128 design takes D 96, 128");
  static constexpr int kFull = D / 64;       // full 64-column parts
  static constexpr bool kTail = D % 64 != 0;  // and a 32-column part
  static constexpr int kQPart = kRows * kRowBytes;
  static constexpr int kQBytes = kRows * 2 * D;
  static constexpr int kOPart = kWgRows * kRowBytes;
  static constexpr int kWgOBytes = kWgRows * 2 * D;
  static constexpr int kO0 = kQBytes;
  static constexpr int kTilePart = kKeys * kRowBytes;
  static constexpr int kTileBytes = kKeys * 2 * D;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStage0 = kO0 + kConsumers * kWgOBytes;
  static constexpr int kBias = kStage0 + kStages * kStageBytes;
  static constexpr int kBars = kBias + kStages * kKeys * 4;
  static constexpr int kSmem =
      kBars + (2 * kStages + 2 + 2 * kConsumers) * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory of a block");
};
static_assert(128 * (kConsumers * kConsumerRegs + kProducerRegs) <=
                  kThreads * (65536 / kThreads / 8 * 8),
              "the register split fits the launch bound's registers");

// named barriers 1 + w: consumer warpgroup w's turn to issue its products,
// among both warpgroups' 256 threads (0 is __syncthreads')
constexpr int kTurnBarrier = 1;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// expect `bytes` more of TMA transactions in the current phase of bar,
// without arriving
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// TMA store of the box at src (shared) to the map's coordinates, in this
// thread's bulk group (3-d and 4-d maps); the wait until this thread's
// groups have read their shared memory (.read) or are done
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// d (64 x 64) = a (64 x 16, registers) * b (16 x 64, shared, K-major)
// [+ d]
__device__ __forceinline__ void wgmma_rs_kmajor_n64(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// byte offset of (row, byte c of the row) in a box of 128-byte rows
// swizzled by 128 bytes (16-byte chunk c / 16 of row r at chunk c / 16 ^
// r % 8)
__device__ __forceinline__ int swizzled(int row, int c) {
  return row * kRowBytes + ((((c >> 4) ^ (row & 7)) << 4) | (c & 15));
}

// part p of O (columns 64p .. 64p + 63), and the 32-column tail part
template <int N>
__device__ __forceinline__ float (&half(float (&o)[N], int p))[32] {
  return *reinterpret_cast<float(*)[32]>(&o[32 * p]);
}
template <int N>
__device__ __forceinline__ float (&tail(float (&o)[N]))[16] {
  return *reinterpret_cast<float(*)[16]>(&o[N - 16]);
}

// A consumer warpgroup's 64 query rows of an item: q's A fragments, S (then
// p), O in its parts, p's A fragments, the running max (log2 units), this
// thread's share of each row's sum and the rescale O owes. A thread holds
// rows g and g + 8 of its warp's 16 (g = lane / 4), columns 2 (lane % 4)
// and + 1 of each n8 tile, and the same elements of q and p as A fragments.
template <int D, bool BIAS>
struct Rows {
  using G = Geo<D>;
  static constexpr int NS = kKeys / 16;  // k16 steps of p.v
  static constexpr int KF = 4 * G::kFull;  // k16 steps of q.k in full parts
  uint32_t qa[D / 16][4];  // q, k16 step kk of q.k
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
  // q's fragments from the swizzled query tile at q: row r (g of this
  // warp's 16) and r + 8 of warpgroup w's 64, bytes 4 t4 and 4 t4 + 16 of
  // each k16 step's 32 (the tail part's rows are 64 bytes, its swizzle 64)
  __device__ __forceinline__ void load_q(const uint8_t* q, int w, int tid) {
    const int r = w * kWgRows + (tid / 32) * 16 + (tid % 32) / 4;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qa[kk][e] = *reinterpret_cast<const uint32_t*>(
            kk < KF ? q + kk / 4 * G::kQPart +
                          swizzled(r + 8 * (e & 1),
                                   32 * (kk % 4) + 4 * (tid % 4) +
                                       16 * (e >> 1))
                    : q + G::kFull * G::kQPart +
                          swizzled64(r + 8 * (e & 1),
                                     32 * (kk - KF) + 4 * (tid % 4) +
                                         16 * (e >> 1)));
  }
  // issues S = q.k^T over the full parts: 4 k16 steps a part, q from
  // registers, k's 32 bytes further along its swizzled rows each, part p
  // p kTilePart bytes after part 0 (dk)
  __device__ __forceinline__ void qk(uint64_t dk) {
#pragma unroll
    for (int kk = 0; kk < KF; ++kk)
      wgmma_rs_kmajor_n64(s, qa[kk],
                          dk + kk / 4 * (G::kTilePart >> 4) + 2 * (kk % 4),
                          kk > 0);
  }
  // and over the tail part (dkt): 2 k16 steps of its 64-byte rows
  __device__ __forceinline__ void qk_tail(uint64_t dkt) {
#pragma unroll
    for (int kk = KF; kk < D / 16; ++kk)
      wgmma_rs_kmajor_n64(s, qa[kk], dkt + 2 * (kk - KF), 1);
  }
  // issues O += p.v: keys 16 kk .. 16 kk + 15 are 16 rows further, part p
  // one part further, the tail part at dvt; successive wgmmas go to
  // different parts
  __device__ __forceinline__ void pv(uint64_t dv, uint64_t dvt) {
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const uint64_t dvk = dv + kk * (16 * kRowBytes >> 4);
#pragma unroll
      for (int p = 0; p < G::kFull; ++p)
        wgmma_rs_n64(half(o, p), ph[kk], dvk + p * (G::kTilePart >> 4));
      if constexpr (G::kTail)
        wgmma_rs_n32(tail(o), ph[kk], dvt + kk * (16 * 64 >> 4));
#pragma unroll
      for (int p = 0; p < G::kFull; ++p)
        wgmma_rs_n64(half(o, p), pl[kk], dvk + p * (G::kTilePart >> 4));
      if constexpr (G::kTail)
        wgmma_rs_n32(tail(o), pl[kk], dvt + kk * (16 * 64 >> 4));
    }
  }
  __device__ __forceinline__ void hold_all() {
    hold(o);
    hold(ph);
    hold(pl);
    hold(qa);
  }
  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= c[(i >> 1) & 1];
  }
  // O / row sum, rounded once to bf16, into this warpgroup's swizzled
  // output tile at ob (its parts); a row whose every key is masked gives
  // 0, as the TPU kernel's (m > -1e29) factor (here in log2 units). row:
  // this thread's row g of the 64
  __device__ __forceinline__ void stage_out(uint32_t ob, int row, int t4) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float den = l[r];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      const bool keep = !BIAS || m[r] > -1e29f * kLog2e;
      const float inv = keep ? 1.f / den : 0.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t v = as_u32(__floats2bfloat162_rn(
            o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv));
        const uint32_t at =
            j < 8 * G::kFull
                ? ob + j / 8 * G::kOPart +
                      swizzled(row + 8 * r, 16 * (j % 8) + 4 * t4)
                : ob + G::kFull * G::kOPart +
                      swizzled64(row + 8 * r, 16 * (j - 8 * G::kFull) +
                                                  4 * t4);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v)
                     : "memory");
      }
    }
  }
};

// The block's items: item i is (query tile i % nq, head i / nq % H, batch
// row i / (nq H)); a block takes items blockIdx.x, + gridDim.x, ...
struct Item {
  int q0, h, b;
  __device__ __forceinline__ Item(int i, int nq, int H)
      : q0(i % nq * kRows), h(i / nq % H), b(i / nq / H) {}
};

// The tensor maps of a launch: q, k, v and out in boxes of 64 columns
// (3-d maps of the whole token row at d = D = 128; else 4-d maps whose
// innermost extent is the head row, encode4), and the 32-column boxes of
// the tail part where D % 64 = 32.
struct Maps {
  CUtensorMap q, k, v, o, qt, kt, vt, ot;
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

// The producer warpgroup's first warp: lane 0 issues the copies, all lanes
// stage the bias. Each item's query tile goes into the q buffer once
// both consumer warpgroups hold the last item's in registers, its key
// tiles into the ring's stages, counted across items.
template <int D, bool M4, bool BIAS>
__device__ __forceinline__ void produce(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    const CUtensorMap* qtail, const CUtensorMap* ktail,
    const CUtensorMap* vtail, const float* __restrict__ bias, uint8_t* smem,
    uint32_t base, int L, int K, int H, int items, const Coords& co) {
  using G = Geo<D>;
  const uint32_t full0 = base + G::kBars;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t qfull = empty0 + 8 * kStages;
  const uint32_t qempty = qfull + 8;
  const int lane = threadIdx.x % 32;
  const int nq = (L + kRows - 1) / kRows;
  const int ntiles = (K + kKeys - 1) / kKeys;
  int g = 0;  // key tiles issued
  int j = 0;  // items
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++j) {
    const Item it(i, nq, H);
    const int kv_col = it.h * co.kv_col_h;
    const int kv_z = it.b * co.kv_z_b + it.h * co.kv_z_h;
    if (lane == 0) {
      if (j > 0) mbar_wait(qempty, (j - 1) & 1);
      mbar_expect(qfull, G::kQBytes);
#pragma unroll
      for (int p = 0; p < G::kFull; ++p)
        load_box<M4>(base + p * G::kQPart, qmap, qfull, it.h * co.q_col_h,
                     p * kCols, it.q0, it.b * co.q_z_b + it.h * co.q_z_h);
      if constexpr (G::kTail)
        load_box<M4>(base + G::kFull * G::kQPart, qtail, qfull,
                     it.h * co.q_col_h, G::kFull * kCols, it.q0,
                     it.b * co.q_z_b + it.h * co.q_z_h);
    }
    for (int t = 0; t < ntiles; ++t, ++g) {
      const int s = g % kStages;
      if (g >= kStages) mbar_wait(empty0 + 8 * s, (g / kStages - 1) & 1);
      // the copies first, then the bias under them; the stage is full once
      // the copies' bytes have landed and all 32 lanes have arrived
      if (lane == 0) {
        mbar_expect_tx(full0 + 8 * s, 2 * G::kTileBytes);
        const uint32_t ks = base + G::kStage0 + s * G::kStageBytes;
#pragma unroll
        for (int p = 0; p < G::kFull; ++p) {
          load_box<M4>(ks + p * G::kTilePart, kmap, full0 + 8 * s, kv_col,
                       p * kCols, t * kKeys, kv_z);
          load_box<M4>(ks + G::kTileBytes + p * G::kTilePart, vmap,
                       full0 + 8 * s, kv_col, p * kCols, t * kKeys, kv_z);
        }
        if constexpr (G::kTail) {
          const int pt = G::kFull * G::kTilePart;
          load_box<M4>(ks + pt, ktail, full0 + 8 * s, kv_col,
                       G::kFull * kCols, t * kKeys, kv_z);
          load_box<M4>(ks + G::kTileBytes + pt, vtail, full0 + 8 * s, kv_col,
                       G::kFull * kCols, t * kKeys, kv_z);
        }
      }
      if constexpr (BIAS) {
        float* bs = reinterpret_cast<float*>(smem + G::kBias + s * kKeys * 4);
        const float* bb = bias + static_cast<long long>(it.b) * K;
#pragma unroll
        for (int c = lane; c < kKeys; c += 32) {
          const int key = t * kKeys + c;
          const float x = __ldg(bb + min(key, K - 1));  // no branch
          bs[c] = key < K ? x * kLog2e : -INFINITY;
        }
      }
      mbar_arrive(full0 + 8 * s);
    }
  }
}

// Consumer warpgroup w: query rows q0 + 64 w .. q0 + 64 w + 63 of each of
// the block's items. Each issue of its products (tile 0's q.k; tile t's
// q.k with tile t - 1's p.v; the last tile's p.v) waits for its turn
// (named barrier 1 + w) and hands the turn to the other warpgroup after
// it; warpgroup 1 hands none on after its last, so that each named barrier
// ends with as many arrivals as waits. A stage is released once both
// warpgroups' threads are done with it, the q buffer once they hold q in
// registers. The output leaves by TMA from this warpgroup's output tile,
// which the next item's output waits to have been read.
template <int D, bool BIAS>
__device__ __forceinline__ void consume(uint8_t* smem, uint32_t base, int L,
                                        int K, int H, int items,
                                        float scale_log2, int w) {
  using G = Geo<D>;
  const uint32_t full0 = base + G::kBars;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t qfull = empty0 + 8 * kStages;
  const uint32_t qempty = qfull + 8;
  const uint32_t ofull0 = qempty + 8;
  const uint32_t oempty0 = ofull0 + 8 * kConsumers;
  const int tid = threadIdx.x % 128;
  const int t4 = tid % 4;
  const int row = (tid / 32) * 16 + (tid % 32) / 4;  // g of the 64 rows
  const int mine = kTurnBarrier + w, other = kTurnBarrier + 1 - w;
  const int nq = (L + kRows - 1) / kRows;
  const int ntiles = (K + kKeys - 1) / kKeys;
  const auto dk = [&](int st) {
    return make_desc(base + G::kStage0 + st * G::kStageBytes, kGroupBytes,
                     1);
  };
  const auto dv = [&](int st) {
    return make_desc(base + G::kStage0 + st * G::kStageBytes + G::kTileBytes,
                     kGroupBytes, 1);
  };
  // the tail part of stage st's k and v tiles (64-byte rows)
  const auto dkt = [&](int st) {
    return make_tail_desc(base + G::kStage0 + st * G::kStageBytes +
                          G::kFull * G::kTilePart);
  };
  const auto dvt = [&](int st) {
    return make_tail_desc(base + G::kStage0 + st * G::kStageBytes +
                          G::kTileBytes + G::kFull * G::kTilePart);
  };
  // warpgroup 0 takes the first turn
  if (w == 0) bar_arrive(mine);
  int g = 0;  // key tiles consumed
  int j = 0;  // items
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++j) {
    const Item it(i, nq, H);
    const bool last_item = i + static_cast<int>(gridDim.x) >= items;
    Rows<D, BIAS> x;
    // tile t's softmax, its bias from stage st
    const auto softmax = [&](int t, int st) {
      const float* bs =
          reinterpret_cast<const float*>(smem + G::kBias + st * kKeys * 4);
      tile_softmax<BIAS>(
          x.s, x.m, x.l, x.c,
          [&](int jj) {
            return *reinterpret_cast<const float2*>(bs + 8 * jj + 2 * t4);
          },
          K - t * kKeys, t4, scale_log2);
    };
    const auto qk = [&](int st) {
      x.qk(dk(st));
      if constexpr (G::kTail) x.qk_tail(dkt(st));
    };
    const auto pv = [&](int st) {
      if constexpr (G::kTail)
        x.pv(dv(st), dvt(st));
      else
        x.pv(dv(st), 0);
    };
    mbar_wait(qfull, j & 1);
    x.load_q(smem, w, tid);
    // this thread's q is in its registers: once all are, the buffer may be
    // refilled
    mbar_arrive(qempty);
    // tile 0: q.k, softmax
    mbar_wait(full0 + 8 * (g % kStages), (g / kStages) & 1);
    bar_sync(mine);
    wg_fence();
    qk(g % kStages);
    wg_commit();
    bar_arrive(other);
    wg_wait<0>();
    hold(x.s);
    softmax(0, g % kStages);
    tile_split(x.s, x.ph, x.pl);
    // tile t: q.k of t, O's rescale by t - 1's softmax under it, and p.v
    // of t - 1 in one turn; then t's softmax under that p.v
    for (int t = 1; t < ntiles; ++t) {
      const int st = (g + t) % kStages;
      const int prev = (g + t - 1) % kStages;
      mbar_wait(full0 + 8 * st, ((g + t) / kStages) & 1);
      bar_sync(mine);
      wg_fence();
      qk(st);
      wg_commit();
      x.rescale();  // q.k does not touch O
      wg_fence();
      pv(prev);
      wg_commit();
      bar_arrive(other);
      wg_wait<1>();
      hold(x.s);
      softmax(t, st);
      wg_wait<0>();
      x.hold_all();
      // stage prev is read by this thread: its warp's q.k and p.v are
      // done, and so is its softmax's read of the bias
      mbar_arrive(empty0 + 8 * prev);
      tile_split(x.s, x.ph, x.pl);
    }
    // the last tile's p.v
    g += ntiles;
    x.rescale();
    bar_sync(mine);
    wg_fence();
    pv((g - 1) % kStages);
    wg_commit();
    if (w == 0 || !last_item) bar_arrive(other);
    wg_wait<0>();
    x.hold_all();
    mbar_arrive(empty0 + 8 * ((g - 1) % kStages));
    // the last item's output has left this warpgroup's output tile; this
    // one's goes to it, visible to TMA, and to the storer warp
    if (j > 0) mbar_wait(oempty0 + 8 * w, (j - 1) & 1);
    x.stage_out(base + G::kO0 + w * G::kWgOBytes, row, t4);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(ofull0 + 8 * w);
  }
}

// The producer warpgroup's second warp: lane 0 stores each item's output
// tiles by TMA, each once its consumer warpgroup has staged it, and hands
// the tile back once TMA has read it. TMA clips rows past L (and, on a 4-d
// map, columns past d).
template <int D, bool M4>
__device__ __forceinline__ void store_out(const CUtensorMap* omap,
                                          const CUtensorMap* otail,
                                          uint32_t base, int L, int H,
                                          int items, const Coords& co) {
  using G = Geo<D>;
  const uint32_t ofull0 = base + G::kBars + 8 * (2 * kStages + 2);
  const uint32_t oempty0 = ofull0 + 8 * kConsumers;
  const int nq = (L + kRows - 1) / kRows;
  if (threadIdx.x % 32 != 0) return;
  int j = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++j) {
    const Item it(i, nq, H);
    for (int w = 0; w < kConsumers; ++w) {
      mbar_wait(ofull0 + 8 * w, j & 1);
#pragma unroll
      for (int p = 0; p < G::kFull; ++p) {
        if constexpr (M4)
          tma_store_4d(omap, base + G::kO0 + w * G::kWgOBytes + p * G::kOPart,
                       p * kCols, it.h * co.q_col_h, it.q0 + w * kWgRows,
                       it.b * co.q_z_b + it.h * co.q_z_h);
        else
          tma_store(omap, base + G::kO0 + w * G::kWgOBytes + p * G::kOPart,
                    it.h * co.q_col_h + p * kCols, it.q0 + w * kWgRows,
                    it.b * co.q_z_b + it.h * co.q_z_h);
      }
      if constexpr (G::kTail)
        tma_store_4d(otail,
                     base + G::kO0 + w * G::kWgOBytes + G::kFull * G::kOPart,
                     G::kFull * kCols, it.h * co.q_col_h, it.q0 + w * kWgRows,
                     it.b * co.q_z_b + it.h * co.q_z_h);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(oempty0 + 8 * w);
    }
  }
  bulk_wait();
}

// scale_log2 = log2(e) / sqrt(d). A persistent block: items (tile of 128
// query rows, head, batch row) blockIdx.x, + gridDim.x, ... D: d rounded up
// to 32; M4: the maps are 4-d (encode4), as every width but d = 128 needs.
// The tail part's maps (qtail, ktail, vtail, otail) are read where D % 64
// = 32 only.
template <int D, bool M4, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
attn_packed_kernel_wgmma128(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap omap,
                            const float* __restrict__ bias, int L, int K,
                            int H, int items, Coords co, float scale_log2,
                            const __grid_constant__ CUtensorMap qtail,
                            const __grid_constant__ CUtensorMap ktail,
                            const __grid_constant__ CUtensorMap vtail,
                            const __grid_constant__ CUtensorMap otail) {
  using G = Geo<D>;
  static_assert(M4 || D == 128, "a 3-d map takes d = D = 128 only");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);

  if (threadIdx.x == 0) {
    const uint32_t full0 = base + G::kBars;
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer's lanes
      mbar_init(full0 + 8 * (kStages + s), 128 * kConsumers);  // each thread
    }
    mbar_init(full0 + 16 * kStages, 1);               // q full
    mbar_init(full0 + 16 * kStages + 8, 128 * kConsumers);  // q empty
    for (int w = 0; w < kConsumers; ++w) {
      mbar_init(full0 + 8 * (2 * kStages + 2 + w), 128);  // output staged
      mbar_init(full0 + 8 * (2 * kStages + 2 + kConsumers + w), 1);  // read
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the roles, by a warpgroup index read from lane 0 (warp-uniform to
  // ptxas: a split on threadIdx.x serializes wgmma, C7520), in one if /
  // else that never reconverges (else ptxas ignores setmaxnreg, C7508)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x / 32 == 4 * kConsumers)
      produce<D, M4, BIAS>(&qmap, &kmap, &vmap, &qtail, &ktail, &vtail, bias,
                           smem, base, L, K, H, items, co);
    else if (threadIdx.x / 32 == 4 * kConsumers + 1)
      store_out<D, M4>(&omap, &otail, base, L, H, items, co);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    consume<D, BIAS>(smem, base, L, K, H, items, scale_log2, wg);
  }
}

template <int D, bool M4, bool BIAS>
cudaError_t launch(const Maps& mp, const float* bias, int B, int H, int L,
                   int K, const Coords& co, float scale_log2,
                   cudaStream_t stream) {
  const auto kernel = attn_packed_kernel_wgmma128<D, M4, BIAS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::kSmem);
  if (err != cudaSuccess) return err;
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long items = static_cast<long long>((L + kRows - 1) / kRows) *
                          H * B;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);
  kernel<<<grid, kThreads, Geo<D>::kSmem, stream>>>(
      mp.q, mp.k, mp.v, mp.o, bias, L, K, H, static_cast<int>(items), co,
      scale_log2, mp.qt, mp.kt, mp.vt, mp.ot);
  return cudaGetLastError();
}

template <int D, bool M4>
cudaError_t launch_d(const Maps& mp, const float* bias, int B, int H, int L,
                     int K, const Coords& co, float scale_log2,
                     cudaStream_t stream) {
  return bias ? launch<D, M4, true>(mp, bias, B, H, L, K, co, scale_log2,
                                    stream)
              : launch<D, M4, false>(mp, bias, B, H, L, K, co, scale_log2,
                                     stream);
}

}  // namespace

// C entry, bound with ctypes: bfloat16 q, k, v and out at d = 65..128 with
// d % 8 = 0, optional float32 (B, K) bias (null for none), q, k, v and out
// 16-byte aligned; layouts as samt_attention_wgmma's (0 token-major,
// kernel K1; 1 head-split, kernel K2; kv_shared 1 for a context shared by
// the batch). d = 128 runs on 3-d maps of whole token rows, the other
// widths on 4-d maps of head rows, in D = d rounded up to 32 columns.
// Returns the CUDA error of the launch (0 on success),
// cudaErrorInvalidValue for what the kernel does not take or a tensor map
// that cannot be encoded.
extern "C" int samt_attention_wgmma128(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* out, int B, int H, int L, int K,
                                       int d, int layout, int kv_shared,
                                       float scale, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if ((layout != 0 && layout != 1) || B <= 0 || H <= 0 || L <= 0 || K <= 0 ||
      B > 65535 || H > 65535 || d < 65 || d > 128 || d % 8 != 0 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Maps mp;
  Coords co;
  bool ok;
  if (d == 128) {
    // out as q's layout, in boxes of a warpgroup's 64 rows
    const long long E = static_cast<long long>(H) * d;
    ok = layout_maps(q, k, v, B, H, L, K, d, layout, kv_shared, kRows, kKeys,
                     &mp.q, &mp.k, &mp.v, &co) &&
         (layout == 0
              ? encode(&mp.o, out, d, E, L, B, 2 * E, 2 * E * L, kWgRows)
              : encode(&mp.o, out, d, d, L, static_cast<long long>(B) * H,
                       2 * d, 2LL * d * L, kWgRows));
  } else {
    ok = layout_maps4(q, k, v, out, B, H, L, K, d, layout, kv_shared, kCols,
                      kRows, kKeys, kWgRows, &mp.q, &mp.k, &mp.v, &mp.o,
                      &co) &&
         (d > 96 ||
          layout_maps4(q, k, v, out, B, H, L, K, d, layout, kv_shared, 32,
                       kRows, kKeys, kWgRows, &mp.qt, &mp.kt, &mp.vt, &mp.ot,
                       &co));
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* bb = static_cast<const float*>(bias);
  const float sl2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return static_cast<int>(
        launch_d<128, false>(mp, bb, B, H, L, K, co, sl2, s));
  return static_cast<int>(
      d > 96 ? launch_d<128, true>(mp, bb, B, H, L, K, co, sl2, s)
             : launch_d<96, true>(mp, bb, B, H, L, K, co, sl2, s));
}
