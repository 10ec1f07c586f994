// Building blocks of the wgmma attention kernels (fused_attention_wgmma.cu,
// fused_attention_wgmma128.cu, fused_attention_wgmma256.cu): the layouts'
// tensor-map coordinates, wgmma with p from registers, the exponential, the
// split of an f32 softmax weight into bf16 hi + lo, the online softmax of a
// 64-key tile, the 64-byte swizzle of a 32-column tail part, and the
// host's encoding of bf16 tensor maps: 3-d maps of whole token rows, and
// 4-d maps of head rows for widths whose boxes run past d.
// Each including file gets its own copy (anonymous namespace).
#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_async.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Element strides of the output and tensor-map coordinates of the inputs:
// q's tile of head h, batch row b is at column h * q_col_h, plane
// b * q_z_b + h * q_z_h of its map; k's and v's likewise with kv_*.
struct Coords {
  int q_col_h, q_z_b, q_z_h;
  int kv_col_h, kv_z_b, kv_z_h;
  long long o_batch, o_row, o_head;
};

// ---------------------------------------------------------------------------
// wgmma with A from registers (p.v)
// ---------------------------------------------------------------------------

// d (64 x 16) += a (64 x 16, registers) * b (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32) += a (64 x 16, registers) * b (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// a head row past its full 64-column parts: a 32-column part (the 64-byte
// swizzle) where D % 64 = 32. wgmma descriptors of such a part: layout type
// 2, 8-row groups 512 bytes apart
constexpr int kTailLayout = 2;
constexpr uint32_t kTailGroupBytes = 8 * 64;

// make_desc of such a part. A function of its own, so that make_desc keeps
// the arguments it has at every other call of a file (the compiler folds
// them into it before it is inlined: with other arguments at some calls,
// the d = 256 kernel's SASS changed, two instructions of its first q.k)
__device__ __forceinline__ uint64_t make_tail_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(kTailGroupBytes >> 4) << 32) |
         (static_cast<uint64_t>(kTailLayout) << 62);
}

// d (64 x 64) += a (64 x 16, registers) * b (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi), both
// rounded to nearest even; x in the low half, as an A fragment wants
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// ---------------------------------------------------------------------------
// the online softmax of one 64-key tile (the d = 128 and d = 256 kernels)
// ---------------------------------------------------------------------------

// A consumer warpgroup's scores of one 64-key tile, this thread's s: rows g
// and g + 8 of its warp's 16 (g = lane / 4), columns 2 (lane % 4) and + 1
// of each n8 tile. S -> p in place, the running max m (log2 units), this
// thread's share l of each row's sum, and the rescale c that O owes.
// bias_at(j): this thread's two bias values (times log2(e), -inf past K)
// of n8 tile j, with BIAS; past: the first masked key of the tile without
// it.
template <bool BIAS, typename BiasAt>
__device__ __forceinline__ void tile_softmax(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&c)[2],
                                             BiasAt bias_at, int past, int t4,
                                             float scale_log2) {
  float mx[2] = {-FLT_MAX, -FLT_MAX};
  if constexpr (BIAS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bl = bias_at(j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = fmaf(s[4 * j + e], scale_log2, (e & 1) ? bl.y : bl.x);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      }
    }
  } else {
    if (past < 64) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t4 + (e & 1) >= past) s[4 * j + e] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
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
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const float p =
        BIAS ? ex2(s[i] - m[r]) : ex2(fmaf(s[i], scale_log2, -m[r]));
    l[r] += p;
    s[i] = p;
  }
}

// p -> A fragments as bf16 hi and lo: keys 16 kk .. 16 kk + 15 are S's n8
// tiles 2 kk and 2 kk + 1, rows g and g + 8
__device__ __forceinline__ void tile_split(const float (&s)[32],
                                           uint32_t (&ph)[4][4],
                                           uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], ph[kk][e],
                 pl[kk][e]);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A 3-d bf16 map (`cols` columns, `rows` rows, `planes` planes; byte
// strides of a row and of a plane) read in boxes of min(d, 64) x box_rows
// (a head of d = 128 is two boxes, of d = 256 four), each box row swizzled
// by its own width.
inline bool encode(CUtensorMap* map, const void* ptr, int d, long long cols,
                   long long rows, long long planes, long long row_bytes,
                   long long plane_bytes, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(plane_bytes)};
  const int box_cols = d > 64 ? 64 : d;
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_128B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps and coordinates of a call in either layout. layout 0,
// token-major: q, out (B, L, H*d); k, v (B, K, H*d), or a shared (K, H*d)
// when kv_shared. layout 1, head-split: q, out (B, H, L, d); k, v
// (B, H, K, d), or a shared (1, H, K, d). q's boxes are q_rows rows, k's
// and v's kv_rows. False where a map cannot be encoded.
inline bool layout_maps(const void* q, const void* k, const void* v, int B,
                        int H, int L, int K, int d, int layout, int kv_shared,
                        int q_rows, int kv_rows, CUtensorMap* qm,
                        CUtensorMap* km, CUtensorMap* vm, Coords* co) {
  const long long E = static_cast<long long>(H) * d;
  if (layout == 0) {
    *co = Coords{d, 1, 0, d, kv_shared ? 0 : 1, 0, L * E, E, d};
    return encode(qm, q, d, E, L, B, 2 * E, 2 * E * L, q_rows) &&
           encode(km, k, d, E, K, kv_shared ? 1 : B, 2 * E, 2 * E * K,
                  kv_rows) &&
           encode(vm, v, d, E, K, kv_shared ? 1 : B, 2 * E, 2 * E * K,
                  kv_rows);
  }
  const long long planes = kv_shared ? H : static_cast<long long>(B) * H;
  *co = Coords{0, H, 1, 0, kv_shared ? 0 : H, 1, E * L,
               static_cast<long long>(d), static_cast<long long>(L) * d};
  return encode(qm, q, d, d, L, static_cast<long long>(B) * H, 2 * d,
                2LL * d * L, q_rows) &&
         encode(km, k, d, d, K, planes, 2 * d, 2LL * d * K, kv_rows) &&
         encode(vm, v, d, d, K, planes, 2 * d, 2LL * d * K, kv_rows);
}

// A 4-d bf16 map whose innermost extent is one head row of d columns:
// (d, heads, rows, planes), byte strides of a head, a row and a plane, read
// in boxes of box_cols x 1 x box_rows x 1 (64 columns: the 128-byte
// swizzle; 32: the 64-byte one). TMA zero-fills the columns past d on a
// load and clips them on a store, so a box that runs past the head row
// never reads or writes the next head's columns (a 3-d map's rows hold
// all H heads). Every stride must be a multiple of 16 bytes: d % 8 = 0.
inline bool encode4(CUtensorMap* map, const void* ptr, int d, int box_cols,
                    long long heads, long long rows, long long planes,
                    long long head_bytes, long long row_bytes,
                    long long plane_bytes, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(head_bytes),
                                 static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(plane_bytes)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 4-d maps (encode4) and coordinates of a call in either layout, as
// layout_maps' 3-d ones: a box is at (column, head coordinate, row, plane)
// = (c, h * col_h, row, b * z_b + h * z_h). Token-major: (d, H, rows, B)
// (col_h 1); head-split: (d, 1, rows, B * H) (col_h 0). box_cols: 64 or
// 32; q's boxes are q_rows rows, k's and v's kv_rows; out, where om is
// given, as q's layout in boxes of o_rows rows.
inline bool layout_maps4(const void* q, const void* k, const void* v,
                         const void* out, int B, int H, int L, int K, int d,
                         int layout, int kv_shared, int box_cols, int q_rows,
                         int kv_rows, int o_rows, CUtensorMap* qm,
                         CUtensorMap* km, CUtensorMap* vm, CUtensorMap* om,
                         Coords* co) {
  const long long E = static_cast<long long>(H) * d;
  const long long kv_planes =
      layout == 0 ? (kv_shared ? 1 : B)
                  : (kv_shared ? H : static_cast<long long>(B) * H);
  const long long q_planes = layout == 0 ? B : static_cast<long long>(B) * H;
  const long long heads = layout == 0 ? H : 1;
  const long long row_bytes = layout == 0 ? 2 * E : 2LL * d;
  if (layout == 0) {
    *co = Coords{1, 1, 0, 1, kv_shared ? 0 : 1, 0, L * E, E, d};
  } else {
    *co = Coords{0, H, 1, 0, kv_shared ? 0 : H, 1, E * L,
                 static_cast<long long>(d), static_cast<long long>(L) * d};
  }
  return encode4(qm, q, d, box_cols, heads, L, q_planes, 2LL * d, row_bytes,
                 row_bytes * L, q_rows) &&
         encode4(km, k, d, box_cols, heads, K, kv_planes, 2LL * d, row_bytes,
                 row_bytes * K, kv_rows) &&
         encode4(vm, v, d, box_cols, heads, K, kv_planes, 2LL * d, row_bytes,
                 row_bytes * K, kv_rows) &&
         (om == nullptr ||
          encode4(om, out, d, box_cols, heads, L, q_planes, 2LL * d,
                  row_bytes, row_bytes * L, o_rows));
}

// byte offset of (row, byte c of the row) in a box of 64-byte rows
// swizzled by 64 bytes (16-byte chunk c / 16 of row r at chunk c / 16 ^
// (r / 2) % 4), the box at a 512-byte boundary
__device__ __forceinline__ int swizzled64(int row, int c) {
  return row * 64 + ((((c >> 4) ^ ((row >> 1) & 3)) << 4) | (c & 15));
}

}  // namespace
