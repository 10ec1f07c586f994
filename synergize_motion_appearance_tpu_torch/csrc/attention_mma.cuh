// Building blocks of the mma.sync attention kernels (fused_attention_packed.cu,
// fused_attention_chunked.cu): a layout's strides, the exponential, the
// swizzle of a staged bf16 tile, ldmatrix, mma.sync m16n8k16 and the split of
// an f32 softmax weight into bf16 hi + lo. Each including file gets its own
// copy (anonymous namespace).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Element strides of a layout: q and out share (q_batch, q_row, q_head);
// k and v share (kv_batch, kv_row, kv_head), with kv_batch 0 for a context
// shared by the batch. Within a head the d values are contiguous.
struct Strides {
  long long q_batch, q_row, q_head;
  long long kv_batch, kv_row, kv_head;
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of 16-byte chunk c of row r in a tile of rows of NC chunks:
// the chunk is XORed with the row's place among the rows of one 128-byte
// span, so 8 consecutive rows at one chunk hit 8 distinct bank groups.
template <int NC>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kPer = NC >= 8 ? 1 : 8 / NC;  // rows per 128 bytes
  return static_cast<uint32_t>(r * NC * 16 + ((c ^ ((r / kPer) % NC)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi), both
// rounded to nearest even; x in the low half, as an mma fragment wants
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

}  // namespace
