// cp.async, ldmatrix and mma.sync helpers for the port's kernels (sm_90a).
// flash_attention.cu and nested_lowrank.cu still carry their own copies,
// whose signatures differ.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), lane = 4 * gid + tig:
//   A regs {(gid, 2tig..+1), (gid+8, 2tig..), (gid, 2tig+8..), (gid+8, 2tig+8..)}
//   B regs {(k 2tig..+1, n gid), (k 2tig+8..+9, n gid)}
//   C      {(gid, 2tig), (gid, 2tig+1), (gid+8, 2tig), (gid+8, 2tig+1)}
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; full == false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
// 4 bytes global -> shared (the path for rows not 16-byte aligned).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Byte offset of 16-byte chunk c of row r in a tile of CH chunks a row, the
// chunk index XOR-swizzled by the row's low three bits (ldmatrix reads of 8
// rows at one chunk column hit 8 different bank groups).
template <int CH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * CH + (c ^ (r & 7))) * 16u;
}

// Four 8x8 b16 matrices: lanes 8i..8i+7 address the 8 rows of matrix i,
// which lands in register i as (row lane / 4, cols 2 (lane % 4)..+1).
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// Four 8x8 b16 matrices, transposed: lanes 8i..8i+7 address the 8 rows of
// matrix i, which lands in register i as (row 2 (lane % 4)..+1, col lane / 4).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x split for 3xTF32: hi = tf32(x), lo = tf32(x - hi) (both rounded to
// nearest, ties away from zero; x - hi is exact in fp32), so that hi + lo
// carries x to about 2^-22 and hi * hi, hi * lo are exact in fp32.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// tf32_split's rounding by integer ops: adding half of TF32's last place
// to the magnitude's bits and clearing the 13 bits below it rounds to
// nearest, ties away from zero, as cvt.rna does (NaN payloads aside).  Five
// instructions where the two cvt.rna take nine, for kernels whose splits
// are most of their product phases' instructions.
__device__ __forceinline__ uint32_t tf32_round_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void tf32_split_int(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round_bits(x);
  lo = tf32_round_bits(x - __uint_as_float(hi));
}

// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), lane = 4 * gid + tig:
//   A regs {(gid, tig), (gid+8, tig), (gid, tig+4), (gid+8, tig+4)}
//   B regs {(k tig, n gid), (k tig+4, n gid)}
//   C      as m16n8k16's above.
// c (16x8 fp32) += a (16x8 tf32, row) * b (8x8 tf32, col).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round-to-nearest-even), lo in the low half:
// a C fragment's pair repacked as an A fragment's register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
