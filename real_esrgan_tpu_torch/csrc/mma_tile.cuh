// Warp-level bf16 tensor-core building blocks of fused_rdb.cu's f32 kernel
// (rdb_f32_split_kernel): mma.sync m16n8k16 (bf16 operands, f32 accumulators
// in registers) fed by ldmatrix from shared memory, and cp.async copies.
//
// nvcuda::wmma is not used: nvcc lowers wmma::load_matrix_sync here to four
// generic 32-bit loads a fragment and thread, plus a register transpose
// (MOVM) for a row-major B, 20 load instructions for 12 products a k step,
// and the load unit, not the tensor cores, sets the pace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

using bf16 = __nv_bfloat16;

struct FragA { uint32_t r[4]; };  // 16 x 16 of A, row-major: a0..a3 of m16n8k16
struct FragB { uint32_t r[4]; };  // 16 (k) x 16 (n) of B: b0, b1 of columns 0..7, then of 8..15
struct FragC { float r[8]; };     // 16 x 16 of C: c0..c3 of columns 0..7, then of 8..15

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix.x4 from this lane's own row address (a shared-memory address), for
// operands whose rows are not evenly spaced: lanes 0..15 give rows 0..15 of
// columns 0..7, lanes 16..31 the same rows of columns 8..15.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t row_address) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(row_address)
               : "memory");
}

// The same with the 8 x 8 blocks transposed: rows are k, columns n.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t row_address) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(row_address)
               : "memory");
}

__device__ __forceinline__ void mma(FragC& c, const FragA& a, const FragB& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c.r[0]), "+f"(c.r[1]), "+f"(c.r[2]), "+f"(c.r[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c.r[4]), "+f"(c.r[5]), "+f"(c.r[6]), "+f"(c.r[7])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[2]), "r"(b.r[3]));
}

// 16 bytes from device memory to shared memory without passing through
// registers (cp.async); zeros when !valid (src must still be an address
// inside the tensor).  Complete after cp_async_wait and a barrier.
__device__ __forceinline__ void cp_async_16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(shared_address(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Closes the group of this thread's cp.async copies started since the last
// commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most `Pending` of this thread's committed groups are still
// in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(Pending) : "memory");
}

}  // namespace tile
