// Warp-level bf16 tensor-core tile product shared by conv3x3.cu,
// mm_probe.cu and fused_rdb.cu: mma.sync m16n8k16 (bf16 operands, f32
// accumulators in registers) fed by ldmatrix from shared memory.
//
// One warp owns a tile of 32 rows x (16 * NF) columns of the block's output:
// two row fragments by NF column fragments of 16 x 16.  For every k step of
// 16 it runs 2 + NF ldmatrix.x4 (512 bytes each) and 4 * NF mma.sync.
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

// Elements of padding after each shared-memory row of an operand: 16 bytes,
// so that eight consecutive rows (one ldmatrix phase, 16 bytes a row) start
// 16 bytes apart modulo 128 and touch every bank once, whenever the row
// itself is a multiple of 128 bytes.
constexpr int kSkew = 8;

struct FragA { uint32_t r[4]; };  // 16 x 16 of A, row-major: a0..a3 of m16n8k16
struct FragB { uint32_t r[4]; };  // 16 (k) x 16 (n) of B: b0, b1 of columns 0..7, then of 8..15
struct FragC { float r[8]; };     // 16 x 16 of C: c0..c3 of columns 0..7, then of 8..15

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of this lane's row for ldmatrix.x4 over a 16 x 16 tile whose
// rows lie ld elements apart: lanes 0..15 rows 0..15 of columns 0..7, lanes
// 16..31 the same rows of columns 8..15.  Rows must be 16-byte aligned.
__device__ __forceinline__ uint32_t lane_row(const bf16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  return shared_address(tile + (lane & 15) * ld + (lane >> 4) * 8);
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

__device__ __forceinline__ void load_a(FragA& f, const bf16* tile, int ld) {
  ldsm_x4(f.r, lane_row(tile, ld));
}

// tile: element (k, n) = (0, 0) of a row-major (k, n) matrix; the 8 x 8
// blocks are transposed on the way, which gives mma's column-major B.
__device__ __forceinline__ void load_b(FragB& f, const bf16* tile, int ld) {
  ldsm_x4_trans(f.r, lane_row(tile, ld));
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

template <int NF>
__device__ __forceinline__ void zero(FragC (&acc)[2][NF]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][j].r[e] = 0.f;
}

template <int NF>
struct Frags {
  FragA a[2];
  FragB b[NF];
};

template <int NF>
__device__ __forceinline__ void load_frags(Frags<NF>& f, const bf16* a, int lda, int a_frag_stride,
                                           const bf16* b, int ldb) {
  load_a(f.a[0], a, lda);
  load_a(f.a[1], a + a_frag_stride, lda);
#pragma unroll
  for (int j = 0; j < NF; ++j) load_b(f.b[j], b + j * 16, ldb);
}

template <int NF>
__device__ __forceinline__ void mma_frags(const Frags<NF>& f, FragC (&acc)[2][NF]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) mma(acc[i][j], f.a[i], f.b[j]);
}

// acc[i][j] += sum over steps of A_i(step) (16 x 16) @ B_j(step) (16 x 16),
// i < 2, j < NF, operands in shared memory.
// a: a cursor over the steps in order: a.ptr() is the first element of row
//    fragment 0 at the current step (lda elements between its rows; row
//    fragment 1 starts a_frag_stride elements further), a.advance() moves on.
// b: first element of column fragment 0 at step 0, ldb elements between its
//    rows; a step moves 16 rows down.
// Every row of a fragment must start on a 16-byte boundary.
template <int NF, typename ACursor>
__device__ __forceinline__ void mma_tile(ACursor a, int lda, int a_frag_stride,
                                         const bf16* __restrict__ b, int ldb, int steps,
                                         FragC (&acc)[2][NF]) {
  // two sets of fragments in registers: the loads of step s + 1 are started
  // before the products of step s
  Frags<NF> f0, f1;
  const size_t b_step = (size_t)16 * ldb;
  load_frags<NF>(f0, a.ptr(), lda, a_frag_stride, b, ldb);
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    a.advance();
    load_frags<NF>(f1, a.ptr(), lda, a_frag_stride, b + (s + 1) * b_step, ldb);
    mma_frags<NF>(f0, acc);
    if (s + 2 < steps) {
      a.advance();
      load_frags<NF>(f0, a.ptr(), lda, a_frag_stride, b + (s + 2) * b_step, ldb);
    }
    mma_frags<NF>(f1, acc);
  }
  if (s < steps) mma_frags<NF>(f0, acc);
}

// The A cursor of a plain row-major operand: a step moves 16 columns on.
struct RowCursor {
  const bf16* p;
  __device__ __forceinline__ const bf16* ptr() const { return p; }
  __device__ __forceinline__ void advance() { p += 16; }
};

// Rounds one 16 x 16 f32 accumulator to bf16 and writes it row-major,
// straight from the registers: lane l holds columns 2 (l % 4) and + 1 (and
// the same + 8) of rows l / 4 and l / 4 + 8, so four lanes write 16
// contiguous bytes of a row.  row_ptr(r) returns the address of the tile's
// first column in row r; it must be 4-byte aligned.
template <typename RowPtr>
__device__ __forceinline__ void store_bf16(const FragC& acc, RowPtr row_ptr) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* dst = row_ptr(g + half * 8) + c;
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(acc.r[half * 2], acc.r[half * 2 + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dst + 8) =
        __floats2bfloat162_rn(acc.r[4 + half * 2], acc.r[4 + half * 2 + 1]);
  }
}

// Copies rows x (vecs_per_row * 8) bf16 from device memory (row stride
// src_ld elements) into shared memory (row stride dst_ld), 16 bytes a
// thread, by all threads of the block.
__device__ __forceinline__ void copy_rows(bf16* dst, int dst_ld, const bf16* __restrict__ src,
                                          size_t src_ld, int rows, int vecs_per_row) {
  for (int i = threadIdx.x; i < rows * vecs_per_row; i += blockDim.x) {
    const int r = i / vecs_per_row, v = i % vecs_per_row;
    *reinterpret_cast<uint4*>(dst + r * dst_ld + v * 8) =
        __ldg(reinterpret_cast<const uint4*>(src + r * src_ld + v * 8));
  }
}

// 16 bytes from device memory to shared memory without passing through
// registers (cp.async); zeros when !valid (src must still be an address
// inside the tensor).  Complete after cp_async_wait_all and a barrier.
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

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// copy_rows with cp.async: returns at once; the data is there after a
// commit, a wait and a barrier.
__device__ __forceinline__ void copy_rows_async(bf16* dst, int dst_ld, const bf16* __restrict__ src,
                                                size_t src_ld, int rows, int vecs_per_row) {
  for (int i = threadIdx.x; i < rows * vecs_per_row; i += blockDim.x) {
    const int r = i / vecs_per_row, v = i % vecs_per_row;
    cp_async_16(dst + r * dst_ld + v * 8, src + r * src_ld + v * 8, true);
  }
}

}  // namespace tile
