// Two bf16 matrix-product probes for Hopper (sm_90a) on the tensor cores
// (mma.sync fed by ldmatrix, f32 accumulate, one rounding to bf16 at the end).
//
// They replace the two Pallas TPU probes of tools/pallas_conv_exp.py:
//
// * mm_grid_forward replaces bench_mosaic_mm: C = A @ B, (m, k) @ (k, n).
//   The TPU kernel walks a sequential grid of 8192-row blocks; here the grid
//   is parallel, one block for each 64 x BN tile of C, and k is streamed
//   through shared memory in chunks of 64 with cp.async, three chunks in
//   flight or in use, so a block waits for device memory once, not once a
//   chunk.  Bound: bytes.  At the RDB's shapes (8192 x 192 @ 192 x 192) the
//   product reads and writes 6.4 MB for 0.6 GFLOP, about 94 FLOP a byte
//   against the card's 295, and the whole of it takes less time than a
//   launch.  A block holds 68 KB of shared memory at BN = 96, so three
//   blocks share an SM and all 384 of that shape run at once.
//
// * mm_resident_forward replaces bench_mosaic_mm_vmem: the same product
//   repeated `reps` times inside the kernel and summed in f32.  The TPU
//   kernel keeps all of A and B in VMEM; a block here has 227 KB, so each
//   block loads its 64-row slice of A (all of k) and a BN-column slice of B
//   (all of k) into shared memory ONCE and then runs the reps products from
//   shared memory, with no device-memory read in the loop.  At k = 576,
//   n = 192 that is 75 KB of A beside 120 KB of B's column half (BN = 96).
//   Bound: operations (2 m k n reps).  What it reads is how fast mma.sync
//   fed by ldmatrix from shared memory keeps the tensor cores busy: each
//   warp loads 2 + NF fragments for 4 NF products a k step, and at k = 576
//   one block of four warps has an SM to itself.
//
// m is a multiple of 64, k of 16, n of 32 * NF; the wrapper picks NF.  Only
// the widths the experiment tool's shapes reach are built (mm_grid 3 and 5,
// mm_resident 3, 4 and 5), and NF = 1, which takes every other n.

#include "mma_tile.cuh"

namespace {

using tile::bf16;
using tile::kSkew;

constexpr int kThreads = 128;  // four warps, 2 x 2 over the block's tile
constexpr int kBM = 64;        // rows of C a block
constexpr int kBK = 64;        // k chunk of mm_grid
constexpr int kStages = 3;     // k chunks of mm_grid in flight or in use

template <int NF>
__device__ __forceinline__ void store_tile(tile::FragC (&acc)[2][NF], bf16* c, int n, int row0,
                                           int col0) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      tile::store_bf16(acc[i][j],
                       [&](int r) { return c + (size_t)(row0 + i * 16 + r) * n + col0 + j * 16; });
}

template <int NF>
__global__ void __launch_bounds__(kThreads) mm_grid_kernel(const bf16* __restrict__ a,
                                                           const bf16* __restrict__ b,
                                                           bf16* __restrict__ c, int k, int n) {
  constexpr int BN = 32 * NF, LDA = kBK + kSkew, LDB = BN + kSkew;
  constexpr int kStageElems = kBM * LDA + kBK * LDB;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);  // kStages x (A chunk, B chunk)
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * BN;
  const int chunks = (k + kBK - 1) / kBK;

  // starts the copy of k chunk `chunk` into its stage; one group a call, so
  // that the groups in flight can be counted
  auto start_copy = [&](int chunk) {
    if (chunk < chunks) {
      const int k0 = chunk * kBK, kc = min(kBK, k - k0);
      bf16* a_s = stages + (chunk % kStages) * kStageElems;
      tile::copy_rows_async(a_s, LDA, a + (size_t)row0 * k + k0, k, kBM, kc / 8);
      tile::copy_rows_async(a_s + kBM * LDA, LDB, b + (size_t)k0 * n + col0, n, kc, BN / 8);
    }
    tile::cp_async_commit();
  };

  tile::FragC acc[2][NF];
  tile::zero<NF>(acc);
  for (int chunk = 0; chunk < kStages - 1; ++chunk) start_copy(chunk);
  for (int chunk = 0; chunk < chunks; ++chunk) {
    start_copy(chunk + kStages - 1);  // into the stage the products before this one read
    tile::cp_async_wait<kStages - 1>();
    __syncthreads();
    const bf16* a_w = stages + (chunk % kStages) * kStageElems + wr * 32 * LDA;
    const bf16* b_w = stages + (chunk % kStages) * kStageElems + kBM * LDA + wc * 16 * NF;
    tile::mma_tile<NF>(tile::RowCursor{a_w}, LDA, 16 * LDA, b_w, LDB, min(kBK, k - chunk * kBK) / 16,
                       acc);
    __syncthreads();
  }
  store_tile<NF>(acc, c, n, row0 + wr * 32, col0 + wc * 16 * NF);
}

template <int NF>
__global__ void __launch_bounds__(kThreads) mm_resident_kernel(const bf16* __restrict__ a,
                                                               const bf16* __restrict__ b,
                                                               bf16* __restrict__ c, int k, int n,
                                                               int reps) {
  constexpr int BN = 32 * NF, LDB = BN + kSkew;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = k + kSkew;
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + kBM * lda;
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * BN;

  tile::copy_rows(a_s, lda, a + (size_t)row0 * k, k, kBM, k / 8);
  tile::copy_rows(b_s, LDB, b + col0, n, k, BN / 8);
  __syncthreads();

  const bf16* a_w = a_s + wr * 32 * lda;
  tile::FragC acc[2][NF];
  tile::zero<NF>(acc);
  for (int rep = 0; rep < reps; ++rep) {
    // every repetition reads its fragments from shared memory again
    asm volatile("" ::: "memory");
    tile::mma_tile<NF>(tile::RowCursor{a_w}, lda, 16 * lda, b_s + wc * 16 * NF, LDB, k / 16, acc);
  }
  store_tile<NF>(acc, c, n, row0 + wr * 32, col0 + wc * 16 * NF);
}

size_t resident_smem_bytes(int k, int nf) {
  return sizeof(bf16) * ((size_t)kBM * (k + kSkew) + (size_t)k * (32 * nf + kSkew));
}

bool bad_shape(int m, int k, int n, int nf) {
  return nf < 1 || m <= 0 || k <= 0 || m % kBM || k % 16 || n % (32 * nf);
}

template <int NF>
int launch_grid(const bf16* a, const bf16* b, bf16* c, int m, int k, int n, cudaStream_t s) {
  const size_t smem = sizeof(bf16) * kStages * (kBM * (kBK + kSkew) + kBK * (32 * NF + kSkew));
  cudaError_t err = cudaFuncSetAttribute(mm_grid_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mm_grid_kernel<NF><<<dim3(n / (32 * NF), m / kBM), kThreads, smem, s>>>(a, b, c, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <int NF>
int launch_resident(const bf16* a, const bf16* b, bf16* c, int m, int k, int n, int reps,
                    cudaStream_t s) {
  const size_t smem = resident_smem_bytes(k, NF);
  cudaError_t err = cudaFuncSetAttribute(mm_resident_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mm_resident_kernel<NF><<<dim3(n / (32 * NF), m / kBM), kThreads, smem, s>>>(a, b, c, k, n, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c (m, n) = a (m, k) @ b (k, n), all bf16 row-major.  nf: column fragments
// of one warp, 1, 3 or 5; a block's tile of C is 64 x 32 nf.  Returns the
// cudaError_t of the launch.
extern "C" int mm_grid_forward(const void* a, const void* b, void* c, int m, int k, int n, int nf,
                               void* stream) {
  if (bad_shape(m, k, n, nf)) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  bf16* pc = static_cast<bf16*>(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return launch_grid<1>(pa, pb, pc, m, k, n, s);
    case 3: return launch_grid<3>(pa, pb, pc, m, k, n, s);
    case 5: return launch_grid<5>(pa, pb, pc, m, k, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// c (m, n) = bf16(sum over reps of a @ b), the sum kept in f32.  nf: 1, 3, 4 or 5.
extern "C" int mm_resident_forward(const void* a, const void* b, void* c, int m, int k, int n,
                                   int reps, int nf, void* stream) {
  if (bad_shape(m, k, n, nf) || reps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  bf16* pc = static_cast<bf16*>(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return launch_resident<1>(pa, pb, pc, m, k, n, reps, s);
    case 3: return launch_resident<3>(pa, pb, pc, m, k, n, reps, s);
    case 4: return launch_resident<4>(pa, pb, pc, m, k, n, reps, s);
    case 5: return launch_resident<5>(pa, pb, pc, m, k, n, reps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
