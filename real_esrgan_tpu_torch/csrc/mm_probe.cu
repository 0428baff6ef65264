// Two bf16 matrix-product probes for Hopper (sm_90a) on the tensor cores,
// f32 accumulate, one rounding to bf16 at the end.
//
// * mm_grid_forward replaces tools/pallas_conv_exp.py::bench_mosaic_mm (the
//   pallas_call at :119): C = A @ B, (m, k) @ (k, n).  It is bound by bytes:
//   at the RDB's shapes (8192 x 192 @ 192 x 192, and k = 576) the product
//   moves 6.4 (12.7) MB for 0.6 (1.8) GFLOP, 94 (143) FLOP a byte against the
//   card's 295, so the design is about keeping bytes in flight and reading
//   each byte of device memory once.  One block computes a 64 x BN tile of C,
//   BN the whole of n up to 256, so every row of A is read once and B, small,
//   comes from L2.  One producer warp walks k in chunks of 64 and, for each,
//   issues TMA loads of A's 64 x 64 box and B's BN / 64 boxes of 64 x 64 into
//   a ring of `stages` shared-memory stages (up to six, 192 KB at BN = 192),
//   armed on a `full` mbarrier; the consumer warpgroup waits on it, runs
//   wgmma m64nBNk16 from shared memory (A K-major, B MN-major, both 128-byte
//   swizzled, hopper.cuh), keeps one chunk's group in flight and releases
//   the stage before it on an `empty` mbarrier.  Ragged k and columns past n
//   arrive as zeros from TMA.  The epilogue rounds to bf16 into the first
//   stage, laid out as 128-byte-swizzled boxes, and one thread stores them
//   with TMA, which writes nothing past n: on the H100 that is faster than
//   storing from registers, whose 16-byte row pieces leave each 32-byte
//   sector half written.  ops/mm_probe.py::mm_grid_plan states the
//   geometry, and the launch refuses any other.
//
// * mm_resident_forward replaces bench_mosaic_mm_vmem: the same product
//   repeated `reps` times inside the kernel and summed in f32.  The TPU
//   kernel keeps all of A and B in VMEM; a block here has 227 KB, so each
//   block loads its 64-row slice of A (all of k) and a BN-column slice of B
//   (all of k) into shared memory ONCE and then runs the reps products from
//   shared memory, with no device-memory read in the loop.  At k = 576,
//   n = 192 that is 75 KB of A beside 120 KB of B's column half (BN = 96).
//   Bound: operations (2 m k n reps).  What it reads is how fast mma.sync
//   fed by ldmatrix (mma_tile.cuh) from shared memory keeps the tensor cores
//   busy: each warp loads 2 + NF fragments for 4 NF products a k step, and
//   at k = 576 one block of four warps has an SM to itself.  m is a multiple
//   of 64, k of 16, n of 32 NF; the wrapper picks NF (5, 4, 3 or 1).

#include <algorithm>

#include "hopper.cuh"
#include "mma_tile.cuh"

namespace {

using tile::bf16;
using tile::kSkew;

constexpr int kThreads = 128;  // mm_resident: four warps, 2 x 2 over the block's tile
constexpr int kBM = 64;        // rows of C a block

// mm_grid
constexpr int kBK = 64;                // k chunk: one 128-byte swizzle row of bf16
constexpr int kAtom = 64;              // columns of B in one TMA box (128 bytes)
constexpr int kMaxBN = 256;            // the widest wgmma
constexpr int kBoxBytes = 64 * 128;    // one TMA box: 64 rows of 128 bytes
constexpr int kMaxStages = 6;
constexpr int kAlign = 1024;           // the 128-byte swizzle repeats every 1024 bytes
constexpr int kConsumers = 128;        // one warpgroup: warps 0-3
constexpr int kGridThreads = kConsumers + 32;  // and the producer warp
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may have

struct GridPlan {
  int bn, stages, grid_x, grid_y, smem_bytes, tx_bytes;
};

// The launch geometry of mm_grid, as ops/mm_probe.py::mm_grid_plan states it:
// a stage is A's box and B's bn / 64 boxes, each full box counted in the
// stage's expected transaction bytes; two mbarriers (full, empty) a stage;
// 1024 bytes to align the ring.
GridPlan grid_plan(int m, int k, int n) {
  GridPlan p;
  p.bn = std::min(kMaxBN, (n + kAtom - 1) / kAtom * kAtom);
  p.tx_bytes = kBoxBytes * (1 + p.bn / kAtom);
  const int chunks = (k + kBK - 1) / kBK;
  const int fit = (kSmemLimit - kAlign) / (p.tx_bytes + 16);
  p.stages = std::min({chunks, kMaxStages, fit});
  p.grid_x = (n + p.bn - 1) / p.bn;
  p.grid_y = m / kBM;
  p.smem_bytes = kAlign + p.stages * (p.tx_bytes + 16);
  return p;
}

template <int BN>
__global__ void __launch_bounds__(kGridThreads) mm_grid_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c, int k, int n, int stages) {
  constexpr int kStageBytes = kBoxBytes * (1 + BN / kAtom);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + (kAlign - hopper::smem_u32(smem_raw) % kAlign) % kAlign;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kStageBytes);
  uint64_t* empty = full + stages;
  // warp-uniform as far as the compiler can see (a broadcast lane), so the
  // consumer's wgmma sit on no divergent path
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * BN;
  const int chunks = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_mbarrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer: one thread issues every load
    if (lane == 0) {
      for (int chunk = 0; chunk < chunks; ++chunk) {
        const int s = chunk % stages;
        const uint32_t round = chunk / stages;
        hopper::mbar_wait(&empty[s], (round & 1) ^ 1);  // round 0 passes at once
        unsigned char* stage = ring + s * kStageBytes;
        hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
        hopper::tma_load_2d(stage, &map_a, &full[s], chunk * kBK, row0);
#pragma unroll
        for (int j = 0; j < BN / kAtom; ++j)
          hopper::tma_load_2d(stage + kBoxBytes * (1 + j), &map_b, &full[s], col0 + j * kAtom,
                              chunk * kBK);
      }
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int s = chunk % stages;
    hopper::mbar_wait(&full[s], (chunk / stages) & 1);
    const uint32_t a_s = hopper::smem_u32(ring + s * kStageBytes), b_s = a_s + kBoxBytes;
    const int steps = min(kBK, k - chunk * kBK) / 16;
    hopper::fence_operands(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // unrolled: measurably faster at k = 576
      if (kk < steps)
        hopper::Wgmma<BN>::mma(acc, hopper::smem_desc(a_s + 32 * kk, 16, 1024),
                               hopper::smem_desc(b_s + 2048 * kk, kBoxBytes, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the chunk before this one has been read
    hopper::fence_operands(acc);
    if (chunk > 0) hopper::mbar_arrive(&empty[(chunk - 1) % stages]);  // every consumer thread
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);

  // every chunk is consumed: stage 0 becomes C's tile, BN / 64 boxes of 64
  // rows x 128 bytes, 128-byte swizzled like the loads
  unsigned char* tile_c = ring;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + lane / 4 + 8 * half;
      const uint32_t offset = (col / kAtom) * kBoxBytes + r * 128 + (col % kAtom) * 2;
      *reinterpret_cast<__nv_bfloat162*>(tile_c + (offset ^ ((r % 8) << 4))) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1, kConsumers);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < BN / kAtom; ++j)
      if (col0 + j * kAtom < n)
        hopper::tma_store_2d(&map_c, tile_c + j * kBoxBytes, col0 + j * kAtom, row0);
    hopper::bulk_commit();
    hopper::bulk_wait_read();
  }
}

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

template <int BN>
int launch_grid(const void* a, const void* b, bf16* c, int m, int k, int n, const GridPlan& p,
                cudaStream_t s) {
  CUtensorMap map_a, map_b, map_c;
  int err = hopper::encode_bf16_2d(&map_a, a, m, k, kBM, kBK);
  if (err != 0) return err;
  err = hopper::encode_bf16_2d(&map_b, b, k, n, kBK, kAtom);
  if (err != 0) return err;
  err = hopper::encode_bf16_2d(&map_c, c, m, n, kBM, kAtom);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(mm_grid_kernel<BN>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          p.smem_bytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  mm_grid_kernel<BN><<<dim3(p.grid_x, p.grid_y), kGridThreads, p.smem_bytes, s>>>(
      map_a, map_b, map_c, k, n, p.stages);
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

// c (m, n) = a (m, k) @ b (k, n), all bf16 row-major, m a multiple of 64, k
// of 16, n of 32.  bn and stages must be grid_plan's for this shape (the
// wrapper passes mm_grid_plan's).  Returns 0, the cudaError_t of the launch,
// or hopper::kEncodeErrorBase + the CUresult of a failed tensor-map encode.
extern "C" int mm_grid_forward(const void* a, const void* b, void* c, int m, int k, int n, int bn,
                               int stages, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || m % kBM || k % 16 || n % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const GridPlan p = grid_plan(m, k, n);
  if (bn != p.bn || stages != p.stages) return static_cast<int>(cudaErrorInvalidValue);
  bf16* pc = static_cast<bf16*>(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.bn) {
    case 64: return launch_grid<64>(a, b, pc, m, k, n, p, s);
    case 128: return launch_grid<128>(a, b, pc, m, k, n, p, s);
    case 192: return launch_grid<192>(a, b, pc, m, k, n, p, s);
    case 256: return launch_grid<256>(a, b, pc, m, k, n, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The geometry mm_grid_forward launches at (m, k, n), into out[9]: bn, bk,
// stages, grid x, grid y, threads, dynamic shared-memory bytes, cluster size,
// expected transaction bytes a stage.  Returns 0, or cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int mm_grid_built_plan(int m, int k, int n, int* out) {
  if (m <= 0 || k <= 0 || n <= 0 || m % kBM || k % 16 || n % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const GridPlan p = grid_plan(m, k, n);
  const int values[9] = {p.bn, kBK, p.stages, p.grid_x, p.grid_y, kGridThreads, p.smem_bytes, 1,
                         p.tx_bytes};
  std::copy(values, values + 9, out);
  return 0;
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
