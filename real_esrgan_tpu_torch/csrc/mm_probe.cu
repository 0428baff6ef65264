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
// * mm_resident_forward replaces bench_mosaic_mm_vmem (the pallas_call at
//   :159): the same product issued `reps` times inside the kernel, summed
//   in f32, each product in full from on-chip memory, with no device-memory
//   read inside the reps loop.  Bound: operations (2 m k n reps; at the gate's
//   shapes 32 products of 0.6 or 1.8 GFLOP).  The TPU kernel keeps all of A
//   and B in VMEM.  Here a block computes a 64 x BN tile of C (BN 192, 128 or
//   64, ops/mm_probe.py::mm_resident_plan) with two consumer warpgroups, each
//   of which owns one half of k:
//   - A stays in registers for the whole kernel, in wgmma's A-fragment
//     layout: each thread loads its 4 words a k step of its warpgroup's half
//     once, straight from device memory (k up to 576: 18 steps, 72
//     registers, beside BN / 2 accumulators);
//   - all of B's BN-column slice stays in shared memory, loaded once by TMA
//     on one mbarrier as 64 k x 64 column boxes, 128-byte swizzled; a column
//     box's k rows run on from one box to the next, so k step s starts
//     2048 s bytes in and LBO is the distance between column boxes;
//   - each warpgroup issues its k steps as wgmma m64nBNk16 with A from
//     registers and B MN-major through a descriptor, one commit group a
//     rep, into one accumulator; so every rep reads only B, from shared
//     memory: 64 FLOP a byte, against about 32 that the tensor cores need;
//   - at the end the second warpgroup's partial sums pass through the freed
//     shared memory, the first adds them once in f32, rounds to bf16 into
//     128-byte-swizzled boxes, and one thread stores them with TMA.
//   k is padded to whole 64-k boxes: A's steps past k load zeros and TMA
//   fills B's rows past k (and columns past n) with zeros, so every k step
//   of the kernel instance (BN, k boxes) is issued whole, unguarded.  At
//   (8192, 576) @ (576, 192) that is 128 blocks in one wave and 216 KB of B
//   a block.  m is a multiple of 64, k of 16 (up to 576), n of 32.

#include <cuda_bf16.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// the shapes both kernels take: m a multiple of 64, k of 16, n of 32
bool bad_shape(int m, int k, int n) {
  return m <= 0 || k <= 0 || n <= 0 || m % kBM || k % 16 || n % 32;
}

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

// mm_resident
constexpr int kResidentThreads = 256;   // two consumer warpgroups, one half of k each
constexpr int kMaxKBoxes = 9;           // k up to 576: 18 k steps of A a warpgroup in registers
constexpr int kResidentWidths[3] = {192, 128, 64};  // BN, widest first
constexpr int kStepBytes = 16 * 128;    // one k step of a column box: 16 rows of 128 bytes

struct ResidentPlan {
  int bn, k_boxes, grid_x, grid_y, smem_bytes, tx_bytes;
};

// B's slice (k boxes x BN / 64 column boxes), or the epilogue's f32 partial
// sums (256 BN bytes) and bf16 tile (128 BN), whichever is larger; 1024
// bytes to align it; one mbarrier
int resident_smem_bytes(int k_boxes, int bn) {
  return kAlign + std::max(k_boxes * (bn / kAtom) * kBoxBytes, 384 * bn) + 8;
}

// The launch geometry of mm_resident, as ops/mm_probe.py::mm_resident_plan
// states it: k in whole 64-k boxes; of the widths whose B slice fits shared
// memory, the one that leaves the fewest columns past n (the widest on a
// tie).  Returns false if none fits or k is past what the registers hold.
bool resident_plan(int m, int k, int n, ResidentPlan* p) {
  p->k_boxes = (k + kBK - 1) / kBK;
  p->bn = 0;
  int cover = 0;
  for (int bn : kResidentWidths) {
    const int c = (n + bn - 1) / bn * bn;
    if (resident_smem_bytes(p->k_boxes, bn) <= kSmemLimit && (p->bn == 0 || c < cover)) {
      p->bn = bn;
      cover = c;
    }
  }
  if (p->bn == 0 || p->k_boxes > kMaxKBoxes) return false;
  p->grid_x = (n + p->bn - 1) / p->bn;
  p->grid_y = m / kBM;
  p->smem_bytes = resident_smem_bytes(p->k_boxes, p->bn);
  p->tx_bytes = p->k_boxes * (p->bn / kAtom) * kBoxBytes;
  return true;
}

template <int BN, int KB>
__global__ void __launch_bounds__(kResidentThreads, 1) mm_resident_kernel(
    const __grid_constant__ CUtensorMap map_b, const __grid_constant__ CUtensorMap map_c,
    const bf16* __restrict__ a, int k, int n, int reps) {
  constexpr int KS = 2 * KB;  // k steps a warpgroup holds: half of k, padded to whole boxes
  constexpr int kColBoxes = BN / kAtom;
  constexpr int kTileBytes = KB * kColBoxes * kBoxBytes;
  constexpr int kRegion = kTileBytes > 384 * BN ? kTileBytes : 384 * BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tile_b = smem_raw + (kAlign - hopper::smem_u32(smem_raw) % kAlign) % kAlign;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile_b + kRegion);
  // warp-uniform as far as the compiler can see (a broadcast lane), so the
  // wgmma sit on no divergent path
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int group = warp / 4;  // the warpgroup: k steps KS group .. + KS - 1
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // all of B's slice, once: column box j's k boxes one after another
    hopper::mbar_arrive_expect_tx(bar, kTileBytes);
    for (int j = 0; j < kColBoxes; ++j)
      for (int kb = 0; kb < KB; ++kb)
        hopper::tma_load_2d(tile_b + (j * KB + kb) * kBoxBytes, &map_b, bar, col0 + j * kAtom,
                            kb * kBK);
  }

  // A, once: wgmma's A fragment of k step s is rows r and r + 8 (r = 16 (warp
  // % 4) + lane / 4), k 16 s + 2 (lane % 4) + {0, 1} and + 8; zeros past k
  uint32_t frag[KS][4];
  {
    const uint32_t* lo =
        reinterpret_cast<const uint32_t*>(a + (size_t)(row0 + 16 * (warp % 4) + lane / 4) * k) +
        lane % 4;
    const uint32_t* hi = lo + 4 * (size_t)k;  // eight rows on
    const int steps = k / 16;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int s = group * KS + i;
      const bool live = s < steps;
      frag[i][0] = live ? __ldg(lo + 8 * s) : 0u;
      frag[i][1] = live ? __ldg(hi + 8 * s) : 0u;
      frag[i][2] = live ? __ldg(lo + 8 * s + 4) : 0u;
      frag[i][3] = live ? __ldg(hi + 8 * s + 4) : 0u;
    }
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  hopper::mbar_wait(bar, 0);
  const uint64_t desc =
      hopper::smem_desc(hopper::smem_u32(tile_b) + kStepBytes * KS * group, KB * kBoxBytes, 1024);
  for (int rep = 0; rep < reps; ++rep) {
    hopper::fence_operands(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < KS; ++i)  // k step i of the half: 2048 bytes on (128 in the descriptor)
      hopper::WgmmaRSMN<BN>::mma(acc, frag[i], desc + (kStepBytes >> 4) * i, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // at most this rep's group and the one before in flight
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);

  // Every wgmma of the block has read B: the second warpgroup's partial sums
  // go to shared memory, one 16-byte piece a thread and four registers, and
  // the first adds them, rounds, and writes C's tile after them as BN / 64
  // boxes of 64 rows x 128 bytes, 128-byte swizzled like the loads.
  __syncthreads();
  float4* partial = reinterpret_cast<float4*>(tile_b);
  const int t = threadIdx.x % 128;
  if (group == 1) {
#pragma unroll
    for (int q = 0; q < BN / 8; ++q)
      partial[q * 128 + t] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncthreads();
  if (group == 0) {
    unsigned char* tile_c = tile_b + 256 * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float4 other = partial[j * 128 + t];
      const float sums[4] = {acc[4 * j] + other.x, acc[4 * j + 1] + other.y,
                             acc[4 * j + 2] + other.z, acc[4 * j + 3] + other.w};
      const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + lane / 4 + 8 * half;
        const uint32_t offset = (col / kAtom) * kBoxBytes + r * 128 + (col % kAtom) * 2;
        *reinterpret_cast<__nv_bfloat162*>(tile_c + (offset ^ ((r % 8) << 4))) =
            __floats2bfloat162_rn(sums[2 * half], sums[2 * half + 1]);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1, 128);
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < kColBoxes; ++j)
        if (col0 + j * kAtom < n)
          hopper::tma_store_2d(&map_c, tile_c + j * kBoxBytes, col0 + j * kAtom, row0);
      hopper::bulk_commit();
      hopper::bulk_wait_read();
    }
  }
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

template <int BN, int KB>
int launch_resident(const void* a, const void* b, void* c, int m, int k, int n, int reps,
                    const ResidentPlan& p, cudaStream_t s) {
  CUtensorMap map_b, map_c;
  int err = hopper::encode_bf16_2d(&map_b, b, k, n, kBK, kAtom);
  if (err != 0) return err;
  err = hopper::encode_bf16_2d(&map_c, c, m, n, kBM, kAtom);
  if (err != 0) return err;
  const cudaError_t cerr = cudaFuncSetAttribute(
      mm_resident_kernel<BN, KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  mm_resident_kernel<BN, KB><<<dim3(p.grid_x, p.grid_y), kResidentThreads, p.smem_bytes, s>>>(
      map_b, map_c, static_cast<const bf16*>(a), k, n, reps);
  return static_cast<int>(cudaGetLastError());
}

// the instance of width BN for p.k_boxes, KB = 1 .. kMaxKBoxes
template <int BN, int KB = 1>
int launch_resident_boxes(const void* a, const void* b, void* c, int m, int k, int n, int reps,
                          const ResidentPlan& p, cudaStream_t s) {
  if constexpr (KB > kMaxKBoxes) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (p.k_boxes == KB) return launch_resident<BN, KB>(a, b, c, m, k, n, reps, p, s);
    return launch_resident_boxes<BN, KB + 1>(a, b, c, m, k, n, reps, p, s);
  }
}

}  // namespace

// c (m, n) = a (m, k) @ b (k, n), all bf16 row-major, m a multiple of 64, k
// of 16, n of 32.  bn and stages must be grid_plan's for this shape (the
// wrapper passes mm_grid_plan's).  Returns 0, the cudaError_t of the launch,
// or hopper::kEncodeErrorBase + the CUresult of a failed tensor-map encode.
extern "C" int mm_grid_forward(const void* a, const void* b, void* c, int m, int k, int n, int bn,
                               int stages, void* stream) {
  if (bad_shape(m, k, n)) return static_cast<int>(cudaErrorInvalidValue);
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
  if (bad_shape(m, k, n)) return static_cast<int>(cudaErrorInvalidValue);
  const GridPlan p = grid_plan(m, k, n);
  const int values[9] = {p.bn, kBK, p.stages, p.grid_x, p.grid_y, kGridThreads, p.smem_bytes, 1,
                         p.tx_bytes};
  std::copy(values, values + 9, out);
  return 0;
}

// c (m, n) = bf16(sum over reps of a @ b), the sum kept in f32; a, b, c
// bf16 row-major, m a multiple of 64, k of 16 (up to 576), n of 32.  bn and
// k_boxes must be resident_plan's for this shape (the wrapper passes
// mm_resident_plan's).  Returns as mm_grid_forward.
extern "C" int mm_resident_forward(const void* a, const void* b, void* c, int m, int k, int n,
                                   int reps, int bn, int k_boxes, void* stream) {
  ResidentPlan p;
  if (bad_shape(m, k, n) || reps < 1 || !resident_plan(m, k, n, &p) || bn != p.bn ||
      k_boxes != p.k_boxes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.bn) {
    case 64: return launch_resident_boxes<64>(a, b, c, m, k, n, reps, p, s);
    case 128: return launch_resident_boxes<128>(a, b, c, m, k, n, reps, p, s);
    case 192: return launch_resident_boxes<192>(a, b, c, m, k, n, reps, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The geometry mm_resident_forward launches at (m, k, n), into out[11]: bm,
// bn, k boxes, k steps a warpgroup, warpgroups, threads, the registers a
// thread holds its operands in (A's fragments and the accumulators),
// dynamic shared-memory bytes, grid x, grid y, expected transaction bytes.
// Returns 0, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int mm_resident_built_plan(int m, int k, int n, int* out) {
  ResidentPlan p;
  if (bad_shape(m, k, n) || !resident_plan(m, k, n, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int values[11] = {kBM,          p.bn,         p.k_boxes,  2 * p.k_boxes,
                          kResidentThreads / 128,     kResidentThreads,
                          8 * p.k_boxes + p.bn / 2,   p.smem_bytes,
                          p.grid_x,     p.grid_y,     p.tx_bytes};
  std::copy(values, values + 11, out);
  return 0;
}
