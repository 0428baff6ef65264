// Fused ResidualDenseBlock forward for Hopper (sm_90a): bf16 on the tensor
// cores, f32 on CUDA cores.
//
// Replaces the Pallas TPU kernel real_esrgan_tpu/ops/pallas_rdb.py::fused_rdb
// (pl.pallas_call at pallas_rdb.py:188).  One launch computes one whole RDB
// of the RRDB generator: x in (B, H, W, 64) NHWC, 0.2 * o5 + x out.  The four
// intermediates o1..o4 (32 channels each) never touch device memory: each
// block keeps its x tile with a 5-pixel halo and o1 at (T+8)^2, o2 at
// (T+6)^2, o3 at (T+4)^2, o4 at (T+2)^2 in shared memory, and writes only
// its T x T output tile.
//
// Bound: operations.  One RDB costs 2*9*(64*32 + 96*32 + 128*32 + 160*32 +
// 192*64) = 479,232 FLOP per pixel against 2 * 64 * sizeof(T) bytes per pixel
// of device-memory traffic (x read once, out written once), about 1,900 FLOP
// per byte in bf16, far above the card's 295.  The halo recompute adds about
// 1.34x (bf16, T=16) and 1.77x (f32, T=8) to the FLOPs actually executed.
//
// bf16 (rdb_bf16_kernel): each of the five stages is an implicit GEMM on
// mma.sync m16n8k16 fed by ldmatrix (mma_tile.cuh).  M is the stage's region
// of pixels (24^2, 22^2, 20^2, 18^2, 16^2 at T=16), cut into fragments of 16
// pixels that may wrap across region rows; the tail fragment reads a clamped
// pixel and stores nothing.  N is 32 (o1..o4) or 64 (o5).  K is 9 taps x
// Cin of each source; a tap is a pointer offset into the source's buffer, so
// no patch matrix is built.  Eight warps (one block of 256 threads an SM)
// each compute 32 columns: in stages 1-4 all eight take the fragments in
// turn, in stage 5 two groups of four take one column half each.  Twelve
// warps spill at their 168-register cap and ran slower.  The weights (479 KB
// an RDB, more than an SM holds) stream from L2 through a ring of two 12 KB
// slots: a slice is one tap row (3 taps) x 32 input channels x N, 6 k-steps,
// and the next slice loads while the products of this one run; every block
// reads each weight once, 60 slices and 60 barriers a tile.  Slices of one
// tap (135 barriers of 2-4 k-steps each) ran slower on the card: the barrier
// and the pipeline's restart, not the tensor cores, set the pace there.
// Activations (200,704 B) and the ring take 225,280 B of shared memory,
// which leaves no room for a row skew: the 16-byte chunks of each pixel's row
// (and of each weight row) are placed by an XOR swizzle, so that the eight
// rows of an ldmatrix phase fall in eight different bank groups.
//
// f32 (rdb_f32_kernel): 512 threads on CUDA cores, 8 pixels x 2 output
// channels a work item, weights read from L2 in pairs.  The tensor cores
// would compute f32 as TF32, which keeps about three decimal digits: the f32
// path is held to 1e-4 of the JAX output and stays exact here.
//
// Numerics follow the packed formulation of the flax block
// (real_esrgan_tpu/models/rrdbnet.py, ResidualDenseBlock, packed=True):
// every (source, consumer) 3x3 conv accumulates in f32 and is rounded to the
// element type; the per-source terms are then added in the element type in
// the order x, o1, o2, o3, o4, then the bias; LeakyReLU(0.2) on o1..o4; the
// output is T(0.2) * o5 + x.  For f32 every rounding is the identity.
// Two deliberate departures from the Pallas kernel:
//   * intermediates at positions outside the image are zero ('same' conv
//     semantics of the flax block; the Pallas kernel computes them there);
//   * H and W need not be multiples of the tile: the ragged edge is masked.

#include "mma_tile.cuh"

namespace {

constexpr int kC = 64;        // RDB channels
constexpr int kG = 32;        // growth channels
constexpr int kHalo = 5;      // five chained 3x3 convs

struct Params {
  const void* x;
  const void* w[5];   // per-source packed weights, (9, Cin_s, N_s), N contiguous
  const float* bias;  // (5, 64)
  void* out;
  int H, W;
};

// Columns of source s's packed weights: consumers s+1..5 in order, kG wide
// each except the last (o5), which is kC wide.
__host__ __device__ constexpr int packed_columns(int s) { return (4 - s) * kG + kC; }

// ---------------------------------------------------------------------------
// f32 on CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kTile = 8;
constexpr int kThreads = 512;
constexpr int kPix = 8;       // pixels of one work item
constexpr int kQ = 2;         // output channels of one work item

// Shared-memory buffer K: K = 0 is the x tile, K = 1..4 is o_K.
template <int K>
struct Buf {
  static constexpr int kSide = kTile + 2 * (kHalo - K);
  static constexpr int kCh = K == 0 ? kC : kG;
  static constexpr int kElems = kSide * kSide * kCh;
};

constexpr size_t kSmemBytes = sizeof(float) * (Buf<0>::kElems + Buf<1>::kElems + Buf<2>::kElems +
                                               Buf<3>::kElems + Buf<4>::kElems);

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * 0.2f; }

// Adds source S's contribution to consumer K for one work item: kPix pixels
// (region coordinates rr, cc of consumer K) by 2 output channels (oc, oc+1).
template <int K, int S>
__device__ __forceinline__ void add_source(const float* __restrict__ in,
                                           const float* __restrict__ w_src,
                                           const int (&rr)[kPix], const int (&cc)[kPix], int oc,
                                           float (&sum)[kPix][kQ]) {
  constexpr int kCin = Buf<S>::kCh;
  constexpr int kSin = Buf<S>::kSide;
  constexpr int kN = packed_columns(S);
  constexpr int kCol = (K - 1 - S) * kG;
  constexpr int kShift = K - S - 1;  // offset of consumer K's region inside source S's buffer
  const float* w = w_src + kCol + oc;

  int base[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) base[j] = ((rr[j] + kShift) * kSin + cc[j] + kShift) * kCin;

  float acc[kPix][kQ];
#pragma unroll
  for (int j = 0; j < kPix; ++j) acc[j][0] = acc[j][1] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = ((tap / 3) * kSin + tap % 3) * kCin;
    const float* wt = w + tap * kCin * kN;
#pragma unroll 1
    for (int ci = 0; ci < kCin; ci += 8) {
      float2 wv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) wv[u] = __ldg(reinterpret_cast<const float2*>(wt + (ci + u) * kN));
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        float xv[8];
        load8(in + base[j] + toff + ci, xv);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc[j][0] = fmaf(xv[u], wv[u].x, acc[j][0]);
          acc[j][1] = fmaf(xv[u], wv[u].y, acc[j][1]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPix; ++j) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) sum[j][q] = S == 0 ? acc[j][q] : sum[j][q] + acc[j][q];
  }
}

// Computes o_K (K = 1..4) into shared memory, or for K = 5 the block's output
// tile 0.2 * o5 + x into device memory.
template <int K>
__device__ __forceinline__ void stage(const Params& p, float* const (&buf)[5], int ty0, int tx0) {
  constexpr int kSide = K < 5 ? Buf<K>::kSide : kTile;
  constexpr int kCout = K < 5 ? kG : kC;
  constexpr int kGroups = kCout / kQ;
  constexpr int kRegion = kSide * kSide;
  constexpr int kItems = (kRegion + kPix - 1) / kPix * kGroups;
  const int org_y = ty0 - (kHalo - K);  // image coordinates of region (0, 0)
  const int org_x = tx0 - (kHalo - K);

  for (int item = threadIdx.x; item < kItems; item += kThreads) {
    const int oc = (item % kGroups) * kQ;
    const int pix0 = (item / kGroups) * kPix;
    int rr[kPix], cc[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int pix = min(pix0 + j, kRegion - 1);  // the tail computes a valid pixel, never stored
      rr[j] = pix / kSide;
      cc[j] = pix % kSide;
    }

    float sum[kPix][kQ];
    add_source<K, 0>(buf[0], static_cast<const float*>(p.w[0]), rr, cc, oc, sum);
    if constexpr (K > 1) add_source<K, 1>(buf[1], static_cast<const float*>(p.w[1]), rr, cc, oc, sum);
    if constexpr (K > 2) add_source<K, 2>(buf[2], static_cast<const float*>(p.w[2]), rr, cc, oc, sum);
    if constexpr (K > 3) add_source<K, 3>(buf[3], static_cast<const float*>(p.w[3]), rr, cc, oc, sum);
    if constexpr (K > 4) add_source<K, 4>(buf[4], static_cast<const float*>(p.w[4]), rr, cc, oc, sum);

    const float b0 = p.bias[(K - 1) * kC + oc];
    const float b1 = p.bias[(K - 1) * kC + oc + 1];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (pix0 + j >= kRegion) break;
      float v0 = sum[j][0] + b0;
      float v1 = sum[j][1] + b1;
      const int gy = org_y + rr[j];
      const int gx = org_x + cc[j];
      if constexpr (K < 5) {
        const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
        v0 = inside ? lrelu(v0) : 0.f;
        v1 = inside ? lrelu(v1) : 0.f;
        *reinterpret_cast<float2*>(buf[K] + (rr[j] * kSide + cc[j]) * kG + oc) = make_float2(v0, v1);
      } else {
        if (gy < p.H && gx < p.W) {
          const float* xc = buf[0] + ((rr[j] + kHalo) * Buf<0>::kSide + cc[j] + kHalo) * kC + oc;
          float* out = static_cast<float*>(p.out) + (((size_t)blockIdx.z * p.H + gy) * p.W + gx) * kC + oc;
          *reinterpret_cast<float2*>(out) = make_float2(v0 * 0.2f + xc[0], v1 * 0.2f + xc[1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) rdb_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const buf[5] = {
      reinterpret_cast<float*>(smem),
      reinterpret_cast<float*>(smem) + Buf<0>::kElems,
      reinterpret_cast<float*>(smem) + Buf<0>::kElems + Buf<1>::kElems,
      reinterpret_cast<float*>(smem) + Buf<0>::kElems + Buf<1>::kElems + Buf<2>::kElems,
      reinterpret_cast<float*>(smem) + Buf<0>::kElems + Buf<1>::kElems + Buf<2>::kElems +
          Buf<3>::kElems,
  };
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTile;
  const int tx0 = blockIdx.x * kTile;

  // x tile with its halo, zero outside the image, in 16-byte vectors
  {
    constexpr int kSide = Buf<0>::kSide;
    constexpr int kVec = 4;
    constexpr int kVecs = kSide * kSide * kC / kVec;
    const float* x = static_cast<const float*>(p.x) + (size_t)b * p.H * p.W * kC;
    for (int i = threadIdx.x; i < kVecs; i += kThreads) {
      const int e = i * kVec;
      const int pix = e / kC;
      const int gy = ty0 - kHalo + pix / kSide;
      const int gx = tx0 - kHalo + pix % kSide;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
        v = __ldg(reinterpret_cast<const uint4*>(x + ((size_t)gy * p.W + gx) * kC + e % kC));
      *reinterpret_cast<uint4*>(buf[0] + e) = v;
    }
  }
  __syncthreads();
  stage<1>(p, buf, ty0, tx0);
  __syncthreads();
  stage<2>(p, buf, ty0, tx0);
  __syncthreads();
  stage<3>(p, buf, ty0, tx0);
  __syncthreads();
  stage<4>(p, buf, ty0, tx0);
  __syncthreads();
  stage<5>(p, buf, ty0, tx0);
}

int launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rdb_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.W + kTile - 1) / kTile, (p.H + kTile - 1) / kTile, B);
  rdb_f32_kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace bf16mma {

using tile::bf16;

constexpr int kTile = 16;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 32;               // input channels of one weight slice
constexpr int kRingSlots = 2;            // one slice in flight ahead of the one in use
constexpr int kSlotElems = 3 * kGroup * kC;  // the largest slice: 3 taps x 32 x 64 columns
// A slice is (stage k, source s, group of 32 input channels, tap row dy), in
// that order: stage k has k + 1 channel groups (two of x, one of each o).
constexpr int kSlices = 3 * (2 + 3 + 4 + 5 + 6);

// Buffer s (0: x, 1..4: o_s) is the region of stage s; stage 5's region is
// the output tile.
__host__ __device__ constexpr int side(int s) { return kTile + 2 * (kHalo - s); }
__host__ __device__ constexpr int channels(int s) { return s == 0 ? kC : kG; }
__host__ __device__ constexpr int buf_elems(int s) { return side(s) * side(s) * channels(s); }
__host__ __device__ constexpr int buf_offset(int s) {
  return s == 0 ? 0 : buf_offset(s - 1) + buf_elems(s - 1);
}
constexpr int kRingOffset = buf_offset(5);
constexpr size_t kSmemBytes = sizeof(bf16) * (kRingOffset + kRingSlots * kSlotElems);
static_assert(kSmemBytes <= 232448, "more shared memory than a block may have");

// Rows of 4 or 8 chunks of 16 bytes (64- or 128-byte rows).  Chunk c of row
// r is stored at chunk c ^ swizzle(r): eight consecutive rows read at the
// same chunk then fall in eight different 16-byte bank groups.
template <int kChunks>
__device__ __forceinline__ int swizzle(int row) {
  static_assert(kChunks == 4 || kChunks == 8, "rows of 64 or 128 bytes");
  return kChunks == 8 ? (row & 7) : ((row >> 1) & 3);
}

// Element offset of chunk `chunk` of row `row`.
template <int kChunks>
__device__ __forceinline__ int chunk_offset(int row, int chunk) {
  return row * kChunks * 8 + ((chunk ^ swizzle<kChunks>(row)) << 3);
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : round_bf16(v * round_bf16(0.2f));
}

// Copies the 3 x 32 rows of one slice (row dx * 32 + c: tap dx of the row,
// input channel c of the group) from source s's packed weights, whose rows
// (tap, channel) are ld elements long and whose rows of one tap lie cin
// apart, into a slot of kChunks * 8 columns.
template <int kChunks>
__device__ __forceinline__ void copy_slice(bf16* dst, const bf16* src, int cin, int ld) {
  for (int i = threadIdx.x; i < 3 * kGroup * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i % kChunks;
    const int dx = row / kGroup, c = row % kGroup;
    tile::cp_async_16(dst + chunk_offset<kChunks>(row, ch), src + (size_t)(dx * cin + c) * ld + ch * 8,
                      true);
  }
}

// Starts the copy of weight slice i into its ring slot: the columns of
// consumer k in source s's packed weights.  Commits a group even past the
// last slice, so that the count of groups in flight stays the same.
__device__ __forceinline__ void start_slice(const Params& p, bf16* ring, int i) {
  if (i < kSlices) {
    int k = 1, r = i;
    while (r >= 3 * (k + 1)) { r -= 3 * (k + 1); ++k; }
    const int group = r / 3, dy = r % 3;  // groups 0, 1 are x, group g > 1 is o_{g-1}
    const int s = group < 2 ? 0 : group - 1, c0 = group == 1 ? kGroup : 0;
    const int cin = channels(s), ld = packed_columns(s);
    // a constant index into the kernel's parameters, so they stay out of local memory
    const void* w = s == 0 ? p.w[0] : s == 1 ? p.w[1] : s == 2 ? p.w[2] : s == 3 ? p.w[3] : p.w[4];
    const bf16* src = static_cast<const bf16*>(w) + (size_t)(3 * dy * cin + c0) * ld + (k - 1 - s) * kG;
    bf16* dst = ring + (i % kRingSlots) * kSlotElems;
    if (k < 5) copy_slice<kG / 8>(dst, src, cin, ld);
    else copy_slice<kC / 8>(dst, src, cin, ld);
  }
  tile::cp_async_commit();
}

// Waits for slice i, frees the slot of slice i - 1 (every warp is past it
// after the barrier) and starts slice i + kRingSlots - 1 there.  Returns the
// shared-memory address of slice i.
__device__ __forceinline__ uint32_t acquire_slice(const Params& p, bf16* ring, int i) {
  tile::cp_async_wait<kRingSlots - 2>();
  __syncthreads();
  start_slice(p, ring, i + kRingSlots - 1);
  return tile::shared_address(ring + (i % kRingSlots) * kSlotElems);
}

// Per-warp state of one stage.  A warp computes 32 output columns: stage 5's
// 64 columns go to two groups of kWarps / 2 warps.  Warp w of a group of
// kGroupWarps takes fragments of 16 region pixels w, w + kGroupWarps, ...
template <int K>
struct Stage {
  static constexpr int kSide = side(K);
  static constexpr int kPixels = kSide * kSide;
  static constexpr int kFrags = (kPixels + 15) / 16;
  static constexpr int kN = K < 5 ? kG : kC;      // columns of the stage (and of its slices)
  static constexpr int kGroupWarps = kWarps * kG / kN;
  static constexpr int kU = (kFrags + kGroupWarps - 1) / kGroupWarps;
  static constexpr int kNF = kG / 16;             // 16-column fragments of a warp
  tile::FragC acc[kU][kNF];
  __nv_bfloat162 sum[kU][kNF][4];  // running sum in bf16, two columns a register
  int rr[kU], cc[kU];        // region row and column of this lane's A row
  int first, units;          // this warp's first fragment and its count
  int col0;                  // this warp's first column
};

// Adds source S's conv to stage K's running sum: one slice for each group of
// 32 input channels and tap row, 6 k-steps each (3 taps x 2 x 16 channels),
// every fragment of the warp against the slice.
template <int K, int S>
__device__ __forceinline__ void add_source(const Params& p, bf16* smem, int& slice, Stage<K>& st) {
  using St = Stage<K>;
  constexpr int kU = St::kU, kNF = St::kNF, kN = St::kN;
  constexpr int kSin = side(S), kCin = channels(S), kChunks = kCin / 8;
  constexpr int kSteps = 3 * kGroup / 16;
  constexpr int kShift = K - S - 1;  // consumer K's region inside source S's buffer, less the tap
  const int lane = threadIdx.x & 31, hi = lane >> 4, brow = lane & 15;
  const uint32_t in = tile::shared_address(smem + buf_offset(S));
  bf16* ring = smem + kRingOffset;

  int p0[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) p0[u] = (st.rr[u] + kShift) * kSin + st.cc[u] + kShift;
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int q = 0; q < kNF; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) st.acc[u][q].r[e] = 0.f;

  // this lane's row of a 16 x 16 B block: slice row 16 j + brow, swizzled
  const uint32_t b_row = brow * kN * 2;
  const int b_swz = swizzle<kN / 8>(brow);

#pragma unroll 1
  for (int part = 0; part < 3 * kCin / kGroup; ++part, ++slice) {
    const uint32_t w = acquire_slice(p, ring, slice);
    const int row = (part % 3) * kSin, chunk0 = (part / 3) * (kGroup / 8) + hi;
    tile::FragA a[2][kU];
    tile::FragB b[2][kNF];
    // k-step j: tap dx = j / 2 of the row, channels 16 (j % 2) .. + 15 of the group
    auto load = [&](int j, tile::FragA (&fa)[kU], tile::FragB (&fb)[kNF]) {
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (u < st.units) {
          const int px = p0[u] + row + j / 2;
          tile::ldsm_x4(fa[u].r, in + px * kCin * 2 + (((chunk0 + 2 * (j % 2)) ^ swizzle<kChunks>(px)) << 4));
        }
#pragma unroll
      for (int q = 0; q < kNF; ++q)
        tile::ldsm_x4_trans(fb[q].r, w + (16 * j) * kN * 2 + b_row +
                                         (((st.col0 / 8 + 2 * q + hi) ^ b_swz) << 4));
    };
    load(0, a[0], b[0]);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (j + 1 < kSteps) load(j + 1, a[(j + 1) & 1], b[(j + 1) & 1]);
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (u < st.units)
#pragma unroll
          for (int q = 0; q < kNF; ++q) tile::mma(st.acc[u][q], a[j & 1][u], b[j & 1][q]);
    }
  }

  // round the source's conv to bf16 and add it to the running bf16 sum
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int q = 0; q < kNF; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 t = __floats2bfloat162_rn(st.acc[u][q].r[2 * e], st.acc[u][q].r[2 * e + 1]);
        if constexpr (S == 0) {
          st.sum[u][q][e] = t;
        } else {
          const float2 old = __bfloat1622float2(st.sum[u][q][e]), add = __bfloat1622float2(t);
          st.sum[u][q][e] = __floats2bfloat162_rn(old.x + add.x, old.y + add.y);
        }
      }
}

// Stage K: o_K (K = 1..4) into its shared-memory buffer, or for K = 5 the
// block's output tile 0.2 * o5 + x into device memory.
template <int K>
__device__ __forceinline__ void stage(const Params& p, bf16* smem, int& slice, int ty0, int tx0) {
  using St = Stage<K>;
  constexpr int kSide = St::kSide, kPixels = St::kPixels, kU = St::kU, kNF = St::kNF;
  constexpr int kGroupWarps = St::kGroupWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  St st;
  st.first = warp % kGroupWarps;
  st.units = (St::kFrags - st.first + kGroupWarps - 1) / kGroupWarps;
  st.col0 = warp / kGroupWarps * kG;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int m = min((st.first + kGroupWarps * u) * 16 + (lane & 15), kPixels - 1);  // tail: clamped, never stored
    st.rr[u] = m / kSide;
    st.cc[u] = m % kSide;
  }
  add_source<K, 0>(p, smem, slice, st);
  if constexpr (K > 1) add_source<K, 1>(p, smem, slice, st);
  if constexpr (K > 2) add_source<K, 2>(p, smem, slice, st);
  if constexpr (K > 3) add_source<K, 3>(p, smem, slice, st);
  if constexpr (K > 4) add_source<K, 4>(p, smem, slice, st);

  // epilogue: lane holds columns 2 (lane % 4) + {0, 1} (and + 8) of rows
  // lane / 4 and lane / 4 + 8 of each 16 x 16 block
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int org_y = ty0 - (kHalo - K), org_x = tx0 - (kHalo - K);  // image coordinates of region (0, 0)
  const bf16* x_buf = smem;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (u >= st.units) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (st.first + kGroupWarps * u) * 16 + g + 8 * half;
      if (m >= kPixels) continue;
      const int r = m / kSide, c = m % kSide;
      const int gy = org_y + r, gx = org_x + c;
#pragma unroll
      for (int q = 0; q < kNF; ++q)
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          const int n = st.col0 + q * 16 + nh * 8 + c2;
          const float2 s = __bfloat1622float2(st.sum[u][q][nh * 2 + half]);
          const float v0 = round_bf16(s.x + round_bf16(__ldg(p.bias + (K - 1) * kC + n)));
          const float v1 = round_bf16(s.y + round_bf16(__ldg(p.bias + (K - 1) * kC + n + 1)));
          if constexpr (K < 5) {
            const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
            const __nv_bfloat162 o = inside ? __floats2bfloat162_rn(lrelu(v0), lrelu(v1))
                                            : __floats2bfloat162_rn(0.f, 0.f);
            *reinterpret_cast<__nv_bfloat162*>(smem + buf_offset(K) + chunk_offset<kG / 8>(m, n >> 3) +
                                               (n & 7)) = o;
          } else if (gy < p.H && gx < p.W) {
            const int px = (r + kHalo) * side(0) + c + kHalo;
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                x_buf + chunk_offset<kC / 8>(px, n >> 3) + (n & 7)));
            const float res = round_bf16(0.2f);
            bf16* out = static_cast<bf16*>(p.out) + (((size_t)blockIdx.z * p.H + gy) * p.W + gx) * kC + n;
            *reinterpret_cast<__nv_bfloat162*>(out) =
                __floats2bfloat162_rn(round_bf16(v0 * res) + xv.x, round_bf16(v1 * res) + xv.y);
          }
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) rdb_bf16_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;

  // x tile with its halo, zero outside the image, one 16-byte chunk a copy
  {
    constexpr int kSide = side(0), kChunks = kC / 8;
    const bf16* x = static_cast<const bf16*>(p.x) + (size_t)blockIdx.z * p.H * p.W * kC;
    for (int i = threadIdx.x; i < kSide * kSide * kChunks; i += kThreads) {
      const int pix = i / kChunks, ch = i % kChunks;
      const int gy = ty0 - kHalo + pix / kSide, gx = tx0 - kHalo + pix % kSide;
      const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      const bf16* src = x + (inside ? ((size_t)gy * p.W + gx) * kC + ch * 8 : 0);
      tile::cp_async_16(smem + chunk_offset<kChunks>(pix, ch), src, inside);
    }
    tile::cp_async_commit();
  }
  for (int i = 0; i < kRingSlots - 1; ++i) start_slice(p, smem + kRingOffset, i);

  int slice = 0;
  stage<1>(p, smem, slice, ty0, tx0);
  stage<2>(p, smem, slice, ty0, tx0);
  stage<3>(p, smem, slice, ty0, tx0);
  stage<4>(p, smem, slice, ty0, tx0);
  stage<5>(p, smem, slice, ty0, tx0);
}

int launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rdb_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.W + kTile - 1) / kTile, (p.H + kTile - 1) / kTile, B);
  rdb_bf16_kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16mma

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int fused_rdb_forward(int dtype, const void* x, const void* w0, const void* w1,
                                 const void* w2, const void* w3, const void* w4,
                                 const void* bias, void* out, int B, int H, int W, void* stream) {
  const Params p{x, {w0, w1, w2, w3, w4}, static_cast<const float*>(bias), out, H, W};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return f32::launch(p, B, s);
  if (dtype == 1) return bf16mma::launch(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The output tile side and the dynamic shared memory of one block of the
// dtype's kernel (0 = float32, 1 = bfloat16), or -1 for another dtype.  The
// wrapper holds them against ops/fused_rdb.py::rdb_plan.
extern "C" int fused_rdb_tile(int dtype) {
  return dtype == 0 ? f32::kTile : dtype == 1 ? bf16mma::kTile : -1;
}

extern "C" int fused_rdb_smem_bytes(int dtype) {
  return dtype == 0 ? static_cast<int>(f32::kSmemBytes)
                    : dtype == 1 ? static_cast<int>(bf16mma::kSmemBytes) : -1;
}
