// Fused ResidualDenseBlock forward for Hopper (sm_90a) on the tensor cores:
// bf16 on TMA, mbarriers and wgmma; f32 as three bf16 products (hi*hi +
// hi*lo + lo*hi) on ldmatrix and mma.sync.
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
// per byte in bf16 and 940 in f32, far above the card's 295.  f32 issues
// three bf16 products for each of its FLOPs: 1,437,696 tensor-core FLOP per
// pixel, 3x bf16's bound.  The halo recompute adds about 1.34x (bf16, T=16)
// and 1.77x (f32, T=8) to the FLOPs actually executed.
//
// Each of the five stages is an implicit GEMM: M is the stage's region of
// pixels (T+8 .. T on a side), N is 32 (o1..o4) or 64 (o5), K is 9 taps x
// Cin of each source; a tap is an offset into the source's buffer, so no
// patch matrix is built.  Each source's conv is summed on its own, as the
// numerics below need.  The 16-byte chunks of each pixel's row are placed
// by an XOR swizzle, so that the eight rows of an ldmatrix phase fall in
// eight different bank groups (two where a phase wraps a region row).
//
// bf16 (rdb_bf16_wgmma_kernel, namespace wg): T = 16, 384 threads, 230,520
// B of shared memory.
//   * x arrives as one 4-D TMA box (64, 26, 26, 1) at (0, x0 - 5, y0 - 5,
//     b): TMA writes the 128-byte swizzle the ldmatrix reads want and the
//     zeros outside the image, so there is no masking and no padded copy.
//   * The weights (496 KB an RDB in boxes, more than an SM holds) stream
//     from L2 as 124 boxes of 32 columns x 64 k, which the wrapper lays out
//     once a pack already K-major and swizzled as a wgmma descriptor reads
//     them (ops/fused_rdb.py::box_rdb_weights); one producer thread keeps a
//     ring of seven 4 KB slots full with 1-D bulk copies on full/empty
//     mbarriers.  No block-wide barrier is left inside a stage; only the
//     four hand-offs between stages are a named barrier of the consumers.
//   * Two consumer warpgroups take units of 64 region pixels, one wgmma
//     m64 tile each: warpgroup g takes units g, g + 2, ...  A comes from
//     registers: each warp loads its 16 tap-shifted pixels with ldmatrix.x4,
//     since a tap's shift puts A's start inside a swizzle atom, which a
//     descriptor cannot address, and a region row is not an affine run of
//     the source's.  A k step issues one m64n32k16 wgmma for every unit of
//     the warpgroup (two, one a column half, in stage 5) as one group, and
//     the next step's fragments load while it runs.  Every unit count and
//     step count is a compile-time constant, so no wgmma sits under a
//     guard: a unit past the stage's count reads a clamped pixel and stores
//     nothing, and an o's 288 k end in a half box of which two steps issue.
//   * The producer warpgroup gives up its registers (setmaxnreg): 12 warps
//     leave 168 a thread at launch, and the consumers hold up to five units
//     of accumulators, their bf16 sums and two steps of fragments in 240.
//     With a producer warp and no setmaxnreg (nine warps, also 168) they
//     spill a kilobyte; with no producer at all (eight warps, 255) the
//     consumers' own refills of the ring cost more than they gain.
//   * k runs over 32-channel groups, then taps, then channels: the order of
//     the mma.sync schedule and of the card's library convolution, so that
//     the f32 sums round to bf16 as theirs do (tap-major k rounded a few
//     elements differently, which cancellation at the trunk's magnitude
//     showed as 0.03 on an output of 0.16).
//   * What sets the pace (tools/rdb_probe.py): the m64n32k16 groups
//     themselves.  Without any ldmatrix of A or any ring the kernel still
//     takes twice its work at the tensor rate: small wgmma one step at a time
//     leave the tensor pipe half idle.
//
// The mma.sync schedule (rdb_body<P>, P the products of a fragment pair)
// fragments each region into 16 pixels that may wrap rows; eight warps (one
// block of 256 threads an SM) each compute 32 columns; the weights stream
// through a ring of two cp.async slots of one tap row x 32 input channels x
// N, 60 slices and 60 block-wide barriers a tile.  P = 3 is the f32 kernel;
// P = 1, the earlier bf16 kernel, is instantiated by no shipped kernel and
// kept so that tools/rdb_probe.py can build it beside the wgmma kernel.
//
// f32 (rdb_f32_split_kernel, P = 3): the tensor cores take f32 only as TF32
// (10 mantissa bits), which breaks the f32 path's bound of 1e-4 from the JAX
// output.  So every operand is split in two bf16 parts, a = a_hi + a_lo with
// a_hi = bf16(a) and a_lo = bf16(a - a_hi), which keep 16 of a's 24 bits,
// and each product is a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, all three into one
// f32 accumulator (lo*lo, 2^-16 of the whole, is dropped).  A bf16 x bf16
// product is exact in f32.  The weights are split once a pack by the wrapper
// (ops/fused_rdb.py::split_rdb_weights); x is split as it is loaded, o1..o4
// after their LeakyReLU, as a stage writes them.  Each buffer and each ring
// slot holds a hi plane and then a lo plane in the same swizzled layout, so
// ldmatrix serves both: the bytes of f32, which fit at T=8 with the ring
// (221,184 B) and not at T=16 (401,408 B for the activations alone).  The
// per-source sums, the bias, LeakyReLU and 0.2 * o5 stay in f32 registers,
// and the residual reads f32 x from device memory: x_hi + x_lo is off from x
// by up to 2^-17 |x|, 2.4e-4 at the trunk's |x| of 57, more than the bound.
// The tensor cores' own f32 accumulation truncates at every mma: one
// accumulator a source (up to 108 chained products) put the generator's
// trunk.21.rdb1 1.4e-4 from rdb_plain on its real inputs.  So hi*hi and the
// two small cross products go to separate accumulators, both restarted every
// weight slice (6 and 12 chained products), and each slice's partial sums
// are added to the f32 running sum rounded to nearest: 4.2e-5 at worst over
// the 69 RDBs, for 2% more time (tools/rdb_probe.py on an H100 80GB HBM3 at
// 700 W, which builds such variants side by side).
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

#include <type_traits>

#include "hopper.cuh"
#include "mma_tile.cuh"

namespace {

using tile::bf16;

constexpr int kC = 64;        // RDB channels
constexpr int kG = 32;        // growth channels
constexpr int kHalo = 5;      // five chained 3x3 convs

struct Params {
  const void* x;
  const void* w[5];     // per-source packed bf16 weights, (9, Cin_s, N_s), N contiguous;
                        // for f32 their hi parts
  const void* w_lo[5];  // for f32 the lo parts of the same; unused for bf16
  const float* bias;    // (5, 64)
  void* out;
  int H, W;
};

// Columns of source s's packed weights: consumers s+1..5 in order, kG wide
// each except the last (o5), which is kC wide.
__host__ __device__ constexpr int packed_columns(int s) { return (4 - s) * kG + kC; }

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 32;                   // input channels of one weight slice
constexpr int kRingSlots = 2;                // one slice in flight ahead of the one in use
constexpr int kSliceElems = 3 * kGroup * kC;  // one plane of the largest slice: 3 taps x 32 x 64
// A slice is (stage k, source s, group of 32 input channels, tap row dy), in
// that order: stage k has k + 1 channel groups (two of x, one of each o).
constexpr int kSlices = 3 * (2 + 3 + 4 + 5 + 6);

// P, the products of a fragment pair: 1 (bf16) or 3 (f32 as hi*hi + hi*lo +
// lo*hi).  For P = 3 every buffer and ring slot holds a hi and a lo plane.
template <int P>
__host__ __device__ constexpr int planes() { return P == 1 ? 1 : 2; }
template <int P>
__host__ __device__ constexpr int tile_side() { return P == 1 ? 16 : 8; }

// Buffer s (0: x, 1..4: o_s) is the region of stage s; stage 5's region is
// the output tile.
template <int P>
__host__ __device__ constexpr int side(int s) { return tile_side<P>() + 2 * (kHalo - s); }
__host__ __device__ constexpr int channels(int s) { return s == 0 ? kC : kG; }
template <int P>
__host__ __device__ constexpr int plane_elems(int s) { return side<P>(s) * side<P>(s) * channels(s); }
template <int P>
__host__ __device__ constexpr int buf_offset(int s) {
  return s == 0 ? 0 : buf_offset<P>(s - 1) + planes<P>() * plane_elems<P>(s - 1);
}

template <int P>
struct Layout {
  static constexpr int kRingOffset = buf_offset<P>(5);
  static constexpr int kSlotElems = planes<P>() * kSliceElems;
  static constexpr size_t kSmemBytes = sizeof(bf16) * (kRingOffset + kRingSlots * kSlotElems);
  static_assert(kSmemBytes <= 232448, "more shared memory than a block may have");
};

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

// LeakyReLU(0.2) as the flax block computes it in bf16 (every product rounded)
__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : round_bf16(v * round_bf16(0.2f));
}

__device__ __forceinline__ float lrelu_f32(float v) { return v >= 0.f ? v : v * 0.2f; }

// Two f32 values as their bf16 hi parts and lo parts, one register each:
// hi = bf16(v), lo = bf16(v - hi) (the difference is exact in f32).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = reinterpret_cast<const uint32_t&>(h);
  lo = reinterpret_cast<const uint32_t&>(l);
}

// Copies the 3 x 32 rows of one slice (row dx * 32 + c: tap dx of the row,
// input channel c of the group) from source s's packed weights, whose rows
// (tap, channel) are ld elements long and whose rows of one tap lie cin
// apart, into a slot plane of kChunks * 8 columns.
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
// consumer k in source s's packed weights (for P = 3 the hi part into the
// slot's first plane, the lo part into its second).  Commits a group even
// past the last slice, so that the count of groups in flight stays the same.
template <int P>
__device__ __forceinline__ void start_slice(const Params& p, bf16* ring, int i) {
  if (i < kSlices) {
    int k = 1, r = i;
    while (r >= 3 * (k + 1)) { r -= 3 * (k + 1); ++k; }
    const int group = r / 3, dy = r % 3;  // groups 0, 1 are x, group g > 1 is o_{g-1}
    const int s = group < 2 ? 0 : group - 1, c0 = group == 1 ? kGroup : 0;
    const int cin = channels(s), ld = packed_columns(s);
    const size_t offset = (size_t)(3 * dy * cin + c0) * ld + (k - 1 - s) * kG;
    bf16* dst = ring + (i % kRingSlots) * Layout<P>::kSlotElems;
    // a constant index into the kernel's parameters, so they stay out of local memory
    const void* w = s == 0 ? p.w[0] : s == 1 ? p.w[1] : s == 2 ? p.w[2] : s == 3 ? p.w[3] : p.w[4];
    const bf16* src = static_cast<const bf16*>(w) + offset;
    if (k < 5) copy_slice<kG / 8>(dst, src, cin, ld);
    else copy_slice<kC / 8>(dst, src, cin, ld);
    if constexpr (P == 3) {
      const void* lo = s == 0   ? p.w_lo[0]
                       : s == 1 ? p.w_lo[1]
                       : s == 2 ? p.w_lo[2]
                       : s == 3 ? p.w_lo[3]
                                : p.w_lo[4];
      const bf16* src_lo = static_cast<const bf16*>(lo) + offset;
      if (k < 5) copy_slice<kG / 8>(dst + kSliceElems, src_lo, cin, ld);
      else copy_slice<kC / 8>(dst + kSliceElems, src_lo, cin, ld);
    }
  }
  tile::cp_async_commit();
}

// Waits for slice i, frees the slot of slice i - 1 (every warp is past it
// after the barrier) and starts slice i + kRingSlots - 1 there.  Returns the
// shared-memory address of slice i.
template <int P>
__device__ __forceinline__ uint32_t acquire_slice(const Params& p, bf16* ring, int i) {
  tile::cp_async_wait<kRingSlots - 2>();
  __syncthreads();
  start_slice<P>(p, ring, i + kRingSlots - 1);
  return tile::shared_address(ring + (i % kRingSlots) * Layout<P>::kSlotElems);
}

// Per-warp state of one stage.  A warp computes 32 output columns: stage 5's
// 64 columns go to two groups of kWarps / 2 warps.  Warp w of a group of
// kGroupWarps takes fragments of 16 region pixels w, w + kGroupWarps, ...
template <int P, int K>
struct Stage {
  static constexpr int kSide = side<P>(K);
  static constexpr int kPixels = kSide * kSide;
  static constexpr int kFrags = (kPixels + 15) / 16;
  static constexpr int kN = K < 5 ? kG : kC;      // columns of the stage (and of its slices)
  static constexpr int kGroupWarps = kWarps * kG / kN;
  static constexpr int kU = (kFrags + kGroupWarps - 1) / kGroupWarps;
  static constexpr int kNF = kG / 16;             // 16-column fragments of a warp
  tile::FragC acc[kU][kNF];
  // running sum over the sources: bf16, two columns a register, for P = 1;
  // f32, laid out as acc, for P = 3
  std::conditional_t<P == 1, __nv_bfloat162[kU][kNF][4], float[kU][kNF][8]> sum;
  int rr[kU], cc[kU];        // region row and column of this lane's A row
  int first, units;          // this warp's first fragment and its count
  int col0;                  // this warp's first column
};

// Adds source S's conv to stage K's running sum: one slice for each group of
// 32 input channels and tap row, 6 k-steps each (3 taps x 2 x 16 channels),
// every fragment of the warp against the slice, P products each.
template <int P, int K, int S>
__device__ __forceinline__ void add_source(const Params& p, bf16* smem, int& slice, Stage<P, K>& st) {
  using St = Stage<P, K>;
  constexpr int kU = St::kU, kNF = St::kNF, kN = St::kN;
  constexpr int kSin = side<P>(S), kCin = channels(S), kChunks = kCin / 8;
  constexpr int kSteps = 3 * kGroup / 16;
  constexpr int kShift = K - S - 1;  // consumer K's region inside source S's buffer, less the tap
  constexpr int kPlanes = planes<P>();
  // bytes from a hi plane to its lo plane: of the source's buffer, of a ring slot
  constexpr uint32_t kInLo = plane_elems<P>(S) * sizeof(bf16);
  constexpr uint32_t kSliceLo = kSliceElems * sizeof(bf16);
  const int lane = threadIdx.x & 31, hi = lane >> 4, brow = lane & 15;
  const uint32_t in = tile::shared_address(smem + buf_offset<P>(S));
  bf16* ring = smem + Layout<P>::kRingOffset;

  int p0[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) p0[u] = (st.rr[u] + kShift) * kSin + st.cc[u] + kShift;
  auto zero = [](tile::FragC (&f)[kU][kNF]) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int q = 0; q < kNF; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) f[u][q].r[e] = 0.f;
  };
  // P = 3: hi*hi goes to acc, hi*lo and lo*hi to cross, both restarted every
  // slice (see the f32 note at the top)
  tile::FragC cross[kU][kNF];
  if constexpr (P == 1) zero(st.acc);

  // this lane's row of a 16 x 16 B block: slice row 16 j + brow, swizzled
  const uint32_t b_row = brow * kN * 2;
  const int b_swz = swizzle<kN / 8>(brow);

#pragma unroll 1
  for (int part = 0; part < 3 * kCin / kGroup; ++part, ++slice) {
    const uint32_t w = acquire_slice<P>(p, ring, slice);
    const int row = (part % 3) * kSin, chunk0 = (part / 3) * (kGroup / 8) + hi;
    if constexpr (P == 3) {
      zero(st.acc);
      zero(cross);
    }
    tile::FragA a[2][kPlanes][kU];
    tile::FragB b[2][kPlanes][kNF];
    // k-step j: tap dx = j / 2 of the row, channels 16 (j % 2) .. + 15 of the group
    auto load = [&](int j, tile::FragA (&fa)[kPlanes][kU], tile::FragB (&fb)[kPlanes][kNF]) {
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (u < st.units) {
          const int px = p0[u] + row + j / 2;
          const uint32_t at = in + px * kCin * 2 + (((chunk0 + 2 * (j % 2)) ^ swizzle<kChunks>(px)) << 4);
#pragma unroll
          for (int h = 0; h < kPlanes; ++h) tile::ldsm_x4(fa[h][u].r, at + h * kInLo);
        }
#pragma unroll
      for (int q = 0; q < kNF; ++q) {
        const uint32_t at = w + (16 * j) * kN * 2 + b_row + (((st.col0 / 8 + 2 * q + hi) ^ b_swz) << 4);
#pragma unroll
        for (int h = 0; h < kPlanes; ++h) tile::ldsm_x4_trans(fb[h][q].r, at + h * kSliceLo);
      }
    };
    load(0, a[0], b[0]);
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (j + 1 < kSteps) load(j + 1, a[(j + 1) & 1], b[(j + 1) & 1]);
      // products t = 0, 1, 2: hi*hi, hi*lo, lo*hi, each over every fragment
      // pair before the next
#pragma unroll
      for (int t = 0; t < P; ++t)
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (u < st.units)
#pragma unroll
            for (int q = 0; q < kNF; ++q)
              tile::mma(t == 0 ? st.acc[u][q] : cross[u][q], a[j & 1][t == 2][u], b[j & 1][t == 1][q]);
    }
    if constexpr (P == 3) {
      // the slice's partial sums into the f32 running sum, rounded to nearest
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int q = 0; q < kNF; ++q)
#pragma unroll
          for (int e = 0; e < 8; ++e) st.sum[u][q][e] += st.acc[u][q].r[e] + cross[u][q].r[e];
    }
  }

  if constexpr (P == 1) {
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
}

// Stage K: o_K (K = 1..4) into its shared-memory buffer, or for K = 5 the
// block's output tile 0.2 * o5 + x into device memory.
template <int P, int K>
__device__ __forceinline__ void stage(const Params& p, bf16* smem, int& slice, int ty0, int tx0) {
  using St = Stage<P, K>;
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
  if constexpr (P == 3) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int q = 0; q < kNF; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) st.sum[u][q][e] = 0.f;
  }
  add_source<P, K, 0>(p, smem, slice, st);
  if constexpr (K > 1) add_source<P, K, 1>(p, smem, slice, st);
  if constexpr (K > 2) add_source<P, K, 2>(p, smem, slice, st);
  if constexpr (K > 3) add_source<P, K, 3>(p, smem, slice, st);
  if constexpr (K > 4) add_source<P, K, 4>(p, smem, slice, st);

  // epilogue: lane holds columns 2 (lane % 4) + {0, 1} (and + 8) of rows
  // lane / 4 and lane / 4 + 8 of each 16 x 16 block
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int org_y = ty0 - (kHalo - K), org_x = tx0 - (kHalo - K);  // image coordinates of region (0, 0)
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
          if constexpr (P == 1) {
            const float2 s = __bfloat1622float2(st.sum[u][q][nh * 2 + half]);
            const float v0 = round_bf16(s.x + round_bf16(__ldg(p.bias + (K - 1) * kC + n)));
            const float v1 = round_bf16(s.y + round_bf16(__ldg(p.bias + (K - 1) * kC + n + 1)));
            if constexpr (K < 5) {
              const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
              const __nv_bfloat162 o = inside ? __floats2bfloat162_rn(lrelu(v0), lrelu(v1))
                                              : __floats2bfloat162_rn(0.f, 0.f);
              *reinterpret_cast<__nv_bfloat162*>(smem + buf_offset<P>(K) + chunk_offset<kG / 8>(m, n >> 3) +
                                                 (n & 7)) = o;
            } else if (gy < p.H && gx < p.W) {
              const int px = (r + kHalo) * side<P>(0) + c + kHalo;
              const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  smem + chunk_offset<kC / 8>(px, n >> 3) + (n & 7)));
              const float res = round_bf16(0.2f);
              bf16* out = static_cast<bf16*>(p.out) + (((size_t)blockIdx.z * p.H + gy) * p.W + gx) * kC + n;
              *reinterpret_cast<__nv_bfloat162*>(out) =
                  __floats2bfloat162_rn(round_bf16(v0 * res) + xv.x, round_bf16(v1 * res) + xv.y);
            }
          } else {
            const int e = nh * 4 + half * 2;
            const float v0 = st.sum[u][q][e] + __ldg(p.bias + (K - 1) * kC + n);
            const float v1 = st.sum[u][q][e + 1] + __ldg(p.bias + (K - 1) * kC + n + 1);
            if constexpr (K < 5) {
              const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
              uint32_t hi, lo;
              split2(inside ? lrelu_f32(v0) : 0.f, inside ? lrelu_f32(v1) : 0.f, hi, lo);
              bf16* dst = smem + buf_offset<P>(K) + chunk_offset<kG / 8>(m, n >> 3) + (n & 7);
              *reinterpret_cast<uint32_t*>(dst) = hi;
              *reinterpret_cast<uint32_t*>(dst + plane_elems<P>(K)) = lo;
            } else if (gy < p.H && gx < p.W) {
              // the residual in f32 from device memory, rounded as 0.2 * o5 + x is
              const size_t at = (((size_t)blockIdx.z * p.H + gy) * p.W + gx) * kC + n;
              const float2 xv = __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(p.x) + at));
              *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
                  make_float2(__fadd_rn(__fmul_rn(v0, 0.2f), xv.x), __fadd_rn(__fmul_rn(v1, 0.2f), xv.y));
            }
          }
        }
    }
  }
}

// bf16: the x tile with its halo, zero outside the image, one 16-byte chunk
// a cp.async, in a group of its own.
__device__ __forceinline__ void load_x_bf16(const Params& p, bf16* smem, int ty0, int tx0) {
  constexpr int kSide = side<1>(0), kChunks = kC / 8;
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

// f32: the x tile with its halo, zero outside the image, split into its hi
// and lo planes through registers: 8 channels (32 bytes) a step.  Visible
// after the barrier of the first acquire_slice.
__device__ __forceinline__ void load_x_split(const Params& p, bf16* smem, int ty0, int tx0) {
  constexpr int kSide = side<3>(0), kChunks = kC / 8;
  const float* x = static_cast<const float*>(p.x) + (size_t)blockIdx.z * p.H * p.W * kC;
#pragma unroll 4
  for (int i = threadIdx.x; i < kSide * kSide * kChunks; i += kThreads) {
    const int pix = i / kChunks, ch = i % kChunks;
    const int gy = ty0 - kHalo + pix / kSide, gx = tx0 - kHalo + pix % kSide;
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
      const float4* src = reinterpret_cast<const float4*>(x + ((size_t)gy * p.W + gx) * kC + ch * 8);
      v0 = __ldg(src);
      v1 = __ldg(src + 1);
    }
    uint4 hi, lo;
    split2(v0.x, v0.y, hi.x, lo.x);
    split2(v0.z, v0.w, hi.y, lo.y);
    split2(v1.x, v1.y, hi.z, lo.z);
    split2(v1.z, v1.w, hi.w, lo.w);
    bf16* dst = smem + chunk_offset<kChunks>(pix, ch);
    *reinterpret_cast<uint4*>(dst) = hi;
    *reinterpret_cast<uint4*>(dst + plane_elems<3>(0)) = lo;
  }
}

template <int P>
__device__ __forceinline__ void rdb_body(const Params& p, bf16* smem) {
  const int ty0 = blockIdx.y * tile_side<P>(), tx0 = blockIdx.x * tile_side<P>();
  if constexpr (P == 1) {
    load_x_bf16(p, smem, ty0, tx0);
    for (int i = 0; i < kRingSlots - 1; ++i) start_slice<P>(p, smem + Layout<P>::kRingOffset, i);
  } else {
    // the first weight slice is in flight while x is loaded and split
    for (int i = 0; i < kRingSlots - 1; ++i) start_slice<P>(p, smem + Layout<P>::kRingOffset, i);
    load_x_split(p, smem, ty0, tx0);
  }
  int slice = 0;
  stage<P, 1>(p, smem, slice, ty0, tx0);
  stage<P, 2>(p, smem, slice, ty0, tx0);
  stage<P, 3>(p, smem, slice, ty0, tx0);
  stage<P, 4>(p, smem, slice, ty0, tx0);
  stage<P, 5>(p, smem, slice, ty0, tx0);
}

// ---- bf16: TMA, mbarriers and wgmma ---------------------------------------

namespace wg {

constexpr int kTile = 16;
constexpr int kGroups = 2;                        // consumer warpgroups
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 128;        // and a producer warpgroup
// Registers a thread after the producer gives up its own (setmaxnreg): 12
// warps leave 168 a thread at launch, three warps sharing each quarter of
// the SM's file.
constexpr int kProducerRegisters = 24;
constexpr int kConsumerRegisters = 240;
static_assert(kGroups * 128 * kConsumerRegisters + 128 * kProducerRegisters <= 65536,
              "more registers than an SM has");
constexpr int kUnitPixels = 64;                   // one wgmma m64 tile of region pixels
constexpr int kBoxK = 64;                         // k of a weight box: 128 bytes a row
constexpr int kBoxBytes = kG * kBoxK * 2;         // 32 columns x 64 k: 4096
constexpr int kRingSlots = 7;
constexpr int kAlign = 1024;                      // the 128-byte swizzle repeats every 1024 bytes

__host__ __device__ constexpr int side(int s) { return kTile + 2 * (kHalo - s); }
__host__ __device__ constexpr int row_bytes(int s) { return channels(s) * 2; }
__host__ __device__ constexpr int buffer_bytes(int s) { return side(s) * side(s) * row_bytes(s); }
// Boxes of one (consumer, source) pair and one 32-column half: 9 Cin k in
// whole boxes of 64, 9 for x and 5 (the last half zeros) for an o.
__host__ __device__ constexpr int boxes(int s) { return (9 * channels(s) + kBoxK - 1) / kBoxK; }
__host__ __device__ constexpr int halves(int k) { return k < 5 ? 1 : 2; }
// The stream's index of the first box of (consumer k, source s).
__host__ __device__ constexpr int first_box(int k, int s) {
  return s > 0   ? first_box(k, s - 1) + halves(k) * boxes(s - 1)
         : k > 1 ? first_box(k - 1, k - 2) + halves(k - 1) * boxes(k - 2)
                 : 0;
}
constexpr int kStreamBoxes = first_box(5, 4) + halves(5) * boxes(4);  // 124

// Shared memory from the 1024-aligned base: the ring, x, o1..o4, the
// mbarriers (full and empty a slot, and x's).
constexpr int kXOffset = kRingSlots * kBoxBytes;
__host__ __device__ constexpr int buf_offset(int s) {
  return s == 0 ? kXOffset : buf_offset(s - 1) + buffer_bytes(s - 1);
}
constexpr int kBarrierOffset = buf_offset(5);
constexpr int kSmemBytes = kAlign + kBarrierOffset + 8 * (2 * kRingSlots + 1);
static_assert(kStreamBoxes == 124, "the weight stream of box_rdb_weights");
static_assert(kXOffset % kAlign == 0, "TMA's 128-byte swizzle needs x on a 1024-byte boundary");
static_assert(buf_offset(1) % 128 == 0 && buf_offset(2) % 128 == 0 && buf_offset(3) % 128 == 0 &&
                  buf_offset(4) % 128 == 0,
              "o1..o4 on 128-byte lines, for the swizzle's bank groups");
static_assert(kSmemBytes <= 232448, "more shared memory than a block may have");

// The shared-memory addresses of a slot's mbarriers from the block's base:
// full (its box has landed) and empty (every consumer thread is done with it).
__device__ __forceinline__ uint32_t full_at(uint32_t base, int s) {
  return base + kBarrierOffset + 8 * s;
}
__device__ __forceinline__ uint32_t empty_at(uint32_t base, int s) {
  return base + kBarrierOffset + 8 * (kRingSlots + s);
}

template <int K>
struct Stage {
  static constexpr int kSide = side(K);
  static constexpr int kPixels = kSide * kSide;
  static constexpr int kUnits = (kPixels + kUnitPixels - 1) / kUnitPixels;  // 9 8 7 6 4
  static constexpr int kU = (kUnits + kGroups - 1) / kGroups;               // 5 4 4 3 2
  static constexpr int kN = kG * halves(K);                                // 32 or 64 columns
  float acc[kU][kN / 2];                 // one source's conv, f32, wgmma's layout, half by half
  __nv_bfloat162 sum[kU][kN / 4];        // the running bf16 sum over the sources, pairs of acc
};

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[N][4]) {
#pragma unroll
  for (int u = 0; u < N; ++u) hopper::fence_fragment(f[u]);
}

template <int K>
__device__ __forceinline__ void fence_acc(Stage<K>& st) {
#pragma unroll
  for (int u = 0; u < Stage<K>::kU; ++u) hopper::fence_operands(st.acc[u]);
}

// Adds source S's conv to stage K's running sum.  The k of the pair runs
// over groups of 32 input channels, then taps, then the group's channels
// (for an o, one group: tap * 32 + c), in boxes of 64; step t = 4 b + j of
// box b is k 16 t .. + 15: group t / 18, tap (t % 18) / 2, channels 16 (t %
// 2) .. + 15 of the group.  Each step issues one m64n32k16 wgmma a unit and
// 32-column half (two halves, two boxes, in stage 5), all as one group, on
// fragments loaded while the step before ran (every unit's 16 tap-shifted
// pixels of this warp, by ldmatrix.x4); the next step's fragments load
// while it runs.  A box's slots are released once its last step is done.
// Then the f32 conv is rounded to bf16 and added to the bf16 sum.
template <int K, int S>
__device__ __forceinline__ void add_source(Stage<K>& st, uint32_t base, int g, int w, int lane) {
  using St = Stage<K>;
  constexpr int kU = St::kU, kH = halves(K), kSin = side(S), kCin = channels(S), kRow = row_bytes(S);
  constexpr int kShift = K - S - 1;  // stage K's region inside source S's buffer, less the tap
  constexpr int kBoxes = boxes(S);
  constexpr int kSteps = 9 * kCin / 16;  // 36 for x, 18 for an o: the last box of an o is half used
  constexpr int kFirst = first_box(K, S);
  const uint32_t in = base + buf_offset(S);
  const int hi = lane >> 4;
  int p0[kU];  // this lane's A row, a pixel of the region, in source S's buffer at tap (0, 0)
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int m = min((g + kGroups * u) * kUnitPixels + 16 * w + (lane & 15), St::kPixels - 1);
    p0[u] = (m / St::kSide + kShift) * kSin + m % St::kSide + kShift;
  }

  auto load = [&](uint32_t (&f)[kU][4], int t) {
    const int group = t / 18, tap = (t % 18) >> 1;
    const int chunk = group * (kG / 8) + ((t & 1) << 1) + hi;
    const int off = (tap / 3) * kSin + tap % 3;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = p0[u] + off;
      const int swz = kCin == kC ? (q & 7) : ((q >> 1) & 3);
      hopper::ldmatrix_x4(f[u], in + q * kRow + ((chunk ^ swz) << 4));
    }
  };
  auto issue = [&](uint32_t (&f)[kU][4], int t) {
    const int box = kFirst + (t / 4) * kH;
    hopper::wgmma_fence();
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const uint64_t desc =
          hopper::smem_desc(base + ((box + h) % kRingSlots) * kBoxBytes + 32 * (t % 4), 16, 1024);
#pragma unroll
      for (int u = 0; u < kU; ++u)
        hopper::WgmmaRS<kG>::mma(*reinterpret_cast<float(*)[16]>(&st.acc[u][16 * h]), f[u], desc,
                                 t > 0);
    }
    hopper::wgmma_commit();
  };
  auto wait_full = [&](int b) {
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const int box = kFirst + b * kH + h;
      hopper::mbar_wait_at(full_at(base, box % kRingSlots), (box / kRingSlots) & 1);
    }
  };
  auto release = [&](int b) {
#pragma unroll
    for (int h = 0; h < kH; ++h)
      hopper::mbar_arrive_at(empty_at(base, (kFirst + b * kH + h) % kRingSlots));
  };

  uint32_t frag[2][kU][4];
  load(frag[0], 0);
  fence_acc(st);
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    if (t % 4 == 0) wait_full(t / 4);
    issue(frag[t % 2], t);
    hopper::wgmma_wait<1>();  // step t - 1 is done: its box and its fragments are free
    if (t % 4 == 0 && t > 0) release(t / 4 - 1);
    if (t + 1 < kSteps) {
      fence_frags(frag[(t + 1) % 2]);
      load(frag[(t + 1) % 2], t + 1);
    }
  }
  hopper::wgmma_wait<0>();
  fence_frags(frag[0]);
  fence_frags(frag[1]);
  fence_acc(st);
  release(kBoxes - 1);

  // the source's conv rounded to bf16, added to the running bf16 sum
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int e = 0; e < St::kN / 4; ++e) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(st.acc[u][2 * e], st.acc[u][2 * e + 1]);
      if constexpr (S == 0) {
        st.sum[u][e] = v;
      } else {
        const float2 old = __bfloat1622float2(st.sum[u][e]), add = __bfloat1622float2(v);
        st.sum[u][e] = __floats2bfloat162_rn(old.x + add.x, old.y + add.y);
      }
    }
}

// Stage K: o_K (K = 1..4) into its buffer, or for K = 5 the block's output
// tile 0.2 * o5 + x into device memory.  Warpgroup g takes units g, g + 2,
// ...; a unit past the stage's count (stages 1 and 3, warpgroup 1) reads
// the region's last pixel and stores nothing, so that both warpgroups issue
// the same wgmma.  Each unit's last rows past the region are clamped so too.
template <int K>
__device__ __forceinline__ void stage(const Params& p, uint32_t base, int g, int w, int lane,
                                      int ty0, int tx0) {
  using St = Stage<K>;
  constexpr int kU = St::kU, kSide = St::kSide, kPixels = St::kPixels;
  St st;
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int e = 0; e < St::kN / 2; ++e) st.acc[u][e] = 0.f;
  add_source<K, 0>(st, base, g, w, lane);
  if constexpr (K > 1) add_source<K, 1>(st, base, g, w, lane);
  if constexpr (K > 2) add_source<K, 2>(st, base, g, w, lane);
  if constexpr (K > 3) add_source<K, 3>(st, base, g, w, lane);
  if constexpr (K > 4) add_source<K, 4>(st, base, g, w, lane);

  // epilogue: thread (w, lane) holds rows 16 w + lane / 4 (+ 8) of each unit,
  // columns 8 j + 2 (lane % 4) + {0, 1}: sum pair 2 j (+ 1 for the row + 8)
  const int c2 = (lane & 3) * 2;
  const int org_y = ty0 - (kHalo - K), org_x = tx0 - (kHalo - K);  // image coordinates of region (0, 0)
#pragma unroll
  for (int u = 0; u < kU; ++u) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int unit = g + kGroups * u;
      const int m = unit * kUnitPixels + 16 * w + (lane >> 2) + 8 * half;
      if (unit >= St::kUnits || m >= kPixels) continue;
      const int row = m / kSide, col = m % kSide;
      const int gy = org_y + row, gx = org_x + col;
#pragma unroll
      for (int j = 0; j < St::kN / 8; ++j) {
        const int n = 8 * j + c2;
        const float2 s = __bfloat1622float2(st.sum[u][2 * j + half]);
        const float v0 = round_bf16(s.x + round_bf16(__ldg(p.bias + (K - 1) * kC + n)));
        const float v1 = round_bf16(s.y + round_bf16(__ldg(p.bias + (K - 1) * kC + n + 1)));
        if constexpr (K < 5) {
          const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
          const __nv_bfloat162 o = inside ? __floats2bfloat162_rn(lrelu(v0), lrelu(v1))
                                          : __floats2bfloat162_rn(0.f, 0.f);
          hopper::st_shared_u32(base + buf_offset(K) + m * row_bytes(K) +
                                    (((n >> 3) ^ ((m >> 1) & 3)) << 4) + (n & 7) * 2,
                                reinterpret_cast<const uint32_t&>(o));
        } else if (gy < p.H && gx < p.W) {
          const int px = (row + kHalo) * side(0) + col + kHalo;
          const uint32_t xw = hopper::ld_shared_u32(base + kXOffset + px * row_bytes(0) +
                                                    (((n >> 3) ^ (px & 7)) << 4) + (n & 7) * 2);
          const float2 xv = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162&>(xw));
          const float res = round_bf16(0.2f);
          bf16* out = static_cast<bf16*>(p.out) + (((size_t)blockIdx.z * p.H + gy) * p.W + gx) * kC + n;
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(round_bf16(v0 * res) + xv.x, round_bf16(v1 * res) + xv.y);
        }
      }
    }
  }
}

// One RDB on an output tile of 16 x 16 pixels a block: warps 0-7 are two
// consumer warpgroups, warps 8-11 the producer, of which one thread loads
// x's haloed tile by TMA and streams the 124 weight boxes through the ring.
__global__ void __launch_bounds__(kThreads, 1)
    rdb_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_x, Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (kAlign - hopper::smem_u32(smem_raw) % kAlign) % kAlign;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarrierOffset);
  uint64_t* empty = full + kRingSlots;
  uint64_t* x_full = empty + kRingSlots;
  const uint32_t base = hopper::smem_u32(smem);
  // warp-uniform as far as the compiler can see (a broadcast lane), so the
  // consumers' wgmma sit on no divergent path
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingSlots; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_init(x_full, 1);
    hopper::fence_mbarrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    hopper::setmaxnreg_dec<kProducerRegisters>();
    if (warp == kConsumers / 32 && lane == 0) {
      // x with its 5-pixel halo: one 4-D box, zeros outside the image
      hopper::mbar_arrive_expect_tx(x_full, buffer_bytes(0));
      hopper::tma_load_4d(smem + kXOffset, &map_x, x_full, 0, tx0 - kHalo, ty0 - kHalo, blockIdx.z);
      const unsigned char* w = static_cast<const unsigned char*>(p.w[0]);
      for (int i = 0; i < kStreamBoxes; ++i) {
        const int s = i % kRingSlots;
        hopper::mbar_wait(&empty[s], ((i / kRingSlots) & 1) ^ 1);  // round 0 passes at once
        hopper::mbar_arrive_expect_tx(&full[s], kBoxBytes);
        hopper::bulk_load(smem + s * kBoxBytes, w + (size_t)i * kBoxBytes, kBoxBytes, &full[s]);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegisters>();
  const int g = warp / 4, w = warp % 4;
  hopper::mbar_wait(x_full, 0);
  stage<1>(p, base, g, w, lane, ty0, tx0);
  hopper::named_barrier(1, kConsumers);  // o1 is whole before stage 2 reads it
  stage<2>(p, base, g, w, lane, ty0, tx0);
  hopper::named_barrier(1, kConsumers);
  stage<3>(p, base, g, w, lane, ty0, tx0);
  hopper::named_barrier(1, kConsumers);
  stage<4>(p, base, g, w, lane, ty0, tx0);
  hopper::named_barrier(1, kConsumers);
  stage<5>(p, base, g, w, lane, ty0, tx0);
}

int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  CUtensorMap map_x;
  const int err = hopper::encode_bf16_4d(
      &map_x, p.x, {(uint64_t)kC, (uint64_t)p.W, (uint64_t)p.H, (uint64_t)B},
      {kC, (uint32_t)side(0), (uint32_t)side(0), 1}, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const cudaError_t cerr = cudaFuncSetAttribute(
      rdb_bf16_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((p.W + kTile - 1) / kTile, (p.H + kTile - 1) / kTile, B);
  rdb_bf16_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(map_x, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

__global__ void __launch_bounds__(kThreads, 1) rdb_f32_split_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  rdb_body<3>(p, reinterpret_cast<bf16*>(smem_raw));
}

template <int P>
int launch(void (*kernel)(Params), const Params& p, int B, cudaStream_t stream) {
  constexpr int kBytes = static_cast<int>(Layout<P>::kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kTile = tile_side<P>();
  const dim3 grid((p.W + kTile - 1) / kTile, (p.H + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (w0..w4 the bf16 hi parts of the packed weights, l0..l4
// their lo parts), 1 = bfloat16 (w0 the weight boxes of
// ops/fused_rdb.py::box_rdb_weights, the others unused).  Returns 0, the
// cudaError_t of the launch, or hopper::kEncodeErrorBase + the CUresult of
// a failed tensor-map encode.
extern "C" int fused_rdb_forward(int dtype, const void* x, const void* w0, const void* w1,
                                 const void* w2, const void* w3, const void* w4, const void* l0,
                                 const void* l1, const void* l2, const void* l3, const void* l4,
                                 const void* bias, void* out, int B, int H, int W, void* stream) {
  const Params p{x, {w0, w1, w2, w3, w4}, {l0, l1, l2, l3, l4}, static_cast<const float*>(bias), out, H, W};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<3>(rdb_f32_split_kernel, p, B, s);
  if (dtype == 1) return wg::launch_bf16(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The geometry of the dtype's kernel (0 = float32, 1 = bfloat16) into
// out[6]: output tile side, threads, dynamic shared-memory bytes, weight
// ring slots, bytes a slot, slots a tile streams.  Returns 0, or
// cudaErrorInvalidValue for another dtype.  The wrapper holds it against
// ops/fused_rdb.py::rdb_plan.
extern "C" int fused_rdb_built_plan(int dtype, int* out) {
  if (dtype == 0) {
    const int values[6] = {tile_side<3>(), kThreads, static_cast<int>(Layout<3>::kSmemBytes),
                           kRingSlots, static_cast<int>(Layout<3>::kSlotElems * sizeof(bf16)),
                           kSlices};
    for (int i = 0; i < 6; ++i) out[i] = values[i];
    return 0;
  }
  if (dtype == 1) {
    const int values[6] = {wg::kTile, wg::kThreads, wg::kSmemBytes, wg::kRingSlots, wg::kBoxBytes,
                           wg::kStreamBoxes};
    for (int i = 0; i < 6; ++i) out[i] = values[i];
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
