// 'same' 3x3 convolution, NHWC bf16, as an implicit GEMM on Hopper's
// tensor cores (sm_90a): TMA loads into shared memory on mbarriers, wgmma
// with A from registers, f32 accumulate, one rounding to bf16, and a TMA
// store of each output tile.  Built on hopper.cuh.
//
// Replaces the Pallas TPU kernel tools/pallas_conv_exp.py::pallas_conv
// (body _conv_kernel).  That kernel copies a full-width strip of tile + 2
// rows into VMEM, builds a (rows * W, 3 * Cin) patch matrix from three
// dx-shifted bands and multiplies it three times.  None of that carries
// over: a full-width strip does not fit a block's 227 KB, and the patch
// matrix exists only because relayouts are dear on the TPU.
//
// Bound.  2 * 9 * Cin * Cout FLOP a pixel against 2 * (Cin + Cout) bytes:
// 432 FLOP a byte at 64 -> 192, above the card's 295, so operations bound
// it, but the two floors are close (0.117 ms of products, 0.080 ms of bytes
// at the tool's default shape): the output stream has to overlap the
// products.
//
// Design (ops/conv3x3.py::conv3x3_plan states the geometry; the launch
// refuses any other):
//   * Persistent blocks, one an SM: block i computes the output-channel
//     slice i % slices (BN channels, BN in {96, 64, 32}) of the pixel tiles
//     i / slices, i / slices + groups, ...; the blocks of one pixel tile's
//     slices run side by side, so x comes from device memory about once.
//     A pixel tile is `tile` rows x 16 pixels, walked 8 rows (one sub-tile,
//     128 pixels) at a time.
//   * The block's weight slice stays in shared memory: w is laid out by the
//     wrapper as a K-major B (Cout, 9 Cin), k = (3 dy + dx) Cin + c, and
//     loaded by TMA once, as ceil(9 Cin / 64) boxes of BN rows x 64 k,
//     128-byte swizzled (hopper.cuh's K-major layout).
//   * Each sub-tile's input window, 10 x 18 pixels with its 1-pixel halo,
//     is one TMA box of a 4-D map over x (Cin, W, H, B) per 64 channels,
//     loaded at (0, x0 - 1, y0 - 1, b): TMA fills the halo outside the
//     image and the channels past Cin with zeros, so there is no masking
//     and no padded copy.  Pixel q of a window lies at byte 128 q, its
//     16-byte chunk c at chunk c ^ (q % 8).  One producer thread keeps a
//     ring of `stages` windows in flight on full/empty mbarriers.
//   * Two consumer warpgroups; warp w of warpgroup g owns output row
//     4 g + w of the sub-tile, 16 pixels: one m64 tile a warpgroup.  For
//     each k step (a tap's 16 channels) a warp loads its 16 shifted pixels
//     with ldmatrix.x4 out of the swizzled window (eight rows hit eight bank
//     groups) and issues wgmma m64nBNk16 with A from registers and B through
//     a descriptor into the resident slice.  A tap's A starts 128 dx bytes
//     into a swizzle atom, which a shared-memory descriptor (base offset 0)
//     cannot address; hence A from registers.  The k steps go in units of
//     four (a tap and 64 channels), double-buffered in registers, one
//     unit's wgmma group in flight while the next unit is loaded.
//   * The epilogue is each warpgroup's own: it rounds to bf16 into its half
//     of the staging tile, BN / 32 boxes of 64 pixels x 32 channels, 64-byte
//     swizzled, behind its own named barrier, and one of its threads stores
//     them with TMA.  The store runs on while the next sub-tile's products
//     do, and one warpgroup's epilogue while the other's products do.
//
// Modes (what each times on this card):
//   0 full   everything;
//   1 dots   weights loaded, the products and the store run; the producer
//            loads no window but completes each window's barrier phase
//            (the values are undefined, as they are on the TPU);
//   2 patch  windows only: the first Cout columns of the dy = 0 patch row
//            [x(y-1, x-1), x(y-1, x), x(y-1, x+1)] are copied out of each
//            window and stored; no weights, no products;
//   3 dma    weights and windows loaded, zeros stored.

#include <cuda_bf16.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

enum Mode { kFull = 0, kDots = 1, kPatch = 2, kDma = 3 };

constexpr int kRows = 8;                      // output rows of a sub-tile
constexpr int kCols = 16;                     // output pixels of a row
constexpr int kWinRows = kRows + 2, kWinCols = kCols + 2;
constexpr int kPixels = kRows * kCols;        // 128: the two warpgroups' m64 tiles
constexpr int kChannelBox = 64;               // channels of one window box: 128 bytes
constexpr int kWindowBoxBytes = kWinRows * kWinCols * kChannelBox * 2;  // 23040
constexpr int kAlign = 1024;                  // the 128-byte swizzle repeats every 1024 bytes
constexpr int kWindowStride = (kWindowBoxBytes + kAlign - 1) / kAlign * kAlign;  // 23552
constexpr int kKBox = 64;                     // k of one weight box: 128 bytes
constexpr int kGroupPixels = kPixels / 2;    // 64: one warpgroup's 4 rows of 16 pixels
constexpr int kOutBoxChannels = 32;           // one output box: 64 pixels x 64 bytes
constexpr int kOutBoxBytes = kGroupPixels * kOutBoxChannels * 2;  // 4096
constexpr int kMaxStages = 4;
constexpr int kMaxChannelBoxes = 2;           // Cin up to 128: the kernels built (CB)
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kSmemLimit = 232448;
constexpr int kWidths[3] = {96, 64, 32};      // BN, widest first

struct Plan {
  int bn, stages, grid, threads, smem_bytes, window_tx_bytes, weight_tx_bytes, k_boxes,
      channel_boxes, pixel_tiles, slices, groups, items;
};

// The geometry ops/conv3x3.py::conv3x3_plan states: BN the widest built width
// that divides Cout and leaves room for two windows; as many windows (up to
// four) as fit beside the weights, the staging tile and the mbarriers (two
// a window and one for the weights), for Cin up to 128; groups of `slices` blocks, as many as
// the SMs hold, none without a pixel tile.  Returns false if nothing fits.
bool conv_plan(int B, int H, int W, int cin, int cout, int tile, int sms, Plan* p) {
  p->channel_boxes = (cin + kChannelBox - 1) / kChannelBox;
  p->k_boxes = (9 * cin + kKBox - 1) / kKBox;
  p->bn = 0;
  if (p->channel_boxes > kMaxChannelBoxes) return false;
  const int window = p->channel_boxes * kWindowStride;
  for (int bn : kWidths) {
    if (cout % bn) continue;
    const int fixed = kAlign + p->k_boxes * bn * 128 + 2 * bn / kOutBoxChannels * kOutBoxBytes + 8;
    const int stages = std::min(kMaxStages, (kSmemLimit - fixed) / (window + 16));
    if (stages >= 2) {
      p->bn = bn;
      p->stages = stages;
      p->smem_bytes = fixed + stages * (window + 16);
      break;
    }
  }
  if (p->bn == 0) return false;
  p->window_tx_bytes = p->channel_boxes * kWindowBoxBytes;
  p->weight_tx_bytes = p->k_boxes * p->bn * 128;
  p->slices = cout / p->bn;
  p->pixel_tiles = B * (H / tile) * (W / kCols);
  p->items = p->pixel_tiles * p->slices;
  p->groups = std::min(p->pixel_tiles, std::max(1, sms / p->slices));
  p->grid = p->groups * p->slices;
  p->threads = kThreads;
  return true;
}

struct Args {
  int H, W, cin, tile, mode, stages, k_boxes, channel_boxes, pixel_tiles, slices, groups;
  int window_tx_bytes, weight_tx_bytes;
};

// The products run in units of four k steps: unit u is tap u / CB (dy, dx)
// and channel box u % CB, 64 channels.  Where Cin is not a multiple of 64
// the last box's channels past Cin are TMA's zeros in the window, so the
// weight rows its k steps reach (the next tap's, or TMA's zeros past 9 Cin)
// add nothing, and every unit is whole: no k step sits under a guard, which
// would cut the wgmma group into single instructions.

// Loads unit u's A fragments: lane l's ldmatrix row is pixel l % 16 of this
// warp's output row, shifted by the tap; its 16-byte chunk is 2 kk + l / 16
// of the unit's box, swizzled by the window pixel.  `lane_q` is the window
// pixel of lane l at tap (0, 0), `half` = l / 16.
template <int CB>
__device__ __forceinline__ void load_unit(uint32_t (&frag)[4][4], uint32_t window, int lane_q,
                                          int half, int u) {
  const int tap = u / CB, box = u % CB;
  const int q = lane_q + (tap / 3) * kWinCols + tap % 3;
  const uint32_t row = window + box * kWindowStride + 128 * q;
  const int swizzle = half ^ (q & 7);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::ldmatrix_x4(frag[kk], row + 16 * ((2 * kk) ^ swizzle));
}

// Issues unit u's four wgmma as one group: k step kk reads the weights'
// k = tap Cin + 64 box + 16 kk .. + 15, in box k / 64 at 32 (k % 64 / 16)
// bytes (hopper.cuh's K-major layout).
template <int BN, int CB>
__device__ __forceinline__ void issue_unit(float (&acc)[BN / 2], uint32_t (&frag)[4][4],
                                           uint32_t weights, int cin, int u) {
  const int k0 = (u / CB) * cin + (u % CB) * kChannelBox;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = k0 + 16 * kk;
    hopper::WgmmaRS<BN>::mma(
        acc, frag[kk],
        hopper::smem_desc(weights + (k / kKBox) * BN * 128 + 32 * ((k % kKBox) / 16), 16, 1024),
        u + kk > 0);
  }
  hopper::wgmma_commit();
}

__device__ __forceinline__ void fence_unit(uint32_t (&frag)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::fence_fragment(frag[kk]);
}

// acc = this warpgroup's 64 x BN product over all 9 CB units: unit u + 1
// is loaded while unit u's group runs, in the other fragment buffer.
template <int BN, int CB>
__device__ __forceinline__ void products(float (&acc)[BN / 2], uint32_t window, uint32_t weights,
                                         int orow, int lane, int cin) {
  const int lane_q = orow * kWinCols + (lane & 15), half = lane >> 4;
  uint32_t frag[2][4][4];
  load_unit<CB>(frag[0], window, lane_q, half, 0);
  hopper::fence_operands(acc);
#pragma unroll
  for (int u = 0; u < 9 * CB; ++u) {
    issue_unit<BN, CB>(acc, frag[u % 2], weights, cin, u);
    hopper::wgmma_wait<1>();  // unit u - 1 is done: its buffer is free
    fence_unit(frag[(u + 1) % 2]);
    if (u + 1 < 9 * CB) load_unit<CB>(frag[(u + 1) % 2], window, lane_q, half, u + 1);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);
}

// The 16-byte chunk of channel n (0..BN-1, a multiple of 8) of pixel r
// (0..63) in a warpgroup's staging tile: box n / 32, 64-byte rows, 64-byte
// swizzle (address bits 4-5 XOR bits 7-8).
__device__ __forceinline__ uint32_t out_offset(int r, int n) {
  return (n / kOutBoxChannels) * kOutBoxBytes + 64 * r +
         16 * (((n % kOutBoxChannels) >> 3) ^ ((r >> 1) & 3));
}

template <int BN, int CB>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_out, Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (kAlign - hopper::smem_u32(smem_raw) % kAlign) % kAlign;
  unsigned char* weights = base;
  unsigned char* windows = weights + a.k_boxes * BN * 128;
  const int window_bytes = a.channel_boxes * kWindowStride;
  unsigned char* staging = windows + a.stages * window_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * BN / kOutBoxChannels * kOutBoxBytes);
  uint64_t* empty = full + a.stages;
  uint64_t* weights_bar = empty + a.stages;
  // warp-uniform as far as the compiler can see (a broadcast lane), so the
  // consumers' wgmma sit on no divergent path
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int slice = blockIdx.x % a.slices, group = blockIdx.x / a.slices;
  const int n0 = slice * BN;
  const int tiles_x = a.W / kCols, tiles_y = a.H / a.tile, subs = a.tile / kRows;
  const bool use_weights = a.mode != kPatch;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_init(weights_bar, 1);
    hopper::fence_mbarrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer: one thread issues every load
    if (lane == 0) {
      if (use_weights) {
        hopper::mbar_arrive_expect_tx(weights_bar, a.weight_tx_bytes);
        for (int u = 0; u < a.k_boxes; ++u)
          hopper::tma_load_2d(weights + u * BN * 128, &map_w, weights_bar, u * kKBox, n0);
      }
      int n = 0;
      for (int p = group; p < a.pixel_tiles; p += a.groups) {
        const int tx = p % tiles_x, ty = (p / tiles_x) % tiles_y, b = p / (tiles_x * tiles_y);
        for (int sub = 0; sub < subs; ++sub, ++n) {
          const int s = n % a.stages;
          hopper::mbar_wait(&empty[s], ((n / a.stages) & 1) ^ 1);  // round 0 passes at once
          if (a.mode == kDots) {
            hopper::mbar_arrive(&full[s]);
            continue;
          }
          hopper::mbar_arrive_expect_tx(&full[s], a.window_tx_bytes);
          for (int kc = 0; kc < a.channel_boxes; ++kc)
            hopper::tma_load_4d(windows + s * window_bytes + kc * kWindowStride, &map_x, &full[s],
                                kc * kChannelBox, tx * kCols - 1, ty * a.tile + sub * kRows - 1, b);
        }
      }
    }
    return;
  }

  const int orow = warp;            // output row of this warp in the sub-tile: 4 g + w
  const int g = warp / 4;           // its warpgroup
  const bool storer = threadIdx.x % 128 == 0;  // the thread that stores the warpgroup's tile
  staging += g * (BN / kOutBoxChannels) * kOutBoxBytes;  // the warpgroup's half
  const uint32_t weights_u32 = hopper::smem_u32(weights);
  if (use_weights) hopper::mbar_wait(weights_bar, 0);
  float acc[BN / 2];
  int n = 0;
  for (int p = group; p < a.pixel_tiles; p += a.groups) {
    const int tx = p % tiles_x, ty = (p / tiles_x) % tiles_y, b = p / (tiles_x * tiles_y);
    for (int sub = 0; sub < subs; ++sub, ++n) {
      const int s = n % a.stages;
      hopper::mbar_wait(&full[s], (n / a.stages) & 1);
      unsigned char* window = windows + s * window_bytes;
      if (a.mode == kFull || a.mode == kDots)
        products<BN, CB>(acc, hopper::smem_u32(window), weights_u32, orow, lane, a.cin);

      // The epilogue is the warpgroup's own (its barrier, its half of the
      // staging tile, its store), so one warpgroup's epilogue overlaps the
      // other's products.  The store before this one has read the tile.
      if (storer) hopper::bulk_wait_read();
      hopper::named_barrier(1 + g, 128);
      if (a.mode == kFull || a.mode == kDots) {
        // accumulator (row 16 (warp % 4) + lane / 4 (+ 8), column 8 j +
        // 2 (lane % 4)) is pixel `row` of the warpgroup's 64
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * (warp % 4) + lane / 4 + 8 * half;
            *reinterpret_cast<__nv_bfloat162*>(staging + out_offset(r, 8 * j) + 4 * (lane % 4)) =
                __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
          }
      } else {
        // one 16-byte chunk (8 channels) a thread and step
        for (int i = threadIdx.x % 128; i < kGroupPixels * BN / 8; i += 128) {
          const int r = i / (BN / 8), nn = 8 * (i % (BN / 8));
          uint4 value = make_uint4(0, 0, 0, 0);
          if (a.mode == kPatch) {  // column j of the patch: channel j % Cin of band dx = j / Cin
            const int j = n0 + nn, dx = j / a.cin, c = j % a.cin;
            const int q = (4 * g + r / kCols) * kWinCols + r % kCols + dx;
            value = *reinterpret_cast<const uint4*>(
                window + (c / kChannelBox) * kWindowStride + 128 * q +
                16 * (((c % kChannelBox) >> 3) ^ (q & 7)));
          }
          *reinterpret_cast<uint4*>(staging + out_offset(r, nn)) = value;
        }
      }
      hopper::mbar_arrive(&empty[s]);  // this thread is done with the window
      hopper::fence_proxy_async();
      hopper::named_barrier(1 + g, 128);
      if (storer) {
#pragma unroll
        for (int j = 0; j < BN / kOutBoxChannels; ++j)
          hopper::tma_store_4d(&map_out, staging + j * kOutBoxBytes, n0 + j * kOutBoxChannels,
                               tx * kCols, ty * a.tile + sub * kRows + 4 * g, b);
        hopper::bulk_commit();
      }
    }
  }
  if (storer) hopper::bulk_wait_read();
}

template <int BN, int CB>
int launch(const void* x, const void* w, void* out, int B, int H, int W, int cin, int cout,
           int tile, int mode, const Plan& p, cudaStream_t stream) {
  CUtensorMap map_x, map_w, map_out;
  int err = hopper::encode_bf16_4d(&map_x, x, {(uint64_t)cin, (uint64_t)W, (uint64_t)H, (uint64_t)B},
                                   {kChannelBox, kWinCols, kWinRows, 1},
                                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = hopper::encode_bf16_2d(&map_w, w, cout, 9 * (uint64_t)cin, BN, kKBox);
  if (err != 0) return err;
  err = hopper::encode_bf16_4d(&map_out, out,
                               {(uint64_t)cout, (uint64_t)W, (uint64_t)H, (uint64_t)B},
                               {kOutBoxChannels, kCols, kRows / 2, 1}, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return err;
  const cudaError_t cerr = cudaFuncSetAttribute(
      conv3x3_kernel<BN, CB>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const Args args{H,        W,        cin,           tile,     mode,
                  p.stages, p.k_boxes, p.channel_boxes, p.pixel_tiles, p.slices,
                  p.groups, p.window_tx_bytes, p.weight_tx_bytes};
  conv3x3_kernel<BN, CB><<<p.grid, kThreads, p.smem_bytes, stream>>>(map_x, map_w, map_out, args);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int H, int W, int cin, int cout, int tile, int sms) {
  return B <= 0 || H <= 0 || W <= 0 || tile <= 0 || tile % kRows || H % tile || W % kCols ||
         cin <= 0 || cin % 16 || cout <= 0 || cout % 32 || sms <= 0;
}

}  // namespace

// x (B, H, W, Cin) bf16; w_k the K-major weights (Cout, 9 Cin) bf16, k =
// (3 dy + dx) Cin + c; out (B, H, W, Cout) bf16; all contiguous, on 16-byte
// boundaries.  H % tile == 0, tile % 8 == 0, W % 16 == 0, Cin % 16 == 0,
// Cout % 32 == 0; mode patch needs Cout <= 3 Cin.  bn and stages must be
// the plan's at this shape on `sms` SMs (the wrapper passes
// conv3x3_plan's).  Returns 0, the cudaError_t of the launch, or
// hopper::kEncodeErrorBase + the CUresult of a failed tensor-map encode.
extern "C" int conv3x3_forward(const void* x, const void* w_k, void* out, int B, int H, int W,
                               int cin, int cout, int tile, int mode, int bn, int stages, int sms,
                               void* stream) {
  Plan p;
  if (bad_shape(B, H, W, cin, cout, tile, sms) || mode < kFull || mode > kDma ||
      (mode == kPatch && cout > 3 * cin) || !conv_plan(B, H, W, cin, cout, tile, sms, &p) ||
      bn != p.bn || stages != p.stages)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // BN = 96 with two channel boxes never fits: its weights alone outgrow
  // shared memory beside two windows, so that kernel is not built
  switch (p.bn * 4 + p.channel_boxes) {
    case 96 * 4 + 1: return launch<96, 1>(x, w_k, out, B, H, W, cin, cout, tile, mode, p, s);
    case 64 * 4 + 1: return launch<64, 1>(x, w_k, out, B, H, W, cin, cout, tile, mode, p, s);
    case 32 * 4 + 1: return launch<32, 1>(x, w_k, out, B, H, W, cin, cout, tile, mode, p, s);
    case 64 * 4 + 2: return launch<64, 2>(x, w_k, out, B, H, W, cin, cout, tile, mode, p, s);
    case 32 * 4 + 2: return launch<32, 2>(x, w_k, out, B, H, W, cin, cout, tile, mode, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The geometry conv3x3_forward launches at this shape on `sms` SMs, into
// out[13]: bn, stages, grid, threads, dynamic shared-memory bytes, window
// and weight transaction bytes, weight boxes, channel boxes, pixel tiles,
// slices, groups, items.  Returns 0, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int conv3x3_built_plan(int B, int H, int W, int cin, int cout, int tile, int sms,
                                  int* out) {
  Plan p;
  if (bad_shape(B, H, W, cin, cout, tile, sms) || !conv_plan(B, H, W, cin, cout, tile, sms, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int values[13] = {p.bn,          p.stages,          p.grid,
                          p.threads,     p.smem_bytes,      p.window_tx_bytes,
                          p.weight_tx_bytes, p.k_boxes,     p.channel_boxes,
                          p.pixel_tiles, p.slices,          p.groups,
                          p.items};
  std::copy(values, values + 13, out);
  return 0;
}
