// 'same' 3x3 convolution, NHWC bf16, as an implicit GEMM on Hopper's tensor
// cores (sm_90a, mma.sync fed by ldmatrix, f32 accumulate, one rounding to
// bf16).
//
// Replaces the Pallas TPU kernel tools/pallas_conv_exp.py::pallas_conv
// (body _conv_kernel).  That kernel copies a full-width strip of tile + 2
// rows into VMEM, builds a (rows * W, 3 * Cin) patch matrix from three
// dx-shifted bands and multiplies it three times.  None of that carries
// over: a full-width strip (34 x 258 x 64 bf16 = 1.1 MB) does not fit a
// block's 227 KB, the patch matrix exists only because relayouts are dear on
// the TPU, and the channel and width pads of the TPU's DMA are not needed.
//
// Design.  One block computes a column of `tile` rows x 16 pixels x BN
// output channels (BN = 32 * NF, a slice of Cout), 8 rows at a time:
//   * its weight slice (9, Cin, BN) is loaded into shared memory once and
//     reused for all tile / 8 sub-tiles: that is what `tile` buys here;
//   * for each sub-tile, the 10 x 18 pixel window of x (1-pixel halo, zero
//     outside the image by masking, no padded copy in device memory) is
//     staged in shared memory with cp.async, into one of two buffers, while
//     the products of the sub-tile before it run;
//   * the nine taps read their dx/dy-shifted 16-pixel rows straight from
//     that window with ldmatrix (a pixel is a row of the A operand; the
//     pixel stride of Cin + 8 elements keeps the reads free of bank
//     conflicts), so no patch is built; the 9 * Cin / 16 steps of all taps
//     form one software pipeline;
//   * 8 warps, 4 x 2 over (pixel rows, channels): a warp owns 2 rows of 16
//     pixels by 16 * NF channels.
// Bound: operations.  2 * 9 * Cin * Cout FLOP a pixel against 2 * (Cin +
// Cout) bytes: 432 FLOP a byte at 64 -> 192, above the card's 295.
//
// Modes (what each times on this card):
//   0 full   everything;
//   1 dots   weights loaded, the products and the store run, the window of
//            x is NOT staged (shared memory is read as it lies: the values
//            are undefined, as they are on the TPU);
//   2 patch  only the staging: the window is loaded and the first Cout
//            columns of the dy = 0 patch row [x(y-1, x-1), x(y-1, x),
//            x(y-1, x+1)] are copied out of it; no weights, no products.
//            This design has no patch step, so this times what it has in
//            its place;
//   3 dma    weights and windows are loaded, zeros are written.

#include "mma_tile.cuh"

namespace {

using tile::bf16;
using tile::kSkew;

constexpr int kThreads = 256;  // 8 warps, 4 x 2
constexpr int kRows = 8;       // output rows of one sub-tile
constexpr int kCols = 16;      // output pixels of one row: one fragment
constexpr int kWinRows = kRows + 2, kWinCols = kCols + 2;

enum Mode { kFull = 0, kDots = 1, kPatch = 2, kDma = 3 };

struct Params {
  const bf16* x;    // (B, H, W, Cin)
  const bf16* w;    // (9, Cin, Cout), tap-major
  bf16* out;        // (B, H, W, Cout)
  int H, W, cin, cout, tile, mode;
  int zero;         // always 0; the compiler cannot know, so mode dma keeps its loads
};

// Starts the copy of the window of x for output rows y0..y0+7, columns
// x0..x0+15, zero outside the image.
__device__ __forceinline__ void stage_window(const Params& p, bf16* win, const bf16* x_img, int y0,
                                             int x0) {
  const int vecs = p.cin / 8, pix_ld = p.cin + kSkew;
  for (int i = threadIdx.x; i < kWinRows * kWinCols * vecs; i += kThreads) {
    const int pix = i / vecs, v = i % vecs;
    const int gy = y0 - 1 + pix / kWinCols, gx = x0 - 1 + pix % kWinCols;
    const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    const bf16* src = x_img + (inside ? ((size_t)gy * p.W + gx) * p.cin + v * 8 : 0);
    tile::cp_async_16(win + pix * pix_ld + v * 8, src, inside);
  }
}

// The A operand of the implicit GEMM over its 9 * Cin / 16 steps: tap by tap
// (dy, dx), and inside a tap 16 channels at a time.  base is the window pixel
// of the warp's first output pixel at tap (0, 0).
struct TapCursor {
  const bf16* base;
  int pix_ld, chunks;  // elements a pixel, k steps a tap
  int dy = 0, dx = 0, chunk = 0;
  __device__ __forceinline__ const bf16* ptr() const {
    return base + (dy * kWinCols + dx) * pix_ld + chunk * 16;
  }
  __device__ __forceinline__ void advance() {
    if (++chunk == chunks) {
      chunk = 0;
      if (++dx == 3) { dx = 0; ++dy; }
    }
  }
};

template <int NF>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel(Params p) {
  constexpr int BN = 32 * NF, LDB = BN + kSkew;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pix_ld = p.cin + kSkew;
  bf16* w_s = reinterpret_cast<bf16*>(smem);                      // (9 * Cin, LDB)
  bf16* win0 = w_s + (size_t)9 * p.cin * LDB;                     // 2 x (10, 18, pix_ld)
  const int win_elems = kWinRows * kWinCols * pix_ld;

  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  const int n_cb = p.cout / BN;
  const int b = blockIdx.z / n_cb, col0 = (blockIdx.z % n_cb) * BN;
  const int x0 = blockIdx.x * kCols;
  const bf16* x_img = p.x + (size_t)b * p.H * p.W * p.cin;
  bf16* out_img = p.out + (size_t)b * p.H * p.W * p.cout;

  if (p.mode != kPatch) tile::copy_rows(w_s, LDB, p.w + col0, p.cout, 9 * p.cin, BN / 8);

  const int y_end = (blockIdx.y + 1) * p.tile;
  if (p.mode != kDots) stage_window(p, win0, x_img, blockIdx.y * p.tile, x0);
  for (int y0 = blockIdx.y * p.tile, buf = 0; y0 < y_end; y0 += kRows, buf ^= 1) {
    // this sub-tile's window has landed, and every warp is done with the
    // other buffer, which the next window now overwrites
    tile::cp_async_wait_all();
    __syncthreads();
    const bf16* win = win0 + buf * win_elems;
    if (p.mode != kDots && y0 + kRows < y_end)
      stage_window(p, win0 + (buf ^ 1) * win_elems, x_img, y0 + kRows, x0);

    if (p.mode == kPatch || p.mode == kDma) {
      // one 16-byte vector of 8 output channels a thread and step
      for (int i = threadIdx.x; i < kRows * kCols * (BN / 8); i += kThreads) {
        const int pix = i / (BN / 8), j = col0 + (i % (BN / 8)) * 8;
        const int ry = pix / kCols, rx = pix % kCols;
        uint4 val;
        if (p.mode == kPatch) {  // column j of the patch is channel j % Cin of band dx = j / Cin
          val = *reinterpret_cast<const uint4*>(
              win + (ry * kWinCols + rx + j / p.cin) * pix_ld + j % p.cin);
        } else {
          const uint4 a = *reinterpret_cast<const uint4*>(win + pix * pix_ld);
          const uint4 c = *reinterpret_cast<const uint4*>(w_s + (i % (9 * p.cin)) * LDB);
          const uint32_t z = (a.x ^ c.x) & static_cast<uint32_t>(p.zero);
          val = make_uint4(z, z, z, z);
        }
        *reinterpret_cast<uint4*>(out_img + ((size_t)(y0 + ry) * p.W + x0 + rx) * p.cout + j) = val;
      }
      continue;
    }

    tile::FragC acc[2][NF];
    tile::zero<NF>(acc);
    tile::mma_tile<NF>(TapCursor{win + 2 * wr * kWinCols * pix_ld, pix_ld, p.cin / 16}, pix_ld,
                       kWinCols * pix_ld, w_s + wc * 16 * NF, LDB, 9 * (p.cin / 16), acc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
        tile::store_bf16(acc[i][j], [&](int r) {
          return out_img + ((size_t)(y0 + 2 * wr + i) * p.W + x0 + r) * p.cout + col0 +
                 wc * 16 * NF + j * 16;
        });
  }
}

size_t smem_bytes(int cin, int nf) {
  return sizeof(bf16) * ((size_t)9 * cin * (32 * nf + kSkew) +
                         (size_t)2 * kWinRows * kWinCols * (cin + kSkew));
}

template <int NF>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.cin, NF);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.W / kCols, p.H / p.tile, B * (p.cout / (32 * NF)));
  conv3x3_kernel<NF><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, Cin), w (3, 3, Cin, Cout), out (B, H, W, Cout), bf16,
// contiguous.  H % tile == 0, tile % 8 == 0, W % 16 == 0, Cin % 16 == 0,
// Cout % (32 nf) == 0; mode patch needs Cout <= 3 Cin.  nf is 3 (96 channels a
// block, what the experiment tool's 192 channels take) or 1, which takes every
// other Cout.  Returns the cudaError_t of the launch.
extern "C" int conv3x3_forward(const void* x, const void* w, void* out, int B, int H, int W,
                               int cin, int cout, int tile, int mode, int nf, void* stream) {
  if (nf < 1 || B <= 0 || H <= 0 || W <= 0 || tile <= 0 || tile % kRows || H % tile ||
      W % kCols || cin <= 0 || cin % 16 || cout % (32 * nf) || mode < kFull || mode > kDma ||
      (mode == kPatch && cout > 3 * cin))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out),
                 H, W, cin, cout, tile, mode, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return launch<1>(p, B, s);
    case 3: return launch<3>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
