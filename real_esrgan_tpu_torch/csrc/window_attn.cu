// Shifted-window multi-head self-attention of SwinIR's Swin blocks: from the
// qkv projection's output to the heads' concatenated output, in one pass.
//
// Replaces no TPU kernel: the JAX package runs no attention model.  Stock
// PyTorch ops would roll the activation, partition it into windows, write
// the (windows x heads x 64 x 64) scores, read and write them again for the
// bias, the mask and the softmax, multiply by v, and reverse and unroll the
// result: about 8 GB a Swin block at SwinIR-L's batch of 16 x 256^2, where
// the attention itself needs 2 GB.
//
// Bound.  Bytes: q, k and v read once and the output written once (1,920
// bytes a token in bf16 at 8 heads of 30); the products, 61,440 FLOP a
// token, would take a tenth of that time at the bf16 tensor-core rate.
//
// Design:
//   * One block a window of 8 x 8 tokens, one warp a head.  The window's
//     token rows (all heads' q, k and v: 3 C channels, 1,440 bytes at C =
//     240 in bf16) are copied whole into shared memory by cp.async, 16-byte
//     vectors where the row and the pointers allow.  The cyclic shift and
//     the window partition are index arithmetic on those loads: token (ty,
//     tx) of window (wy, wx) is pixel ((8 wy + ty + shift) mod H, (8 wx + tx
//     + shift) mod W).  The output goes back to the same pixel, which undoes
//     both.  Offsets of pixels are 64-bit.
//   * bf16: each warp computes its head's 64 x 64 scores a band of 16 query
//     rows at a time, Q K^T by mma.sync m16n8k16 on the tensor cores, with
//     fragments read straight from the token rows (32-bit pairs of q and k;
//     v's pairs span two tokens and are packed from 16-bit loads).  Head dim
//     30 is padded to 32 in registers only: the pair of dims 30-31 reads as
//     zero.  Scale, bias and mask are added in float32; the softmax is taken
//     in float32 over the whole row of 64 keys, which the band holds, so no
//     running maximum is needed; the probabilities are rounded to bf16 as the
//     A operand of P V.  A row stride of an odd number of 16-byte vectors
//     keeps the fragment loads free of bank conflicts.
//   * float32: the same block and data movement, with the products on the
//     CUDA cores in float32, one query a lane in two rounds.
//   * The bias is table[idx(n, m)][h] from the (15 x 15, heads) table, held
//     in shared memory; idx = (dy + 7) 15 + (dx + 7) for the query's window
//     coordinates less the key's.  The mask is -100 between tokens of
//     different shift regions: rows (and columns) [0, H - 8), [H - 8, H -
//     shift) and [H - shift, H) of the shifted image, labelled 3 ry + rx.
//   * Each warp writes its head's output over its own q in shared memory,
//     and the block copies the C output channels of each token row out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWin = 8;                 // window side
constexpr int kTokens = kWin * kWin;    // tokens a window
constexpr int kHeadDim = 30;            // SwinIR's head dim (embed / heads)
constexpr int kRel = 2 * kWin - 1;      // 15 relative offsets an axis
constexpr int kMaxHeads = 8;            // one warp a head
constexpr float kMaskValue = -100.f;

using bf16 = __nv_bfloat16;

template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(src), "n"(VB)
                 : "memory");
  }
}

template <int VB>
struct Vec;
template <>
struct Vec<16> { using type = uint4; };
template <>
struct Vec<8> { using type = uint2; };
template <>
struct Vec<4> { using type = uint32_t; };

// The window's geometry, shared by both kernels: where each token lives in
// the image, and its shift-region label.
struct Window {
  long long pixel[kTokens];  // (b H + y) W + x of each token
  int label[kTokens];        // 3 ry + rx, or 0 without a shift
};

__device__ __forceinline__ int region(int v, int size, int shift) {
  return v < size - kWin ? 0 : (v < size - shift ? 1 : 2);
}

__device__ void window_geometry(Window& win, int height, int width, int shift) {
  const int wins_w = width / kWin, wins_h = height / kWin;
  const long long w = blockIdx.x;
  const int wx = static_cast<int>(w % wins_w);
  const int wy = static_cast<int>((w / wins_w) % wins_h);
  const long long b = w / (static_cast<long long>(wins_w) * wins_h);
  for (int n = threadIdx.x; n < kTokens; n += blockDim.x) {
    const int ys = wy * kWin + (n >> 3), xs = wx * kWin + (n & 7);  // shifted image
    int y = ys + shift, x = xs + shift;
    if (y >= height) y -= height;
    if (x >= width) x -= width;
    win.pixel[n] = (b * height + y) * width + x;
    win.label[n] = shift ? 3 * region(ys, height, shift) + region(xs, width, shift) : 0;
  }
}

// The window's token rows (3 C elements each, at a stride of `rs`) into
// shared memory, and the bias table; complete on return.
template <typename T, int VB>
__device__ void load_window(T* rows, float* tab, const T* qkv, const float* table,
                            const Window& win, int channels, int heads, int rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  constexpr int kPerVec = VB / sizeof(T);
  const int vecs = 3 * channels / kPerVec;
  for (int n = warp; n < kTokens; n += warps) {
    const T* src = qkv + win.pixel[n] * (3 * channels);
    T* dst = rows + n * rs;
    for (int j = lane; j < vecs; j += 32) cp_async<VB>(dst + j * kPerVec, src + j * kPerVec);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int i = threadIdx.x; i < kRel * kRel * heads; i += blockDim.x) tab[i] = __ldg(table + i);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// The first C elements of each token row (the heads' outputs) to their pixels.
template <typename T, int VB>
__device__ void store_window(T* out, const T* rows, const Window& win, int channels, int rs) {
  using V = typename Vec<VB>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  constexpr int kPerVec = VB / sizeof(T);
  const int vecs = channels / kPerVec;
  for (int n = warp; n < kTokens; n += warps) {
    T* dst = out + win.pixel[n] * channels;
    const T* src = rows + n * rs;
    for (int j = lane; j < vecs; j += 32)
      *reinterpret_cast<V*>(dst + j * kPerVec) = *reinterpret_cast<const V*>(src + j * kPerVec);
  }
}

__device__ __forceinline__ int rel_index(int n, int m) {
  return ((n >> 3) - (m >> 3) + kWin - 1) * kRel + ((n & 7) - (m & 7) + kWin - 1);
}

// ---------------------------------------------------------------- bf16 ---

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Elements d and d + 1 (d even) of a head's row, zero past the head dim.
__device__ __forceinline__ uint32_t pair(const bf16* row, int d) {
  return d < kHeadDim ? *reinterpret_cast<const uint32_t*>(row + d) : 0u;
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int VB>
__global__ void __launch_bounds__(kMaxHeads * 32, 2)
    window_attn_bf16_kernel(const bf16* qkv, const float* table, bf16* out, int height,
                            int width, int heads, int shift, float scale, int rs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Window win;
  bf16* rows = reinterpret_cast<bf16*>(smem);
  float* tab = reinterpret_cast<float*>(smem + kTokens * rs * sizeof(bf16));
  const int channels = heads * kHeadDim;
  window_geometry(win, height, width, shift);
  __syncthreads();
  load_window<bf16, VB>(rows, tab, qkv, table, win, channels, heads, rs);

  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' row group and column pair
  bf16* q = rows + h * kHeadDim;
  const bf16* k = rows + channels + h * kHeadDim;
  const bf16* v = rows + 2 * channels + h * kHeadDim;
  for (int band = 0; band < kTokens / 16; ++band) {
    const int r0 = band * 16 + g, r1 = r0 + 8;
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int d = ks * 16 + 2 * t;
      qa[ks][0] = pair(q + r0 * rs, d);
      qa[ks][1] = pair(q + r1 * rs, d);
      qa[ks][2] = pair(q + r0 * rs, d + 8);
      qa[ks][3] = pair(q + r1 * rs, d + 8);
    }
    float s[8][4];  // key tile nt: (r0, 8 nt + 2t), (r0, +1), (r1, 8 nt + 2t), (r1, +1)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* key = k + (nt * 8 + g) * rs;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        mma_bf16(s[nt], qa[ks], pair(key, ks * 16 + 2 * t), pair(key, ks * 16 + 8 + 2 * t));
    }
    float max0 = -INFINITY, max1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = e < 2 ? r0 : r1, m = nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale + tab[rel_index(n, m) * heads + h];
        if (win.label[n] != win.label[m]) x += kMaskValue;
        s[nt][e] = x;
      }
      max0 = fmaxf(max0, fmaxf(s[nt][0], s[nt][1]));
      max1 = fmaxf(max1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the four lanes of a row group
      max0 = fmaxf(max0, __shfl_xor_sync(0xffffffffu, max0, off));
      max1 = fmaxf(max1, __shfl_xor_sync(0xffffffffu, max1, off));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - max0);
      s[nt][1] = __expf(s[nt][1] - max0);
      s[nt][2] = __expf(s[nt][2] - max1);
      s[nt][3] = __expf(s[nt][3] - max1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    __syncwarp();  // every lane has read this band's q, which the output overwrites
    float o[4][4];
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15
      const uint32_t pa[4] = {pack(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0),
                              pack(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1),
                              pack(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0),
                              pack(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1)};
      const bf16* v0 = v + (16 * kk + 2 * t) * rs;
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        const int d = dn * 8 + g;
        uint32_t b0 = 0u, b1 = 0u;
        if (d < kHeadDim) {
          b0 = pack(v0[d], v0[rs + d]);
          b1 = pack(v0[8 * rs + d], v0[9 * rs + d]);
        }
        mma_bf16(o[dn], pa, b0, b1);
      }
    }
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {  // over this band's q, which no one reads again
      const int d = dn * 8 + 2 * t;
      if (d < kHeadDim) {
        *reinterpret_cast<uint32_t*>(q + r0 * rs + d) = pack(o[dn][0], o[dn][1]);
        *reinterpret_cast<uint32_t*>(q + r1 * rs + d) = pack(o[dn][2], o[dn][3]);
      }
    }
  }
  __syncthreads();
  store_window<bf16, VB>(out, rows, win, channels, rs);
}

// ------------------------------------------------------------- float32 ---

template <int VB>
__global__ void __launch_bounds__(kMaxHeads * 32, 1)
    window_attn_f32_kernel(const float* qkv, const float* table, float* out, int height,
                           int width, int heads, int shift, float scale, int rs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Window win;
  float* rows = reinterpret_cast<float*>(smem);
  float* tab = rows + kTokens * rs;
  const int channels = heads * kHeadDim;
  window_geometry(win, height, width, shift);
  __syncthreads();
  load_window<float, VB>(rows, tab, qkv, table, win, channels, heads, rs);

  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* k = rows + channels + h * kHeadDim;
  const float* v = rows + 2 * channels + h * kHeadDim;
  for (int round = 0; round < kTokens / 32; ++round) {
    const int n = round * 32 + lane;
    float* q = rows + n * rs + h * kHeadDim;  // this lane's own row: the output goes here
    float qv[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 2) {
      const float2 p = *reinterpret_cast<const float2*>(q + d);
      qv[d] = p.x;
      qv[d + 1] = p.y;
    }
    float s[kTokens];
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < kTokens; ++m) {
      const float* key = k + m * rs;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 2) {
        const float2 p = *reinterpret_cast<const float2*>(key + d);
        acc = fmaf(qv[d], p.x, acc);
        acc = fmaf(qv[d + 1], p.y, acc);
      }
      float x = acc * scale + tab[rel_index(n, m) * heads + h];
      if (win.label[n] != win.label[m]) x += kMaskValue;
      s[m] = x;
      mx = fmaxf(mx, x);
    }
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < kTokens; ++m) {
      s[m] = expf(s[m] - mx);
      sum += s[m];
    }
    const float inv = 1.f / sum;
    float o[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) o[d] = 0.f;
#pragma unroll
    for (int m = 0; m < kTokens; ++m) {
      const float p = s[m] * inv;
      const float* val = v + m * rs;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 2) {
        const float2 w = *reinterpret_cast<const float2*>(val + d);
        o[d] = fmaf(p, w.x, o[d]);
        o[d + 1] = fmaf(p, w.y, o[d + 1]);
      }
    }
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 2)
      *reinterpret_cast<float2*>(q + d) = make_float2(o[d], o[d + 1]);
  }
  __syncthreads();
  store_window<float, VB>(out, rows, win, channels, rs);
}

// ------------------------------------------------------------------ host ---

template <typename T>
int row_stride(int channels);
// bf16: 3 C rounded up to an odd number of 16-byte vectors, so that the rows
// of a fragment's eight row groups fall in eight different bank quads
template <>
int row_stride<bf16>(int channels) {
  int vecs = (3 * channels * 2 + 15) / 16;
  if (vecs % 2 == 0) ++vecs;
  return vecs * 8;
}
// float32: whole 16-byte vectors (the lanes of a warp read one key row at a
// time, a broadcast)
template <>
int row_stride<float>(int channels) {
  return (3 * channels * 4 + 15) / 16 * 4;
}

template <typename T>
size_t smem_bytes(int heads, int rs) {
  return static_cast<size_t>(kTokens) * rs * sizeof(T) + sizeof(float) * kRel * kRel * heads;
}

template <int VB>
auto kernel_of(bf16*) { return window_attn_bf16_kernel<VB>; }
template <int VB>
auto kernel_of(float*) { return window_attn_f32_kernel<VB>; }

template <typename T, int VB>
int launch(const void* qkv, const float* table, void* out, long long windows, int height,
           int width, int heads, int shift, float scale, cudaStream_t stream) {
  const int rs = row_stride<T>(heads * kHeadDim);
  const size_t smem = smem_bytes<T>(heads, rs);
  const auto kernel = kernel_of<VB>(static_cast<T*>(nullptr));
  // raised on every launch, since CUDA keeps the limit per device, to the
  // most a block may take (8 heads), so that launches of other head counts
  // from other threads never lower it under one another
  const cudaError_t raised = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T>(kMaxHeads, row_stride<T>(kMaxHeads * kHeadDim))));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  kernel<<<static_cast<unsigned>(windows), heads * 32, smem, stream>>>(
      static_cast<const T*>(qkv), table, static_cast<T*>(out), height, width, heads, shift,
      scale, rs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vector(int vector_bytes, const void* qkv, const float* table, void* out,
                  long long windows, int height, int width, int heads, int shift, float scale,
                  cudaStream_t stream) {
  switch (vector_bytes) {
    case 16:
      return launch<T, 16>(qkv, table, out, windows, height, width, heads, shift, scale, stream);
    case 8:
      return launch<T, 8>(qkv, table, out, windows, height, width, heads, shift, scale, stream);
    case 4:
      return launch<T, 4>(qkv, table, out, windows, height, width, heads, shift, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Window attention of a (batch, height, width, 3 C) qkv tensor, C = heads x
// 30 channels [q | k | v][head][30], into a (batch, height, width, C) output,
// both contiguous in image order; the float32 (225, heads) bias table;
// `shift` 0 or the cyclic shift of a shifted block (0 < shift < 8); `scale`
// 30^-0.5.  height and width are multiples of 8.  dtype 0 float32, 1 bf16;
// vector_bytes 16, 8 or 4 divides C's bytes and both pointers' alignment.
// Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int window_attn_forward(int dtype, const void* qkv, const void* table, void* out,
                                   int batch, int height, int width, int heads, int shift,
                                   float scale, int vector_bytes, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || height % kWin || width % kWin || heads < 1 ||
      heads > kMaxHeads || shift < 0 || shift >= kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dtype == 0 ? 4 : 2;
  const uintptr_t align = reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out);
  if ((heads * kHeadDim * esize) % vector_bytes || align % vector_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long windows =
      static_cast<long long>(batch) * (height / kWin) * (width / kWin);
  if (windows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float* t = static_cast<const float*>(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_vector<float>(vector_bytes, qkv, t, out, windows, height, width, heads, shift,
                                  scale, s);
    case 1:
      return launch_vector<bf16>(vector_bytes, qkv, t, out, windows, height, width, heads, shift,
                                 scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
