// The generator tail's epilogue: bias, LeakyReLU(0.2) and, after a folded
// x2 upconv, the pixel shuffle, in one pass over a convolution's output.
//
// Replaces no TPU kernel.  On the TPU, XLA fuses the bias, the LeakyReLU and
// the depth-to-space of real_esrgan_tpu/models/rrdbnet.py::_subpixel_upconv
// (and the LeakyReLU after conv3) into the convolution's neighbours.  Eager
// PyTorch ran them as separate passes over the full-size tensor (the add, a
// compare, a product and a select) and, after each upconv, a transposing
// copy into NCHW and another back to channels_last.
//
// Bound.  Bytes: each element of y is read once and written once, and no
// arithmetic to speak of, so the card's 3.35 TB/s sets the least time.
//
// Design:
//   * y is a channels_last (N, H, W, G C) tensor: G = 4 after a folded
//     upconv, whose channel g C + o is sub-position g = 2 a + b of output
//     channel o; G = 1 after conv3.  The output of LR pixel (i, j), group g
//     goes to HR pixel (2 i + a, 2 j + b) of a fresh channels_last
//     (N, 2H, 2W, C) tensor; with G = 1 it goes back where it was read (in
//     place).  Every move is a run of C contiguous channels, so both sides
//     load and store 16-byte vectors in whole 32-byte sectors.
//   * A work item is a chunk of kThreads x kUnroll vectors of one input row
//     (n, i); blocks walk the items grid-stride.  Row r = n H + i of the
//     input maps to output rows 2 r + a, so a row's offsets are 64-bit once
//     and 32-bit within it (rows of 2^30 elements or more are refused).  Each
//     thread loads its kUnroll vectors before it stores any: 64 bytes a
//     thread in flight, some 128 KB an SM, enough to cover the memory's
//     latency.
//   * Rounding is the model's plain PyTorch, bit for bit: in bf16 every op
//     widens to float and rounds once, v = bf16(y + bf16(bias)), then
//     v >= 0 ? v : bf16(v * bf16(0.2)); in float32 the same without the
//     roundings.  The _rn intrinsics keep the compiler from contracting the
//     add and the product into one fma.
//   * Channels whose run is not a whole number of 16-byte vectors, or
//     pointers off a 16-byte boundary, take the same loop one element at a
//     time (V = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // vectors a thread holds in flight at once
constexpr int kBlocksPerSm = 8;  // 2048 resident threads an SM at 256 a block
// elements of one input row, past which the row's 32-bit offsets could wrap
constexpr long long kMaxRowElements = 1LL << 30;

// the unit of one load or store: a 16-byte vector, or one element
template <int Bytes>
struct RawOf;
template <>
struct RawOf<16> { using type = uint4; };
template <>
struct RawOf<4> { using type = unsigned int; };
template <>
struct RawOf<2> { using type = unsigned short; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// LeakyReLU(0.2) of y + b, b already rounded to T, as the model's plain
// PyTorch rounds it (ops/tail_epilogue.py::bias_lrelu_plain)
template <typename T>
__device__ __forceinline__ T bias_lrelu_one(T y, float b) {
  const T v = narrow<T>(__fadd_rn(widen(y), b));
  const float fv = widen(v);
  return fv >= 0.f ? v : narrow<T>(__fmul_rn(fv, widen(narrow<T>(0.2f))));
}

template <typename T, int G, int V>
__global__ void __launch_bounds__(kThreads)
    tail_epilogue_kernel(const T* y, const float* bias, T* out, long long rows, int width,
                         int channels, int chunks) {
  using Raw = typename RawOf<sizeof(T) * V>::type;
  const int group_vecs = channels / V;          // vectors of one channel group
  const int row_vecs = width * G * group_vecs;  // vectors of one input row
  const long long items = rows * chunks;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long r = item / chunks;
    const int first = static_cast<int>(item - r * chunks) * (kThreads * kUnroll) + threadIdx.x;
    const Raw* src = reinterpret_cast<const Raw*>(y + r * row_vecs * V);
    Raw in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = first + u * kThreads;
      if (k < row_vecs) in[u] = src[k];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = first + u * kThreads;
      if (k >= row_vecs) continue;
      const int cv = k % group_vecs;
      const int q = k / group_vecs;  // pixel j, group g: q = j G + g
      long long dst;
      if (G == 1) {
        dst = r * row_vecs * V + static_cast<long long>(k) * V;
      } else {
        const int g = q % G, j = q / G;
        dst = (2 * r + (g >> 1)) * (2LL * width * channels) +
              static_cast<long long>(2 * j + (g & 1)) * channels + cv * V;
      }
      T v[V];
      memcpy(v, &in[u], sizeof(Raw));
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[e] = bias_lrelu_one(v[e], widen(narrow<T>(__ldg(bias + cv * V + e))));
      Raw o;
      memcpy(&o, v, sizeof(Raw));
      *reinterpret_cast<Raw*>(out + dst) = o;
    }
  }
}

template <typename T, int G, int V>
int launch(const void* y, const float* bias, void* out, long long rows, int width, int channels,
           int sms, cudaStream_t stream) {
  const int row_vecs = width * G * (channels / V);
  const int chunks = (row_vecs + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int grid = static_cast<int>(std::min<long long>(rows * chunks,
                                                        static_cast<long long>(sms) * kBlocksPerSm));
  tail_epilogue_kernel<T, G, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(y), bias, static_cast<T*>(out), rows, width, channels, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_width(const void* y, const float* bias, void* out, long long rows, int width,
                 int channels, int vector, int sms, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (!vector) return launch<T, G, 1>(y, bias, out, rows, width, channels, sms, stream);
  if (channels % V || reinterpret_cast<unsigned long long>(y) % 16 ||
      reinterpret_cast<unsigned long long>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<T, G, V>(y, bias, out, rows, width, channels, sms, stream);
}

template <typename T>
int launch_groups(const void* y, const float* bias, void* out, long long rows, int width,
                  int channels, int groups, int vector, int sms, cudaStream_t stream) {
  if (groups == 1)
    return launch_width<T, 1>(y, bias, out, rows, width, channels, vector, sms, stream);
  return launch_width<T, 4>(y, bias, out, rows, width, channels, vector, sms, stream);
}

}  // namespace

// out = LeakyReLU(y + bias), shuffled where groups is 4 (see above), for a
// channels_last y of rows = N H input rows of `width` pixels, groups x
// `channels` channels; float32 bias of `channels`.  dtype 0 float32, 1
// bf16; vector 1 for 16-byte vectors (channels a whole number of them, y
// and out on a 16-byte boundary), 0 for one element at a time.  With
// groups 1, out may be y.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int tail_epilogue_forward(int dtype, const void* y, const void* bias, void* out,
                                     long long rows, int width, int channels, int groups,
                                     int vector, int sms, void* stream) {
  if (rows <= 0 || width <= 0 || channels <= 0 || sms <= 0 || (groups != 1 && groups != 4) ||
      static_cast<long long>(width) * groups * channels >= kMaxRowElements)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_groups<float>(y, b, out, rows, width, channels, groups, vector, sms, s);
    case 1:
      return launch_groups<__nv_bfloat16>(y, b, out, rows, width, channels, groups, vector, sms,
                                           s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
