// LayerNorm over the last dim of a contiguous (rows, C) tensor: SwinIR's
// normalisation of the token stream, 2 a Swin block and 2 more a forward
// (110 a SwinIR-L forward).
//
// Replaces no TPU kernel: the JAX package runs no model with a LayerNorm.
// PyTorch's own kernel (vectorized_layer_norm_kernel) launches a block of 128
// threads a row; at SwinIR-L's 240 channels in bf16 a row is 480 bytes, so
// half of each block's lanes idle and every row pays a shared-memory
// reduction and a barrier.  It moved 0.72 TB/s at the batch cell's 16 x 256^2
// tokens, 22% of the card's memory rate.
//
// Bound.  Bytes: the input read once and the output written once, about one
// operation a byte, so the card's 3.35 TB/s sets the least time.
//
// Design:
//   * A warp a row.  Each lane holds up to 8 channels of the row in
//     registers, as vectors of VB bytes (16, 8, 4 or 2, the widest that
//     divides the row and every pointer): at C = 240 in bf16 lanes 0-29 hold
//     one 16-byte vector each, in float32 two.  So rows of up to 256
//     channels, and the row stays in registers from its load to its store.
//   * Statistics in float32: the mean from a warp's shuffle sum, then the
//     variance as the mean of (x - mean)^2 over the registers (two passes,
//     nothing read twice), rstd = rsqrtf(var + eps).  The output is
//     gamma ((x - mean) rstd) + beta in float32, rounded once to the input's
//     dtype, as PyTorch's kernel computes it; gamma and beta come in the
//     input's dtype.  The two differ in the order of their sums alone.
//   * Bytes in flight.  Each warp loads gamma and beta once, then walks groups
//     of kRows = 2 rows grid-stride and issues the loads of its next group
//     before the current group's reductions and stores.  A 480-byte row a
//     warp falls short of the 15-20 KB an SM that Little's law asks at 3.35
//     TB/s; two rows loading behind two rows reducing reach it.  The grid
//     is the SMs times the blocks an SM holds, so every warp slot walks.
//     (At the batch cell's shape 1, 2 or 4 rows, streaming cache hints and
//     a grid of four such waves all came within 3% of this; fewer registers
//     for more blocks an SM put the arrays in local memory and lost.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneElems = 8;  // channels a lane holds of one row
constexpr int kMaxChannels = 32 * kLaneElems;
constexpr int kRows = 2;  // rows a warp holds in each of its two stages

using bf16 = __nv_bfloat16;

template <int VB>
struct Vec;
template <>
struct Vec<16> { using type = uint4; };
template <>
struct Vec<8> { using type = uint2; };
template <>
struct Vec<4> { using type = uint32_t; };
template <>
struct Vec<2> { using type = unsigned short; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float x) { return __float2bfloat16_rn(x); }

// A lane's vectors of one row: lane, lane + 32, ...
template <typename T, int VB>
struct Lane {
  using Raw = typename Vec<VB>::type;
  static constexpr int kPer = VB / static_cast<int>(sizeof(T));  // elements a vector
  static constexpr int kVecs = kLaneElems / kPer;                 // vectors a lane
};

template <typename T, int VB>
__device__ __forceinline__ void unpack(typename Vec<VB>::type raw, float* v) {
  T e[Lane<T, VB>::kPer];
  memcpy(e, &raw, VB);
#pragma unroll
  for (int i = 0; i < Lane<T, VB>::kPer; ++i) v[i] = widen(e[i]);
}

// Rows group R .. group R + R - 1 (those below `rows`) into `buf`.
template <typename T, int VB, int R>
__device__ __forceinline__ void load_rows(typename Vec<VB>::type (&buf)[R][Lane<T, VB>::kVecs],
                                          const T* x, long long group, long long rows,
                                          int channels, int lane, const bool* valid) {
  using Raw = typename Vec<VB>::type;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = group * R + r;
    const Raw* src = reinterpret_cast<const Raw*>(x + row * channels);
#pragma unroll
    for (int k = 0; k < Lane<T, VB>::kVecs; ++k)
      if (row < rows && valid[k]) buf[r][k] = src[lane + 32 * k];
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, T* __restrict__ out, long long rows,
                      int channels, float eps) {
  using L = Lane<T, VB>;
  using Raw = typename L::Raw;
  constexpr int kPer = L::kPer, kVecs = L::kVecs, R = kRows;
  const int lane = threadIdx.x & 31;
  const int row_vecs = channels / kPer;
  bool valid[kVecs];
  float g[kVecs][kPer], b[kVecs][kPer];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = lane + 32 * k;
    valid[k] = v < row_vecs;
    if (valid[k]) {
      unpack<T, VB>(reinterpret_cast<const Raw*>(gamma)[v], g[k]);
      unpack<T, VB>(reinterpret_cast<const Raw*>(beta)[v], b[k]);
    }
  }
  const float c = static_cast<float>(channels);
  const long long groups = (rows + R - 1) / R;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long group = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  Raw cur[R][kVecs], next[R][kVecs];
  if (group < groups) load_rows<T, VB, R>(cur, x, group, rows, channels, lane, valid);
  for (; group < groups; group += stride) {
    if (group + stride < groups)
      load_rows<T, VB, R>(next, x, group + stride, rows, channels, lane, valid);
    float v[R][kVecs][kPer], mean[R], rstd[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mean[r] = 0.f;
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        if (valid[k]) {
          unpack<T, VB>(cur[r][k], v[r][k]);
        } else {
#pragma unroll
          for (int e = 0; e < kPer; ++e) v[r][k][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < kPer; ++e) mean[r] += v[r][k][e];
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) mean[r] += __shfl_xor_sync(0xffffffffu, mean[r], o);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mean[r] /= c;
      rstd[r] = 0.f;
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        if (!valid[k]) continue;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const float d = v[r][k][e] - mean[r];
          rstd[r] += d * d;
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) rstd[r] += __shfl_xor_sync(0xffffffffu, rstd[r], o);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = group * R + r;
      rstd[r] = rsqrtf(rstd[r] / c + eps);
      if (row >= rows) continue;
      Raw* dst = reinterpret_cast<Raw*>(out + row * channels);
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        if (!valid[k]) continue;
        T o[kPer];
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          o[e] = narrow<T>(g[k][e] * ((v[r][k][e] - mean[r]) * rstd[r]) + b[k][e]);
        Raw packed;
        memcpy(&packed, o, VB);
        dst[lane + 32 * k] = packed;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k) cur[r][k] = next[r][k];
    }
  }
}

template <typename T, int VB>
int launch(const void* x, const void* gamma, const void* beta, void* out, long long rows,
           int channels, float eps, cudaStream_t stream) {
  const auto kernel = layer_norm_kernel<T, VB>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks an SM holds: the same on every card of one architecture
  static const int per_sm = [kernel] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) == cudaSuccess
               ? std::max(n, 1) : 1;
  }();
  const long long groups = (rows + kRows - 1) / kRows;
  const long long grid = std::min<long long>((groups + kWarps - 1) / kWarps,
                                             static_cast<long long>(sms) * per_sm);
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(out), rows, channels, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vector(int vector_bytes, const void* x, const void* gamma, const void* beta, void* out,
                  long long rows, int channels, float eps, cudaStream_t stream) {
  switch (vector_bytes) {
    case 16: return launch<T, 16>(x, gamma, beta, out, rows, channels, eps, stream);
    case 8: return launch<T, 8>(x, gamma, beta, out, rows, channels, eps, stream);
    case 4: return launch<T, 4>(x, gamma, beta, out, rows, channels, eps, stream);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, 2>(x, gamma, beta, out, rows, channels, eps, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out = LayerNorm(x) over the last dim, for `rows` contiguous rows of
// `channels` (1 to 256) in x and out; gamma and beta of `channels`, in x's
// dtype.  dtype 0 float32, 1 bf16; vector_bytes (16, 8, 4, or 2 for bf16)
// divides a row's bytes and every pointer's alignment.  Launches on the
// current device's `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int layer_norm_forward(int dtype, const void* x, const void* gamma, const void* beta,
                                  void* out, long long rows, int channels, float eps,
                                  int vector_bytes, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gamma) |
                          reinterpret_cast<uintptr_t>(beta) | reinterpret_cast<uintptr_t>(out);
  if (rows <= 0 || channels < 1 || channels > kMaxChannels || vector_bytes < esize ||
      (channels * esize) % vector_bytes || align % vector_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_vector<float>(vector_bytes, x, gamma, beta, out, rows, channels, eps, s);
    case 1:
      return launch_vector<bf16>(vector_bytes, x, gamma, beta, out, rows, channels, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
