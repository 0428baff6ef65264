// Fused ResidualDenseBlock forward for Hopper (sm_90a), on CUDA cores.
//
// Replaces the Pallas TPU kernel real_esrgan_tpu/ops/pallas_rdb.py::fused_rdb.
// One launch computes one whole RDB of the RRDB generator: x in (B, H, W, 64)
// NHWC, 0.2 * o5 + x out.  The four intermediates o1..o4 (32 channels each)
// never touch device memory: each block keeps its x tile with a 5-pixel halo
// and o1 at (T+8)^2, o2 at (T+6)^2, o3 at (T+4)^2, o4 at (T+2)^2 in shared
// memory, and writes only its T x T output tile.
//
// Bound: compute.  One RDB costs 2*9*(64*32 + 96*32 + 128*32 + 160*32 +
// 192*64) = 479,232 FLOP per pixel against 2 * 64 * sizeof(T) bytes per pixel
// of device-memory traffic (x read once, out written once), about 1,900 FLOP
// per byte in bf16.  The halo recompute adds about 1.34x (bf16, T=16) and
// 1.77x (f32, T=8) to the FLOPs actually executed.  This first version runs on
// CUDA cores with f32 accumulation (no wgmma, no TMA); the tensor-core version
// is later work.
//
// Numerics follow the packed formulation of the flax block
// (real_esrgan_tpu/models/rrdbnet.py, ResidualDenseBlock, packed=True):
// every (source, consumer) 3x3 conv accumulates in f32 and is rounded to the
// element type; the per-source terms are then added in the element type in
// the order x, o1, o2, o3, o4, then the bias; LeakyReLU(0.2) on o1..o4; the
// output is T(0.2) * o5 + x.  For T = float every rounding is the identity.
// Two deliberate departures from the Pallas kernel:
//   * intermediates at positions outside the image are zero ('same' conv
//     semantics of the flax block; the Pallas kernel computes them there);
//   * H and W need not be multiples of the tile: the ragged edge is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;        // RDB channels
constexpr int kG = 32;        // growth channels
constexpr int kHalo = 5;      // five chained 3x3 convs
constexpr int kThreads = 512;
constexpr int kPix = 8;       // pixels of one work item
constexpr int kQ = 2;         // output channels of one work item

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kTile = 8;
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static void load8(const float* p, float* v) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ __forceinline__ static float2 load2_global(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ static float get(const float* p) { return *p; }
  __device__ __forceinline__ static void put2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kTile = 16;
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  // element 0 of a packed pair sits in the low 16 bits
  __device__ __forceinline__ static float lo(uint32_t u) { return __uint_as_float(u << 16); }
  __device__ __forceinline__ static float hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
  __device__ __forceinline__ static void load8(const __nv_bfloat16* p, float* v) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    v[0] = lo(r.x); v[1] = hi(r.x); v[2] = lo(r.y); v[3] = hi(r.y);
    v[4] = lo(r.z); v[5] = hi(r.z); v[6] = lo(r.w); v[7] = hi(r.w);
  }
  __device__ __forceinline__ static float2 load2_global(const __nv_bfloat16* p) {
    const uint32_t r = __ldg(reinterpret_cast<const unsigned int*>(p));
    return make_float2(lo(r), hi(r));
  }
  __device__ __forceinline__ static float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ __forceinline__ static void put2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// Shared-memory buffer K: K = 0 is the x tile, K = 1..4 is o_K.
template <typename T, int K>
struct Buf {
  static constexpr int kSide = Traits<T>::kTile + 2 * (kHalo - K);
  static constexpr int kCh = K == 0 ? kC : kG;
  static constexpr int kElems = kSide * kSide * kCh;
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (Buf<T, 0>::kElems + Buf<T, 1>::kElems + Buf<T, 2>::kElems +
                      Buf<T, 3>::kElems + Buf<T, 4>::kElems);
}

struct Params {
  const void* x;
  const void* w[5];   // per-source packed weights, (9, Cin_s, N_s), N contiguous
  const float* bias;  // (5, 64)
  void* out;
  int H, W;
};

template <typename T>
__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : Traits<T>::round(v * Traits<T>::round(0.2f));
}

// Adds source S's contribution to consumer K for one work item: kPix pixels
// (region coordinates rr, cc of consumer K) by 2 output channels (oc, oc+1).
// Source S's packed weights hold the columns of consumers S+1..5 in order,
// kG wide each except the last (o5), which is kC wide.
template <typename T, int K, int S>
__device__ __forceinline__ void add_source(const T* __restrict__ in, const T* __restrict__ w_src,
                                           const int (&rr)[kPix], const int (&cc)[kPix], int oc,
                                           float (&sum)[kPix][kQ]) {
  using Tr = Traits<T>;
  constexpr int kCin = Buf<T, S>::kCh;
  constexpr int kSin = Buf<T, S>::kSide;
  constexpr int kN = (4 - S) * kG + kC;
  constexpr int kCol = (K - 1 - S) * kG;
  constexpr int kShift = K - S - 1;  // offset of consumer K's region inside source S's buffer
  const T* w = w_src + kCol + oc;

  int base[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) base[j] = ((rr[j] + kShift) * kSin + cc[j] + kShift) * kCin;

  float acc[kPix][kQ];
#pragma unroll
  for (int j = 0; j < kPix; ++j) acc[j][0] = acc[j][1] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = ((tap / 3) * kSin + tap % 3) * kCin;
    const T* wt = w + tap * kCin * kN;
#pragma unroll 1
    for (int ci = 0; ci < kCin; ci += 8) {
      float2 wv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) wv[u] = Tr::load2_global(wt + (ci + u) * kN);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        float xv[8];
        Tr::load8(in + base[j] + toff + ci, xv);
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
    for (int q = 0; q < kQ; ++q) {
      const float t = Tr::round(acc[j][q]);
      sum[j][q] = S == 0 ? t : Tr::round(sum[j][q] + t);
    }
  }
}

// Computes o_K (K = 1..4) into shared memory, or for K = 5 the block's output
// tile 0.2 * o5 + x into device memory.
template <typename T, int K>
__device__ __forceinline__ void stage(const Params& p, T* const (&buf)[5], int b, int ty0, int tx0) {
  using Tr = Traits<T>;
  constexpr int kSide = K < 5 ? Buf<T, K>::kSide : Tr::kTile;
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
    add_source<T, K, 0>(buf[0], static_cast<const T*>(p.w[0]), rr, cc, oc, sum);
    if constexpr (K > 1) add_source<T, K, 1>(buf[1], static_cast<const T*>(p.w[1]), rr, cc, oc, sum);
    if constexpr (K > 2) add_source<T, K, 2>(buf[2], static_cast<const T*>(p.w[2]), rr, cc, oc, sum);
    if constexpr (K > 3) add_source<T, K, 3>(buf[3], static_cast<const T*>(p.w[3]), rr, cc, oc, sum);
    if constexpr (K > 4) add_source<T, K, 4>(buf[4], static_cast<const T*>(p.w[4]), rr, cc, oc, sum);

    const float b0 = Tr::round(p.bias[(K - 1) * kC + oc]);
    const float b1 = Tr::round(p.bias[(K - 1) * kC + oc + 1]);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (pix0 + j >= kRegion) break;
      float v0 = Tr::round(sum[j][0] + b0);
      float v1 = Tr::round(sum[j][1] + b1);
      const int gy = org_y + rr[j];
      const int gx = org_x + cc[j];
      if constexpr (K < 5) {
        const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
        v0 = inside ? lrelu<T>(v0) : 0.f;
        v1 = inside ? lrelu<T>(v1) : 0.f;
        Tr::put2(buf[K] + (rr[j] * kSide + cc[j]) * kG + oc, v0, v1);
      } else {
        if (gy < p.H && gx < p.W) {
          const T* xc = buf[0] + ((rr[j] + kHalo) * Buf<T, 0>::kSide + cc[j] + kHalo) * kC + oc;
          const float res = Tr::round(0.2f);
          const float y0 = Tr::round(Tr::round(v0 * res) + Tr::get(xc));
          const float y1 = Tr::round(Tr::round(v1 * res) + Tr::get(xc + 1));
          T* out = static_cast<T*>(p.out) + (((size_t)blockIdx.z * p.H + gy) * p.W + gx) * kC + oc;
          Tr::put2(out, y0, y1);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) rdb_kernel(Params p) {
  using Tr = Traits<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const buf[5] = {
      reinterpret_cast<T*>(smem),
      reinterpret_cast<T*>(smem) + Buf<T, 0>::kElems,
      reinterpret_cast<T*>(smem) + Buf<T, 0>::kElems + Buf<T, 1>::kElems,
      reinterpret_cast<T*>(smem) + Buf<T, 0>::kElems + Buf<T, 1>::kElems + Buf<T, 2>::kElems,
      reinterpret_cast<T*>(smem) + Buf<T, 0>::kElems + Buf<T, 1>::kElems + Buf<T, 2>::kElems +
          Buf<T, 3>::kElems,
  };
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * Tr::kTile;
  const int tx0 = blockIdx.x * Tr::kTile;

  // x tile with its halo, zero outside the image, in 16-byte vectors
  {
    constexpr int kSide = Buf<T, 0>::kSide;
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kVecs = kSide * kSide * kC / kVec;
    const T* x = static_cast<const T*>(p.x) + (size_t)b * p.H * p.W * kC;
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
  stage<T, 1>(p, buf, b, ty0, tx0);
  __syncthreads();
  stage<T, 2>(p, buf, b, ty0, tx0);
  __syncthreads();
  stage<T, 3>(p, buf, b, ty0, tx0);
  __syncthreads();
  stage<T, 4>(p, buf, b, ty0, tx0);
  __syncthreads();
  stage<T, 5>(p, buf, b, ty0, tx0);
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int kT = Traits<T>::kTile;
  constexpr size_t kSmem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(rdb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.W + kT - 1) / kT, (p.H + kT - 1) / kT, B);
  rdb_kernel<T><<<grid, kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int fused_rdb_forward(int dtype, const void* x, const void* w0, const void* w1,
                                 const void* w2, const void* w3, const void* w4,
                                 const void* bias, void* out, int B, int H, int W, void* stream) {
  const Params p{x, {w0, w1, w2, w3, w4}, static_cast<const float*>(bias), out, H, W};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
