// Convolution epilogue of the folded bf16 serving forward, for Hopper
// (sm_90a): per-channel f32 bias, ONE rounding to bf16, then optionally a
// residual add rounded again, then optionally ReLU, over a convolution's f32
// output in channels_last memory. The result (bf16 values held in f32) is
// written over the input.
//
// Replaces no TPU kernel: in the JAX package XLA fuses this epilogue into
// the convolution. It reproduces that package's op sequence and its
// roundings, deepcut_tpu/ops/conv.py:83-95 (f32 accumulate, + f32 bias,
// astype bf16) followed by models/resnet.py:229-243 (_cbr's ReLU) and :281
// (relu(shortcut + z), a bf16 add), and the heads' crop(up) + sk (:427).
// The convolution before it runs in f32 with TF32 allowed over operands
// that hold bf16 values, so each product is exact and the sum is f32, as
// XLA's bf16 conv with preferred_element_type=f32.
//
// Inputs (on the device): y (N, C, H, W) f32 channels_last-contiguous,
// i.e. P = N*H*W rows of C channels; bias (C,) f32 or null; residual
// (N, C, H, W) f32 with channel stride 1 and any pixel strides (a top-left
// crop of a larger map is a strided view) or null.
//
// Bound: bytes. It reads y (and the residual) once and writes y once,
// 8 (12) bytes per element for one add and a rounding or two: far below
// the card's 295 operations per byte. Design: one pass with 16-byte loads
// and stores where C % 4 == 0 (every trunk conv) and 4-byte ones otherwise
// (the heads' 42 or 406 channels). Threads of a block are (x: channel
// vectors, y: pixels), so a thread keeps its channels across the pixels it
// visits and no integer divide is spent per element; the residual's pixel
// offset costs two divides per pixel, amortised over C channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int V>
struct Pack;

template <>
struct Pack<1> {
  float v[1];
  __device__ __forceinline__ static Pack load(const float* p) {
    Pack k;
    k.v[0] = *p;
    return k;
  }
  __device__ __forceinline__ void store(float* p) const { *p = v[0]; }
};

template <>
struct Pack<4> {
  float v[4];
  __device__ __forceinline__ static Pack load(const float* p) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    Pack k;
    k.v[0] = a.x;
    k.v[1] = a.y;
    k.v[2] = a.z;
    k.v[3] = a.w;
    return k;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(float* __restrict__ y, const float* __restrict__ bias,
                     const float* __restrict__ res, int pixels, int C, int H, int W,
                     long long rn, long long rh, long long rw, int relu) {
  const int vecs = C / V;
  for (int p = blockIdx.x * blockDim.y + threadIdx.y; p < pixels; p += gridDim.x * blockDim.y) {
    float* row = y + static_cast<long long>(p) * C;
    const float* rrow = nullptr;
    if (res != nullptr) {
      const int w = p % W;
      const int t = p / W;
      rrow = res + static_cast<long long>(t / H) * rn + static_cast<long long>(t % H) * rh +
             static_cast<long long>(w) * rw;
    }
    for (int cv = threadIdx.x; cv < vecs; cv += blockDim.x) {
      const int c = cv * V;
      Pack<V> k = Pack<V>::load(row + c);
      Pack<V> b, r;
      if (bias != nullptr) b = Pack<V>::load(bias + c);
      if (rrow != nullptr) r = Pack<V>::load(rrow + c);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v = bias != nullptr ? k.v[e] + b.v[e] : k.v[e];
        v = round_bf16(v);
        if (rrow != nullptr) v = round_bf16(v + r.v[e]);
        // the JAX package's where(x > 0, x, 0): NaN and -0 become +0
        if (relu) v = v > 0.0f ? v : 0.0f;
        k.v[e] = v;
      }
      k.store(row + c);
    }
  }
}

template <int V>
int launch(float* y, const float* bias, const float* res, int pixels, int C, int H, int W,
           long long rn, long long rh, long long rw, int relu, cudaStream_t stream) {
  const int vecs = C / V;
  int bx = 32;
  while (bx / 2 >= vecs && bx > 1) bx /= 2;  // the smallest power of two >= vecs, at most 32
  const dim3 block(bx, kThreads / bx);
  const long long want = (static_cast<long long>(pixels) + block.y - 1) / block.y;
  const int grid = static_cast<int>(want < 65535 ? want : 65535);
  conv_epilogue_kernel<V><<<grid, block, 0, stream>>>(y, bias, res, pixels, C, H, W, rn, rh,
                                                       rw, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError() (0 when
// the launch was accepted). vec4 != 0 takes 16-byte accesses: the caller
// guarantees C % 4 == 0, 16-byte aligned pointers and residual strides that
// are multiples of 4. Pixels = N*H*W < 2**31, checked by the caller.
extern "C" int conv_epilogue_launch(float* y, const float* bias, const float* res, int pixels,
                                    int C, int H, int W, long long rn, long long rh,
                                    long long rw, int relu, int vec4, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec4) return launch<4>(y, bias, res, pixels, C, H, W, rn, rh, rw, relu, stream);
  return launch<1>(y, bias, res, pixels, C, H, W, rn, rh, rw, relu, stream);
}
