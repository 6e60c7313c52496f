// int8 serving convolution pieces for Hopper (sm_90a): the patch gather
// (int8_im2col), the dequantizing / requantizing epilogue (int8_epilogue)
// and the first quantization of a tensor (quantize_i8). The product between
// them is cuBLASLt's int8 GEMM (torch._int_mm, int8 x int8 -> int32).
//
// Replaces no TPU kernel: in the JAX package XLA computes each int8 conv
// with conv_general_dilated (deepcut_tpu/models/quantize.py:66-87) and fuses
// the rest into it. The epilogue reproduces that package's op sequence and
// roundings (quantize.py:116-135, :157, :175-184, :214, :229-230):
//   v = fma(float(acc), s_x * w_scale[c], b[c])    one rounding, as XLA:CPU
//   v = bf16(v)                                    the conv's astype(bf16)
//   v = bf16(v + r)  (f32 residual holding bf16)   relu(shortcut + z), bf16
//   v = v + r        (f32 residual, f32 path)      the heads' crop(up) + sk
//   v = fma(float(r8), s_y, v) (int8 residual)     the int8-resident stream
//   v = v > 0 ? v : 0                              where(x > 0, x, 0)
//   q = clamp(rint(v * (1/s_next)), -127, 127)     quant() of the next conv
// Every operation is an explicit __fmaf_rn / __fadd_rn / __fmul_rn, so
// nvcc's contraction cannot change a rounding.
//
// Inputs (on the device, validated by ops/int8_conv.py):
// - im2col: x (N, H, W, C) int8 contiguous (channels_last NCHW); out
//   rows of ldk >= kh*kw*C int8 (the GEMM's widths are multiples of 8; the
//   caller zeroes any padding), K ordered (kh, kw, C) like the packed weights;
//   zero where the tap falls outside the image or between the pixels of
//   an input dilated by `lhs` (the int8 deconv: lhs 2, pad 2, the flipped
//   kernel packed by the wrapper). The pads of H and W are separate: a
//   row-sharded conv reads its halo rows as they are (pad_h 0) and pads W.
// - epilogue: acc, P = N*H*W rows of ldc >= C int32 (the GEMM's output,
//   its width padded to 8); scale, bias (C,) f32; residual (N, C, H, W)
//   f32 or int8 with channel stride 1 and any pixel strides (a top-left
//   crop is a strided view) or null; out (P, C) f32 and / or out_q (P, C)
//   int8, either may be null.
// - quantize: x f32 and y int8 dense, in the same order, n elements.
//
// Bound: bytes, for all three. im2col reads each input byte kh*kw times
// from L2 at most and writes kh*kw bytes per input byte; the epilogue
// reads 4-12 bytes and writes 1-5 per element for a handful of flops;
// quantize reads 4 and writes 1. The card does ~295 operations per byte,
// so none comes near the tensor cores. Design: one pass each, grid-stride
// loops, 16-byte accesses where the channel count and alignment allow
// (every trunk conv: C % 16 == 0 for im2col, C % 4 == 0 elsewhere) and
// byte / word accesses otherwise (the heads' 42 channels). Epilogue threads
// are (x: channel vectors, y: pixels), as in conv_epilogue.cu, so the
// residual's pixel offset costs two divides per pixel, amortised over C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks per SM

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ signed char quant(float v, float r) {
  float q = rintf(__fmul_rn(v, r));  // round half to even, like jnp.round
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rz(q));
}

// ---- int8_im2col ----------------------------------------------------------
template <int V>
struct Bytes;
template <>
struct Bytes<16> {
  using T = uint4;
};
template <>
struct Bytes<4> {
  using T = unsigned int;
};
template <>
struct Bytes<1> {
  using T = unsigned char;
};

template <int V>
__global__ void __launch_bounds__(kThreads)
im2col_kernel(const signed char* __restrict__ x, signed char* __restrict__ out, int H, int W,
              int C, int kw, int stride, int pad_h, int pad_w, int dil, int lhs, int oh, int ow,
              int rows,
              int taps, long long ldk) {
  using T = typename Bytes<V>::T;
  const int cv = C / V;                 // vectors per tap
  const int kv = taps * cv;             // vectors per output row
  const long long total = static_cast<long long>(rows) * kv;
  const int hd = (H - 1) * lhs + 1;     // the (dilated) input's extent
  const int wd = (W - 1) * lhs + 1;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < total;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int m = static_cast<int>(v / kv);
    const int r = static_cast<int>(v - static_cast<long long>(m) * kv);
    const int tap = r / cv;
    const int c = (r - tap * cv) * V;
    const int i = tap / kw;
    const int j = tap - i * kw;
    const int ox = m % ow;
    const int t = m / ow;
    const int oy = t % oh;
    const int n = t / oh;
    int py = oy * stride + i * dil - pad_h;
    int px = ox * stride + j * dil - pad_w;
    bool inside = py >= 0 && py < hd && px >= 0 && px < wd;
    if (lhs > 1) {
      inside = inside && py % lhs == 0 && px % lhs == 0;
      py /= lhs;
      px /= lhs;
    }
    T val = T();
    if (inside) {
      val = *reinterpret_cast<const T*>(
          x + ((static_cast<long long>(n) * H + py) * W + px) * C + c);
    }
    *reinterpret_cast<T*>(out + static_cast<long long>(m) * ldk + static_cast<long long>(tap) * C +
                          c) = val;
  }
}

// ---- int8_epilogue --------------------------------------------------------
template <int V>
__device__ __forceinline__ void load_i32(const int* p, int (&a)[V]) {
  if constexpr (V == 4) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
  } else {
    a[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&a)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
  } else {
    a[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_i8(const signed char* p, float (&a)[V]) {
  if constexpr (V == 4) {
    const char4 t = *reinterpret_cast<const char4*>(p);
    a[0] = static_cast<float>(t.x);
    a[1] = static_cast<float>(t.y);
    a[2] = static_cast<float>(t.z);
    a[3] = static_cast<float>(t.w);
  } else {
    a[0] = static_cast<float>(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&a)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    *p = a[0];
  }
}

template <int V>
__device__ __forceinline__ void store_i8(signed char* p, const signed char (&a)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<char4*>(p) = make_char4(a[0], a[1], a[2], a[3]);
  } else {
    *p = a[0];
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const int* __restrict__ acc, int ldc, const float* __restrict__ scale,
                const float* __restrict__ bias, const void* __restrict__ res, int res_kind,
                float res_scale, long long rn, long long rh, long long rw,
                float* __restrict__ out, signed char* __restrict__ out_q, float rnext,
                int pixels, int C, int H, int W, int bf16, int relu) {
  const int vecs = C / V;
  for (int p = blockIdx.x * blockDim.y + threadIdx.y; p < pixels; p += gridDim.x * blockDim.y) {
    const int* arow = acc + static_cast<long long>(p) * ldc;
    long long roff = 0;
    if (res_kind != 0) {
      const int w = p % W;
      const int t = p / W;
      roff = static_cast<long long>(t / H) * rn + static_cast<long long>(t % H) * rh +
             static_cast<long long>(w) * rw;
    }
    const long long orow = static_cast<long long>(p) * C;
    for (int cv = threadIdx.x; cv < vecs; cv += blockDim.x) {
      const int c = cv * V;
      int a[V];
      float s[V], b[V], r[V], v[V];
      signed char q[V];
      load_i32<V>(arow + c, a);
      load_f32<V>(scale + c, s);
      load_f32<V>(bias + c, b);
      if (res_kind == 1) load_f32<V>(static_cast<const float*>(res) + roff + c, r);
      if (res_kind == 2) load_i8<V>(static_cast<const signed char*>(res) + roff + c, r);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float x = __fmaf_rn(__int2float_rn(a[e]), s[e], b[e]);
        if (bf16) x = round_bf16(x);
        if (res_kind == 1) {
          x = __fadd_rn(x, r[e]);
          if (bf16) x = round_bf16(x);
        } else if (res_kind == 2) {
          x = __fmaf_rn(r[e], res_scale, x);
        }
        if (relu) x = x > 0.0f ? x : 0.0f;  // NaN and -0 become +0, as JAX's ReLU
        v[e] = x;
        if (out_q != nullptr) q[e] = quant(x, rnext);
      }
      if (out != nullptr) store_f32<V>(out + orow + c, v);
      if (out_q != nullptr) store_i8<V>(out_q + orow + c, q);
    }
  }
}

template <int V>
int launch_epilogue(const int* acc, int ldc, const float* scale, const float* bias,
                    const void* res, int res_kind, float res_scale, long long rn, long long rh,
                    long long rw, float* out, signed char* out_q, float rnext, int pixels, int C,
                    int H, int W, int bf16, int relu, cudaStream_t stream) {
  const int vecs = C / V;
  int bx = 32;
  while (bx / 2 >= vecs && bx > 1) bx /= 2;  // the smallest power of two >= vecs, at most 32
  const dim3 block(bx, kThreads / bx);
  const long long want = (static_cast<long long>(pixels) + block.y - 1) / block.y;
  const int grid = static_cast<int>(want < 65535 ? want : 65535);
  epilogue_kernel<V><<<grid, block, 0, stream>>>(acc, ldc, scale, bias, res, res_kind, res_scale,
                                                 rn, rh, rw, out, out_q, rnext, pixels, C, H, W,
                                                 bf16, relu);
  return static_cast<int>(cudaGetLastError());
}

// ---- quantize_i8 ----------------------------------------------------------
template <int V>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, signed char* __restrict__ y, long long vecs,
                float r) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < vecs;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float a[V];
    signed char q[V];
    load_f32<V>(x + i * V, a);
#pragma unroll
    for (int e = 0; e < V; ++e) q[e] = quant(a[e], r);
    store_i8<V>(y + i * V, q);
  }
}

int grid_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
}

}  // namespace

// Each entry launches on `stream` of `device` and returns cudaGetLastError()
// (0 when the launch was accepted). The caller guarantees the vector width's
// alignment and divisibility (see ops/int8_conv.py) and sizes below 2**31
// rows / pixels.
extern "C" int int8_im2col_launch(const signed char* x, signed char* out, int N, int H, int W,
                                  int C, int kh, int kw, int stride, int pad_h, int pad_w,
                                  int dil, int lhs, int oh, int ow, int rows, int ldk, int vec,
                                  int device, cudaStream_t stream) {
  (void)N;  // rows = N * oh * ow
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vecs = static_cast<long long>(rows) * kh * kw * (C / vec);
  const int grid = grid_for(vecs);
  if (vec == 16) {
    im2col_kernel<16><<<grid, kThreads, 0, stream>>>(x, out, H, W, C, kw, stride, pad_h, pad_w,
                                                     dil, lhs, oh, ow, rows, kh * kw, ldk);
  } else if (vec == 4) {
    im2col_kernel<4><<<grid, kThreads, 0, stream>>>(x, out, H, W, C, kw, stride, pad_h, pad_w,
                                                    dil, lhs, oh, ow, rows, kh * kw, ldk);
  } else {
    im2col_kernel<1><<<grid, kThreads, 0, stream>>>(x, out, H, W, C, kw, stride, pad_h, pad_w,
                                                    dil, lhs, oh, ow, rows, kh * kw, ldk);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int int8_epilogue_launch(const int* acc, int ldc, const float* scale,
                                    const float* bias, const void* res, int res_kind,
                                    float res_scale, long long rn, long long rh, long long rw,
                                    float* out, signed char* out_q, float rnext, int pixels,
                                    int C, int H, int W, int bf16, int relu, int vec4,
                                    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec4) {
    return launch_epilogue<4>(acc, ldc, scale, bias, res, res_kind, res_scale, rn, rh, rw, out,
                              out_q, rnext, pixels, C, H, W, bf16, relu, stream);
  }
  return launch_epilogue<1>(acc, ldc, scale, bias, res, res_kind, res_scale, rn, rh, rw, out,
                            out_q, rnext, pixels, C, H, W, bf16, relu, stream);
}

extern "C" int quantize_i8_launch(const float* x, signed char* y, long long n, float r,
                                  int vec4, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec4) {
    quantize_kernel<4><<<grid_for(n / 4), kThreads, 0, stream>>>(x, y, n / 4, r);
  } else {
    quantize_kernel<1><<<grid_for(n), kThreads, 0, stream>>>(x, y, n, r);
  }
  return static_cast<int>(cudaGetLastError());
}
