// Fused pose decode for Hopper (sm_90a): masked per-joint argmax over the
// part-probability maps, the location-refinement gather at the argmax, and
// the 5-row pose.
//
// Replaces the TPU kernel deepcut_tpu/ops/pallas_decode.py:30-78
// (_argmax_kernel launched by joint_argmax, wrapped by decode_pose_pallas)
// together with the XLA decode around it, deepcut_tpu/pose/decode.py:27-62,
// including the bucket mask that the Pallas kernel lacks.
//
// Inputs (all on the device, contiguous): prob (N, J, h, w) f32,
// loc (N, 2J, h, w) f32, vh / vw (N,) int32 valid rows / columns of each
// image's cell grid. Output: (N, 5, J) f32 rows [x, y, conf, off_y, off_x].
//
// Bound: it reads N*J*h*w*4 bytes of prob once (about 0.4 MB for one image
// at a 688 canvas, 14 joints on an 86 x 86 grid) plus two loc values per
// joint, and does a handful of integer and compare operations per cell. At
// these sizes one launch is far below a microsecond of HBM time, so it is
// bound by launch latency; it exists to replace the XLA decode's several
// kernels (mask, argmax, max, gather, stack) with one launch.
//
// Design: the TPU kernel walks 2048-position tiles along a SEQUENTIAL grid
// and carries the running (max, argmax) in its output block; Hopper blocks
// run in no order, so here one block owns one (n, j) map. Each thread scans
// a stride of positions in increasing order, then the block reduces its
// (value, index) pairs by warp shuffle and shared memory. The order is
// jnp.argmax's: NaN above every number (the first NaN wins), then the larger
// value, then the SMALLER index, so ties go to the first position exactly
// as on the TPU. Ties are common on the bf16 serving path, and the pose then
// depends on this rule alone. The pose arithmetic uses the _rn intrinsics so
// nvcc cannot contract it into FMAs: it rounds as the f32 reference does,
// step by step in the same order.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kStride = 8.0f;
constexpr float kHalfStride = 4.0f;
constexpr float kLocrefScale = 7.2801098892805181f;  // sqrt(53)

// True when (v, i) comes before (bv, bi) in jnp.argmax's order.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_reduce(float& bv, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
decode_pose_kernel(const float* __restrict__ prob, const float* __restrict__ loc,
                   const int* __restrict__ vh, const int* __restrict__ vw,
                   float* __restrict__ out, int J, int h, int w, float scale) {
  const int j = blockIdx.x;
  const int n = blockIdx.y;
  const int P = h * w;
  const float* map = prob + (static_cast<size_t>(n) * J + j) * P;
  const int rows = vh[n];
  const int cols = vw[n];

  // INT_MAX loses every tie, so the first scanned cell always replaces the
  // start value, even when it is -inf.
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int r = p / w;
    const int c = p - r * w;
    const float v = (r < rows && c < cols) ? map[p] : -INFINITY;
    if (better(v, p, bv, bi)) {
      bv = v;
      bi = p;
    }
  }
  warp_reduce(bv, bi);

  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = bv;
    s_idx[warp] = bi;
  }
  __syncthreads();
  if (warp != 0) return;
  bv = lane < kWarps ? s_val[lane] : -INFINITY;
  bi = lane < kWarps ? s_idx[lane] : INT_MAX;
  warp_reduce(bv, bi);
  if (lane != 0) return;

  const int row = bi / w;
  const int col = bi - row * w;
  const float* lj = loc + (static_cast<size_t>(n) * 2 * J + 2 * j) * P;
  const float off_x = lj[bi];
  const float off_y = lj[P + bi];
  const float mx = __fmul_rn(off_x, kLocrefScale);
  const float my = __fmul_rn(off_y, kLocrefScale);
  const float x = __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(col), kStride), kHalfStride), mx);
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(row), kStride), kHalfStride), my);
  float* o = out + static_cast<size_t>(n) * 5 * J + j;
  o[0 * J] = __fdiv_rn(x, scale);
  o[1 * J] = __fdiv_rn(y, scale);
  o[2 * J] = bv;
  o[3 * J] = __fdiv_rn(my, scale);
  o[4 * J] = __fdiv_rn(mx, scale);
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError() (0 when
// the launch was accepted). The caller checks shapes: n, J >= 1, h * w >= 1.
extern "C" int decode_pose_launch(const float* prob, const float* loc, const int* vh,
                                  const int* vw, float* out, int n, int J, int h, int w,
                                  float scale, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(J, n);
  decode_pose_kernel<<<grid, kThreads, 0, stream>>>(prob, loc, vh, vw, out, J, h, w, scale);
  return static_cast<int>(cudaGetLastError());
}
