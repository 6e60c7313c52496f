// Fused pose decode for Hopper (sm_90a): per-joint masked argmax, the
// location-refinement gather at the argmax, and the 5-row pose. Two entries
// of one source:
//
// - decode_fused_launch, the serving path's: reads the heads' fused map
//   (N, C >= 3J, h, w) before it is sliced, computes the sigmoid of the J
//   pose logits itself, and takes the valid rows / columns and the scale by
//   value. It leaves out the f32 head copies, the sigmoid launch and the
//   host-to-device copies of the valid sizes that surrounded the first
//   kernel.
// - decode_pose_launch, for paths that already hold probability maps
//   (scoremaps(), the tiled HD path, averaged pyramids, every frame under a
//   mesh): (N, J, h, w) f32 prob and (N, 2J, h, w) f32 loc, read in place as
//   strided views (column stride 1), one thread-block cluster per (image,
//   joint) plane, the valid sizes and the scale by value.
//
// Replaces the TPU kernel deepcut_tpu/ops/pallas_decode.py:30-78
// (_argmax_kernel launched by joint_argmax, wrapped by decode_pose_pallas)
// together with the XLA decode around it, deepcut_tpu/pose/decode.py:27-62,
// including the bucket mask that the Pallas kernel lacks.
//
// Output of both: (N, 5, J) f32 rows [x, y, conf, off_y, off_x].
//
// Order: jnp.argmax's. NaN above every number (the first NaN wins), then
// the larger value, then the SMALLER index, so ties go to the first
// position exactly as on the TPU. Ties are common on the bf16 serving path,
// and the pose then depends on this rule alone. The pose arithmetic uses the
// _rn intrinsics so nvcc cannot contract it into FMAs: it rounds as the f32
// reference does, step by step in the same order. The sigmoid is PyTorch's
// CUDA expression, 1 / (1 + expf(-x)), compiled without fast math, so the
// confidences are those of torch.sigmoid on the card.
//
// Bound (fused entry): bytes. The function needs the J logits of each valid
// cell once (at (4, 14, 88, 88) f32, 1.73 MB: 0.52 us at 3.35 TB/s) plus two
// loc values per joint, and writes N*5*J floats; the sigmoid and the
// compares are a few operations per byte. The map was written by the heads'
// last epilogue a moment before and sits in the 50 MB L2.
//
// Design (fused entry), against the first kernel's 14 blocks at batch 1, a
// divide and a scalar 4-byte load per cell:
// - one thread-block CLUSTER per image, 16 blocks where the card can
//   schedule that many in one cluster and 8 otherwise (host probe below).
//   Each block takes a band of the image's valid rows for all J joints. A
//   thread is (cell group, joint): 32 groups of 16 joint lanes, each thread
//   one running (value, index) pair over its group's cells, so the two
//   groups of a warp meet in one shuffle and the 16 warps in shared memory
//   (J pairs per thread would need J warp-shuffle reductions, each as long
//   as this one). The blocks reduce through distributed shared memory:
//   every block writes its J pairs into block 0's shared memory
//   (map_shared_rank), the cluster syncs once, and block 0 reduces them and
//   writes the pose while the others have left;
// - each block copies its band's logits, only those, into shared memory
//   with asynchronous copies (cp.async), the whole band at once where it
//   fits in 200 KB, so every copy is in flight before one wait. A cell's J
//   logits are 4J contiguous bytes of a channels_last map; a copy moves the
//   widest granule they allow, 16 bytes where J and C are multiples of 4, 8
//   bytes at J = 14 (56 bytes), else 4: a third of the bytes that copying
//   whole rows, loc channels included, would move. A thread's (row, column)
//   advances by a step fixed per block, so no integer divide is spent per
//   cell;
// - the valid sizes, strides and scale arrive by value in the kernel's
//   parameters (FusedArgs), so nothing is copied to the card per call.
//
// Bound (probability-map entry): bytes. It needs each valid cell's
// probability once (at one image's (14, 90, 160) grid, 806 KB: 0.24 us at
// 3.35 TB/s; (14, 136, 240), 1.83 MB: 0.55 us), two loc values per joint
// and the N*5*J floats of the pose; one compare per cell. At these sizes
// the launch, one round of loads, the reductions and one cluster barrier
// set the time (a few microseconds), not the bytes: the design keeps the
// dependent steps few.
//
// Design (probability-map entry), against the first kernel's one
// 256-thread block per plane (14 blocks on 132 SMs at batch 1; an integer
// divide, a scalar load and a select per cell; the valid sizes read from
// device memory):
// - one thread-block CLUSTER of kProbCluster = 8 blocks per (image, joint)
//   plane: 112 blocks of 128 threads at J = 14 and batch 1. The grid is
//   (cluster, J, N); at N = 4, 448 blocks still fit the card at once, and
//   where N*J clusters exceed what it holds, the rest start as earlier
//   clusters leave (every plane is independent: only the time grows).
//   Clusters of 16 (non-portable) won at no path shape on the card by
//   more than two readings of one size differ; 8 is portable and needs no
//   probe. Each block takes a band of the plane's valid rows;
// - a 2-D walk: the band is rows x vectors of G floats (G = 4, 2 or 1: the
//   widest load that the view's width and strides allow, from the wrapper,
//   halved at the launch until the base is aligned), thread t starts at
//   vector t and steps kProbThreads vectors by a fixed (rows, vectors)
//   increment, so no integer divide is spent per cell; neighbouring threads
//   read neighbouring vectors of a row (coalesced), each thread issues
//   kUnroll loads before it compares any (at the paths' shapes a thread
//   reads at most 8 vectors, in one or two rounds).
//   Rows at or past the valid height and vectors wholly past the valid
//   width are never read; the columns of a row's last vector past it are
//   read and skipped;
// - each thread keeps one running (value, index) pair; a warp meets in
//   shuffles, the block's warps in shared memory, and every block writes
//   its pair into block 0's shared memory (map_shared_rank); after one
//   cluster barrier block 0's first warp reduces them in shuffles, gathers
//   the two loc values at the argmax and writes the pose while the others
//   have left;
// - the valid sizes, the element strides of image, joint and row of prob
//   and of loc, and the scale arrive by value (ProbArgs): nothing is copied
//   to the card per call, and a row-cropped or channel-sliced view is read
//   where it lies.

#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// A probability-map view's geometry, checked and built once per geometry by
// the caller (ops/cuda_decode.py mirrors it as a ctypes Structure).
struct ProbGeometry {
  long long pn, pj, ph;  // prob's element strides of image, joint and row; column stride 1
  long long ln, lj, lh;  // loc's
  int n, J, h, w;
  int granule;           // the widest load (4, 2 or 1 floats) the width and strides allow
  int device;
};

namespace {

constexpr int kProbThreads = 128;
constexpr int kProbWarps = kProbThreads / 32;
constexpr int kUnroll = 4;       // vectors a thread loads before it compares any
constexpr int kProbCluster = 8;  // blocks per (image, joint) plane
constexpr float kStride = 8.0f;
constexpr float kHalfStride = 4.0f;
constexpr float kLocrefScale = 7.2801098892805181f;  // sqrt(53)

constexpr int kFusedThreads = 512;
constexpr int kFusedWarps = kFusedThreads / 32;
constexpr int kMaxJoints = 16;   // joint lanes of a fused block: thread = (cell group, joint)
constexpr int kCellGroups = kFusedThreads / kMaxJoints;
constexpr int kMaxCluster = 16;
constexpr int kMaxBatch = 64;    // images per launch (FusedArgs / ProbArgs capacity)
constexpr int kStageFloats = 51200;  // at most 200 KB of staged logits per block

struct FusedArgs {
  long long sn, sh;  // element strides of image and row; the channel stride is 1
                     // and the column stride C (a channels_last map)
  int n, J, h, w, C;
  int granule;       // floats per staging copy: 4, 2 or 1 (16, 8 or 4 bytes)
  int stage_floats;  // the dynamic shared memory, in floats (>= one row)
  float scale;
  int vh[kMaxBatch];
  int vw[kMaxBatch];
};

struct ProbArgs {
  ProbGeometry g;  // the view's; g.n is this launch's images
  float scale;
  int vh[kMaxBatch];
  int vw[kMaxBatch];
};

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

// The pose of joint j from its argmax (cell bi of a w-wide grid, value bv)
// and the two loc values there, into out[0..4][j] (row stride J).
__device__ __forceinline__ void write_pose(float* o, int J, int bi, float bv, int w, float off_x,
                                           float off_y, float scale) {
  const int row = bi / w;
  const int col = bi - row * w;
  const float mx = __fmul_rn(off_x, kLocrefScale);
  const float my = __fmul_rn(off_y, kLocrefScale);
  const float x = __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(col), kStride), kHalfStride), mx);
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(row), kStride), kHalfStride), my);
  o[0 * J] = __fdiv_rn(x, scale);
  o[1 * J] = __fdiv_rn(y, scale);
  o[2 * J] = bv;
  o[3 * J] = __fdiv_rn(my, scale);
  o[4 * J] = __fdiv_rn(mx, scale);
}

// ---------------------------------------------------------------------------
// Fused entry: one cluster per image
// ---------------------------------------------------------------------------

// Copies `bytes` (16, 8 or 4) from global to shared memory asynchronously.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int bytes) {
  if (bytes == 16) {
    __pipeline_memcpy_async(dst, src, 16);
  } else if (bytes == 8) {
    __pipeline_memcpy_async(dst, src, 8);
  } else {
    __pipeline_memcpy_async(dst, src, 4);
  }
}

__global__ void __launch_bounds__(kFusedThreads)
decode_fused_kernel(const float* __restrict__ fused, float* __restrict__ out,
                    const __grid_constant__ FusedArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = blockIdx.y;
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int J = a.J, C = a.C, w = a.w;
  const int vh = min(a.vh[n], a.h), vw = min(a.vw[n], w);
  const float* img = fused + static_cast<long long>(n) * a.sn;

  extern __shared__ __align__(16) float stage[];  // [row][cell][J] logits of the band
  __shared__ float s_val[kFusedWarps][kMaxJoints];
  __shared__ int s_idx[kFusedWarps][kMaxJoints];
  __shared__ float g_val[kMaxCluster][kMaxJoints];  // block 0: every block's pairs
  __shared__ int g_idx[kMaxCluster][kMaxJoints];

  const int r_begin = static_cast<int>(static_cast<long long>(vh) * rank / ranks);
  const int r_end = static_cast<int>(static_cast<long long>(vh) * (rank + 1) / ranks);
  const int ld = (vw * J + 3) & ~3;           // staged row stride, 16-byte aligned
  const int rows_per_stage = ld > 0 ? max(1, a.stage_floats / ld) : 1;

  // The copy: thread t moves part t % parts of cells t / parts, + step, ...
  // of each staged row, `granule` floats at a time (one divide per thread).
  const int gran = a.granule;
  const int parts = J / gran;
  const int step = kFusedThreads / parts;
  const int part = threadIdx.x % parts;
  const int cell0 = threadIdx.x / parts < step ? threadIdx.x / parts : vw;

  // The scan: thread (g, j) takes joint j over cell group g's cells of the
  // band, in increasing position; INT_MAX loses every tie, so the first
  // cell always replaces the start.
  const int j = threadIdx.x % kMaxJoints;
  const int g = threadIdx.x / kMaxJoints;
  const int k0 = vw > 0 ? g / vw : 0;
  const int c0 = vw > 0 ? g - k0 * vw : 0;
  const int dk = vw > 0 ? kCellGroups / vw : 0;
  const int dc = vw > 0 ? kCellGroups - dk * vw : 0;
  float bv = -INFINITY;
  int bi = INT_MAX;

  for (int ra = r_begin; ra < r_end && vw > 0; ra += rows_per_stage) {
    const int rows = min(rows_per_stage, r_end - ra);
    __syncthreads();  // the previous stage has been read
    // every copy in flight before one wait: a loop of plain loads and
    // stores would wait an L2 round trip per step
    for (int k = 0; k < rows; ++k) {
      const float* src = img + static_cast<long long>(ra + k) * a.sh + part * gran;
      float* dst = stage + k * ld + part * gran;
      for (int c = cell0; c < vw; c += step)
        copy_async(dst + c * J, src + static_cast<long long>(c) * C, gran * 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (j < J) {
      for (int k = k0, c = c0; k < rows;) {
        const float p = 1.0f / (1.0f + expf(-stage[k * ld + c * J + j]));
        const int idx = (ra + k) * w + c;
        if (better(p, idx, bv, bi)) {
          bv = p;
          bi = idx;
        }
        k += dk;
        c += dc;
        if (c >= vw) {
          c -= vw;
          ++k;
        }
      }
    }
  }

  // block: lanes j and j + 16 of a warp hold the same joint; then one
  // thread per joint over the warps, which writes the block's pair into
  // block 0's shared memory
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float ov = __shfl_down_sync(0xffffffffu, bv, kMaxJoints);
  const int oi = __shfl_down_sync(0xffffffffu, bi, kMaxJoints);
  if (better(ov, oi, bv, bi)) {
    bv = ov;
    bi = oi;
  }
  if (lane < kMaxJoints) {
    s_val[warp][lane] = bv;
    s_idx[warp][lane] = bi;
  }
  __syncthreads();
  if (threadIdx.x < J) {  // here g == 0 and j == threadIdx.x
    float v = s_val[0][j];
    int i = s_idx[0][j];
    for (int q = 1; q < kFusedWarps; ++q) {
      if (better(s_val[q][j], s_idx[q][j], v, i)) {
        v = s_val[q][j];
        i = s_idx[q][j];
      }
    }
    *cluster.map_shared_rank(&g_val[rank][j], 0) = v;
    *cluster.map_shared_rank(&g_idx[rank][j], 0) = i;
  }
  cluster.sync();  // every block's pairs are in block 0
  if (rank != 0 || threadIdx.x >= J) return;

  float v = g_val[0][j];
  int i = g_idx[0][j];
  for (int r = 1; r < ranks; ++r) {
    if (better(g_val[r][j], g_idx[r][j], v, i)) {
      v = g_val[r][j];
      i = g_idx[r][j];
    }
  }
  if (i == INT_MAX) i = 0;  // no valid cell: the plain version's argmax of all -inf
  const int row = i / w;
  const int col = i - row * w;
  const float* at = img + static_cast<long long>(row) * a.sh + static_cast<long long>(col) * C;
  write_pose(out + static_cast<long long>(n) * 5 * J + j, J, i, v, w, at[J + 2 * j],
             at[J + 2 * j + 1], a.scale);
}

// ---------------------------------------------------------------------------
// Probability-map entry: one cluster per (image, joint) plane
// ---------------------------------------------------------------------------

// G consecutive floats of a row at p (aligned to 4G bytes) into o.
template <int G>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (G == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  } else if constexpr (G == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = t.x;
    o[1] = t.y;
  } else {
    o[0] = __ldg(p);
  }
}

template <int G>
__global__ void __launch_bounds__(kProbThreads)
decode_prob_kernel(const float* __restrict__ prob, const float* __restrict__ loc,
                   float* __restrict__ out, const __grid_constant__ ProbArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int j = blockIdx.y;
  const int n = blockIdx.z;
  const int w = a.g.w;
  const int vh = min(max(a.vh[n], 0), a.g.h);
  const int vw = min(max(a.vw[n], 0), w);
  const float* plane = prob + n * a.g.pn + j * a.g.pj;

  __shared__ float s_val[kProbWarps];
  __shared__ int s_idx[kProbWarps];
  __shared__ float g_val[kProbCluster];  // block 0: every block's pair
  __shared__ int g_idx[kProbCluster];

  // this block's band of valid rows; q vectors of G floats cover a valid row
  const int r_begin = static_cast<int>(static_cast<long long>(vh) * rank / ranks);
  const int rows = static_cast<int>(static_cast<long long>(vh) * (rank + 1) / ranks) - r_begin;
  const int q = (vw + G - 1) / G;
  float bv = -INFINITY;
  int bi = INT_MAX;  // loses every tie, so the first cell always replaces the start
  if (q > 0) {
    // vector t of the band is (row k, vector c); a step of kProbThreads
    // vectors is dk rows and dc vectors (one divide per thread)
    int k = threadIdx.x / q;
    int c = threadIdx.x - k * q;
    const int dk = kProbThreads / q;
    const int dc = kProbThreads - dk * q;
    while (k < rows) {
      float v[kUnroll][G];
      int kk[kUnroll], cc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        kk[u] = k;
        cc[u] = c * G;
        if (k < rows) load_vec<G>(plane + (r_begin + k) * a.g.ph + c * G, v[u]);
        k += dk;
        c += dc;
        if (c >= q) {
          c -= q;
          ++k;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (kk[u] >= rows) break;
        const int base = (r_begin + kk[u]) * w + cc[u];
#pragma unroll
        for (int e = 0; e < G; ++e) {
          if (cc[u] + e < vw && better(v[u][e], base + e, bv, bi)) {
            bv = v[u][e];
            bi = base + e;
          }
        }
      }
    }
  }

  // warp, then the block's warps, then block 0 over the cluster
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_reduce(bv, bi);
  if (lane == 0) {
    s_val[warp] = bv;
    s_idx[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kProbWarps ? s_val[lane] : -INFINITY;
    bi = lane < kProbWarps ? s_idx[lane] : INT_MAX;
    warp_reduce(bv, bi);
    if (lane == 0) {
      *cluster.map_shared_rank(&g_val[rank], 0) = bv;
      *cluster.map_shared_rank(&g_idx[rank], 0) = bi;
    }
  }
  cluster.sync();  // every block's pair is in block 0
  if (rank != 0 || warp != 0) return;

  // lane r takes block r's pair; one warp reduction gives the plane's
  float v = lane < ranks ? g_val[lane] : -INFINITY;
  int i = lane < ranks ? g_idx[lane] : INT_MAX;
  warp_reduce(v, i);
  if (lane != 0) return;
  if (i == INT_MAX) i = 0;  // no valid cell: the plain version's argmax of all -inf
  const int row = i / w;
  const int col = i - row * w;
  const float* at = loc + n * a.g.ln + 2LL * j * a.g.lj + row * a.g.lh + col;
  write_pose(out + static_cast<long long>(n) * 5 * a.g.J + j, a.g.J, i, v, w, at[0], at[a.g.lj],
             a.scale);
}

// The fused entry's cluster: 16 blocks (a non-portable size) where the card
// can place such a cluster of it, else the portable 8.
int fused_cluster_size() {
  static int size = 0;
  if (size != 0) return size;
  size = 8;
  if (cudaFuncSetAttribute(decode_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kStageFloats * static_cast<int>(sizeof(float))) != cudaSuccess ||
      cudaFuncSetAttribute(decode_fused_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess) {
    cudaGetLastError();
    return size;
  }
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.gridDim = dim3(kMaxCluster, 1, 1);
  config.blockDim = dim3(kFusedThreads, 1, 1);
  config.dynamicSmemBytes = kStageFloats * sizeof(float);
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, decode_fused_kernel, &config) == cudaSuccess &&
      clusters > 0) {
    size = kMaxCluster;
  }
  cudaGetLastError();
  return size;
}

using ProbKernel = void (*)(const float*, const float*, float*, ProbArgs);

ProbKernel prob_kernel(int granule) {
  return granule == 4 ? decode_prob_kernel<4>
                      : (granule == 2 ? decode_prob_kernel<2> : decode_prob_kernel<1>);
}

}  // namespace

extern "C" {

// Both entries launch on `stream` of the map's device and return
// cudaGetLastError() (0 when every launch was accepted). The caller checks
// shapes and layouts.

int decode_max_batch() { return kMaxBatch; }
int decode_fused_max_joints() { return kMaxJoints; }
int decode_fused_stage_floats() { return kStageFloats; }

int decode_fused_cluster_size(int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  return fused_cluster_size();
}

int decode_fused_launch(const float* fused, float* out, long long sn, long long sh, int n, int J,
                        int h, int w, int C, int granule, float scale, const int* vh,
                        const int* vw, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  FusedArgs a = {};
  a.sn = sn;
  a.sh = sh;
  a.n = n;
  a.J = J;
  a.h = h;
  a.w = w;
  a.C = C;
  a.granule = granule;
  a.scale = scale;
  for (int i = 0; i < n; ++i) {
    a.vh[i] = vh[i];
    a.vw[i] = vw[i];
  }
  const int cs = fused_cluster_size();
  // shared memory for the tallest band's logits (every row of it at once
  // where it fits), at least one row
  const int ld = (w * J + 3) & ~3;
  const int band = (h + cs - 1) / cs;
  a.stage_floats = band * ld < kStageFloats ? band * ld : (kStageFloats / ld) * ld;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.gridDim = dim3(cs, n, 1);
  config.blockDim = dim3(kFusedThreads, 1, 1);
  config.dynamicSmemBytes = a.stage_floats * sizeof(float);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, decode_fused_kernel, fused, out, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int decode_pose_cluster() { return kProbCluster; }

// sizes: the n valid rows, then the n valid columns. Launches once per
// kMaxBatch images.
int decode_pose_launch(const ProbGeometry* g, const float* prob, const float* loc, float* out,
                       const int* sizes, float scale, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(g->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int granule = g->granule;  // and the base's alignment
  while (reinterpret_cast<unsigned long long>(prob) % (4 * granule) != 0) granule /= 2;
  const ProbKernel kernel = prob_kernel(granule);
  for (int i = 0; i < g->n; i += kMaxBatch) {
    const int m = g->n - i < kMaxBatch ? g->n - i : kMaxBatch;
    ProbArgs a = {};
    a.g = *g;
    a.g.n = m;
    a.scale = scale;
    for (int k = 0; k < m; ++k) {
      a.vh[k] = sizes[i + k];
      a.vw[k] = sizes[g->n + i + k];
    }
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kProbCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.gridDim = dim3(kProbCluster, g->J, m);
    config.blockDim = dim3(kProbThreads, 1, 1);
    config.dynamicSmemBytes = 0;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, prob + i * g->pn, loc + i * g->ln,
                             out + static_cast<long long>(i) * 5 * g->J, a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
