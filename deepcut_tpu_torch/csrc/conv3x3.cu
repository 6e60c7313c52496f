// The serving trunk's 3x3 convolutions as an implicit GEMM on Hopper's
// tensor cores (sm_90a): stride 1, padding = dilation, groups 1, Cin and
// Cout multiples of 64, over operands that hold bf16 values.
//
// Replaces no TPU kernel: on the TPU XLA's convolution computes these
// (deepcut_tpu/ops/conv.py:83-95, a bf16 conv with preferred_element_type
// f32); on the card cuDNN's TF32 implicit GEMM did. The contract is
// exact_conv's (deepcut_tpu_torch/ops/conv.py): x (N, Cin, H, W) f32
// channels_last holding bf16 values, the result a bias-free f32
// (N, Cout, H, W) channels_last sum of exact bf16 x bf16 products, which
// conv_epilogue then finishes. Only the order of the f32 sums differs from
// cuDNN's.
//
// Bound: operations. K = 9 * Cin is 576 to 4608, so a tile of 128 pixels by
// 128 output channels does 290-1000 FLOP per byte it reads from device
// memory, at or above the card's 295 for bf16 (res2's 64 channels, ~145,
// are bound by their f32 bytes). Design:
// - GEMM: M = N*H*W output pixels (rows of channels_last memory), N = Cout,
//   K walked slab by slab (32 input channels), each slab tap by tap. A
//   tile is 128 pixels by BN = 256, 128 or 64 channels (256 where that
//   still gives most SMs a tile: res5 at batch 4); a persistent grid of
//   one block per SM walks the tiles.
// - Warp roles: warpgroups 0 and 1 each own 64 of the tile's pixels and
//   run wgmma m64nBNk16 (bf16 in, f32 accumulators in registers); one
//   thread of warpgroup 2 issues every TMA copy (setmaxnreg moves its
//   registers to the consumers). Rings of mbarriers pass the stages
//   between them: 2 stages of A (one slab), 12 (BN = 256: 6) of B (one tap
//   of a slab).
// - A (activations): per slab, TMA copies the f32 rows that the 9 taps
//   read, either one window of 128 + 2*d*W + 2*d consecutive pixels (when
//   it fits in three boxes: res4's 44-wide maps) or three bands of
//   128 + 2*d pixels, one per tap row; rows past either end of the tensor
//   come in as zeros. A tap is then a row offset into this stage. Each
//   consumer thread reads its two pixels' 16-byte channel quads (a quarter
//   warp reads 128 contiguous bytes: no bank conflicts), converts them to
//   bf16 (exact: they hold bf16 values), zeroes the pixels whose tap falls
//   in the padding or wraps into a neighbouring row or image, and hands
//   them to wgmma as its A fragment in registers. It loads a whole batch
//   of taps' fragments (the slab's 9, or 5 and 4 beside BN = 256's
//   accumulators) into registers of their own before issuing the batch's
//   wgmmas: a fragment register rewritten while an earlier wgmma may still
//   read it makes ptxas wait for every wgmma before the next (measured:
//   half the rate). The other consumer warpgroup's wgmmas fill the tensor
//   cores while one loads.
// - B (weights): packed once, bf16 (Cout, 3, 3, Cin), each 16-channel
//   group in the order [0,1,4,5,8,9,12,13, 2,3,6,7,10,11,14,15], so that a
//   thread's 4 consecutive channels are exactly its A fragment's columns
//   (2t, 2t+1, 2t+8, 2t+9). TMA copies one tap of a slab (BN rows of 64
//   bytes) with the 64-byte swizzle that wgmma's K-major descriptor reads.
// - Epilogue: the f32 accumulators are stored straight to the output's
//   channels_last rows (32 contiguous bytes per row and quad of threads).
// No host sync and no allocation: the caller allocates the output; the
// tensor maps travel as kernel parameters, so a CUDA graph's capture holds
// them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                  // output pixels per tile
constexpr int kSlab = 32;                 // input channels per K slab
constexpr int kGroup = 16;                // channels per A box and per wgmma k step
constexpr int kAStages = 2;
constexpr int kThreads = 384;             // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kMaxDil = 8;
constexpr int kBoxMax = kBM + 2 * kMaxDil;               // rows of one A box
constexpr int kAGroupBytes = 3 * kBoxMax * kGroup * 4;   // one 16-channel group of a stage
constexpr int kAStageBytes = 2 * kAGroupBytes;

struct Geometry {
  int pixels;       // M = N*H*W
  int H, W, cin, dil;
  int ntiles, tiles;
  int nbox;         // A boxes per slab and channel group
  int box;          // rows per A box: kBM + 2*dil
  int box_off[3];   // each box's first pixel, from the tile's first
  int band[3];      // the stage row of tap row r's pixel for tile row 0, tap column 0
  int cout;
};

template <int BN>
struct Layout {
  static constexpr int kBStages = BN == 256 ? 6 : 12;
  // taps whose A fragments one consumer thread holds at once: all 9 (72
  // registers) beside 64 accumulators; 5 beside BN = 256's 128
  static constexpr int kTapBatch = BN == 256 ? 5 : 9;
  static constexpr int kBStageBytes = BN * kSlab * 2;
  static constexpr int kB = 0;
  static constexpr int kA = kB + kBStages * kBStageBytes;
  static constexpr int kBar = kA + kAStages * kAStageBytes;
  static constexpr int kBytes = kBar + 8 * 2 * (kAStages + kBStages);
  static constexpr int kAlloc = kBytes + 1024;   // slack to align the base to 1024
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major B tile with the 64-byte
// swizzle: rows of 64 bytes, 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps registers in place across the asynchronous wgmma that reads them.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// D(64 x BN) (+)= A(64 x 16, registers) * B(16 x BN, shared): one warpgroup.
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<256> {
  __device__ __forceinline__ static void run(float (&d)[128], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
        "}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),
          ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
  }
};

#undef ACC8

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi, bool keep) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return keep ? *reinterpret_cast<const uint32_t*>(&v) : 0u;
}

// Bit 3*r + s set where tap (r, s) of output pixel p reads inside the image.
__device__ __forceinline__ uint32_t tap_mask(const Geometry& g, int p) {
  if (p >= g.pixels) return 0;
  const int hw = g.H * g.W;
  const int rem = p - (p / hw) * hw;
  const int h = rem / g.W;
  const int w = rem - h * g.W;
  uint32_t mask = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int hh = h + (r - 1) * g.dil;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int ww = w + (s - 1) * g.dil;
      if (hh >= 0 && hh < g.H && ww >= 0 && ww < g.W) mask |= 1u << (3 * r + s);
    }
  }
  return mask;
}

template <int BN>
struct Consumer {
  using L = Layout<BN>;
  const Geometry& g;
  uint32_t smem;                // shared address of the aligned base
  const uint8_t* base;          // the same, generic
  int row0;                     // this thread's first tile row (the second is row0 + 8)
  int quad;                     // its 16-byte channel quad within a group
  bool leader;                  // lane 0: arrives for its warp
  int pixels, cout, dil, ntiles, slabs, band0, band1, band2;
  int sa = 0, sb = 0;           // ring stages of the next A slab and B tap
  uint32_t pa = 0, pb = 0;      // and the parities their full barriers complete

  __device__ Consumer(const Geometry& geo, uint32_t s, const uint8_t* b, int tid)
      : g(geo), smem(s), base(b) {
    const int warp = tid / 32, lane = tid % 32;
    row0 = 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
    quad = lane % 4;
    leader = lane == 0;
    pixels = g.pixels;
    cout = g.cout;
    dil = g.dil;
    ntiles = g.ntiles;
    slabs = g.cin / kSlab;
    band0 = g.band[0];
    band1 = g.band[1];
    band2 = g.band[2];
  }

  __device__ __forceinline__ uint32_t full_a(int s) const { return smem + L::kBar + 8 * s; }
  __device__ __forceinline__ uint32_t empty_a(int s) const {
    return smem + L::kBar + 8 * (kAStages + s);
  }
  __device__ __forceinline__ uint32_t full_b(int s) const {
    return smem + L::kBar + 8 * (2 * kAStages + s);
  }
  __device__ __forceinline__ uint32_t empty_b(int s) const {
    return smem + L::kBar + 8 * (2 * kAStages + L::kBStages + s);
  }

  // Stage index and parity of a ring position.
  __device__ __forceinline__ static void next(int& stage, uint32_t& parity, int stages) {
    if (++stage == stages) {
      stage = 0;
      parity ^= 1;
    }
  }

  // This thread's A fragments of tap TAP (its two pixels, 32 channels) from
  // the slab's stage, converted to bf16, zero where the tap reads padding.
  template <int TAP>
  __device__ __forceinline__ void load(const uint8_t* stage, uint32_t (&a)[8], uint32_t mask0,
                                       uint32_t mask1) const {
    constexpr int r = TAP / 3, s = TAP % 3;
    const int j0 = (r == 0 ? band0 : (r == 1 ? band1 : band2)) + row0 + s * dil;
    const bool v0 = (mask0 >> TAP) & 1u, v1 = (mask1 >> TAP) & 1u;
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      const uint8_t* rows = stage + grp * kAGroupBytes;
      const float4 x0 = *reinterpret_cast<const float4*>(rows + j0 * (kGroup * 4));
      const float4 x1 = *reinterpret_cast<const float4*>(rows + (j0 + 8) * (kGroup * 4));
      a[4 * grp + 0] = bf16x2(x0.x, x0.y, v0);
      a[4 * grp + 1] = bf16x2(x1.x, x1.y, v1);
      a[4 * grp + 2] = bf16x2(x0.z, x0.w, v0);
      a[4 * grp + 3] = bf16x2(x1.z, x1.w, v1);
    }
  }

  // Taps T0..T1-1 of a slab: every A fragment loaded into registers of its
  // own before the wgmma fence and left alone until the batch's last wgmma
  // has completed (the header says why); each tap's two k16 steps are a
  // group, whose B stage is released once it has completed.
  template <int T0, int T1>
  __device__ __forceinline__ void taps(const uint8_t* stage, float (&d)[BN / 2], uint32_t mask0,
                                       uint32_t mask1, int accumulate) {
    uint32_t a[T1 - T0][8];
#pragma unroll
    for (int t = T0; t < T1; ++t) {
      switch (t) {   // a compile-time tap for `load`'s offsets
        case 0: load<0>(stage, a[t - T0], mask0, mask1); break;
        case 1: load<1>(stage, a[t - T0], mask0, mask1); break;
        case 2: load<2>(stage, a[t - T0], mask0, mask1); break;
        case 3: load<3>(stage, a[t - T0], mask0, mask1); break;
        case 4: load<4>(stage, a[t - T0], mask0, mask1); break;
        case 5: load<5>(stage, a[t - T0], mask0, mask1); break;
        case 6: load<6>(stage, a[t - T0], mask0, mask1); break;
        case 7: load<7>(stage, a[t - T0], mask0, mask1); break;
        default: load<8>(stage, a[t - T0], mask0, mask1); break;
      }
    }
    pin(d);
    wg_fence();
#pragma unroll
    for (int t = T0; t < T1; ++t) {
      bar_wait(full_b(sb), pb);
      const uint64_t desc0 = b_desc(smem + L::kB + sb * L::kBStageBytes);
      Mma<BN>::run(d, a[t - T0][0], a[t - T0][1], a[t - T0][2], a[t - T0][3], desc0,
                   t == T0 ? accumulate : 1);
      Mma<BN>::run(d, a[t - T0][4], a[t - T0][5], a[t - T0][6], a[t - T0][7],
                   desc0 + 2 /* +32 bytes: channels 16-31 */, 1);
      wg_commit();
      if (t > T0) {   // the group before this one
        wg_wait<1>();
        __syncwarp();
        if (leader) bar_arrive(empty_b(sb >= 1 ? sb - 1 : sb + L::kBStages - 1));
      }
      next(sb, pb, L::kBStages);
    }
    wg_wait<0>();     // the batch's registers are free again
    pin(d);
    __syncwarp();
    if (leader) bar_arrive(empty_b(sb >= 1 ? sb - 1 : sb + L::kBStages - 1));
  }

  __device__ void tile(int t, float* __restrict__ y) {
    const int m0 = (t / ntiles) * kBM;
    const int n0 = (t % ntiles) * BN;
    const uint32_t mask0 = tap_mask(g, m0 + row0);
    const uint32_t mask1 = tap_mask(g, m0 + row0 + 8);
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
    for (int slab = 0; slab < slabs; ++slab) {
      bar_wait(full_a(sa), pa);
      const uint8_t* stage = base + L::kA + sa * kAStageBytes + 16 * quad;
      taps<0, L::kTapBatch>(stage, d, mask0, mask1, slab > 0);
      if constexpr (L::kTapBatch < 9) taps<L::kTapBatch, 9>(stage, d, mask0, mask1, 1);
      __syncwarp();   // the slab's rows are in registers: its A stage is free
      if (leader) bar_arrive(empty_a(sa));
      next(sa, pa, kAStages);
    }
    const int p0 = m0 + row0, p1 = p0 + 8;
    float* out0 = y + static_cast<long long>(p0) * cout + n0 + 2 * quad;
    float* out1 = y + static_cast<long long>(p1) * cout + n0 + 2 * quad;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (p0 < pixels) *reinterpret_cast<float2*>(out0 + 8 * j) = make_float2(d[4 * j], d[4 * j + 1]);
      if (p1 < pixels)
        *reinterpret_cast<float2*>(out1 + 8 * j) = make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               float* __restrict__ y, const __grid_constant__ Geometry g) {
  using L = Layout<BN>;
  extern __shared__ uint8_t raw[];
  const uint32_t raw_addr = smem_u32(raw);
  const uint32_t pad = (1024 - (raw_addr & 1023)) & 1023;
  uint8_t* base = raw + pad;
  const uint32_t smem = raw_addr + pad;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kAStages; ++s) {
      bar_init(smem + L::kBar + 8 * s, 1);                      // full: the producer
      bar_init(smem + L::kBar + 8 * (kAStages + s), 8);         // empty: each consumer warp
    }
    for (int s = 0; s < L::kBStages; ++s) {
      bar_init(smem + L::kBar + 8 * (2 * kAStages + s), 1);
      bar_init(smem + L::kBar + 8 * (2 * kAStages + L::kBStages + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {   // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 256) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
    const uint32_t a_bytes = 2u * g.nbox * g.box * kGroup * 4;
    int it_a = 0, it_b = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const int m0 = (t / g.ntiles) * kBM;
      const int n0 = (t % g.ntiles) * BN;
      for (int slab = 0; slab < g.cin / kSlab; ++slab) {
        const int sa = it_a % kAStages;
        bar_wait(smem + L::kBar + 8 * (kAStages + sa), ((it_a / kAStages) & 1) ^ 1);
        const uint32_t full = smem + L::kBar + 8 * sa;
        bar_expect(full, a_bytes);
        for (int grp = 0; grp < 2; ++grp) {
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            if (b < g.nbox)
              tma_load(smem + L::kA + sa * kAStageBytes + grp * kAGroupBytes + b * g.box * kGroup * 4,
                     &map_a, slab * kSlab + grp * kGroup, m0 + g.box_off[b], full);
          }
        }
        ++it_a;
        for (int tap = 0; tap < 9; ++tap) {
          const int sb = it_b % L::kBStages;
          bar_wait(smem + L::kBar + 8 * (2 * kAStages + L::kBStages + sb), ((it_b / L::kBStages) & 1) ^ 1);
          const uint32_t fb = smem + L::kBar + 8 * (2 * kAStages + sb);
          bar_expect(fb, L::kBStageBytes);
          tma_load(smem + L::kB + sb * L::kBStageBytes, &map_b, tap * g.cin + slab * kSlab, n0, fb);
          ++it_b;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  Consumer<BN> c(g, smem, base, tid);
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) c.tile(t, y);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int sm_count(int device) {
  static int counts[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (counts[device] == 0) {
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device);
  }
  return counts[device];
}

template <int BN>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, float* y, const Geometry& g,
           int device, cudaStream_t stream) {
  const int smem = Layout<BN>::kAlloc;
  cudaError_t err =
      cudaFuncSetAttribute(conv3x3_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count(device);
  const int grid = g.tiles < sms ? g.tiles : sms;
  conv3x3_kernel<BN><<<grid, kThreads, smem, stream>>>(map_a, map_b, y, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError() (0 when
// the launch was accepted), or -1 where cuTensorMapEncodeTiled is
// missing, or -(100 + CUresult) where it refuses a map. x: N*H*W rows of
// cin f32 (channels_last); wk: the packed bf16 weights, cout rows of
// 9*cin; y: N*H*W rows of cout f32. The caller guarantees cin and cout
// multiples of 64, 1 <= dil <= 8, N*H*W < 2**31 - 2**20 and 16-byte
// aligned pointers.
extern "C" int conv3x3_launch(const float* x, const void* wk, float* y, int n, int h, int w,
                              int cin, int cout, int dil, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return -1;
  // 256 output channels a tile where that still gives most SMs a tile
  // (res5 at batch 4): twice the products for each A fragment read
  const int mtiles = (n * h * w + kBM - 1) / kBM;
  const int bn = cout % 256 == 0 && 4 * mtiles * (cout / 256) >= 3 * sm_count(device) ? 256
                 : cout % 128 == 0                                               ? 128
                                                                                 : 64;
  Geometry g;
  g.pixels = n * h * w;
  g.H = h;
  g.W = w;
  g.cin = cin;
  g.cout = cout;
  g.dil = dil;
  g.ntiles = cout / bn;
  g.tiles = ((g.pixels + kBM - 1) / kBM) * g.ntiles;
  g.box = kBM + 2 * dil;
  const int window = kBM + 2 * dil * w + 2 * dil;
  if (window <= 3 * g.box) {   // one window of consecutive pixels
    g.nbox = (window + g.box - 1) / g.box;
    for (int b = 0; b < 3; ++b) {
      g.box_off[b] = -dil * w - dil + b * g.box;
      g.band[b] = b * dil * w;
    }
  } else {                     // one band per tap row
    g.nbox = 3;
    for (int b = 0; b < 3; ++b) {
      g.box_off[b] = (b - 1) * dil * w - dil;
      g.band[b] = b * g.box;
    }
  }

  CUtensorMap map_a, map_b;
  const cuuint32_t ones[2] = {1, 1};
  const cuuint64_t a_dim[2] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(g.pixels)};
  const cuuint64_t a_stride[1] = {static_cast<cuuint64_t>(cin) * 4};
  const cuuint32_t a_box[2] = {kGroup, static_cast<cuuint32_t>(g.box)};
  CUresult res = encode(&map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), a_dim,
                        a_stride, a_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -(100 + static_cast<int>(res));
  const cuuint64_t b_dim[2] = {static_cast<cuuint64_t>(9 * cin), static_cast<cuuint64_t>(cout)};
  const cuuint64_t b_stride[1] = {static_cast<cuuint64_t>(9 * cin) * 2};
  const cuuint32_t b_box[2] = {kSlab, static_cast<cuuint32_t>(bn)};
  res = encode(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wk), b_dim,
               b_stride, b_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -(100 + static_cast<int>(res));
  if (bn == 256) return launch<256>(map_a, map_b, y, g, device, stream);
  if (bn == 128) return launch<128>(map_a, map_b, y, g, device, stream);
  return launch<64>(map_a, map_b, y, g, device, stream);
}
