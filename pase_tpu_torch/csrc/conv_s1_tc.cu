// VALID stride-1 1-D convolution on Hopper's tensor cores (sm_90a): TMA
// loads into shared memory, wgmma products, mbarriers between one producer
// warp and two consumer warpgroups. Two entry points, one per input type:
//
//   conv_s1_tc      bfloat16 x and y, bf16 products (wgmma .bf16);
//   conv_s1_tf32x3  float32 x and y, three TF32 products (wgmma .tf32).
//
// Both replace the TPU kernel of experiments/pallas_conv_proto.py: _kernel /
// conv_s1_pallas (pallas_call at :65), K4. They compute
//
//   y[b, t, o] = sum_{j < K, c < C} x[b, t + j, c] * w[j, c, o]
//
// for x [B, Tin, C] and y [B, Tout, O], Tout = Tin - K + 1, with the sum kept
// in float32 registers; ops/conv.py routes by x's type alone.
//
// The conv as a GEMM: M runs over output rows, N over the O output channels,
// and the reduction over (tap j, block of channels c0). A block of channels
// is one 128-byte row of x: 64 bf16 or 32 float32 values. A tile is BM rows
// (256; 128 in float32 at BN = 128) x BN channels. For each channel block the
// kernel loads one window of x, rows m0 .. m0 + BM - 1 + (taps in the group)
// - 1, and serves every tap from it: the A operand of tap j is the window
// shifted down j rows, a wgmma descriptor that starts j x 128 bytes in (the
// swizzle follows the absolute address, see desc_k()). So x moves into
// shared memory once per channel block, not once per tap, and a step of the
// reduction loads only its B tile. Taps go in groups of at most 16, so any
// K fits the window. (An A tile loaded per tap moves about 2.5x the bytes
// into shared memory at the trunk shapes.)
//
// bf16: B is w[j] as the caller laid it out, [C, O] with O contiguous, which
// wgmma reads with its transposed-B flag (desc_b()).
//
// float32 (3xTF32): each operand v is split into a high and a low TF32 part,
// hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest even
// (tf32_rne()), and the sum takes x_lo w_hi + x_hi w_lo + x_hi w_hi: the
// dropped x_lo w_lo is about 2^-22 of each product. TF32 alone keeps about
// 2^-11 and would break the 1e-5 bound this route is held to. wgmma takes
// TF32 operands K-major only (no transpose flag), so B is w[j]^T: a small
// kernel of this file (split_w_kernel) writes w's hi and lo parts as [2K, O,
// C] on every call. x is split in shared memory: once a window has landed,
// the 256 consumer threads round it to its hi part in place and write the lo
// part to a second window beside it, then both warpgroups read them through
// descriptors like bf16's. (A split in registers would keep one window per
// buffer, but then every tap re-loads and re-splits its A fragments; here
// each value is split once per window, for all its taps, and wgmma reads A
// from shared memory as in the bf16 route.) The two parts double a window
// buffer's shared memory. The tensor cores' float32 sums lose low bits at
// each step, so a window's products go into sums of their own, which are
// then added into the tile's with float32 adds (promote()); the two sets
// of sums are why a float32 tile at BN = 128 has 128 rows.
//
// x is read in place through a 3-D tensor map {C, rows, slabs} with the
// caller's strides. When the batch rows lie evenly spaced (a contiguous x)
// the batch is one slab of B * Tin rows: the K - 1 rows of each batch whose
// window runs into the next batch are computed and dropped (5 of 205 rows at
// the last trunk layer, where a slab per batch row would compute 256 for
// 200). Otherwise (the strided space-to-depth view of the first layer) each
// batch row is a slab. TMA fills rows past the end and channels past C with
// zeros; the epilogue stores only rows that are outputs and channels o < O.
//
// One block of 288 threads per SM walks the tiles (persistent): warpgroups 0
// and 1 each own half the rows of a tile and run a wgmma.m64nBN per 64 rows
// per k-step (16 bf16 or 8 TF32 channels; three for 3xTF32), float32 sums in
// registers;
// warp 8 issues the TMA loads into window buffers and a ring of B stages, a
// full and an empty mbarrier per buffer, and runs on into the next tile
// while the consumers store this one. BN is 64 for O <= 64, else 128 (bf16
// tiles of 128 x 128 and 128 x 256 were no faster at the trunk shapes on the
// H100).
//
// What bounds it: every trunk layer but the first is bound by operations
// (989 TFLOP/s of dense bf16 on the H100 SXM; for 3xTF32 three TF32
// products at 495 TFLOP/s, 165 TFLOP/s of float32 work); the first (393 MB
// of x in bf16, 787 MB in float32; 64 outputs) by bytes (3.35 TB/s) in bf16
// and about evenly in float32: there the kernel has to stream x once, which
// is why it reads the space-to-depth view without copying it.

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowBytes = 128;                   // a window row: one block
                                                 // of channels, the swizzle
constexpr int kGroup = 16;                       // taps per window, at most
constexpr int kConsumers = 2;                    // wgmma warpgroups
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kSmemMax = 232448;                 // a block's dynamic limit

// Errors of the C entry points beyond cudaError_t's range.
constexpr int kNoEncoder = 20000;     // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = 10000;  // + the CUresult of the encoder

// T: __nv_bfloat16 or float.
template <typename T, int BN>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBK = kRowBytes / sizeof(T);  // channels per block
  // output rows per tile. float32 keeps a second set of sums (see
  // promote()), so at BN = 128 a tile has 128 rows: 64 sums and 64 partial
  // sums a thread
  static constexpr int kBM = (kF32 && BN == 128) ? 128 : 256;
  static constexpr int kMM = kBM / 64 / kConsumers;  // m64 tiles per wg
  static constexpr int kWinBytes =                   // a window, 1024-aligned
      ((kBM + kGroup - 1) * kRowBytes + 1023) / 1024 * 1024;
  // float32: a window buffer holds the hi and the lo window, a B stage the
  // hi and the lo tile
  static constexpr int kParts = kF32 ? 2 : 1;
  static constexpr int kBTile = BN * kRowBytes;
  static constexpr int kStageBytes = kParts * kBTile;
  static constexpr int kBufBytes = kParts * kWinBytes;
  // BN = 64 is the byte-bound first layer: more windows in flight; else
  // more B stages
  static constexpr int kWindows =
      kF32 ? (BN == 64 ? 2 : 3) : (BN == 64 ? 4 : 2);
  static constexpr int kBarriers = 2 * kWindows + 2 * 12;
  static constexpr int kFree =
      kSmemMax - 1024 - 8 * kBarriers - kWindows * kBufBytes;
  static constexpr int kStages =
      kFree / kStageBytes < 12 ? kFree / kStageBytes : 12;
  // 1024 bytes to align the first buffer to the swizzle atom, the windows,
  // the B stages, the barriers
  static constexpr int kSmem =
      1024 + kWindows * kBufBytes + kStages * kStageBytes + 8 * kBarriers;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase `parity` has completed. No wait of a
// working pipeline lasts a millisecond: after 10 s the kernel traps, so a
// broken one fails its launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// One box of a 3-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle (A; and B
// in TF32), starting at shared address `addr`: rows of 128 bytes, 8-row
// atoms 1024 bytes apart (SBO; LBO is unused in this layout). The swizzle is
// applied to the absolute shared address, as TMA applied it when it wrote
// the window from a 1024-aligned base, so a start on any 128-byte row reads
// the rows back right with a base offset of 0 (the row's phase, (addr >> 7)
// & 7, in that field gave wrong sums on the H100).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma descriptor of the bf16 B operand, w[j] as it lies ([C, O], O
// contiguous: MN-major) in the 128-byte swizzle: boxes of 64 channel rows x
// 64 outputs (128 bytes), 8-row atoms 1024 bytes apart along C (SBO), the
// next 64 outputs in the next box, 8 KB on (LBO).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(8192 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the sums across the
// asynchronous products.
template <int M, int R>
__device__ __forceinline__ void fence_acc(float (&d)[M][R]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[m][i])::"memory");
  }
}

template <int M, int R>
__device__ __forceinline__ void zero(float (&d)[M][R]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int i = 0; i < R; ++i) d[m][i] = 0.f;
  }
}

template <int M, int R>
__device__ __forceinline__ void copy(float (&d)[M][R],
                                     const float (&src)[M][R]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int i = 0; i < R; ++i) d[m][i] = src[m][i];
  }
}

// sum += part in float32, rounded to nearest. The tensor cores' own float32
// sums lose low bits at every step: 3xTF32 summed in one accumulator over a
// whole tile (hundreds to thousands of wgmma steps at the trunk layers)
// drifts past 1e-5 of max|y| on the H100; promoting each window's partial
// sums keeps the route within it (python -m pase_tpu_torch.kernel_variants
// measures both; PERF.md).
template <int M, int R>
__device__ __forceinline__ void promote(float (&sum)[M][R],
                                        const float (&part)[M][R]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int i = 0; i < R; ++i) sum[m][i] += part[m][i];
  }
}

#define PASE_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3])
#define PASE_F16(d, i) PASE_F4(d, i), PASE_F4(d, i + 4), PASE_F4(d, i + 8), \
    PASE_F4(d, i + 12)
#define PASE_F32(d, i) PASE_F16(d, i), PASE_F16(d, i + 16)
#define PASE_R32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define PASE_R64 PASE_R32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63"

// D[64 x 64] += A[64 x k] B[64 x k]^T, A K-major in shared memory. TF32:
// k = 8, B K-major (no transpose flag exists for TF32); bf16: k = 16, B
// MN-major (the transposed-B flag).
template <bool kTF32>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  if constexpr (kTF32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" PASE_R32
        "}, %32, %33, p, 1, 1;\n}\n"
        : PASE_F32(d, 0)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" PASE_R32
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : PASE_F32(d, 0)
        : "l"(da), "l"(db), "r"(1));
  }
}

// D[64 x 128] += A[64 x k] B[128 x k]^T, as above
template <bool kTF32>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  if constexpr (kTF32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" PASE_R64
        "}, %64, %65, p, 1, 1;\n}\n"
        : PASE_F32(d, 0), PASE_F32(d, 32)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" PASE_R64
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : PASE_F32(d, 0), PASE_F32(d, 32)
        : "l"(da), "l"(db), "r"(1));
  }
}

// float32 bits rounded to TF32 (10 mantissa bits kept, the 13 below them
// zero), to nearest, ties to even; inf and nan pass unchanged. Integer
// operations only, so ops/conv.py's split_tf32 repeats it bit for bit.
__host__ __device__ __forceinline__ uint32_t tf32_rne(uint32_t u) {
  if ((u & 0x7F800000u) == 0x7F800000u) return u;
  return (u + 0xFFFu + ((u >> 13) & 1u)) & ~0x1FFFu;
}

// v = hi + lo + (below 2^-22 of v): hi = tf32(v), lo = tf32(v - hi); v - hi
// is exact in float32.
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = __uint_as_float(tf32_rne(__float_as_uint(v)));
  lo = __uint_as_float(tf32_rne(__float_as_uint(v - hi)));
}

// float32 route: the landed window's `rows` rows of x become their hi part
// in place and their lo part kWinBytes on, by the 256 consumer threads (the
// same byte offsets, so the same swizzle). Then the writes are made visible
// to wgmma (the async proxy) and both warpgroups meet: each reads rows the
// other split.
template <int kWinBytes>
__device__ __forceinline__ void split_window(unsigned char* win, int rows) {
  float4* hi = reinterpret_cast<float4*>(win);
  float4* lo = reinterpret_cast<float4*>(win + kWinBytes);
  for (int i = threadIdx.x; i < rows * (kRowBytes / 16);
       i += 128 * kConsumers) {
    const float4 v = hi[i];
    float4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(128 * kConsumers) : "memory");
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float v0, float v1,
                                           bool both, bool second) {
  if constexpr (sizeof(T) == 4) {
    if (both) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      p[0] = v0;
      if (second) p[1] = v1;
    }
  } else {
    if (both) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    } else {
      p[0] = __float2bfloat16(v0);
      if (second) p[1] = __float2bfloat16(v1);
    }
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_s1_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_x_tail,
                      const __grid_constant__ CUtensorMap map_w,
                      T* __restrict__ y, int taps, int c_blocks,
                      int m_tiles, int n_tiles, int tiles, int tail,
                      long long rows_out, long long tin, long long tout,
                      long long O) {
  using C = Cfg<T, BN>;
  constexpr int kWindows = C::kWindows, kBM = C::kBM, kMM = C::kMM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t win0 = (base + 1023) & ~1023u;         // window buffers
  const uint32_t b0 = win0 + kWindows * C::kBufBytes;    // B stages
  const uint32_t bars = b0 + C::kStages * C::kStageBytes;
  const uint32_t a_full = bars, a_empty = bars + 8 * kWindows;
  const uint32_t b_full = bars + 16 * kWindows;
  const uint32_t b_empty = b_full + 8 * C::kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWindows; ++i) {
      mbar_init(a_full + 8 * i, 1);
      mbar_init(a_empty + 8 * i, kConsumers * 4);  // one arrive per warp
    }
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(b_full + 8 * i, 1);
      mbar_init(b_empty + 8 * i, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Persistent: block i takes tiles i, i + gridDim.x, ...; tile (slab,
  // m-tile, n-tile) with n fastest, so neighbouring blocks share windows in
  // L2. Both roles walk the same sequence of windows and B tiles, so the
  // producer runs on into the next tile while the consumers store this one.
  if (warp == kConsumers * 4) {
    // producer: per (tap group g0, channel block), the window, then the B
    // tiles of the group's taps; each into a buffer its consumers freed
    if (lane == 0) {
      int a_it = 0, b_it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int slab = tile / (m_tiles * n_tiles);
        const int m0 = (tile / n_tiles) % m_tiles * kBM;
        const int n0 = tile % n_tiles * BN;
        for (int g0 = 0; g0 < taps; g0 += kGroup) {
          const int ng = taps - g0 < kGroup ? taps - g0 : kGroup;
          for (int cb = 0; cb < c_blocks; ++cb, ++a_it) {
            const int wa = a_it % kWindows;
            const uint32_t win = win0 + wa * C::kBufBytes;
            mbar_wait(a_empty + 8 * wa, ((a_it / kWindows) & 1) ^ 1);
            mbar_expect_tx(a_full + 8 * wa, (kBM + tail) * kRowBytes);
            tma_load_3d(win, &map_x, a_full + 8 * wa, cb * C::kBK, m0 + g0,
                        slab);
            if (tail > 0) {
              tma_load_3d(win + kBM * kRowBytes, &map_x_tail,
                          a_full + 8 * wa, cb * C::kBK, m0 + g0 + kBM, slab);
            }
            for (int j = 0; j < ng; ++j, ++b_it) {
              const int s = b_it % C::kStages;
              const uint32_t stage = b0 + s * C::kStageBytes;
              mbar_wait(b_empty + 8 * s, ((b_it / C::kStages) & 1) ^ 1);
              mbar_expect_tx(b_full + 8 * s, C::kStageBytes);
              if constexpr (C::kF32) {
                // the hi tile of tap g0 + j, then its lo tile (taps on)
                for (int p = 0; p < 2; ++p) {
                  tma_load_3d(stage + p * C::kBTile, &map_w, b_full + 8 * s,
                              cb * C::kBK, n0, p * taps + g0 + j);
                }
              } else {
                for (int q = 0; q < BN / 64; ++q) {
                  tma_load_3d(stage + q * 8192, &map_w, b_full + 8 * s,
                              n0 + 64 * q, cb * C::kBK, g0 + j);
                }
              }
            }
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows m0 + kBM / 2 wg .. m0 + kBM / 2 (wg
    // + 1) - 1 of a tile, as kMM tiles of 64
    const int wg = warp / 4;
    float acc[kMM][BN / 2];
    // float32: acc takes one window's products and is then added into sum
    // with float32 adds (promote); bf16 sums in acc alone
    float sum[kMM][C::kF32 ? BN / 2 : 1];
    int a_it = 0, b_it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int slab = tile / (m_tiles * n_tiles);
      const int m0 = (tile / n_tiles) % m_tiles * kBM;
      const int n0 = tile % n_tiles * BN;
      zero(acc);
      if constexpr (C::kF32) zero(sum);
      int prev_s = -1, prev_wa = 0;
      bool prev_last = false;
      for (int g0 = 0; g0 < taps; g0 += kGroup) {
        const int ng = taps - g0 < kGroup ? taps - g0 : kGroup;
        for (int cb = 0; cb < c_blocks; ++cb, ++a_it) {
          const int wa = a_it % kWindows;
          const uint32_t buf = win0 + wa * C::kBufBytes;
          mbar_wait(a_full + 8 * wa, (a_it / kWindows) & 1);
          if constexpr (C::kF32) {
            split_window<C::kWinBytes>(smem_raw + (buf - base), kBM + tail);
            zero(acc);
          }
          const uint32_t win = buf + wg * kMM * 64 * kRowBytes;
          for (int j = 0; j < ng; ++j, ++b_it) {
            const int s = b_it % C::kStages;
            mbar_wait(b_full + 8 * s, (b_it / C::kStages) & 1);
            // tap j: the window from its row j on
            const uint32_t a = win + j * kRowBytes;
            const uint32_t b = b0 + s * C::kStageBytes;
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < 4; ++k) {
#pragma unroll
              for (int m = 0; m < kMM; ++m) {
                // 64 rows down: 8 KB; a k-step on: 32 bytes of A (16 bf16
                // or 8 float32 channels); of B, 32 bytes (TF32, K-major) or
                // 16 rows, 2 KB (bf16, MN-major)
                const uint32_t am = a + m * 64 * kRowBytes + 32 * k;
                if constexpr (C::kF32) {
                  // the small products first: x_lo w_hi, x_hi w_lo, then
                  // x_hi w_hi
                  wgmma<true>(acc[m], desc_k(am + C::kWinBytes),
                              desc_k(b + 32 * k));
                  wgmma<true>(acc[m], desc_k(am),
                              desc_k(b + C::kBTile + 32 * k));
                  wgmma<true>(acc[m], desc_k(am), desc_k(b + 32 * k));
                } else {
                  wgmma<false>(acc[m], desc_k(am), desc_b(b + 2048 * k));
                }
              }
            }
            wgmma_commit();
            // the products of the previous step are done: hand its B stage
            // back, and its window after the group's last tap
            wgmma_wait<1>();
            fence_acc(acc);
            if (prev_s >= 0 && lane == 0) {
              mbar_arrive(b_empty + 8 * prev_s);
              if (prev_last) mbar_arrive(a_empty + 8 * prev_wa);
            }
            prev_s = s;
            prev_wa = wa;
            prev_last = j == ng - 1;
          }
          if constexpr (C::kF32) {
            // the window's products done: its last B stage and the window
            // go back, and its partial sums into sum
            wgmma_wait<0>();
            fence_acc(acc);
            if (lane == 0) {
              mbar_arrive(b_empty + 8 * prev_s);
              mbar_arrive(a_empty + 8 * wa);
            }
            prev_s = -1;
            promote(sum, acc);
          }
        }
      }
      if constexpr (C::kF32) {
        copy(acc, sum);
      } else {
        wgmma_wait<0>();
        fence_acc(acc);
        // the last step's B stage and window, for the producer's next tile
        if (lane == 0) {
          mbar_arrive(b_empty + 8 * prev_s);
          mbar_arrive(a_empty + 8 * prev_wa);
        }
      }

      // sum acc[m][4i + 2h + e] is row 64 m + 16 (warp % 4) + lane / 4 +
      // 8 h, channel 8 i + 2 (lane % 4) + e of the warpgroup's kBM / 2 x BN
      const bool pairs = (O % 2) == 0;
#pragma unroll
      for (int m = 0; m < kMM; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = m0 + wg * kMM * 64 + m * 64 +
                              (warp % 4) * 16 + lane / 4 + 8 * h;
          const long long t = r % tin;
          if (r >= rows_out || t >= tout) continue;
          T* yr = y + ((slab + r / tin) * tout + t) * O;
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const long long o = n0 + 8 * i + 2 * (lane % 4);
            if (o < O) {
              store_pair(yr + o, acc[m][4 * i + 2 * h],
                         acc[m][4 * i + 2 * h + 1], pairs, o + 1 < O);
            }
          }
        }
      }
    }
  }
}

// w [taps, C, O] float32 -> ws [2 taps, O, c_dim]: ws[j] = hi(w[j]^T) and
// ws[taps + j] = lo(w[j]^T), channels C .. c_dim - 1 zero. 32 x 32 tiles
// through shared memory, so reads (along O) and writes (along C) are
// coalesced. Grid (ceil(c_dim / 32), ceil(O / 32), taps), 32 x 8 threads.
__global__ void split_w_kernel(const float* __restrict__ w,
                               float* __restrict__ ws, long long taps,
                               long long C, long long O, long long c_dim) {
  __shared__ float tile[32][33];
  const long long c0 = static_cast<long long>(blockIdx.x) * 32;
  const long long o0 = static_cast<long long>(blockIdx.y) * 32;
  const long long j = blockIdx.z;
  for (int r = threadIdx.y; r < 32; r += 8) {  // r: a channel
    const long long c = c0 + r, o = o0 + threadIdx.x;
    tile[r][threadIdx.x] = (c < C && o < O) ? w[(j * C + c) * O + o] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {  // r: an output
    const long long o = o0 + r, c = c0 + threadIdx.x;
    if (o < O && c < c_dim) {
      float hi, lo;
      split_tf32(tile[threadIdx.x][r], hi, lo);
      ws[(j * O + o) * c_dim + c] = hi;
      ws[((taps + j) * O + o) * c_dim + c] = lo;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so that the
// library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A tensor map over {d0, d1, d2} (d0 contiguous, strides s1 and s2 in
// bytes) with boxes of {box0, rows, 1}, the 128-byte swizzle, zeros outside.
CUresult make_map(EncodeTiled encode, CUtensorMap* map,
                  CUtensorMapDataType type, const void* base, long long d0,
                  long long d1, long long d2, long long s1, long long s2,
                  int box0, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1),
                                 static_cast<cuuint64_t>(s2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, int BN>
int launch(const CUtensorMap* maps, void* y, long long slabs, long long taps,
           long long c_blocks, int tail, long long rows_out, long long tin,
           long long tout, long long O, cudaStream_t stream) {
  using C = Cfg<T, BN>;
  const long long n_tiles = (O + BN - 1) / BN;
  const long long m_tiles = (rows_out + C::kBM - 1) / C::kBM;
  const long long tiles = m_tiles * n_tiles * slabs;
  if (tiles > INT_MAX || taps > INT_MAX || c_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // blocks that fit on the card at once, per device: set up and asked once
  constexpr int kDevices = 64;
  static int slots[kDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int fit = device < kDevices ? slots[device] : 0;
  if (fit == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(conv_s1_tc_kernel<T, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv_s1_tc_kernel<T, BN>, kThreads, C::kSmem);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    fit = sms * per_sm;
    if (device < kDevices) slots[device] = fit;
  }
  const long long blocks = tiles < fit ? tiles : fit;
  conv_s1_tc_kernel<T, BN><<<static_cast<unsigned int>(blocks), kThreads,
                             C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<T*>(y),
      static_cast<int>(taps), static_cast<int>(c_blocks),
      static_cast<int>(m_tiles), static_cast<int>(n_tiles),
      static_cast<int>(tiles), tail, rows_out, tin, tout, O);
  return static_cast<int>(cudaGetLastError());
}

// The x maps (window and tail) and the w map are in `maps`; launches the
// kernel for bn 64 or 128.
template <typename T>
int run(const CUtensorMap* maps, void* y, long long c_dim, long long slabs,
        long long taps, int tail, long long rows_out, long long tin,
        long long tout, long long O, int bn, cudaStream_t s) {
  const long long c_blocks = (c_dim + Cfg<T, 64>::kBK - 1) / Cfg<T, 64>::kBK;
  switch (bn) {
    case 64:
      return launch<T, 64>(maps, y, slabs, taps, c_blocks, tail, rows_out,
                           tin, tout, O, s);
    case 128:
      return launch<T, 128>(maps, y, slabs, taps, c_blocks, tail, rows_out,
                            tin, tout, O, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The window's rows past the tile's (at most 256, TMA's longest box): one
// fewer than the taps of the largest group.
int tail_rows(long long taps) {
  return static_cast<int>(taps < kGroup ? taps : kGroup) - 1;
}

}  // namespace

// Both entry points: x has `c_dim` channels (16 bytes of them a multiple)
// of `rows` rows in each of `slabs` slabs, row and slab strides in bytes
// (multiples of 16, x 16-byte aligned); output row r of slab s is y[s + r /
// tin, r % tin] when r % tin < tout and r < rows_out. y [B, tout, O]
// contiguous, in x's type. bn: 64 or 128. Each launches on `stream` and
// returns cudaGetLastError() after its launches: 0 when they were accepted;
// 10000 + a CUresult when a tensor map was refused, 20000 when the driver
// has no cuTensorMapEncodeTiled.

// bf16 x, y; w bf16 [taps, w_c, O] with rows `w_row_bytes` apart (a
// multiple of 16), w_c <= c_dim.
extern "C" int conv_s1_tc(const void* x, long long c_dim, long long rows,
                          long long slabs, long long row_bytes,
                          long long slab_bytes, const void* w, long long w_c,
                          long long w_row_bytes, void* y,
                          long long tin, long long tout, long long taps,
                          long long O, long long rows_out, int bn,
                          void* stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const int tail = tail_rows(taps);
  constexpr auto kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[3];
  CUresult r = make_map(encode, &maps[0], kType, x, c_dim, rows, slabs,
                        row_bytes, slab_bytes, 64,
                        Cfg<__nv_bfloat16, 64>::kBM);
  if (r == CUDA_SUCCESS) {
    r = make_map(encode, &maps[1], kType, x, c_dim, rows, slabs, row_bytes,
                 slab_bytes, 64, tail > 0 ? tail : 1);
  }
  if (r == CUDA_SUCCESS) {
    r = make_map(encode, &maps[2], kType, w, O, w_c, taps, w_row_bytes,
                 w_c * w_row_bytes, 64, 64);
  }
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  return run<__nv_bfloat16>(maps, y, c_dim, slabs, taps, tail, rows_out, tin,
                            tout, O, bn, static_cast<cudaStream_t>(stream));
}

// float32 x, y; w float32 [taps, w_c, O] contiguous, w_c <= c_dim; ws
// scratch of 2 taps x O x c_dim floats for w's TF32 parts (split_w_kernel,
// launched first on the same stream).
extern "C" int conv_s1_tf32x3(const void* x, long long c_dim, long long rows,
                              long long slabs, long long row_bytes,
                              long long slab_bytes, const void* w,
                              long long w_c, void* ws, void* y,
                              long long tin, long long tout, long long taps,
                              long long O, long long rows_out, int bn,
                              void* stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps > 65535 || (O + 31) / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_w_kernel<<<dim3(static_cast<unsigned int>((c_dim + 31) / 32),
                        static_cast<unsigned int>((O + 31) / 32),
                        static_cast<unsigned int>(taps)),
                   dim3(32, 8), 0, s>>>(static_cast<const float*>(w),
                                        static_cast<float*>(ws), taps, w_c,
                                        O, c_dim);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tail = tail_rows(taps);
  const int box_c = Cfg<float, 64>::kBK;
  constexpr auto kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap maps[3];
  // the window's first rows: a tile's (128 at bn 128, else 256)
  const int bm = bn == 128 ? Cfg<float, 128>::kBM : Cfg<float, 64>::kBM;
  CUresult r = make_map(encode, &maps[0], kType, x, c_dim, rows, slabs,
                        row_bytes, slab_bytes, box_c, bm);
  if (r == CUDA_SUCCESS) {
    r = make_map(encode, &maps[1], kType, x, c_dim, rows, slabs, row_bytes,
                 slab_bytes, box_c, tail > 0 ? tail : 1);
  }
  if (r == CUDA_SUCCESS) {
    r = make_map(encode, &maps[2], kType, ws, c_dim, O, 2 * taps, c_dim * 4,
                 O * c_dim * 4, box_c, bn);
  }
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  return run<float>(maps, y, c_dim, slabs, taps, tail, rows_out, tin, tout,
                    O, bn, s);
}
