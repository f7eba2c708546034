// VALID stride-1 1-D convolution in bfloat16 on Hopper's tensor cores
// (sm_90a): TMA loads into shared memory, wgmma products, mbarriers between
// one producer warp and two consumer warpgroups.
//
// Replaces, for bfloat16, the TPU kernel of experiments/pallas_conv_proto.py:
// _kernel / conv_s1_pallas (pallas_call at :65), K4. It computes
//
//   y[b, t, o] = sum_{j < K, c < C} x[b, t + j, c] * w[j, c, o]
//
// for x [B, Tin, C] and y [B, Tout, O] in bfloat16, Tout = Tin - K + 1, with
// the sum kept in float32 and rounded once to bfloat16. float32 inputs go to
// csrc/conv_s1.cu: ops/conv.py routes by type alone.
//
// The conv as a GEMM: M runs over output rows, N over the O output channels,
// and the reduction over (tap j, block of 64 channels c0). A tile is 256 rows
// x BN channels. For each channel block the kernel loads one window of x,
// rows m0 .. m0 + 255 + (taps in the group) - 1, and serves every tap from
// it: the A operand of tap j is the window shifted down j rows, a wgmma
// descriptor that starts j x 128 bytes in (the swizzle follows the absolute
// address, see desc_a()). So x moves into shared memory once per channel
// block, not once per tap, and a step of the reduction loads only its B
// tile: w[j] as the caller laid it out, [C, O] with O contiguous, which
// wgmma reads with its transposed-B flag (desc_b()). Taps go in groups of
// at most 16, so any K fits the window. (An A tile loaded per tap moves
// about 2.5x the bytes into shared memory at the trunk shapes.)
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
// and 1 each own 128 rows of a tile and run two wgmma.m64nBNk16 per 16
// channels, float32 sums in registers; warp 8 issues the TMA loads into
// window buffers and a ring of B stages, a full and an empty mbarrier per
// buffer, and runs on into the next tile while the consumers store this
// one. BN is 64 for O <= 64, else 128 (tiles of 128 x 128 and 128 x 256
// were no faster at the trunk shapes on the H100).
//
// What bounds it: every trunk layer but the first is bound by operations
// (989 TFLOP/s of dense bf16 on the H100 SXM); the first (393 MB of x, 64
// outputs) by bytes (3.35 TB/s): there the kernel has to stream x once,
// which is why it reads the space-to-depth view without copying it.

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 256;                         // output rows per tile
constexpr int kBK = 64;                          // channels per step: 128 B
constexpr int kGroup = 16;                       // taps per window, at most
constexpr int kWinBytes =                        // a window, 1024-aligned
    ((kBM + kGroup - 1) * kBK * 2 + 1023) / 1024 * 1024;
constexpr int kConsumers = 2;                    // wgmma warpgroups
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kMM = kBM / 64 / kConsumers;       // m64 tiles per warpgroup
constexpr int kSmemMax = 232448;                 // a block's dynamic limit

// Errors of the C entry point beyond cudaError_t's range.
constexpr int kNoEncoder = 20000;     // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = 10000;  // + the CUresult of the encoder

template <int BN>
struct Cfg {
  static constexpr int kBTile = BN * kBK * 2;
  // BN = 64 is the byte-bound first layer: more windows in flight; BN = 128
  // more B stages
  static constexpr int kWindows = BN == 64 ? 4 : 2;
  static constexpr int kBarriers = 2 * kWindows + 2 * 12;
  static constexpr int kFree =
      kSmemMax - 1024 - 8 * kBarriers - kWindows * kWinBytes;
  static constexpr int kStages = kFree / kBTile < 12 ? kFree / kBTile : 12;
  // 1024 bytes to align the first buffer to the swizzle atom, the windows,
  // the B stages, the barriers
  static constexpr int kSmem =
      1024 + kWindows * kWinBytes + kStages * kBTile + 8 * kBarriers;
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

// wgmma descriptor of the A operand, K-major in the 128-byte swizzle,
// starting at shared address `addr`: rows of 128 bytes, 8-row atoms 1024
// bytes apart (SBO; LBO is unused in this layout). The swizzle is applied to
// the absolute shared address, as TMA applied it when it wrote the window
// from a 1024-aligned base, so a start on any 128-byte row reads the rows
// back right with a base offset of 0 (the row's phase, (addr >> 7) & 7, in
// that field gave wrong sums on the H100).
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma descriptor of the B operand, w[j] as it lies ([C, O], O contiguous:
// MN-major) in the 128-byte swizzle: boxes of 64 channel rows x 64 outputs
// (128 bytes), 8-row atoms 1024 bytes apart along C (SBO), the next 64
// outputs in the next box, 8 KB on (LBO).
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
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[kMM][R]) {
#pragma unroll
  for (int m = 0; m < kMM; ++m) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[m][i])::"memory");
  }
}

// D[64 x 64] += A[64 x 16] B[64 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[128 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_s1_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_x_tail,
                      const __grid_constant__ CUtensorMap map_w,
                      __nv_bfloat16* __restrict__ y, int taps, int c_blocks,
                      int m_tiles, int n_tiles, int tiles, int tail,
                      long long rows_out, long long tin, long long tout,
                      long long O) {
  using C = Cfg<BN>;
  constexpr int kWindows = C::kWindows;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t win0 = (smem_u32(smem_raw) + 1023) & ~1023u;  // windows
  const uint32_t b0 = win0 + kWindows * kWinBytes;              // B stages
  const uint32_t bars = b0 + C::kStages * C::kBTile;
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
            const uint32_t win = win0 + wa * kWinBytes;
            mbar_wait(a_empty + 8 * wa, ((a_it / kWindows) & 1) ^ 1);
            mbar_expect_tx(a_full + 8 * wa, (kBM + tail) * kBK * 2);
            tma_load_3d(win, &map_x, a_full + 8 * wa, cb * kBK, m0 + g0,
                        slab);
            if (tail > 0) {
              tma_load_3d(win + kBM * kBK * 2, &map_x_tail, a_full + 8 * wa,
                          cb * kBK, m0 + g0 + kBM, slab);
            }
            for (int j = 0; j < ng; ++j, ++b_it) {
              const int s = b_it % C::kStages;
              mbar_wait(b_empty + 8 * s, ((b_it / C::kStages) & 1) ^ 1);
              mbar_expect_tx(b_full + 8 * s, C::kBTile);
              for (int q = 0; q < BN / 64; ++q) {
                tma_load_3d(b0 + s * C::kBTile + q * 8192, &map_w,
                            b_full + 8 * s, n0 + 64 * q, cb * kBK, g0 + j);
              }
            }
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows m0 + 128 wg .. m0 + 128 wg + 127
    // of a tile, as kMM tiles of 64
    const int wg = warp / 4;
    float acc[kMM][BN / 2];
    int a_it = 0, b_it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int slab = tile / (m_tiles * n_tiles);
      const int m0 = (tile / n_tiles) % m_tiles * kBM;
      const int n0 = tile % n_tiles * BN;
#pragma unroll
      for (int m = 0; m < kMM; ++m) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
      }
      int prev_s = -1, prev_wa = 0;
      bool prev_last = false;
      for (int g0 = 0; g0 < taps; g0 += kGroup) {
        const int ng = taps - g0 < kGroup ? taps - g0 : kGroup;
        for (int cb = 0; cb < c_blocks; ++cb, ++a_it) {
          const int wa = a_it % kWindows;
          const uint32_t win =
              win0 + wa * kWinBytes + wg * kMM * 64 * kBK * 2;
          mbar_wait(a_full + 8 * wa, (a_it / kWindows) & 1);
          for (int j = 0; j < ng; ++j, ++b_it) {
            const int s = b_it % C::kStages;
            mbar_wait(b_full + 8 * s, (b_it / C::kStages) & 1);
            // tap j: the window from its row j on
            const uint32_t a = win + j * kBK * 2;
            const uint32_t b = b0 + s * C::kBTile;
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < kBK / 16; ++k) {
#pragma unroll
              for (int m = 0; m < kMM; ++m) {
                // 64 rows down: 8 KB; 16 channels on: 32 bytes of A, 16
                // rows (2 KB) of B
                wgmma(acc[m], desc_a(a + m * 64 * kBK * 2 + 32 * k),
                      desc_b(b + 2048 * k));
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
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      // the last step's B stage and window, for the producer's next tile
      if (lane == 0) {
        mbar_arrive(b_empty + 8 * prev_s);
        mbar_arrive(a_empty + 8 * prev_wa);
      }

      // sum acc[m][4i + 2h + e] is row 64 m + 16 (warp % 4) + lane / 4 +
      // 8 h, channel 8 i + 2 (lane % 4) + e of the warpgroup's 128 x BN
      const bool pairs = (O % 2) == 0;
#pragma unroll
      for (int m = 0; m < kMM; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = m0 + wg * kMM * 64 + m * 64 +
                              (warp % 4) * 16 + lane / 4 + 8 * h;
          const long long t = r % tin;
          if (r >= rows_out || t >= tout) continue;
          __nv_bfloat16* yr = y + ((slab + r / tin) * tout + t) * O;
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const long long o = n0 + 8 * i + 2 * (lane % 4);
            const float v0 = acc[m][4 * i + 2 * h];
            const float v1 = acc[m][4 * i + 2 * h + 1];
            if (pairs && o < O) {
              *reinterpret_cast<__nv_bfloat162*>(yr + o) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              if (o < O) yr[o] = __float2bfloat16(v0);
              if (o + 1 < O) yr[o + 1] = __float2bfloat16(v1);
            }
          }
        }
      }
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

// A bf16 tensor map over {d0, d1, d2} (d0 contiguous, strides s1 and s2 in
// bytes) with boxes of {64, rows, 1}, the 128-byte swizzle, zeros outside.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                  long long d0, long long d1, long long d2, long long s1,
                  long long s2, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1),
                                 static_cast<cuuint64_t>(s2)};
  const cuuint32_t box[3] = {kBK, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN>
int launch(const CUtensorMap* maps, void* y, long long slabs, long long taps,
           long long c_blocks, int tail, long long rows_out, long long tin,
           long long tout, long long O, cudaStream_t stream) {
  using C = Cfg<BN>;
  const long long n_tiles = (O + BN - 1) / BN;
  const long long m_tiles = (rows_out + kBM - 1) / kBM;
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
    e = cudaFuncSetAttribute(conv_s1_tc_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv_s1_tc_kernel<BN>, kThreads, C::kSmem);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    fit = sms * per_sm;
    if (device < kDevices) slots[device] = fit;
  }
  const long long blocks = tiles < fit ? tiles : fit;
  conv_s1_tc_kernel<BN><<<static_cast<unsigned int>(blocks), kThreads,
                          C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(y),
      static_cast<int>(taps), static_cast<int>(c_blocks),
      static_cast<int>(m_tiles), static_cast<int>(n_tiles),
      static_cast<int>(tiles), tail, rows_out, tin, tout, O);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: bf16, `c_dim` channels (a multiple of 8) of `rows` rows in each of
// `slabs` slabs, row and slab strides in bytes (multiples of 16, x 16-byte
// aligned); output row r of slab s is y[s + r / tin, r % tin] when r % tin <
// tout and r < rows_out. w: bf16 [taps, w_c, O] with rows `w_row_bytes`
// apart (a multiple of 16), w_c <= c_dim. y: bf16 [B, tout, O] contiguous.
// bn: 64 or 128. Launches on `stream` and returns
// cudaGetLastError() after the launch: 0 when it was accepted; 10000 + a
// CUresult when a tensor map was refused, 20000 when the driver has no
// cuTensorMapEncodeTiled.
extern "C" int conv_s1_tc(const void* x, long long c_dim, long long rows,
                          long long slabs, long long row_bytes,
                          long long slab_bytes, const void* w, long long w_c,
                          long long w_row_bytes, void* y,
                          long long tin, long long tout, long long taps,
                          long long O, long long rows_out, int bn,
                          void* stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  // the window's rows past the tile's (whose 256 rows are TMA's longest
  // box): one fewer than the taps of the largest group
  const int tail = static_cast<int>(taps < kGroup ? taps : kGroup) - 1;
  CUtensorMap maps[3];
  CUresult r = make_map(encode, &maps[0], x, c_dim, rows, slabs, row_bytes,
                        slab_bytes, kBM);
  if (r == CUDA_SUCCESS) {
    r = make_map(encode, &maps[1], x, c_dim, rows, slabs, row_bytes,
                 slab_bytes, tail > 0 ? tail : 1);
  }
  if (r == CUDA_SUCCESS) {
    r = make_map(encode, &maps[2], w, O, w_c, taps, w_row_bytes,
                 w_c * w_row_bytes, 64);
  }
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  const long long c_blocks = (c_dim + kBK - 1) / kBK;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64:
      return launch<64>(maps, y, slabs, taps, c_blocks, tail, rows_out, tin,
                        tout, O, s);
    case 128:
      return launch<128>(maps, y, slabs, taps, c_blocks, tail, rows_out,
                         tin, tout, O, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
