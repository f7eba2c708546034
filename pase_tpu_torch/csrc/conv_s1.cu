// VALID stride-1 1-D convolution in float32 in the JAX layout, for Hopper
// (sm_90a), on the CUDA cores.
//
// Replaces, for float32, the TPU kernel of experiments/pallas_conv_proto.py:
// _kernel / conv_s1_pallas (pallas_call at :65), K4. It computes
//
//   y[b, t, o] = sum_{j < K, c < C} x[b, t + j, c] * w[j, c, o]
//
// for x [B, Tin, C], w [K, C, O], y [B, Tout, O], Tout = Tin - K + 1, all
// contiguous float32, with the sum kept in float32. bfloat16 inputs go to the
// tensor-core kernel csrc/conv_s1_tc.cu: the tensor cores have no full
// float32 product, and TF32 would break the 1e-5 bound this route is held to.
// Strided layers reach both through the space-to-depth reform in
// ops/conv.py, as the prototype's conv_pallas does.
//
// The TPU kernel holds one whole x row [Tin, C] and every weight in VMEM and
// runs K unrolled [Tout, C] x [C, O] dots on the matrix unit. Here a block
// owns a kTT x kTO tile of (t, o) outputs of one batch row; 256 threads, each
// with a 4 x 4 register tile (4 consecutive t, 4 consecutive o). Input
// channels go in stages of kCC: the x window [kTT + K - 1, kCC] is staged in
// shared memory (transposed, t fastest, so a thread's 4 t are consecutive),
// and the weights [kKC taps, kCC, kTO] beside it; every (tap, channel) step
// is 4 + 1 vector shared loads and 16 FMAs. Out-of-range t, c and o are
// zero-filled in shared memory and masked at the store, so any shape runs
// without padding copies; offsets are 64-bit.
//
// What bounds it: float32 has 67 TFLOP/s outside the tensor cores; this
// kernel is bound by its shared-memory loads well below that (about 24
// TFLOP/s at the trunk shapes on an H100).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTT = 64;         // output time steps per block
constexpr int kTO = 64;         // output channels per block
constexpr int kCC = 16;         // input channels per shared-memory stage
constexpr int kKC = 8;          // taps per weight stage
constexpr int kThreads = 256;   // 16 x 16 threads, 4 t x 4 o each

// Row length of the transposed x window in shared memory: odd, so the
// transposing stores of a warp spread over the banks.
__host__ __device__ inline int x_ld(long long K) {
  return (kTT + static_cast<int>(K) - 1) | 1;
}

__global__ void __launch_bounds__(kThreads)
conv_s1_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, long long Tin, long long C, long long K,
               long long O) {
  extern __shared__ float smem[];
  const int xld = x_ld(K);
  float* xs = smem;                    // [kCC][xld]: x[t0 + r, c0 + c]
                                       // at c * xld + r
  float* ws = smem + kCC * xld;        // [kKC][kCC][kTO], 64-byte aligned
  const long long tout = Tin - K + 1;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTT;
  const long long o0 = static_cast<long long>(blockIdx.y) * kTO;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* xb = x + b * Tin * C;
  const int xlen = kTT + static_cast<int>(K) - 1;
  float acc[4][4] = {};

  for (long long c0 = 0; c0 < C; c0 += kCC) {
    for (int i = tid; i < xlen * kCC; i += kThreads) {
      const int r = i / kCC, c = i % kCC;
      const long long t = t0 + r, cc = c0 + c;
      xs[c * xld + r] = (t < Tin && cc < C) ? xb[t * C + cc] : 0.f;
    }
    for (long long j0 = 0; j0 < K; j0 += kKC) {
      const int kc = (K - j0 < kKC) ? static_cast<int>(K - j0) : kKC;
      for (int i = tid; i < kc * kCC * kTO; i += kThreads) {
        const int o = i % kTO, c = (i / kTO) % kCC, jj = i / (kTO * kCC);
        const long long cc = c0 + c, oo = o0 + o;
        ws[i] = (cc < C && oo < O) ? w[((j0 + jj) * C + cc) * O + oo] : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < kc; ++jj) {
        const float* xr = xs + static_cast<int>(j0) + jj + ty * 4;
        const float* wr = ws + jj * kCC * kTO + tx * 4;
#pragma unroll
        for (int c = 0; c < kCC; ++c) {
          const float4 wv = *reinterpret_cast<const float4*>(wr + c * kTO);
          float xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = xr[c * xld + i];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(xv[i], wv.x, acc[i][0]);
            acc[i][1] = fmaf(xv[i], wv.y, acc[i][1]);
            acc[i][2] = fmaf(xv[i], wv.z, acc[i][2]);
            acc[i][3] = fmaf(xv[i], wv.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long t = t0 + ty * 4 + i;
    if (t >= tout) continue;
    float* yr = y + (b * tout + t) * O;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long o = o0 + tx * 4 + k;
      if (o < O) yr[o] = acc[i][k];
    }
  }
}

}  // namespace

// float32 x [B, Tin, C], w [K, C, O], y [B, Tin - K + 1, O], contiguous.
// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError() after
// the launch: 0 when it was accepted. The caller checks Tin >= K, B and
// ceil(O / 64) <= 65535.
extern "C" int conv_s1(const void* x, const void* w, void* y, long long B,
                       long long Tin, long long C, long long K, long long O,
                       void* stream) {
  const long long tout = Tin - K + 1;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kCC) * x_ld(K) +
                                       static_cast<size_t>(kKC) * kCC * kTO);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_s1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned int>((tout + kTT - 1) / kTT),
                  static_cast<unsigned int>((O + kTO - 1) / kTO),
                  static_cast<unsigned int>(B));
  conv_s1_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), Tin, C, K, O);
  return static_cast<int>(cudaGetLastError());
}
