// QRNN forget-mult pooling, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of pase_tpu/ops/pallas_qrnn.py: the time-blocked
// linear scan _scan_kernel / _linear_scan_pallas_raw (K1) together with the
// gate math of forget_mult_pallas / qrnn_pool_pallas (K3), fused:
//
//   z = tanh(y[..., :H]); f = sigmoid(y[..., H:2H]); o = sigmoid(y[..., 2H:])
//   c_t = (1 - f_t) * c_{t-1} + f_t * z_t        (carry seeded with c0 or 0)
//   h_t = o_t * c_t;  returns h [B, T, H] and c_T [B, H]
//
// Layout: y [B, T, 3H], h [B, T, H], c0 / c_T [B, H], all f32, contiguous.
// One thread owns one (b, j) lane, j fastest, so the loads of z, f and o at
// t*3H + {0, H, 2H} + j and the store of h are coalesced across a warp. The
// carry lives in a register; y is read once and h, c_T are written once. No
// padding copies: the ragged last block is masked, and every offset is
// 64-bit.
//
// What bounds it: at batch (B*H lanes in the tens of thousands) device-memory
// bytes, 16 bytes per lane-step (12 read, 4 written). At serving shapes there
// are few lanes (B*H = 512 at B = 1) and the sequential T loop makes it
// bound by load latency; the loop loads UNROLL steps of y ahead of their use
// so several loads are in flight per thread. A chunked two-level scan
// (per-chunk local scans, carry prefix, fix-up) for few lanes is later work.
//
// The carry is SEEDED with c0 and every step is c = a*c + b (one FMA). The
// JAX version folds c0 into b_1 instead (a rounded multiply, then an add);
// seeding keeps a block-streamed run, which threads c_T into the next
// block's c0, bit-identical to one full run. Full-precision tanhf / expf;
// build without --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float step_(float c, float zr, float fr, float orr,
                                       float* out) {
  const float z = tanhf(zr);
  const float f = sigmoidf_(fr);
  const float a = 1.0f - f;
  const float b = f * z;
  c = fmaf(a, c, b);
  *out = sigmoidf_(orr) * c;
  return c;
}

__global__ void __launch_bounds__(kThreads)
qrnn_pool_fwd_kernel(const float* __restrict__ y, const float* __restrict__ c0,
                     float* __restrict__ h, float* __restrict__ c_last,
                     int64_t B, int64_t T, int64_t H) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= B * H) return;
  const int64_t b = lane / H;
  const int64_t j = lane - b * H;
  const int64_t ys = 3 * H;  // y stride over t
  const float* yp = y + b * T * ys + j;
  float* hp = h + b * T * H + j;
  float c = (c0 != nullptr) ? c0[lane] : 0.0f;

  int64_t t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float zr[kUnroll], fr[kUnroll], orr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* p = yp + (t + u) * ys;
      zr[u] = p[0];
      fr[u] = p[H];
      orr[u] = p[2 * H];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      c = step_(c, zr[u], fr[u], orr[u], hp + (t + u) * H);
    }
  }
  for (; t < T; ++t) {
    const float* p = yp + t * ys;
    c = step_(c, p[0], p[H], p[2 * H], hp + t * H);
  }
  c_last[lane] = c;
}

}  // namespace

// Launches on `stream` (a cudaStream_t). c0 may be null (zero seed).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int qrnn_pool_fwd(const void* y, const void* c0, void* h,
                             void* c_last, long long B, long long T,
                             long long H, void* stream) {
  const long long lanes = B * H;
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  qrnn_pool_fwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(c0),
      static_cast<float*>(h), static_cast<float*>(c_last), B, T, H);
  return static_cast<int>(cudaGetLastError());
}
