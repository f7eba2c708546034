// QRNN forget-mult pooling, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of pase_tpu/ops/pallas_qrnn.py: the time-blocked
// linear scan _scan_kernel / _linear_scan_pallas_raw (K1) together with the
// gate math of forget_mult_pallas / qrnn_pool_pallas (K3), fused, and the
// reverse-time scan of the custom VJP _ls_fwd / _ls_bwd (K2) with the
// gradient of the K3 gates fused into it:
//
//   z = tanh(y[..., :H]); f = sigmoid(y[..., H:2H]); s = sigmoid(y[..., 2H:])
//   a = 1 - f
//   c_t = a_t * c_{t-1} + f_t * z_t        (carry seeded with c0 or 0)
//   h_t = s_t * c_t;  returns h [B, T, H] and c_T [B, H]
//
// Backward, given dh [B, T, H] and dc_T [B, H] (optional):
//
//   g_t  = dh_t * s_t + a_{t+1} * g_{t+1}   (g seeded with dc_T, a_T = 1)
//   dy_z = g_t * f_t * (1 - z_t^2)
//   dy_f = g_t * (z_t - c_{t-1}) * f_t * (1 - f_t)   (c_{-1} = c0 or 0)
//   dy_o = dh_t * c_t * s_t * (1 - s_t)
//   dc0  = a_0 * g_0
//
// Layout: y / dy [B, T, 3H], h / c / dh [B, T, H], c0 / c_T / dc_T / dc0
// [B, H], all f32, contiguous. One thread owns one (b, j) lane, j fastest,
// so the loads and stores at t*3H + {0, H, 2H} + j and t*H + j are coalesced
// across a warp. The carry (c forward, g backward) lives in a register. No
// padding copies: the ragged last block is masked, and every offset is
// 64-bit.
//
// Three entry points:
//   qrnn_pool_fwd        serving forward: reads y, writes h and c_T
//                        (16 bytes per lane-step);
//   qrnn_pool_fwd_train  the same, and also writes c, the residual of the
//                        backward (20 bytes per lane-step). A reverse scan
//                        cannot rebuild c_{t-1} from c_t without dividing
//                        by a, so c is stored;
//   qrnn_pool_bwd        reads y, c and dh, writes dy once (32 bytes per
//                        lane-step). c_{t-1} of step t is c_t of step t-1,
//                        so it is carried in a register, not read twice.
//                        The JAX VJP flips a and dc, materializes a_next and
//                        c_prev and runs the forward kernel again; here one
//                        pass walks t from T-1 down to 0.
//
// What bounds them: at batch (B*H lanes in the tens of thousands) device
// memory bytes. At serving shapes there are few lanes (B*H = 512 at B = 1)
// and the sequential T loop makes them bound by load latency; each loop
// loads kUnroll steps ahead of their use so several loads are in flight per
// thread. A chunked two-level scan for few lanes is later work.
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

template <bool kWriteC>
__device__ __forceinline__ float step_(float c, float zr, float fr, float orr,
                                       float* h_out, float* c_out) {
  const float z = tanhf(zr);
  const float f = sigmoidf_(fr);
  const float a = 1.0f - f;
  const float b = f * z;
  c = fmaf(a, c, b);
  *h_out = sigmoidf_(orr) * c;
  if (kWriteC) *c_out = c;
  return c;
}

// kWriteC = false is the serving kernel; true also stores every c_t.
template <bool kWriteC>
__global__ void __launch_bounds__(kThreads)
qrnn_pool_fwd_kernel(const float* __restrict__ y, const float* __restrict__ c0,
                     float* __restrict__ h, float* __restrict__ c_all,
                     float* __restrict__ c_last, int64_t B, int64_t T,
                     int64_t H) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= B * H) return;
  const int64_t b = lane / H;
  const int64_t j = lane - b * H;
  const int64_t ys = 3 * H;  // y stride over t
  const float* yp = y + b * T * ys + j;
  float* hp = h + b * T * H + j;
  float* cp = kWriteC ? c_all + b * T * H + j : nullptr;
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
      c = step_<kWriteC>(c, zr[u], fr[u], orr[u], hp + (t + u) * H,
                         kWriteC ? cp + (t + u) * H : nullptr);
    }
  }
  for (; t < T; ++t) {
    const float* p = yp + t * ys;
    c = step_<kWriteC>(c, p[0], p[H], p[2 * H], hp + t * H,
                       kWriteC ? cp + t * H : nullptr);
  }
  c_last[lane] = c;
}

// One reverse step at time t: updates g and a_next, puts dy_t's three gate
// gradients in dyp. c_t is the forward state at t, c_prev the one at t-1
// (c0 or 0 at t = 0).
__device__ __forceinline__ void bwd_step_(float zr, float fr, float orr,
                                          float dh, float c_t, float c_prev,
                                          float& g, float& a_next,
                                          float* dyp) {
  const float z = tanhf(zr);
  const float f = sigmoidf_(fr);
  const float a = 1.0f - f;
  const float s = sigmoidf_(orr);
  g = fmaf(a_next, g, dh * s);
  dyp[0] = g * f * (1.0f - z * z);
  dyp[1] = g * (z - c_prev) * f * a;
  dyp[2] = dh * c_t * s * (1.0f - s);
  a_next = a;
}

__global__ void __launch_bounds__(kThreads)
qrnn_pool_bwd_kernel(const float* __restrict__ y, const float* __restrict__ c,
                     const float* __restrict__ dh,
                     const float* __restrict__ dc_last,
                     const float* __restrict__ c0, float* __restrict__ dy,
                     float* __restrict__ dc0, int64_t B, int64_t T,
                     int64_t H) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= B * H) return;
  const int64_t b = lane / H;
  const int64_t j = lane - b * H;
  const int64_t ys = 3 * H;
  const float* yp = y + b * T * ys + j;
  const float* cp = c + b * T * H + j;
  const float* dhp = dh + b * T * H + j;
  float* dyp = dy + b * T * ys + j;
  const float seed = (c0 != nullptr) ? c0[lane] : 0.0f;
  float g = (dc_last != nullptr) ? dc_last[lane] : 0.0f;
  float a_next = 1.0f;     // g_{T-1} = dh s + dc_T
  float c_t = cp[(T - 1) * H];

  int64_t t = T - 1;
  // steps t, t-1, ..., t-kUnroll+1; each needs c at one step earlier, which
  // exists while t - kUnroll >= 0
  for (; t - kUnroll >= 0; t -= kUnroll) {
    float zr[kUnroll], fr[kUnroll], orr[kUnroll], dhr[kUnroll], cpr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t tt = t - u;
      const float* p = yp + tt * ys;
      zr[u] = p[0];
      fr[u] = p[H];
      orr[u] = p[2 * H];
      dhr[u] = dhp[tt * H];
      cpr[u] = cp[(tt - 1) * H];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float out[3];
      bwd_step_(zr[u], fr[u], orr[u], dhr[u], c_t, cpr[u], g, a_next, out);
      float* q = dyp + (t - u) * ys;
      q[0] = out[0];
      q[H] = out[1];
      q[2 * H] = out[2];
      c_t = cpr[u];
    }
  }
  for (; t >= 0; --t) {
    const float* p = yp + t * ys;
    const float c_prev = (t > 0) ? cp[(t - 1) * H] : seed;
    float out[3];
    bwd_step_(p[0], p[H], p[2 * H], dhp[t * H], c_t, c_prev, g, a_next, out);
    float* q = dyp + t * ys;
    q[0] = out[0];
    q[H] = out[1];
    q[2 * H] = out[2];
    c_t = c_prev;
  }
  if (dc0 != nullptr) dc0[lane] = a_next * g;   // a_0 * g_0
}

unsigned int blocks_for(long long B, long long H) {
  return static_cast<unsigned int>((B * H + kThreads - 1) / kThreads);
}

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError() after the launch: 0 when it was accepted. c0, dc_last
// and dc0 may be null (zero seed, no c_T gradient, no c0 gradient).

extern "C" int qrnn_pool_fwd(const void* y, const void* c0, void* h,
                             void* c_last, long long B, long long T,
                             long long H, void* stream) {
  qrnn_pool_fwd_kernel<false><<<blocks_for(B, H), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(c0),
      static_cast<float*>(h), nullptr, static_cast<float*>(c_last), B, T, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qrnn_pool_fwd_train(const void* y, const void* c0, void* h,
                                   void* c_all, void* c_last, long long B,
                                   long long T, long long H, void* stream) {
  qrnn_pool_fwd_kernel<true><<<blocks_for(B, H), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(c0),
      static_cast<float*>(h), static_cast<float*>(c_all),
      static_cast<float*>(c_last), B, T, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qrnn_pool_bwd(const void* y, const void* c, const void* dh,
                             const void* dc_last, const void* c0, void* dy,
                             void* dc0, long long B, long long T, long long H,
                             void* stream) {
  qrnn_pool_bwd_kernel<<<blocks_for(B, H), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(c),
      static_cast<const float*>(dh), static_cast<const float*>(dc_last),
      static_cast<const float*>(c0), static_cast<float*>(dy),
      static_cast<float*>(dc0), B, T, H);
  return static_cast<int>(cudaGetLastError());
}
