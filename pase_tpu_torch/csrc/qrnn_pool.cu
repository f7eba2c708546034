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
// Four entry points:
//   qrnn_pool_fwd        forward: reads y, writes h and c_T (16 bytes per
//                        lane-step); the seeded serving call (c0 given);
//   qrnn_pool_fwd_chunked the same function, chunked in time: the unseeded
//                        serving and eval call (below);
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
// What bounds them: device memory bytes, when there are enough lanes. At
// serving shapes there are few lanes (B*H = 4096 at B = 8, 512 at B = 1):
// a thread per lane gives 64 blocks of two warps or fewer, each walking all
// T steps, bound by load latency (about 0.23 us a step on the H100) with
// most SMs idle. The serial loops load kUnroll steps ahead of their use so
// several loads are in flight per thread.
//
// qrnn_pool_fwd_chunked cuts each lane's time axis into chunks of at most
// kMaxChunk steps, one thread each, as pase_tpu/parallel/sp.py composes the
// carries across shards, inside one block: (1) each thread loads its chunk's
// z and f gates (all loads issued before the first use), keeps a and b in
// registers, and composes the chunk's map c -> A c + B from c = 0; (2) one
// warp per lane scans the lane's chunk maps (each thread composes a few
// consecutive chunks, then a shuffle scan) into the carry into every chunk;
// (3) each thread re-runs its chunk from its carry with the serial step's
// fmaf(a, c, b), loading the o gate, and writes h. y is read once. A block
// is a tile of kChunkThreads / lanes chunks x `lanes` consecutive lanes (8,
// or 4 when tiles of 8 would leave SMs idle); longer T is walked in segments
// of chunks x len steps, each seeded with the last one's c_T, so any T is
// one launch. The carry into a chunk comes from composed maps, so it rounds
// otherwise than the serial loop (a = 1 - f lies in (0, 1): the composition
// only contracts); a block-streamed run is bit-identical to the full run
// only on the serial kernel, so seeded calls stay there. With many lanes
// the serial kernel is bound by bytes and the chunked one is slower
// (ops/cuda_qrnn.py routes by lane count).
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

constexpr int kChunkThreads = 512;
// Steps per chunk at most, blocks per SM the registers must allow, o loads
// in flight per thread in (3). Of 16/1/16, 16/2/8, 16/2/16, 8/2/8 and
// 8/3/8, 8/2/8 was the fastest at the serving shape [8,1000,512] on the
// H100 (python -m pase_tpu_torch.kernel_variants; PERF.md).
constexpr int kMaxChunk = 8;
constexpr int kChunkBlocks = 2;
constexpr int kOLoads = 8;

__global__ void __launch_bounds__(kChunkThreads, kChunkBlocks)
qrnn_pool_fwd_chunked_kernel(const float* __restrict__ y,
                             const float* __restrict__ c0,
                             float* __restrict__ h,
                             float* __restrict__ c_last, int64_t B,
                             int64_t T, int64_t H, int lanes, int len) {
  // the chunk maps (A, B) of a segment; phase 2 puts the carry into each
  // chunk in sb
  __shared__ float sa[kChunkThreads], sb[kChunkThreads];
  __shared__ float carry[8];         // into the segment, per lane
  const int chunks = kChunkThreads / lanes;
  const int l = threadIdx.x % lanes, k = threadIdx.x / lanes;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * lanes + l;
  const bool live = lane < B * H;
  const int64_t b = lane / H;
  const int64_t j = lane - b * H;
  const int64_t ys = 3 * H;
  const float* yp = y + b * T * ys + j;
  float* hp = h + b * T * H + j;
  if (threadIdx.x < lanes) {
    carry[threadIdx.x] = (live && c0 != nullptr) ? c0[lane] : 0.0f;
  }
  const int64_t seg = static_cast<int64_t>(chunks) * len;
  for (int64_t s0 = 0; s0 < T; s0 += seg) {
    const int64_t t0 = s0 + static_cast<int64_t>(k) * len;
    const int64_t left = live ? T - t0 : 0;
    const int n = left <= 0 ? 0 : (left < len ? static_cast<int>(left) : len);
    // (1) the chunk's z and f gates (z in bz, f in a); then a = 1 - f,
    // b = f z and the map from c = 0 (steps past n are the identity)
    float a[kMaxChunk], bz[kMaxChunk];
#pragma unroll
    for (int u = 0; u < kMaxChunk; ++u) {
      a[u] = 1.0f;
      bz[u] = 0.0f;
      if (u < n) {
        const float* p = yp + (t0 + u) * ys;
        bz[u] = p[0];
        a[u] = p[H];
      }
    }
    float ca = 1.0f, cb = 0.0f;
#pragma unroll
    for (int u = 0; u < kMaxChunk; ++u) {
      if (u < n) {
        const float z = tanhf(bz[u]);
        const float f = sigmoidf_(a[u]);
        a[u] = 1.0f - f;
        bz[u] = f * z;
        cb = fmaf(a[u], cb, bz[u]);
        ca *= a[u];
      }
    }
    sa[threadIdx.x] = ca;
    sb[threadIdx.x] = cb;
    __syncthreads();
    // (2) warp w scans lane w's chunks; thread i owns chunks i q .. i q +
    // q - 1. A map (pa, pb) composed after an earlier one (qa, qb) is
    // c -> pa (qa c + qb) + pb
    if (threadIdx.x / 32 < lanes) {
      const int wl = threadIdx.x / 32, i = threadIdx.x % 32;
      const int q = chunks / 32;
      float pa = 1.0f, pb = 0.0f;
      for (int m = 0; m < q; ++m) {
        const int idx = (i * q + m) * lanes + wl;
        pb = fmaf(sa[idx], pb, sb[idx]);
        pa *= sa[idx];
      }
      for (int off = 1; off < 32; off *= 2) {
        const float qa = __shfl_up_sync(0xffffffffu, pa, off);
        const float qb = __shfl_up_sync(0xffffffffu, pb, off);
        if (i >= off) {
          pb = fmaf(pa, qb, pb);
          pa *= qa;
        }
      }
      float ea = __shfl_up_sync(0xffffffffu, pa, 1);
      float eb = __shfl_up_sync(0xffffffffu, pb, 1);
      if (i == 0) {
        ea = 1.0f;
        eb = 0.0f;
      }
      float c = fmaf(ea, carry[wl], eb);
      for (int m = 0; m < q; ++m) {
        const int idx = (i * q + m) * lanes + wl;
        const float ma = sa[idx], mb = sb[idx];
        sb[idx] = c;
        c = fmaf(ma, c, mb);
      }
    }
    __syncthreads();
    // (3) the chunk again from its carry, as the serial kernel steps, with
    // the o gate loaded kOLoads steps at a time
    float c = sb[threadIdx.x];
#pragma unroll
    for (int u0 = 0; u0 < kMaxChunk; u0 += kOLoads) {
      float o[kOLoads];
#pragma unroll
      for (int u = 0; u < kOLoads; ++u) {
        if (u0 + u < n) o[u] = yp[(t0 + u0 + u) * ys + 2 * H];
      }
#pragma unroll
      for (int u = 0; u < kOLoads; ++u) {
        if (u0 + u < n) {
          c = fmaf(a[u0 + u], c, bz[u0 + u]);
          hp[(t0 + u0 + u) * H] = sigmoidf_(o[u]) * c;
        }
      }
    }
    if (n > 0 && t0 + n == T) c_last[lane] = c;
    if (k == chunks - 1 && n == len) carry[l] = c;  // into the next segment
    __syncthreads();
  }
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

// Lanes per block: 8, or 4 when tiles of 8 would be fewer blocks than the
// card has SMs.
extern "C" int qrnn_pool_fwd_chunked(const void* y, const void* c0, void* h,
                                     void* c_last, long long B, long long T,
                                     long long H, void* stream) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int lanes = (B * H + 7) / 8 >= sms ? 8 : 4;
  const long long chunks = kChunkThreads / lanes;
  const long long need = (T + chunks - 1) / chunks;
  const int len = static_cast<int>(need < kMaxChunk ? need : kMaxChunk);
  qrnn_pool_fwd_chunked_kernel<<<
      static_cast<unsigned int>((B * H + lanes - 1) / lanes), kChunkThreads,
      0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(c0),
      static_cast<float*>(h), static_cast<float*>(c_last), B, T, H, lanes,
      len);
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
