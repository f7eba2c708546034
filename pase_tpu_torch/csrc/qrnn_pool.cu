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
// [B, H], all f32, contiguous. In qrnn_pool_fwd one thread owns one (b, j)
// lane, j fastest, so the loads and stores at t*3H + {0, H, 2H} + j and
// t*H + j are coalesced across a warp; the other kernels tile lanes and
// steps (below). No padding copies: the ragged last block is masked, and
// every offset is 64-bit.
//
// Seven entry points:
//   qrnn_pool_fwd        forward: reads y, writes h and c_T (16 bytes per
//                        lane-step), one thread a lane: the seeded serving
//                        call on many lanes;
//   qrnn_pool_fwd_seg    the same function, bit for bit, gates apart from
//                        the chain (below): the seeded serving call on
//                        fewer lanes (a streaming push);
//   qrnn_pool_fwd_few    the same function, chunked in time, the chunk
//                        maps of each warp scanned by shuffles: the
//                        unseeded call outside the eval and split routes
//                        (B = 1 extraction, a 10 s window, the serving
//                        batch; below);
//   qrnn_pool_fwd_split  the same function, each lane's time axis cut
//                        into tiles spread over blocks, their carries
//                        passed between blocks (below): the unseeded call
//                        on 512 lanes or fewer of 7500 steps or more (a
//                        file of 75 s or more at B = 1);
//   qrnn_pool_fwd_eval   the same function, chunked in time as the
//                        training forward is, 32 lanes a block, without
//                        its c stores (below): the unseeded call on many
//                        lanes (every training CLI's eval, batched
//                        serving);
//   qrnn_pool_fwd_train  the same, and also writes c, the residual of the
//                        backward (20 bytes per lane-step), chunked in
//                        time (below). A reverse scan cannot rebuild
//                        c_{t-1} from c_t without dividing by a, so c is
//                        stored;
//   qrnn_pool_bwd        reads y, c and dh, writes dy once (32 bytes per
//                        lane-step), chunked in time (below). The JAX VJP
//                        flips a and dc, materializes a_next and c_prev
//                        and runs the forward kernel again; here one
//                        kernel walks the chunks from the last to the
//                        first.
//
// What bounds them: device memory bytes, when there are enough lanes. At
// the streaming push shapes there are few lanes and few steps ([1, 100,
// 512]: 512 lanes of 100 steps, 0.6 MB). There the one-thread-per-lane
// loop (qrnn_pool_fwd_kernel) gave 8 blocks of
// two warps, each thread doing tanhf, two expf and two IEEE divides before
// the one FMA of the carry, with nothing to hide their latency: about 360
// cycles a step against the FMA's 4 (0.0201 ms at [1,100,512] on the H100,
// ten times its latency floor). qrnn_pool_fwd_seg separates the gate
// math, which is parallel in t, from the carry chain, which is serial in t
// (qrnn_pool_fwd_seg_kernel): a block owns a tile of
// kSegLanes consecutive lanes and walks T in segments of kSegSteps steps.
// (1) Every thread of the block loads its share of the segment's gates
// (rows of kSegLanes floats at t*3H + {0, H, 2H} + j) and computes a =
// 1 - sigmoid(f), b = sigmoid(f) tanh(z) into shared memory and s =
// sigmoid(o) into registers, with the expressions of the serial step; then
// it issues the next segment's loads, which land while (2) one thread per
// lane steps c = fmaf(a, c, b) over the segment from shared memory, a and
// b read kChainAhead steps ahead so that only the FMA's latency stays on
// the chain, and writes each c_t back over b_t; (3) every thread writes
// h = s c. The transcendentals are spread over all the block's threads and
// over B*H / kSegLanes blocks, and the chain is the serial loop's: the
// same gates, the same seed, the same fmaf in the same order, so the bits
// are those of the one-thread-per-lane loop at every shape.
//
// qrnn_pool_fwd_few, the unseeded forward outside the eval and split
// routes: B = 1 extraction (2 s utterances: 512 lanes of 200 steps, 1.2 MB
// of y, a byte bound of 0.5 us under the 1.3 us launch floor), a 10 s
// window, the serving batch of 8 (4096 lanes of 1000 steps). It cuts each
// lane's time axis into chunks, one thread each, as pase_tpu/parallel/sp.py
// composes the carries across shards, inside one block. The kernel it
// replaced (a tile of 512 threads, 8 lanes a block, or 4 under 8 x the
// SMs' lanes) took 0.0052 ms at [1,200,512]: two dependent trips to memory
// (z and f, then o after the scan), two barriers and a 4-warp scan of 128
// maps for 2 steps a thread, and each warp's load of a step 16 bytes of a
// row. Here a block owns LW consecutive lanes and walks T in segments of
// 32 / LW chunks a warp x NW warps (qrnn_pool_fwd_few_kernel): (1) each
// thread loads its chunk's z, f and o together, every load issued before
// the first use (the next segment's in flight across the barrier), and
// composes its chunk's map c -> A c + B from c = 0; (2) each warp scans its
// chunks' maps with shuffles; (3) after the segment's one barrier a thread
// puts the carry through the maps of the warps before its own, then its
// warp's scanned map; (4) it re-runs its chunk from that carry with the
// serial step's fmaf and writes h. y is read once; longer T is walked in
// segments, each seeded with the last one's c_T, so any T is one launch.
// The carry into a chunk comes from composed maps, so it rounds otherwise
// than the serial loop (a = 1 - f lies in (0, 1): the composition only
// contracts); a block-streamed run is bit-identical to the full run only
// on the serial kernels, so seeded calls stay there. Three tiles by lanes
// (kFew*): on at most kFewNarrow lanes blocks of 4 lanes (B = 1: 128
// blocks, 16 warps of 8 chunks of at most 4 steps, 2 blocks an SM), on at
// most kFewMid blocks of 8 (a 32-byte sector a step; B = 2: 128 blocks, 16
// warps of 4 chunks of at most 8, 1 block an SM), on more blocks of 8 with
// chunks of at most 4 at 2 blocks an SM (the serving batch: 512 blocks in
// one wave). Its sigmoids hold their argument at -80 or above
// (sigmoid_sat_): frozen gates (y_f = -200) otherwise send the divide to
// its slow path on every step. Measured on the H100 (python -m
// pase_tpu_torch.kernel_variants fewlane, in turns with the replaced
// kernel built from an earlier source; PERF.md): 0.0038 against 0.0052 ms
// at [1,200,512], 0.0075 against 0.0091 at [1,1000,512], 0.0125 against
// 0.0191 at [2,1500,512], 0.0314 against 0.0372 at [8,1000,512]; the
// streaming floor (y read once, h written once, no carry) takes 0.0026 at
// [1,200,512]. More blocks mattered more than full sectors at B = 1
// (blocks of 8 lanes: 0.0087-0.0097 ms at [1,1000,512]); full sectors from
// 1024 lanes (blocks of 4 there: 0.0161 ms at [2,1500,512]). A cluster of
// blocks a lane tile (32 lanes, 8 blocks cutting T, one segment each,
// their maps passed through distributed shared memory: one pass, no flags)
// only matched the replaced kernel at B = 1 of 200-1000 steps (0.0053
// against 0.0051 ms at [1,200,512]), and was taken out again.
//
// qrnn_pool_fwd_split cuts each lane's time axis across blocks, which the
// TPU kernel never had to do (its grid walks the time blocks in order,
// carrying c in scratch; Hopper's blocks run in no order). A block owns a
// tile of kEvalLanes lanes (a warp's load of a step is one 128-byte row)
// x segs segments of the eval kernel's chunking, about kSplitGrid tiles a
// call (one wave of 3 blocks an SM), tiles taken by an atomic ticket so a
// block waits only on running ones. The carry between tiles is composed
// as pase_tpu/parallel/sp.py composes it between shards, in index order,
// with the same bits on every call: (1) the block runs its tile with
// fwd_chunks_ from c = 0 (c0 on the first tile, whose carry is the true
// one), recording the carry into each segment, A (the product of the a)
// and B (the carry out): the tile's map c -> A c + B; it stores h only
// from the first segment before which A so far is under kSpecTiny in
// every lane (a carry in has no say there); (2) warp 0 publishes the map,
// composes the carry into the tile from the published maps of the tiles
// before it (look_back_: from the nearest tile whose carry out is
// published, fmaf(A, c, B) each, the same value whichever block computes
// it) and publishes the carry out; (3) the block runs the tile again from
// the true carry, the next segment's loads in flight, up to the first
// segment from (1)'s first stored one whose carry in equals the recorded
// one bit for bit in every lane: from there on the two runs are the same,
// so h and c_T are those of the run from the true carry. The carry's
// influence decays as the product of the a: on random gates within a
// segment, so (3) is a segment; on gates that keep a carry thousands of
// steps (f near 0) (1) stores nothing and (3) is the whole tile, read
// twice. Measured on the H100 (python -m pase_tpu_torch.kernel_variants
// split, in turns; PERF.md), split / the kernel qrnn_pool_fwd_few
// replaced on random and on slow gates: 0.65 and 0.98-1.01 at
// [1,10000,512], 0.84 and 1.17 at [1,5000,512], 0.93 and 1.56 at
// [8,4000,512]; against qrnn_pool_fwd_few 0.89 and 1.36 at [1,10000,512];
// ops/cuda_qrnn.py routes it at most 512 lanes of at least 7500 steps. Other designs at [1,10000,512]: storing h in (1)
// from the start and running (3) a segment at a time, 0.043 ms on random
// gates but 1.12 of the replaced kernel on slow ones; a map pass and then
// the run in each block (z and f read again from L2) 0.066 ms, the two
// passes adding up (0.031 and 0.038 alone); one pass with the tile's gates
// in registers 0.059-0.062, its look-back then on each block's critical
// path; persistent blocks holding their next ticket 0.145 (a held tile's
// map waits for its holder); map blocks and run blocks in turns in one
// launch 0.070. A cooperative launch (a grid barrier between the maps and
// the runs) needs every block resident, so each would walk several tiles
// and read them twice, the two passes again; it was not built, nor two
// launches (z and f read twice). Flags: ctrl = {ticket counter, epoch, a
// flag a tile}; a flag holds the call's epoch and the tile's state (1:
// map, 2: carry out), so no call clears them: the block with the last
// ticket resets the counter and moves the epoch on. The wrapper keeps one
// zeroed ctrl a stream for eager calls, and gives each call captured in a
// CUDA graph a zeroed ctrl of its own (the zeroing replays with it;
// ops/cuda_qrnn.py), so two streams or two graphs never share flags.
// Every wait traps after 10 s. For short calls the look-back and the
// second run cost more than the split saves.
//
// qrnn_pool_fwd_train and qrnn_pool_bwd, the training pair (K2 of
// pallas_qrnn.py:76-97, with K3's gates and their gradient fused in), run
// once each in every training step at a rank's lanes: 12288 to 98304
// (B*H) of T = 200 steps. Bytes bound them: 20 and 32 bytes a lane-step
// against 14 and 25 operations, so the card needs about 25 KB of loads in
// flight on each SM to stream at its rate. One thread a lane walking T
// (the first design of the pair, still qrnn_pool_fwd's) had 2-12 warps an
// SM at those lanes, each with one lane's next 8 steps in flight, and
// nothing in flight while it computed them: 26-30 % of the byte bound at
// 12288 lanes (qrnn_pool_fwd itself: 41 % at 24576 lanes). Here a block
// owns kTrainLanes consecutive lanes (one warp's width, so a warp's loads
// and stores of one step are one coalesced row) and walks T in segments
// of kTrainChunks chunks of `len` steps, one chunk a warp, chosen so that
// the fewest segments cover T (T = 200: forward 4 of 8 x 7, backward 7 of
// 8 x 4):
// (1) each thread has its chunk's inputs in registers, loaded together
// (forward: the z, f and o gates; backward: those, dh and c), and issues
// the next segment's loads (kPrefetch) before it computes the gates and
// composes the chunk's affine map from a zero carry; (2) after one
// barrier, each thread puts the segment's carry through the maps of the
// chunks before it (the ones after it, backward), in a fixed order: no
// atomics, the same bits on every call; (3) it re-runs its chunk from that
// carry with the serial step's expressions and writes its outputs. The
// carry into the next segment is the last chunk's (the first chunk's,
// backward), through shared memory in two buffers, so one barrier a
// segment suffices. The backward's carry is q_t = a_t g_t, the gradient
// into c_{t-1}: seeded with dc_T, and dc0 = q_0. Every output is written
// once, every input read once but c at each chunk's first step - 1 (the
// c_{t-1} of dy_f), which the warp of the chunk before also loads.
// Loads go straight to registers: no asynchronous copy and no mbarrier,
// so no wait needs the 10 s trap of csrc/conv_s1_tc.cu; every thread of a
// block runs the same segments, so each reaches every __syncthreads().
// ops/qrnn.py's qrnn_pool_fwd_train_chunked_plain (at either forward's
// chunking) and qrnn_pool_bwd_chunked_plain repeat this algebra in this
// order.
//
// qrnn_pool_fwd_eval, the unseeded forward on many lanes (every training
// CLI's eval: 3 streams x the batch's rows, T = 200), runs the training
// forward's body (fwd_chunks_) without c's stores: 16 bytes a lane-step,
// 80 registers a thread either way, at a tile of its own (kEval*, below):
// 8 chunks of at most 5 steps a block, so T = 200 is 5 full segments of
// 8 x 5. A seeded call never takes it: its composed carry rounds otherwise
// than the serial chain, and only that chain keeps a block-streamed run
// bit for bit equal to a full one.
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

// sigmoidf_ with x held at -kSigmoidFloor or above (qrnn_pool_fwd_few's
// kernel): 1 + expf(-x) stays finite, so the IEEE divide keeps its fast
// path (a forget gate of -200 gives 1 / inf, the slow path, on every step
// of a chunk). It differs from sigmoidf_ only below -kSigmoidFloor, where
// both are under 2e-35; NaN stays NaN.
constexpr float kSigmoidFloor = 80.0f;

__device__ __forceinline__ float sigmoid_sat_(float x) {
  return sigmoidf_(x < -kSigmoidFloor ? -kSigmoidFloor : x);
}

__device__ __forceinline__ float step_(float c, float zr, float fr, float orr,
                                       float* h_out) {
  const float z = tanhf(zr);
  const float f = sigmoidf_(fr);
  const float a = 1.0f - f;
  const float b = f * z;
  c = fmaf(a, c, b);
  *h_out = sigmoidf_(orr) * c;
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

// qrnn_pool_fwd_seg's kernel, gates apart from the chain (header). A block
// owns kSegLanes consecutive lanes and walks T in segments of kSegSteps steps
// with kSegThreads threads; each thread keeps one lane and every
// kSegThreads / kSegLanes-th step of the segment. Chosen on the H100 at
// the push shapes [1,100,512], [8,100,512], [1,10,512] and [8,10,512]
// among 4, 8 and 32 lanes, 32, 64 and 128 steps and 128 and 256 threads
// (python -m pase_tpu_torch.kernel_variants serial; PERF.md): 8 / 128 /
// 128 was the fastest at [8,100,512], within 0.7 us of the fastest at
// [1,100,512] (tiles of 256 threads, 1.5-2 us slower at B = 8), and faster
// than the loop at the 100 ms pushes.
constexpr int kSegLanes = 8;
constexpr int kSegSteps = 128;
constexpr int kSegThreads = 128;
constexpr int kChainAhead = 8;

// Thread row r's raw gates of the segment from s0: steps s0 + r + k kRows.
template <int kPer, int kRows>
__device__ __forceinline__ void seg_load_(const float* yp, bool live,
                                          int64_t s0, int r, int64_t T,
                                          int64_t H, float (&zr)[kPer],
                                          float (&fr)[kPer],
                                          float (&orr)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t t = s0 + r + k * kRows;
    if (live && t < T) {
      const float* p = yp + t * 3 * H;
      zr[k] = p[0];
      fr[k] = p[H];
      orr[k] = p[2 * H];
    }
  }
}

template <int L, int S, int NT>
__global__ void __launch_bounds__(NT)
qrnn_pool_fwd_seg_kernel(const float* __restrict__ y,
                         const float* __restrict__ c0,
                         float* __restrict__ h, float* __restrict__ c_last,
                         int64_t B, int64_t T, int64_t H) {
  static_assert(NT % L == 0 && S % (NT / L) == 0 && S % kChainAhead == 0,
                "a block's rows must tile the segment");
  constexpr int kRows = NT / L;    // steps one pass of the block covers
  constexpr int kPer = S / kRows;  // steps per thread per segment
  // a and b of the segment's steps, [step][lane]; the chain writes c_t
  // over b_t
  __shared__ float sa[S * L], sb[S * L];
  const int l = threadIdx.x % L, r = threadIdx.x / L;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * L + l;
  const bool live = lane < B * H;
  const int64_t bi = live ? lane / H : 0;
  const int64_t j = live ? lane - bi * H : 0;
  const int64_t ys = 3 * H;
  const float* yp = y + bi * T * ys + j;
  float* hp = h + bi * T * H + j;
  // the carry; only threads r == 0 (one per lane) run the chain
  float c = (live && r == 0 && c0 != nullptr) ? c0[lane] : 0.0f;
  float zr[kPer], fr[kPer], orr[kPer], s[kPer];

  seg_load_<kPer, kRows>(yp, live, 0, r, T, H, zr, fr, orr);
  for (int64_t s0 = 0; s0 < T; s0 += S) {
    const int n = T - s0 < S ? static_cast<int>(T - s0) : S;
    // (1) the gates of the segment; steps past n (and dead lanes) are the
    // identity map a = 1, b = 0
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int tt = r + k * kRows;
      float a = 1.0f, b = 0.0f;
      s[k] = 0.0f;
      if (live && tt < n) {
        const float z = tanhf(zr[k]);
        const float f = sigmoidf_(fr[k]);
        a = 1.0f - f;
        b = f * z;
        s[k] = sigmoidf_(orr[k]);
      }
      sa[tt * L + l] = a;
      sb[tt * L + l] = b;
    }
    if (s0 + S < T) {                // in flight during (2) and (3)
      seg_load_<kPer, kRows>(yp, live, s0 + S, r, T, H, zr, fr, orr);
    }
    __syncthreads();
    // (2) the chain, a and b read kChainAhead steps ahead; the padded
    // steps past n (up to a multiple of kChainAhead) are never read back
    if (r == 0 && live) {
      const int steps = (n + kChainAhead - 1) / kChainAhead * kChainAhead;
      float na[kChainAhead], nb[kChainAhead];
#pragma unroll
      for (int u = 0; u < kChainAhead; ++u) {
        na[u] = sa[u * L + l];
        nb[u] = sb[u * L + l];
      }
      for (int t0 = 0; t0 < steps; t0 += kChainAhead) {
        float ca[kChainAhead], cb[kChainAhead];
#pragma unroll
        for (int u = 0; u < kChainAhead; ++u) {
          ca[u] = na[u];
          cb[u] = nb[u];
        }
        if (t0 + kChainAhead < steps) {
#pragma unroll
          for (int u = 0; u < kChainAhead; ++u) {
            na[u] = sa[(t0 + kChainAhead + u) * L + l];
            nb[u] = sb[(t0 + kChainAhead + u) * L + l];
          }
        }
#pragma unroll
        for (int u = 0; u < kChainAhead; ++u) {
          c = fmaf(ca[u], c, cb[u]);
          sb[(t0 + u) * L + l] = c;
        }
      }
      c = sb[(n - 1) * L + l];        // c at the segment's last real step
    }
    __syncthreads();
    // (3) h = s c
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int tt = r + k * kRows;
      if (live && tt < n) hp[(s0 + tt) * H] = s[k] * sb[tt * L + l];
    }
    __syncthreads();                  // before (1) of the next segment
  }
  if (r == 0 && live) c_last[lane] = c;
}


// The training pair's tile (header): lanes a block, threads a block (so
// kTrainChunks chunks a segment), steps a chunk at most forward and
// backward, blocks an SM the registers must allow, and whether the next
// segment's loads are issued before this one's gates are computed. Chosen
// on the H100 at chip_smoke.TRAIN_QRNN_SHAPES among the tiles of python -m
// pase_tpu_torch.kernel_variants train (PERF.md): the forward is fastest
// with chunks of 8 at 3 blocks an SM (at 4, 64 registers a thread, 0.0295
// ms against 0.0198 at [24,200,512]), the backward, which holds 5 inputs
// and 4 factors a step, with chunks of 4 at 3 blocks (chunks of 8 took 128
// registers, so 2 blocks: 0.0433 ms against 0.0314).
constexpr int kTrainLanes = 32;
constexpr int kTrainThreads = 256;
constexpr int kFwdChunk = 8;
constexpr int kBwdChunk = 4;
constexpr int kFwdBlocks = 3;
constexpr int kBwdBlocks = 3;
constexpr bool kPrefetch = true;
constexpr int kTrainChunks = kTrainThreads / kTrainLanes;
static_assert(kTrainThreads % kTrainLanes == 0 && kTrainLanes % 32 == 0,
              "a warp holds lanes of one chunk");

// Steps a chunk for T: the fewest segments of `chunks` chunks of at most
// max_chunk steps, then the shortest chunk that covers T in as many.
int chunk_len(long long T, int chunks, int max_chunk) {
  const long long per = static_cast<long long>(chunks) * max_chunk;
  const long long cover = (T + per - 1) / per * chunks;
  return static_cast<int>((T + cover - 1) / cover);
}

int train_len(long long T, int max_chunk) {
  return chunk_len(T, kTrainChunks, max_chunk);
}

// The steps of chunk k of the segment from s0 (0 on a dead lane).
__device__ __forceinline__ int chunk_steps(bool live, int64_t T, int64_t t0,
                                           int len) {
  const int64_t left = live ? T - t0 : 0;
  return left <= 0 ? 0 : (left < len ? static_cast<int>(left) : len);
}

// A chunk's raw gates: p points at y[b, t0, j].
template <int C>
__device__ __forceinline__ void chunk_load_y_(const float* p, int n,
                                              int64_t H, float (&z)[C],
                                              float (&f)[C], float (&o)[C]) {
#pragma unroll
  for (int u = 0; u < C; ++u) {
    if (u < n) {
      const float* q = p + u * 3 * H;
      z[u] = q[0];
      f[u] = q[H];
      o[u] = q[2 * H];
    }
  }
}

// qrnn_pool_fwd_few's tiles (header): on at most kFewNarrow lanes, lanes
// a block (a warp's row of a step), warps a block (the block's chunks: 32
// / kFewLanes a warp x kFewWarps), steps a chunk at most and blocks an SM
// the registers must allow; on at most kFewMid lanes the same of the mid
// tile, on more of the wide one; and segments of loads in flight.
constexpr int kFewNarrow = 512;
constexpr int kFewLanes = 4;
constexpr int kFewWarps = 16;
constexpr int kFewChunk = 4;
constexpr int kFewBlocks = 2;
constexpr int kFewMid = 1024;
constexpr int kFewMidLanes = 8;
constexpr int kFewMidWarps = 16;
constexpr int kFewMidChunk = 8;
constexpr int kFewMidBlocks = 1;
constexpr int kFewWideLanes = 8;
constexpr int kFewWideWarps = 16;
constexpr int kFewWideChunk = 4;
constexpr int kFewWideBlocks = 2;
constexpr int kFewDepth = 1;
static_assert(32 % kFewLanes == 0 && 32 % kFewMidLanes == 0 &&
                  32 % kFewWideLanes == 0,
              "a warp holds whole lane groups");

// qrnn_pool_fwd_few's kernel (header): a block owns LW consecutive lanes
// and walks T in segments of NW warps x 32 / LW chunks of `len` <= C
// steps; warp w holds chunks w 32 / LW .. w 32 / LW + 32 / LW - 1 (thread
// i: lane i % LW of the group, the warp's chunk i / LW), the loads of the
// next D segments in flight across the barrier. (1) Each thread loads its
// chunk's z, f and o gates (every load issued before the first use) and
// composes the chunk's map c -> A c + B from c = 0; (2) the warp scans its
// chunks' maps with shuffles (an inclusive scan over the chunk index, a
// map composed after an earlier one as c -> pa (qa c + qb) + pb), and its
// last chunk's map, the warp's, goes to shared memory; (3) after the
// segment's one barrier, each thread puts the segment's carry through the
// maps of the warps before its own in order, then through the scanned map
// of its warp's chunks before its own; (4) it runs its chunk from that
// carry with the serial step's fmaf and writes h. The carry into the next
// segment is the last chunk's, through shared memory in two buffers.
template <int LW, int NW, int C, int D, int MB>
__global__ void __launch_bounds__(32 * NW, MB)
qrnn_pool_fwd_few_kernel(const float* __restrict__ y,
                         const float* __restrict__ c0,
                         float* __restrict__ h, float* __restrict__ c_last,
                         int64_t B, int64_t T, int64_t H, int len) {
  constexpr int CW = 32 / LW, NC = CW * NW;
  // the warps' maps and the carry into the segment, by segment parity
  __shared__ float wa[2][NW][LW], wb[2][NW][LW], carry[2][LW];
  const int w = threadIdx.x / 32, i = threadIdx.x % 32;
  const int l = i % LW, kw = i / LW, k = w * CW + kw;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * LW + l;
  const bool live = lane < B * H;
  const int64_t bi = live ? lane / H : 0;
  const int64_t j = live ? lane - bi * H : 0;
  const float* yp = y + bi * T * 3 * H + j;
  float* hp = h + bi * T * H + j;
  const int64_t seg = static_cast<int64_t>(NC) * len;
  constexpr int R = D > 0 ? D : 1;
  float rz[R][C], rf[R][C], ro[R][C];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int64_t t0 = d * seg + static_cast<int64_t>(k) * len;
    chunk_load_y_<C>(yp + t0 * 3 * H, chunk_steps(live, T, t0, len), H,
                     rz[d], rf[d], ro[d]);
  }
  if (k == 0) carry[0][l] = (live && c0 != nullptr) ? c0[lane] : 0.0f;
  int p = 0;
  for (int64_t s0 = 0; s0 < T; s0 += seg, p ^= 1) {
    const int64_t t0 = s0 + static_cast<int64_t>(k) * len;
    const int n = chunk_steps(live, T, t0, len);
    if (D == 0) chunk_load_y_<C>(yp + t0 * 3 * H, n, H, rz[0], rf[0], ro[0]);
    float a[C], b[C], s[C];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      a[u] = rf[0][u];
      b[u] = rz[0][u];
      s[u] = ro[0][u];
    }
#pragma unroll
    for (int d = 0; d + 1 < D; ++d) {
#pragma unroll
      for (int u = 0; u < C; ++u) {
        rz[d][u] = rz[d + 1][u];
        rf[d][u] = rf[d + 1][u];
        ro[d][u] = ro[d + 1][u];
      }
    }
    const int64_t ahead = t0 + D * seg;
    if (D > 0 && s0 + D * seg < T) {
      chunk_load_y_<C>(yp + ahead * 3 * H, chunk_steps(live, T, ahead, len),
                       H, rz[R - 1], rf[R - 1], ro[R - 1]);
    }
    // (1) the gates, and the chunk's map from c = 0
    float pa = 1.0f, pb = 0.0f;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (u < n) {
        const float z = tanhf(b[u]);
        const float f = sigmoid_sat_(a[u]);
        a[u] = 1.0f - f;
        b[u] = f * z;
        s[u] = sigmoid_sat_(s[u]);
        pb = fmaf(a[u], pb, b[u]);
        pa *= a[u];
      }
    }
    // (2) the warp's chunks scanned: thread i then holds the map of the
    // warp's chunks 0 .. kw; ea, eb that of chunks 0 .. kw - 1
#pragma unroll
    for (int off = LW; off < 32; off *= 2) {
      const float qa = __shfl_up_sync(0xffffffffu, pa, off);
      const float qb = __shfl_up_sync(0xffffffffu, pb, off);
      if (i >= off) {
        pb = fmaf(pa, qb, pb);
        pa *= qa;
      }
    }
    const float ea = __shfl_up_sync(0xffffffffu, pa, LW % 32);
    const float eb = __shfl_up_sync(0xffffffffu, pb, LW % 32);
    if (kw == CW - 1) {
      wa[p][w][l] = pa;
      wb[p][w][l] = pb;
    }
    __syncthreads();
    // (3) the segment's carry through the warps before this one, then
    // through the warp's chunks before this one
    float c = carry[p][l];
    for (int m = 0; m < w; ++m) c = fmaf(wa[p][m][l], c, wb[p][m][l]);
    if (kw > 0) c = fmaf(ea, c, eb);
    // (4) the chunk from its carry, as the serial step
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (u < n) {
        c = fmaf(a[u], c, b[u]);
        hp[(t0 + u) * H] = s[u] * c;
      }
    }
    if (n > 0 && t0 + n == T) c_last[lane] = c;
    // into the next segment: when there is one, every chunk here is full
    if (k == NC - 1) carry[p ^ 1][l] = c;
  }
}

// The split kernel's speculative run (fwd_chunks_ with spec) stores h
// from the first segment before which the product of the a is under
// kSpecTiny in every live lane of the tile: a carry in (|c| <= 1 past the
// first tile: c is a mean of tanh values) then moves c by less than 1e-9,
// so the run from the true carry meets it there or soon after; the
// segments before are the second run's.
constexpr float kSpecTiny = 1e-9f;

// The chunked forward's body (header): the NC chunks of L lanes of a block
// walk the steps t_begin .. t_end - 1 of lane tile `tile` (lanes tile L ..
// tile L + L - 1) in segments of NC chunks of `len` <= C steps from
// t_begin, the loads of the next D segments in flight across the barrier
// (D = 0: none). The carry into the first segment is seed(lane, live),
// called by warp 0's threads (k == 0) after the first segments' loads are
// issued. With kStoreC (qrnn_pool_fwd_train) it also writes every c_t to
// c_all; without it (qrnn_pool_fwd_eval, qrnn_pool_fwd_split) c_all is not
// touched; c_T is written by the lane's step T - 1. With kRecord
// (qrnn_pool_fwd_split) rec ([2 + segments][L], shared) gets the product
// of the segments' chunk A in rec[0], the last chunk's last c in rec[1]
// (the carry out, when the last segment is whole) and the carry into
// segment i in rec[2 + i], read after a barrier; with spec (the split
// kernel's speculative run) h is stored only from the first segment
// before which the product of the a is under kSpecTiny in every live lane
// (*first: its index, 1 << 30 if none; 0 without spec). stop(i, carry) is
// called by every thread before segment i's loads are issued, with the
// carry into it in shared memory: true, the same in every thread, ends the
// run there (RerunStop). Every thread of the block runs the same segments,
// so each reaches every __syncthreads().
struct NoStop {
  __device__ __forceinline__ bool operator()(int, const float*) const {
    return false;
  }
};

template <int L, int NC, int C, int D, bool kStoreC, typename Seed,
          bool kRecord = false, typename Stop = NoStop>
__device__ __forceinline__ void fwd_chunks_(const float* __restrict__ y,
                                            float* __restrict__ h,
                                            float* __restrict__ c_all,
                                            float* __restrict__ c_last,
                                            int64_t B, int64_t T, int64_t H,
                                            int len, int64_t tile,
                                            int64_t t_begin, int64_t t_end,
                                            Seed seed,
                                            float* rec = nullptr,
                                            bool spec = false,
                                            int* first = nullptr,
                                            Stop stop = Stop{}) {
  // the chunk maps (A, B) and the carry into the segment, by segment
  // parity; with kRecord, whether the segment's h is stored
  __shared__ float sa[2][NC][L], sb[2][NC][L], carry[2][L];
  __shared__ int keep_h[2];
  const int l = threadIdx.x % L, k = threadIdx.x / L;
  const int64_t lane = tile * L + l;
  const bool live = lane < B * H;
  const int64_t bi = live ? lane / H : 0;
  const int64_t j = live ? lane - bi * H : 0;
  const float* yp = y + bi * T * 3 * H + j;
  float* hp = h + bi * T * H + j;
  float* cp = kStoreC ? c_all + bi * T * H + j : nullptr;
  const int64_t seg = static_cast<int64_t>(NC) * len;
  // the raw gates of this segment ([0]) and of the D - 1 after it
  constexpr int R = D > 0 ? D : 1;
  float rz[R][C], rf[R][C], ro[R][C];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int64_t t0 = t_begin + d * seg + static_cast<int64_t>(k) * len;
    chunk_load_y_<C>(yp + t0 * 3 * H, chunk_steps(live, t_end, t0, len), H,
                     rz[d], rf[d], ro[d]);
  }
  if (k == 0) carry[0][l] = seed(lane, live);
  if (kRecord && threadIdx.x == 0) {
    keep_h[0] = !spec;
    *first = spec ? 1 << 30 : 0;
  }
  int p = 0, si = 0;
  float prod = 1.0f;
  for (int64_t s0 = t_begin; s0 < t_end; s0 += seg, p ^= 1, ++si) {
    if (stop(si, carry[p])) break;
    const int64_t t0 = s0 + static_cast<int64_t>(k) * len;
    const int n = chunk_steps(live, t_end, t0, len);
    if (D == 0) chunk_load_y_<C>(yp + t0 * 3 * H, n, H, rz[0], rf[0], ro[0]);
    float a[C], b[C], s[C];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      a[u] = rf[0][u];
      b[u] = rz[0][u];
      s[u] = ro[0][u];
    }
#pragma unroll
    for (int d = 0; d + 1 < D; ++d) {
#pragma unroll
      for (int u = 0; u < C; ++u) {
        rz[d][u] = rz[d + 1][u];
        rf[d][u] = rf[d + 1][u];
        ro[d][u] = ro[d + 1][u];
      }
    }
    const int64_t ahead = t0 + D * seg;  // in flight until D segments on
    if (D > 0 && s0 + D * seg < t_end) {
      chunk_load_y_<C>(yp + ahead * 3 * H, chunk_steps(live, t_end, ahead, len),
                       H, rz[R - 1], rf[R - 1], ro[R - 1]);
    }
    // (1) the gates, and the chunk's map c -> A c + B from c = 0
    float ma = 1.0f, mb = 0.0f;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (u < n) {
        const float z = tanhf(b[u]);
        const float f = sigmoidf_(a[u]);
        a[u] = 1.0f - f;
        b[u] = f * z;
        s[u] = sigmoidf_(s[u]);
        mb = fmaf(a[u], mb, b[u]);
        ma *= a[u];
      }
    }
    sa[p][k][l] = ma;
    sb[p][k][l] = mb;
    __syncthreads();
    const bool keep = !kRecord || keep_h[p];
    // (2) the segment's carry through the maps of the chunks before this one
    float c = carry[p][l];
    for (int m = 0; m < k; ++m) c = fmaf(sa[p][m][l], c, sb[p][m][l]);
    if (kRecord && k == 0) {
      rec[(si + 2) * L + l] = c;
#pragma unroll
      for (int m = 0; m < NC; ++m) prod *= sa[p][m][l];
      // the next segment's h stored once a carry in has no say in it
      const bool tiny = __all_sync(0xffffffffu, !live || prod < kSpecTiny);
      if (l == 0) {
        keep_h[p ^ 1] = keep || tiny;
        if (!keep && tiny) *first = si + 1;
      }
    }
    // (3) the chunk from its carry, as the serial step
#pragma unroll
    for (int u = 0; u < C; ++u) {
      if (u < n) {
        c = fmaf(a[u], c, b[u]);
        if (kStoreC) cp[(t0 + u) * H] = c;
        if (keep) hp[(t0 + u) * H] = s[u] * c;
      }
    }
    if (n > 0 && t0 + n == T) c_last[lane] = c;
    // into the next segment: when there is one, every chunk here is full
    if (k == NC - 1) carry[p ^ 1][l] = c;
    if (kRecord && k == NC - 1) rec[L + l] = c;
  }
  if (kRecord && k == 0) rec[l] = prod;
}

// The seed of a lane of the training and eval kernels: c0[lane], or 0.
struct LaneSeed {
  const float* c0;
  __device__ __forceinline__ float operator()(int64_t lane, bool live) const {
    return (live && c0 != nullptr) ? c0[lane] : 0.0f;
  }
};

template <int C>
__global__ void __launch_bounds__(kTrainThreads, kFwdBlocks)
qrnn_pool_fwd_train_kernel(const float* __restrict__ y,
                           const float* __restrict__ c0,
                           float* __restrict__ h, float* __restrict__ c_all,
                           float* __restrict__ c_last, int64_t B, int64_t T,
                           int64_t H, int len) {
  fwd_chunks_<kTrainLanes, kTrainChunks, C, kPrefetch ? 1 : 0, true>(
      y, h, c_all, c_last, B, T, H, len, blockIdx.x, 0, T, LaneSeed{c0});
}

// qrnn_pool_fwd_eval's tile (header): lanes a block, threads a block (so
// kEvalChunks chunks a segment), steps a chunk at most, blocks an SM the
// registers must allow, and how many segments ahead the loads are issued
// before this one's gates are computed. Chosen on the H100 among the 16
// tiles of python -m pase_tpu_torch.kernel_variants eval at the T = 200
// shapes of chip_smoke.QRNN_SHAPES (PERF.md): chunks of at most 5 steps
// (T = 200 in 5 full segments of 8 x 5) were faster at every shape than
// the training forward's chunks of 8 (4 segments of 8 x 7, the last 4/7
// full; 80 registers either way): 0.0324 against 0.0344 ms at
// [48,200,512], 0.0605 against 0.0625 at [96,200,512], 0.0158 against
// 0.0162 at [48,200,256]. 4 blocks an SM, 128 threads a block or the loads
// of two segments ahead were faster at some shapes and slower in total
// (two segments ahead: 0.0362 ms at [48,200,512]).
constexpr int kEvalLanes = 32;
constexpr int kEvalThreads = 256;
constexpr int kEvalChunk = 5;
constexpr int kEvalBlocks = 3;
constexpr int kEvalDepth = 1;
constexpr int kEvalChunks = kEvalThreads / kEvalLanes;
static_assert(kEvalThreads % kEvalLanes == 0 && kEvalLanes % 32 == 0,
              "a warp holds lanes of one chunk");

template <int C>
__global__ void __launch_bounds__(kEvalThreads, kEvalBlocks)
qrnn_pool_fwd_eval_kernel(const float* __restrict__ y,
                          const float* __restrict__ c0,
                          float* __restrict__ h, float* __restrict__ c_last,
                          int64_t B, int64_t T, int64_t H, int len) {
  fwd_chunks_<kEvalLanes, kEvalChunks, C, kEvalDepth, false>(
      y, h, nullptr, c_last, B, T, H, len, blockIdx.x, 0, T, LaneSeed{c0});
}

// qrnn_pool_fwd_split's tile (header): kEvalLanes lanes x whole segments
// of the eval kernel's chunking (kEvalChunks chunks of at most kEvalChunk
// steps, kEvalBlocks blocks an SM, kEvalDepth segments of loads in
// flight: the same body at the same tile), at most kSplitSegs segments a
// tile (their carries are kept in shared memory), about kSplitGrid tiles
// a call (one wave of 3 blocks on each of the H100's 132 SMs).
constexpr int kSplitSegs = 64;
constexpr int kSplitGrid = 384;
static_assert(kEvalLanes == 32, "warp 0 holds the tile's lanes");

// qrnn_pool_fwd_split's tiling of a call on `lanes` lanes (B * H) of T
// steps: tiles of kEvalLanes lanes x `tile` steps, `segs` segments of
// kEvalChunks chunks of `chunk` steps. As many time tiles as bring the
// tiles to kSplitGrid, each of the fewest whole segments of kEvalChunks x
// kEvalChunk steps (at most kSplitSegs) that holds its share of T; when
// one tile holds T, the shortest chunk that covers T in as many.
struct SplitTiling {
  int segs, chunk;
  long long tile, lane_tiles, time_tiles;
};

SplitTiling split_tiling(long long lanes, long long T) {
  const long long seg = static_cast<long long>(kEvalChunks) * kEvalChunk;
  SplitTiling s;
  s.lane_tiles = (lanes + kEvalLanes - 1) / kEvalLanes;
  long long want = (kSplitGrid + s.lane_tiles - 1) / s.lane_tiles;
  want = want < 1 ? 1 : want;
  long long segs = ((T + want - 1) / want + seg - 1) / seg;
  s.segs = static_cast<int>(segs < 1 ? 1 : segs > kSplitSegs ? kSplitSegs
                                                               : segs);
  const long long chunks = static_cast<long long>(s.segs) * kEvalChunks;
  s.chunk = T <= chunks * kEvalChunk
                ? static_cast<int>((T + chunks - 1) / chunks)
                : kEvalChunk;
  s.tile = chunks * s.chunk;
  s.time_tiles = (T + s.tile - 1) / s.tile;
  return s;
}

__device__ __forceinline__ uint64_t global_ns_() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int ld_acquire_(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :
               : "l"(p), "r"(v)
               : "memory");
}

// The epoch of a call lives in bits 2 and up of a flag, its state (1: the
// tile's map published, 2: the carry out of it too) in bits 0-1; the call
// count wraps at kEpochMask + 1.
constexpr int kEpochMask = (1 << 29) - 1;

// The tile's state in this call's epoch e once it is at least 1 (its map
// published). A block publishes its map once its gates are computed,
// microseconds after it starts, and it started before any block that waits
// on it took its ticket: after 10 s the kernel traps, so a broken ticket or
// flag fails its launch instead of holding the card (as
// csrc/conv_s1_tc.cu's waits do).
__device__ __forceinline__ int wait_map_(const int* flag, int e) {
  int f = ld_acquire_(flag);
  if ((f >> 2) == e && (f & 3)) return f & 3;
  const uint64_t t0 = global_ns_();
  while (true) {
    __nanosleep(64);
    f = ld_acquire_(flag);
    if ((f >> 2) == e && (f & 3)) return f & 3;
    if (global_ns_() - t0 > 10000000000ull) __trap();
  }
}

// The carry into time tile tt of lane tile lt, for warp 0 (thread l: lane
// l of the tile): the seed put through the maps of time tiles 0 .. tt - 1
// in that order, c = fmaf(A, c, B) each. A tile publishes its map (state
// 1) and then the carry out of it (state 2), fmaf(A, its carry in, B):
// that is this fold's value there, the same bits whichever block computes
// it. So the fold starts at the nearest tile before tt whose carry out is
// published, or at the seed; the flags of 32 tiles are read at once
// (thread i the i-th), each waited on until its map is published.
__device__ __forceinline__ float look_back_(const int* flags,
                                            const float* maps, int lt,
                                            int lane_tiles, int tt, int l,
                                            int e, float seed) {
  constexpr int L = kEvalLanes;
  int start = -1;        // the tile whose carry out starts the fold
  for (int hi = tt; hi > 0 && start < 0; hi -= 32) {
    const int lo = hi > 32 ? hi - 32 : 0;
    const int j = lo + l;
    const int f =
        j < hi
            ? wait_map_(flags + static_cast<int64_t>(j) * lane_tiles + lt, e)
            : 0;
    const unsigned two = __ballot_sync(0xffffffffu, f == 2);
    if (two) start = lo + 31 - __clz(two);
    else if (lo == 0) break;
  }
  __syncwarp();
  __threadfence();
  float c = start < 0 ? seed
                      : __ldcg(maps + (static_cast<int64_t>(start) *
                                       lane_tiles + lt) * 3 * L + 2 * L + l);
#pragma unroll 8
  for (int m = start + 1; m < tt; ++m) {
    const float* mp =
        maps + (static_cast<int64_t>(m) * lane_tiles + lt) * 3 * L;
    c = fmaf(__ldcg(mp + l), c, __ldcg(mp + L + l));
  }
  return c;
}

// The carry into every lane of the tile as the seed of fwd_chunks_: the
// value warp 0 left in shared memory.
struct SharedSeed {
  const float* c;
  __device__ __forceinline__ float operator()(int64_t, bool) const {
    return c[threadIdx.x % kEvalLanes];
  }
};

// fwd_chunks_'s stop for the split kernel's second run (header, (3)):
// true at the first segment from `first` on (the speculative run's first
// stored one) whose carry in equals the speculative run's (rec[2 + i] of
// its record) bit for bit in every live lane of the tile.
struct RerunStop {
  const float* rec;
  int first;
  int64_t lanes, tile;
  __device__ __forceinline__ bool operator()(int si,
                                             const float* carry) const {
    if (si < first) return false;
    __syncthreads();                  // the carry into segment si written
    const int l = threadIdx.x % kEvalLanes;
    const bool differs =
        threadIdx.x < kEvalLanes && tile * kEvalLanes + l < lanes &&
        __float_as_int(carry[l]) !=
            __float_as_int(rec[(si + 2) * kEvalLanes + l]);
    return !__syncthreads_or(differs);
  }
};

// qrnn_pool_fwd_split's kernel (header): a block a tile of L lanes x segs
// segments of NC chunks of `len` steps, taken by ticket. ctrl: {ticket
// counter, epoch, a flag a tile}, 0 before a stream's first call; maps:
// {A, B, carry out} of L lanes a tile.
template <int C, int NS>
__global__ void __launch_bounds__(kEvalThreads, kEvalBlocks)
qrnn_pool_fwd_split_kernel(const float* __restrict__ y,
                           const float* __restrict__ c0,
                           float* __restrict__ h, float* __restrict__ c_last,
                           int* ctrl, float* maps, int64_t B, int64_t T,
                           int64_t H, int segs, int len, int lane_tiles,
                           int tiles) {
  constexpr int L = kEvalLanes, NC = kEvalChunks;
  // the speculative run's record (fwd_chunks_'s rec) and its first stored
  // segment, the carry into the tile
  __shared__ float rec[NS + 2][L], s_cin[L];
  __shared__ int s_ticket, s_epoch, s_first;
  int* const flags = ctrl + 2;
  // tiles in the order blocks start: a block waits only on tiles of lower
  // tickets, whose blocks are running or done. The block with the last
  // ticket leaves the counter at 0 and moves the epoch on for the next
  // call: every block read the epoch before it took its ticket.
  if (threadIdx.x == 0) {
    const int e = *static_cast<volatile int*>(ctrl + 1);
    __threadfence();
    const int ticket = atomicAdd(ctrl, 1);
    if (ticket == tiles - 1) {
      __threadfence();
      ctrl[0] = 0;
      ctrl[1] = (e + 1) & kEpochMask;
    }
    s_ticket = ticket;
    s_epoch = e;
  }
  __syncthreads();
  const int ticket = s_ticket, e = s_epoch;
  const int tt = ticket / lane_tiles, lt = ticket - tt * lane_tiles;
  const int l = threadIdx.x % L, k = threadIdx.x / L;
  const int64_t seg = static_cast<int64_t>(NC) * len;
  const int64_t t_begin = tt * segs * seg;
  const bool last = t_begin + segs * seg >= T;
  const int64_t t_end = last ? T : t_begin + segs * seg;
  // (1) the speculative run: fwd_chunks_ from c = 0 (or c0 on the first
  // time tile, which stores all of h: its carry is the true one), h stored
  // from the first segment a carry in has no say in; its record: the carry
  // into each segment, the product of the a (A) and the carry out (B) of
  // the tile's map
  const auto zero = [&](int64_t ln, bool lv) {
    return (tt == 0 && lv && c0 != nullptr) ? c0[ln] : 0.0f;
  };
  fwd_chunks_<L, NC, C, kEvalDepth, false, decltype(zero), true>(
      y, h, nullptr, c_last, B, T, H, len, lt, t_begin, t_end, zero,
      &rec[0][0], tt > 0, &s_first);
  __syncthreads();
  if (tt == 0) {
    // it ran from its true carry: the carry out of it published at once
    // (so no look-back folds its map)
    if (!last && k == 0) {
      maps[static_cast<int64_t>(ticket) * 3 * L + 2 * L + l] = rec[1][l];
      __threadfence();
      __syncwarp();
      if (l == 0) st_release_(flags + ticket, (e << 2) | 2);
    }
    return;
  }
  // (2) warp 0: the tile's map published (the last time tile's is read by
  // none); the carry into it (look_back_); the carry out of it, fmaf(A,
  // c_in, B), published
  if (k == 0) {
    float* mp = maps + static_cast<int64_t>(ticket) * 3 * L;
    const float ta = rec[0][l], tb = rec[1][l];
    if (!last) {
      mp[l] = ta;
      mp[L + l] = tb;
      __threadfence();
      __syncwarp();
      if (l == 0) st_release_(flags + ticket, (e << 2) | 1);
    }
    const float c = look_back_(flags, maps, lt, lane_tiles, tt, l, e, 0.0f);
    s_cin[l] = c;
    if (!last) {
      mp[2 * L + l] = fmaf(ta, c, tb);
      __threadfence();
      __syncwarp();
      if (l == 0) st_release_(flags + ticket, (e << 2) | 2);
    }
  }
  __syncthreads();
  // (3) the tile again from the true carry, the next segment's loads in
  // flight, up to the first segment from the speculative run's first
  // stored one whose carry in is the speculative run's bit for bit in
  // every live lane (RerunStop): from there on the two runs are the same
  fwd_chunks_<L, NC, C, kEvalDepth, false, SharedSeed, false, RerunStop>(
      y, h, nullptr, c_last, B, T, H, len, lt, t_begin, t_end,
      SharedSeed{s_cin}, nullptr, false, nullptr,
      RerunStop{&rec[0][0], s_first, B * H, lt});
}

// The launch floor: an empty kernel of one warp.
__global__ void qrnn_pool_empty_kernel() {}

// The streaming floor: h = sigmoid(o) tanh(z) sigmoid(f) of each lane-step,
// y's three thirds read once and h written once, four lanes a thread
// (float4; H a multiple of 4), no carry, with qrnn_pool_fwd_few's
// sigmoids. No K1 of one launch moves less.
__global__ void __launch_bounds__(256)
qrnn_pool_stream_floor_kernel(const float4* __restrict__ y,
                              float4* __restrict__ h, int64_t quads,
                              int64_t hq) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= quads) return;
  const int64_t r = e / hq, q = e - r * hq;
  const float4* p = y + r * 3 * hq + q;
  const float4 z = p[0], f = p[hq], o = p[2 * hq];
  h[e] = make_float4(sigmoid_sat_(o.x) * tanhf(z.x) * sigmoid_sat_(f.x),
                     sigmoid_sat_(o.y) * tanhf(z.y) * sigmoid_sat_(f.y),
                     sigmoid_sat_(o.z) * tanhf(z.z) * sigmoid_sat_(f.z),
                     sigmoid_sat_(o.w) * tanhf(z.w) * sigmoid_sat_(f.w));
}

// A chunk's backward inputs: the raw gates and dh at t0 .. t0 + n - 1 and c
// at t0 - 1 .. t0 + n - 1 (cc[0] = c_{t0-1}: the seed at t0 = 0).
template <int C>
__device__ __forceinline__ void train_load_bwd_(
    const float* yq, const float* dhq, const float* cq, int n, bool first,
    float seed, int64_t H, float (&z)[C], float (&f)[C], float (&o)[C],
    float (&dh)[C], float (&cc)[C + 1]) {
  chunk_load_y_<C>(yq, n, H, z, f, o);
  if (n > 0) cc[0] = first ? seed : cq[-H];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    if (u < n) {
      dh[u] = dhq[u * H];
      cc[u + 1] = cq[u * H];
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kTrainThreads, kBwdBlocks)
qrnn_pool_bwd_chunked_kernel(const float* __restrict__ y,
                             const float* __restrict__ c,
                             const float* __restrict__ dh,
                             const float* __restrict__ dc_last,
                             const float* __restrict__ c0,
                             float* __restrict__ dy, float* __restrict__ dc0,
                             int64_t B, int64_t T, int64_t H, int len) {
  constexpr int L = kTrainLanes, NC = kTrainChunks;
  // the chunk maps q_in -> A q_in + B (q_in: the q out of the chunk after)
  // and the carry into the segment from the one after, by parity
  __shared__ float sa[2][NC][L], sb[2][NC][L], carry[2][L];
  const int l = threadIdx.x % L, k = threadIdx.x / L;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * L + l;
  const bool live = lane < B * H;
  const int64_t bi = live ? lane / H : 0;
  const int64_t j = live ? lane - bi * H : 0;
  const float* yp = y + bi * T * 3 * H + j;
  const float* cp = c + bi * T * H + j;
  const float* dhp = dh + bi * T * H + j;
  float* dyp = dy + bi * T * 3 * H + j;
  const float seed = (live && c0 != nullptr) ? c0[lane] : 0.0f;
  if (k == 0) {
    carry[0][l] = (live && dc_last != nullptr) ? dc_last[lane] : 0.0f;
  }
  const int64_t seg = static_cast<int64_t>(NC) * len;
  const int64_t last = (T - 1) / seg * seg;   // the last segment's s0
  float rz[C], rf[C], ro[C], rdh[C], rc[C + 1];
  auto load = [&](int64_t s0) {
    const int64_t t0 = s0 + static_cast<int64_t>(k) * len;
    train_load_bwd_<C>(yp + t0 * 3 * H, dhp + t0 * H, cp + t0 * H,
                       chunk_steps(live, T, t0, len), t0 == 0, seed, H, rz,
                       rf, ro, rdh, rc);
  };
  if (kPrefetch) load(last);
  int p = 0;
  for (int64_t s0 = last; s0 >= 0; s0 -= seg, p ^= 1) {
    const int64_t t0 = s0 + static_cast<int64_t>(k) * len;
    const int n = chunk_steps(live, T, t0, len);
    if (!kPrefetch) load(s0);
    float a[C], ds[C], kz[C], kf[C], o[C], cc[C + 1];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      a[u] = rf[u];
      kz[u] = rz[u];
      o[u] = ro[u];
      ds[u] = rdh[u];
    }
#pragma unroll
    for (int u = 0; u <= C; ++u) cc[u] = rc[u];
    if (kPrefetch && s0 > 0) load(s0 - seg);   // in flight until then
    // (1) the gates, dy_o, the factors of dy_z and dy_f, and the chunk's
    // map from q_in = 0, walking t down as the serial step
    float ma = 1.0f, g = 0.0f, a_next = 1.0f;
#pragma unroll
    for (int u = C - 1; u >= 0; --u) {
      if (u < n) {
        const float z = tanhf(kz[u]);
        const float f = sigmoidf_(a[u]);
        const float s = sigmoidf_(o[u]);
        const float d = ds[u];
        a[u] = 1.0f - f;
        dyp[(t0 + u) * 3 * H + 2 * H] = d * cc[u + 1] * s * (1.0f - s);
        ds[u] = d * s;
        kz[u] = f * (1.0f - z * z);
        kf[u] = (z - cc[u]) * f * a[u];
        g = fmaf(a_next, g, ds[u]);
        a_next = a[u];
        ma *= a[u];
      }
    }
    sa[p][k][l] = ma;
    sb[p][k][l] = a_next * g;
    __syncthreads();
    // (2) the segment's carry through the maps of the chunks after this one
    float q = carry[p][l];
    for (int m = NC - 1; m > k; --m) q = fmaf(sa[p][m][l], q, sb[p][m][l]);
    // (3) the chunk from its carry, as the serial step: g_t = dh_t s_t +
    // a_{t+1} g_{t+1}, with a_{t+1} g_{t+1} = q at the chunk's last step
    g = q;
    a_next = 1.0f;
#pragma unroll
    for (int u = C - 1; u >= 0; --u) {
      if (u < n) {
        g = fmaf(a_next, g, ds[u]);
        float* dq = dyp + (t0 + u) * 3 * H;
        dq[0] = g * kz[u];
        dq[H] = g * kf[u];
        a_next = a[u];
      }
    }
    q = a_next * g;                      // q at t0
    if (k == 0) {
      carry[p ^ 1][l] = q;               // into the segment before
      if (s0 == 0 && live && dc0 != nullptr) dc0[lane] = q;
    }
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
  qrnn_pool_fwd_kernel<<<blocks_for(B, H), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(c0),
      static_cast<float*>(h), static_cast<float*>(c_last), B, T, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qrnn_pool_fwd_seg(const void* y, const void* c0, void* h,
                                 void* c_last, long long B, long long T,
                                 long long H, void* stream) {
  qrnn_pool_fwd_seg_kernel<kSegLanes, kSegSteps, kSegThreads>
      <<<static_cast<unsigned int>((B * H + kSegLanes - 1) / kSegLanes),
         kSegThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(y), static_cast<const float*>(c0),
          static_cast<float*>(h), static_cast<float*>(c_last), B, T, H);
  return static_cast<int>(cudaGetLastError());
}

// The segment length of qrnn_pool_fwd_seg's kernel (tests cut T around it).
extern "C" int qrnn_pool_fwd_segment_steps() { return kSegSteps; }

namespace {

// qrnn_pool_fwd_few's kernel at one tile on `stream`.
template <int LW, int NW, int C, int MB>
int few_launch(const void* y, const void* c0, void* h, void* c_last,
               long long B, long long T, long long H, void* stream) {
  qrnn_pool_fwd_few_kernel<LW, NW, C, kFewDepth, MB>
      <<<static_cast<unsigned int>((B * H + LW - 1) / LW), 32 * NW, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(y), static_cast<const float*>(c0),
          static_cast<float*>(h), static_cast<float*>(c_last), B, T, H,
          chunk_len(T, 32 / LW * NW, C));
  return static_cast<int>(cudaGetLastError());
}

// {lanes a block, chunks a warp, warps a block, steps a chunk} of
// qrnn_pool_fwd_few's tile for a call on `lanes` lanes of T steps.
void few_tile(long long lanes, long long T, int* out) {
  const int which = lanes <= kFewNarrow ? 0 : lanes <= kFewMid ? 1 : 2;
  const int lw[3] = {kFewLanes, kFewMidLanes, kFewWideLanes};
  const int nw[3] = {kFewWarps, kFewMidWarps, kFewWideWarps};
  const int c[3] = {kFewChunk, kFewMidChunk, kFewWideChunk};
  out[0] = lw[which];
  out[1] = 32 / out[0];
  out[2] = nw[which];
  out[3] = chunk_len(T, out[1] * out[2], c[which]);
}

// {registers a thread, local (spill) bytes a thread, blocks an SM} of one
// tile's kernel as built into out.
template <int LW, int NW, int C, int MB>
cudaError_t few_attrs(int* out) {
  const auto kernel = qrnn_pool_fwd_few_kernel<LW, NW, C, kFewDepth, MB>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                       32 * NW, 0);
}

}  // namespace

// qrnn_pool_fwd_few's kernel, the unseeded forward outside the eval and
// split routes, at one of its tiles by lanes (kFew*, header): on at most
// kFewNarrow lanes the narrow one (B = 1 at H = 512: blocks of 4 lanes, so
// 128 blocks), on at most kFewMid the mid one (B = 2: blocks of 8, a
// 32-byte sector a step, longer chunks), on more the wide one (blocks of
// 8 at 2 an SM).
extern "C" int qrnn_pool_fwd_few(const void* y, const void* c0, void* h,
                                 void* c_last, long long B, long long T,
                                 long long H, void* stream) {
  if (B * H <= kFewNarrow) {
    return few_launch<kFewLanes, kFewWarps, kFewChunk, kFewBlocks>(
        y, c0, h, c_last, B, T, H, stream);
  }
  if (B * H <= kFewMid) {
    return few_launch<kFewMidLanes, kFewMidWarps, kFewMidChunk,
                      kFewMidBlocks>(y, c0, h, c_last, B, T, H, stream);
  }
  return few_launch<kFewWideLanes, kFewWideWarps, kFewWideChunk,
                    kFewWideBlocks>(y, c0, h, c_last, B, T, H, stream);
}

// qrnn_pool_fwd_few's tile for a call on `lanes` lanes of T steps:
// {lanes a block, chunks a warp, warps a block, steps a chunk} into out
// (tests repeat it in the plain version).
extern "C" int qrnn_pool_few_chunking(long long lanes, long long T,
                                      int* out) {
  few_tile(lanes, T, out);
  return 0;
}

// qrnn_pool_fwd_few's kernels as built: {registers a thread, local (spill)
// bytes a thread, blocks an SM at its block size} of the narrow tile, then
// of the mid and the wide ones, into out.
extern "C" int qrnn_pool_few_attrs(int* out) {
  cudaError_t e = few_attrs<kFewLanes, kFewWarps, kFewChunk, kFewBlocks>(out);
  if (e == cudaSuccess) {
    e = few_attrs<kFewMidLanes, kFewMidWarps, kFewMidChunk, kFewMidBlocks>(
        out + 3);
  }
  if (e == cudaSuccess) {
    e = few_attrs<kFewWideLanes, kFewWideWarps, kFewWideChunk,
                  kFewWideBlocks>(out + 6);
  }
  return static_cast<int>(e);
}

// The streaming floor (qrnn_pool_stream_floor_kernel) on `stream`: h [B,
// T, H] from y [B, T, 3H]; cudaErrorInvalidValue unless H % 4 == 0.
extern "C" int qrnn_pool_stream_floor(const void* y, void* h, long long B,
                                      long long T, long long H,
                                      void* stream) {
  if (H % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = B * T * H / 4;
  qrnn_pool_stream_floor_kernel<<<static_cast<unsigned int>(
                                      (quads + 255) / 256),
                                  256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(y), static_cast<float4*>(h), quads, H / 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qrnn_pool_fwd_train(const void* y, const void* c0, void* h,
                                   void* c_all, void* c_last, long long B,
                                   long long T, long long H, void* stream) {
  qrnn_pool_fwd_train_kernel<kFwdChunk>
      <<<static_cast<unsigned int>((B * H + kTrainLanes - 1) / kTrainLanes),
         kTrainThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(y), static_cast<const float*>(c0),
          static_cast<float*>(h), static_cast<float*>(c_all),
          static_cast<float*>(c_last), B, T, H, train_len(T, kFwdChunk));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qrnn_pool_fwd_eval(const void* y, const void* c0, void* h,
                                  void* c_last, long long B, long long T,
                                  long long H, void* stream) {
  qrnn_pool_fwd_eval_kernel<kEvalChunk>
      <<<static_cast<unsigned int>((B * H + kEvalLanes - 1) / kEvalLanes),
         kEvalThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(y), static_cast<const float*>(c0),
          static_cast<float*>(h), static_cast<float*>(c_last), B, T, H,
          chunk_len(T, kEvalChunks, kEvalChunk));
  return static_cast<int>(cudaGetLastError());
}

// ctrl and maps: the kernel's scratch (above); tiles: the tiling's tile
// count, as qrnn_pool_split_tiling gives it (cudaErrorInvalidValue if
// not), which ctrl (2 + tiles ints, 0 before a stream's first call) and
// maps (3 x kEvalLanes x tiles floats) must hold.
extern "C" int qrnn_pool_fwd_split(const void* y, const void* c0, void* h,
                                   void* c_last, void* ctrl, void* maps,
                                   long long tiles, long long B, long long T,
                                   long long H, void* stream) {
  const SplitTiling s = split_tiling(B * H, T);
  if (s.lane_tiles * s.time_tiles != tiles || tiles > 0x3fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  qrnn_pool_fwd_split_kernel<kEvalChunk, kSplitSegs>
      <<<static_cast<unsigned int>(tiles),
         kEvalThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(y), static_cast<const float*>(c0),
          static_cast<float*>(h), static_cast<float*>(c_last),
          static_cast<int*>(ctrl), static_cast<float*>(maps), B, T, H,
          s.segs, s.chunk, static_cast<int>(s.lane_tiles),
          static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

// qrnn_pool_fwd_split's tiling of a call on `lanes` lanes of T steps:
// {steps a chunk, steps a time tile, tiles} into out (the wrapper sizes its
// scratch by it; tests repeat it in the plain version).
extern "C" int qrnn_pool_split_tiling(long long lanes, long long T,
                                      long long* out) {
  const SplitTiling s = split_tiling(lanes, T);
  out[0] = s.chunk;
  out[1] = s.tile;
  out[2] = s.lane_tiles * s.time_tiles;
  return 0;
}

// One empty kernel on `stream`: the launch floor the smoke run times
// beside the launch-bound shapes.
extern "C" int qrnn_pool_empty(void* stream) {
  qrnn_pool_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qrnn_pool_bwd(const void* y, const void* c, const void* dh,
                             const void* dc_last, const void* c0, void* dy,
                             void* dc0, long long B, long long T, long long H,
                             void* stream) {
  qrnn_pool_bwd_chunked_kernel<kBwdChunk>
      <<<static_cast<unsigned int>((B * H + kTrainLanes - 1) / kTrainLanes),
         kTrainThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(y), static_cast<const float*>(c),
          static_cast<const float*>(dh), static_cast<const float*>(dc_last),
          static_cast<const float*>(c0), static_cast<float*>(dy),
          static_cast<float*>(dc0), B, T, H, train_len(T, kBwdChunk));
  return static_cast<int>(cudaGetLastError());
}

// The training pair's chunking for T: {chunks a segment, steps a chunk
// forward, steps a chunk backward} into out (tests repeat it in the plain
// versions).
extern "C" int qrnn_pool_train_chunking(long long T, int* out) {
  out[0] = kTrainChunks;
  out[1] = train_len(T, kFwdChunk);
  out[2] = train_len(T, kBwdChunk);
  return 0;
}

// qrnn_pool_fwd_eval's chunking for T: {chunks a segment, steps a chunk}
// into out (tests repeat it in the chunked plain version).
extern "C" int qrnn_pool_eval_chunking(long long T, int* out) {
  out[0] = kEvalChunks;
  out[1] = chunk_len(T, kEvalChunks, kEvalChunk);
  return 0;
}
