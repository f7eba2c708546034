// codec2-style low-bitrate vocoder round trip (encode+decode fused): the
// port's own copy of the JAX package's native/codec2_lite.cc. Only these
// comments differ; the code is the same, so both packages' round trips
// agree sample for sample when built by one compiler with one set of
// flags (pase_tpu_torch/ops/host_build.py builds it with
// native/Makefile's).
//
// The reference's Codec2Buffer distortion (pase/transforms.py:2131-2325)
// compresses the chunk through the external codec2 library at 8 kHz and
// returns the degraded waveform. That library is not a dependency of
// this package, so this is a dependency-free WORKALIKE of the same codec
// family — codec2 is an LPC vocoder (sinusoidal/LPC-10 analysis, coarse
// quantization of the spectral envelope, pitch and energy, parametric
// resynthesis) — not a bit-compatible reimplementation. It reproduces
// the distortion CLASS: band-limited, spectral-envelope-quantized,
// pitch-synchronous "robotic" resynthesis whose coarseness scales with
// the mode's bit budget. pycodec2 / c2enc are still preferred when
// installed (pase_tpu_torch/data/host_distortions.py backend order).
//
// Analysis @ 8 kHz, 20 ms frames (codec2's 3200/2400 frame size; the
// 1600/1300 modes pack two such frames per packet):
//   * order-10 LPC (Hamming window, autocorrelation + Levinson-Durbin)
//   * envelope quantized as log-area ratios, bits/coefficient by mode
//   * pitch by normalized autocorrelation (50..400 Hz) + voicing flag
//   * log-energy quantized to 5 bits
// Synthesis: impulse train (voiced, phase-continuous) or white noise
// (unvoiced) through the quantized LPC synthesis filter, per-frame
// energy matched to the quantized analysis energy.
//
// C ABI (ctypes):
//   long codec2lite_roundtrip(const float* in, long n, float* out,
//                             int kbps);   // 8 kHz mono in [-1, 1]
//       returns n on success, -1 on bad args.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

constexpr int kFrame = 160;     // 20 ms @ 8 kHz
constexpr int kOrder = 10;
constexpr int kPitchMin = 20;   // 400 Hz
constexpr int kPitchMax = 160;  // 50 Hz

// bits per log-area-ratio coefficient by mode: coarser at lower rates
int lar_bits(int kbps) {
  if (kbps >= 3200) return 6;
  if (kbps >= 2400) return 5;
  if (kbps >= 1600) return 4;
  return 3;                     // 1300 / 1200 / 700
}

double quantize_uniform(double x, double lo, double hi, int bits) {
  const int levels = (1 << bits) - 1;
  double t = (x - lo) / (hi - lo);
  t = t < 0 ? 0 : (t > 1 ? 1 : t);
  return lo + (hi - lo) * (std::round(t * levels) / levels);
}

// Levinson-Durbin: autocorrelation r[0..p] -> a[1..p] (synthesis
// 1/A(z)), reflection coefficients k[1..p]. Returns prediction error.
double levinson(const double* r, int p, double* a, double* k) {
  double err = r[0];
  std::vector<double> tmp(p + 1, 0.0);
  for (int i = 1; i <= p; ++i) {
    double acc = r[i];
    for (int j = 1; j < i; ++j) acc -= a[j] * r[i - j];
    double ki = (err > 1e-12) ? acc / err : 0.0;
    if (ki > 0.999) ki = 0.999;
    if (ki < -0.999) ki = -0.999;
    k[i] = ki;
    a[i] = ki;
    for (int j = 1; j < i; ++j) tmp[j] = a[j] - ki * a[i - j];
    for (int j = 1; j < i; ++j) a[j] = tmp[j];
    err *= (1.0 - ki * ki);
  }
  return err < 1e-12 ? 1e-12 : err;
}

}  // namespace

extern "C" long codec2lite_roundtrip(const float* in, long n, float* out,
                                     int kbps) {
  if (!in || !out || n <= 0) return -1;
  const int bits = lar_bits(kbps);
  const long frames = (n + kFrame - 1) / kFrame;

  std::vector<double> window(kFrame);
  for (int i = 0; i < kFrame; ++i)
    window[i] = 0.54 - 0.46 * std::cos(2.0 * M_PI * i / (kFrame - 1));

  std::mt19937 rng(0x9e3779b9);   // deterministic: same input, same output
  std::normal_distribution<double> gauss(0.0, 1.0);

  std::vector<double> synth_state(kOrder, 0.0);
  double pitch_phase = 0.0;
  double prev_pitch = 80.0;       // samples

  for (long fi = 0; fi < frames; ++fi) {
    const long beg = fi * kFrame;
    const int len = static_cast<int>(std::min<long>(kFrame, n - beg));
    double frame[kFrame] = {0};
    for (int i = 0; i < len; ++i) frame[i] = in[beg + i];

    // --- analysis ---------------------------------------------------------
    double wf[kFrame];
    for (int i = 0; i < kFrame; ++i) wf[i] = frame[i] * window[i];
    double r[kOrder + 1] = {0};
    for (int lag = 0; lag <= kOrder; ++lag)
      for (int i = lag; i < kFrame; ++i) r[lag] += wf[i] * wf[i - lag];
    r[0] *= 1.0001;               // white-noise correction
    double a[kOrder + 1] = {0}, k[kOrder + 1] = {0};
    levinson(r, kOrder, a, k);

    // quantize the envelope as log-area ratios, reconstruct LPC
    double kq[kOrder + 1] = {0};
    for (int i = 1; i <= kOrder; ++i) {
      double lar = std::log((1.0 + k[i]) / (1.0 - k[i]));
      lar = quantize_uniform(lar, -7.0, 7.0, bits);
      double e = std::exp(lar);
      kq[i] = (e - 1.0) / (e + 1.0);
    }
    double aq[kOrder + 1] = {0};
    {  // reflection -> direct form
      double tmp[kOrder + 1];
      for (int i = 1; i <= kOrder; ++i) {
        aq[i] = kq[i];
        for (int j = 1; j < i; ++j) tmp[j] = aq[j] - kq[i] * aq[i - j];
        for (int j = 1; j < i; ++j) aq[j] = tmp[j];
      }
    }

    // pitch + voicing from normalized autocorrelation of the raw frame
    double e0 = 1e-12;
    for (int i = 0; i < kFrame; ++i) e0 += frame[i] * frame[i];
    int best_lag = kPitchMin;
    double best = 0.0;
    for (int lag = kPitchMin; lag <= kPitchMax && lag < kFrame; ++lag) {
      double acc = 0.0, el = 1e-12;
      for (int i = lag; i < kFrame; ++i) {
        acc += frame[i] * frame[i - lag];
        el += frame[i - lag] * frame[i - lag];
      }
      double score = acc / std::sqrt(e0 * el);
      if (score > best) { best = score; best_lag = lag; }
    }
    const bool voiced = best > 0.4;
    // 7-bit log pitch (codec2 quantizes Wo on a log grid)
    double pitch = quantize_uniform(std::log(static_cast<double>(best_lag)),
                                    std::log(double(kPitchMin)),
                                    std::log(double(kPitchMax)), 7);
    pitch = std::exp(pitch);

    // 5-bit log energy
    double rms = std::sqrt(e0 / kFrame);
    double loge = quantize_uniform(std::log10(rms + 1e-10), -6.0, 0.5, 5);
    double rms_q = std::pow(10.0, loge);

    // --- synthesis --------------------------------------------------------
    double exc[kFrame];
    if (voiced) {
      // phase-continuous impulse train + a small noise floor (mixed
      // excitation keeps fricative energy from vanishing entirely)
      for (int i = 0; i < kFrame; ++i) {
        pitch_phase += 1.0;
        double pulse = 0.0;
        if (pitch_phase >= pitch) {
          pitch_phase -= pitch;
          pulse = std::sqrt(pitch);  // unit-power impulse train
        }
        exc[i] = pulse + 0.25 * gauss(rng);
      }
      prev_pitch = pitch;
    } else {
      for (int i = 0; i < kFrame; ++i) exc[i] = gauss(rng);
      pitch_phase = prev_pitch;    // restart cleanly at next voiced frame
    }
    double syn[kFrame];
    for (int i = 0; i < kFrame; ++i) {
      double s = exc[i];
      for (int j = 1; j <= kOrder; ++j) {
        double prev = (i - j >= 0) ? syn[i - j] : synth_state[kOrder + i - j];
        s += aq[j] * prev;
      }
      syn[i] = s;
    }
    for (int j = 0; j < kOrder; ++j)
      synth_state[j] = syn[kFrame - kOrder + j];

    // per-frame energy match to the quantized analysis energy
    double es = 1e-12;
    for (int i = 0; i < kFrame; ++i) es += syn[i] * syn[i];
    double g = rms_q / std::sqrt(es / kFrame);
    for (int i = 0; i < len; ++i) {
      double v = syn[i] * g;
      out[beg + i] = static_cast<float>(v < -1.0 ? -1.0
                                        : (v > 1.0 ? 1.0 : v));
    }
  }
  return n;
}
