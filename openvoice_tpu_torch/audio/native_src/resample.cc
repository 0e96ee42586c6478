// Kaiser-windowed polyphase resampler (the librosa/soxr role on the serving
// host — SURVEY.md §2.4).  Matches scipy.signal.resample_poly semantics:
// upsample by L (zero-stuff), FIR low-pass at min(pi/L, pi/M) with a
// Kaiser(beta≈8.555 for 60 dB... we use the scipy default construction:
// 2*10*max(L,M)+1 taps, beta from 60 dB attenuation), downsample by M,
// compensating the group delay so output[k] ≈ x(k*M/L).

#include "ovt_audio.h"

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

double bessel_i0(double x) {
  // series expansion, converges fast for |x| < ~20
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; k++) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

std::vector<double> design_filter(int up, int down) {
  // scipy resample_poly: 2 * 10 * max(up, down) half-taps, kaiser beta for
  // 60 dB stopband (beta ≈ 5.653 for A=60: beta = 0.1102*(A-8.7))
  int max_rate = up > down ? up : down;
  double f_c = 1.0 / (2.0 * max_rate);  // normalized (fs=1) cutoff
  int half = 10 * max_rate;
  int n_taps = 2 * half + 1;
  double beta = 0.1102 * (60.0 - 8.7);
  double denom = bessel_i0(beta);
  std::vector<double> h(n_taps);
  for (int i = 0; i < n_taps; i++) {
    double t = i - half;
    double sinc = (t == 0) ? 2 * f_c : std::sin(2 * M_PI * f_c * t) / (M_PI * t);
    double r = t / half;
    double win = bessel_i0(beta * std::sqrt(1.0 - r * r)) / denom;
    h[i] = sinc * win * up;
  }
  return h;
}

}  // namespace

extern "C" int64_t ovt_resample(const float* in, int64_t n, int sr_in, int sr_out,
                                float** out) {
  if (sr_in == sr_out) {
    float* r = static_cast<float*>(std::malloc(n * sizeof(float)));
    if (!r) return -4;
    std::memcpy(r, in, n * sizeof(float));
    *out = r;
    return n;
  }
  int g = std::gcd(sr_in, sr_out);
  int up = sr_out / g, down = sr_in / g;
  std::vector<double> h = design_filter(up, down);
  int64_t half = (int64_t(h.size()) - 1) / 2;

  int64_t n_out = (n * up + down - 1) / down;
  float* r = static_cast<float*>(std::malloc(n_out * sizeof(float)));
  if (!r) return -4;

  // polyphase: output k taps the virtual upsampled stream at position k*down;
  // y[k] = sum_j h[k*down - j*up + half] * x[j]
  for (int64_t k = 0; k < n_out; k++) {
    int64_t center = k * down;  // position in upsampled stream
    // j range where |center - j*up| <= half
    int64_t j_lo = (center - half + up - 1) / up;
    if (center < half) j_lo = (center - half) / up - 1;  // handle negatives
    int64_t j_hi = (center + half) / up;
    if (j_lo < 0) j_lo = 0;
    if (j_hi >= n) j_hi = n - 1;
    double acc = 0.0;
    for (int64_t j = j_lo; j <= j_hi; j++) {
      int64_t tap = center - j * up + half;
      if (tap >= 0 && tap < int64_t(h.size())) acc += h[tap] * in[j];
    }
    r[k] = float(acc);
  }
  *out = r;
  return n_out;
}
