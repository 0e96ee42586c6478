// Energy VAD — native mirror of openvoice_tpu/pipeline/se_extractor.py's
// energy_vad (adaptive threshold, min-speech / min-silence hangover).

#include "ovt_audio.h"

#include <algorithm>
#include <cmath>
#include <vector>

extern "C" int64_t ovt_energy_vad(const float* audio, int64_t n, int sample_rate,
                                  float frame_ms, float min_speech_s,
                                  float min_silence_s, float threshold_db,
                                  int64_t* segments, int64_t max_segments) {
  int64_t frame = std::max<int64_t>(1, int64_t(sample_rate * frame_ms / 1000.0f));
  int64_t n_frames = n / frame;
  if (n_frames == 0) return 0;

  std::vector<float> db(n_frames);
  for (int64_t i = 0; i < n_frames; i++) {
    double acc = 0;
    const float* p = audio + i * frame;
    for (int64_t j = 0; j < frame; j++) acc += double(p[j]) * p[j];
    float rms = std::sqrt(float(acc / frame) + 1e-12f);
    db[i] = 20.0f * std::log10(rms + 1e-12f);
  }
  float peak = *std::max_element(db.begin(), db.end());
  std::vector<float> sorted_db(db);
  std::sort(sorted_db.begin(), sorted_db.end());
  float floor_db = sorted_db[size_t(0.10 * (n_frames - 1))];
  float thresh = std::max(floor_db + 10.0f, peak + threshold_db);

  int64_t min_speech_f = std::max<int64_t>(1, int64_t(min_speech_s * 1000 / frame_ms));
  int64_t min_sil_f = std::max<int64_t>(1, int64_t(min_silence_s * 1000 / frame_ms));

  int64_t count = 0;
  int64_t start = -1, gap = 0;
  for (int64_t i = 0; i < n_frames; i++) {
    bool speech = db[i] > thresh;
    if (speech) {
      if (start < 0) start = i;
      gap = 0;
    } else if (start >= 0) {
      gap++;
      if (gap >= min_sil_f) {
        int64_t end = i - gap + 1;
        if (end - start >= min_speech_f && count < max_segments) {
          segments[2 * count] = start * frame;
          segments[2 * count + 1] = end * frame;
          count++;
        }
        start = -1;
        gap = 0;
      }
    }
  }
  if (start >= 0) {
    int64_t end = n_frames;
    if (end - start >= min_speech_f && count < max_segments) {
      segments[2 * count] = start * frame;
      segments[2 * count + 1] = std::min(end * frame, n);
      count++;
    }
  }
  return count;
}
