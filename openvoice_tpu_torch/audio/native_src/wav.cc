// RIFF/WAVE codec (PCM 8/16/24/32 + IEEE float), mirror of the Python
// implementation in openvoice_tpu/audio/io.py.

#include "ovt_audio.h"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr uint16_t kPcm = 0x0001;
constexpr uint16_t kFloat = 0x0003;
constexpr uint16_t kExtensible = 0xFFFE;

uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }

}  // namespace

extern "C" int64_t ovt_wav_read(const char* path, float** out, int* sample_rate,
                                int* channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(size);
  if (std::fread(data.data(), 1, size, f) != size_t(size)) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  if (size < 12 || std::memcmp(data.data(), "RIFF", 4) != 0 ||
      std::memcmp(data.data() + 8, "WAVE", 4) != 0)
    return -2;

  uint16_t fmt = 0, n_ch = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* payload = nullptr;
  size_t payload_len = 0;
  const uint8_t* fmt_body = nullptr;
  size_t fmt_len = 0;

  size_t pos = 12;
  while (pos + 8 <= size_t(size)) {
    const uint8_t* cid = data.data() + pos;
    uint32_t csz = rd32(data.data() + pos + 4);
    const uint8_t* body = data.data() + pos + 8;
    if (pos + 8 + csz > size_t(size)) csz = size - pos - 8;
    if (std::memcmp(cid, "fmt ", 4) == 0 && csz >= 16) {
      fmt = rd16(body);
      n_ch = rd16(body + 2);
      sr = rd32(body + 4);
      bits = rd16(body + 14);
      fmt_body = body;
      fmt_len = csz;
    } else if (std::memcmp(cid, "data", 4) == 0) {
      payload = body;
      payload_len = csz;
    }
    pos += 8 + csz + (csz & 1);
  }
  if (!payload || !fmt_body || n_ch == 0) return -2;
  if (fmt == kExtensible && fmt_len >= 26) fmt = rd16(fmt_body + 24);

  int64_t n_samples;
  std::vector<float> buf;
  if (fmt == kFloat && bits == 32) {
    n_samples = payload_len / 4;
    buf.resize(n_samples);
    std::memcpy(buf.data(), payload, n_samples * 4);
  } else if (fmt == kFloat && bits == 64) {
    n_samples = payload_len / 8;
    buf.resize(n_samples);
    for (int64_t i = 0; i < n_samples; i++) {
      double v;
      std::memcpy(&v, payload + i * 8, 8);
      buf[i] = float(v);
    }
  } else if (fmt == kPcm && bits == 16) {
    n_samples = payload_len / 2;
    buf.resize(n_samples);
    for (int64_t i = 0; i < n_samples; i++) {
      int16_t v = int16_t(rd16(payload + i * 2));
      buf[i] = float(v) / 32768.0f;
    }
  } else if (fmt == kPcm && bits == 32) {
    n_samples = payload_len / 4;
    buf.resize(n_samples);
    for (int64_t i = 0; i < n_samples; i++) {
      int32_t v = int32_t(rd32(payload + i * 4));
      buf[i] = float(v) / 2147483648.0f;
    }
  } else if (fmt == kPcm && bits == 24) {
    n_samples = payload_len / 3;
    buf.resize(n_samples);
    for (int64_t i = 0; i < n_samples; i++) {
      const uint8_t* p = payload + i * 3;
      int32_t v = p[0] | (p[1] << 8) | (p[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      buf[i] = float(v) / 8388608.0f;
    }
  } else if (fmt == kPcm && bits == 8) {
    n_samples = payload_len;
    buf.resize(n_samples);
    for (int64_t i = 0; i < n_samples; i++)
      buf[i] = (float(payload[i]) - 128.0f) / 128.0f;
  } else {
    return -3;
  }

  int64_t frames = n_samples / n_ch;
  float* result = static_cast<float*>(std::malloc(frames * n_ch * sizeof(float)));
  if (!result) return -4;
  std::memcpy(result, buf.data(), frames * n_ch * sizeof(float));
  *out = result;
  *sample_rate = int(sr);
  *channels = n_ch;
  return frames;
}

extern "C" int64_t ovt_wav_write(const char* path, const float* data, int64_t frames,
                                 int sample_rate, int channels) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int64_t n = frames * channels;
  uint32_t payload_len = uint32_t(n * 2);
  uint32_t byte_rate = sample_rate * channels * 2;
  uint16_t block_align = channels * 2;

  uint8_t hdr[44];
  std::memcpy(hdr, "RIFF", 4);
  uint32_t riff_len = 36 + payload_len;
  std::memcpy(hdr + 4, &riff_len, 4);
  std::memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_len = 16;
  std::memcpy(hdr + 16, &fmt_len, 4);
  uint16_t fmt = kPcm;
  uint16_t ch = uint16_t(channels);
  std::memcpy(hdr + 20, &fmt, 2);
  std::memcpy(hdr + 22, &ch, 2);
  uint32_t sr = uint32_t(sample_rate);
  std::memcpy(hdr + 24, &sr, 4);
  std::memcpy(hdr + 28, &byte_rate, 4);
  std::memcpy(hdr + 32, &block_align, 2);
  uint16_t bits = 16;
  std::memcpy(hdr + 34, &bits, 2);
  std::memcpy(hdr + 36, "data", 4);
  std::memcpy(hdr + 40, &payload_len, 4);
  std::fwrite(hdr, 1, 44, f);

  std::vector<int16_t> pcm(n);
  for (int64_t i = 0; i < n; i++) {
    float v = data[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    float scaled = v * 32767.0f;
    pcm[i] = int16_t(scaled >= 0 ? scaled + 0.5f : scaled - 0.5f);
  }
  std::fwrite(pcm.data(), 2, n, f);
  std::fclose(f);
  return 0;
}
