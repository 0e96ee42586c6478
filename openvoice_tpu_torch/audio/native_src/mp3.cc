// MP3 decode + encode for the native audio runtime (the pydub/ffmpeg role
// for the bundled demo .mp3 resources — SURVEY.md §2.4).
//
// Decoding engine: the system's libmpg123; encoding engine: the system's
// libmp3lame (both present in this image, loaded via dlopen with
// self-declared prototypes — the same "native codec dependency" position the
// reference takes with ffmpeg, but wrapped behind our C ABI and with a clean
// -3 error when the library is absent).  Frame-header parsing stays in-repo
// for validation/metadata.  The encoder exists chiefly so lossy-re-encode
// robustness (watermark survival, SE-extraction stability) is MEASURABLE
// in-repo with a real codec instead of a simulated one.

#include "ovt_audio.h"

#include <dlfcn.h>

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// --- libmpg123 API surface (stable C ABI) -----------------------------------
using mpg123_handle = void;

struct Mpg123 {
  int (*init)();
  mpg123_handle* (*make)(const char*, int*);
  int (*open)(mpg123_handle*, const char*);
  int (*getformat)(mpg123_handle*, long*, int*, int*);
  int (*format_none)(mpg123_handle*);
  int (*format)(mpg123_handle*, long, int, int);
  int (*read)(mpg123_handle*, unsigned char*, size_t, size_t*);
  int (*close)(mpg123_handle*);
  void (*del)(mpg123_handle*);
  bool ok = false;
};

constexpr int kMpg123Ok = 0;
constexpr int kMpg123Done = -12;
constexpr int kMpg123NewFormat = -11;
constexpr int kEncFloat32 = 0x200;
constexpr int kEncSigned16 = 0x0D0;

Mpg123 load_mpg123() {
  Mpg123 m{};
  void* h = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_GLOBAL);
  if (!h) h = dlopen("libmpg123.so", RTLD_NOW | RTLD_GLOBAL);
  if (!h) return m;
  m.init = reinterpret_cast<decltype(m.init)>(dlsym(h, "mpg123_init"));
  m.make = reinterpret_cast<decltype(m.make)>(dlsym(h, "mpg123_new"));
  m.open = reinterpret_cast<decltype(m.open)>(dlsym(h, "mpg123_open"));
  m.getformat = reinterpret_cast<decltype(m.getformat)>(dlsym(h, "mpg123_getformat"));
  m.format_none = reinterpret_cast<decltype(m.format_none)>(dlsym(h, "mpg123_format_none"));
  m.format = reinterpret_cast<decltype(m.format)>(dlsym(h, "mpg123_format"));
  m.read = reinterpret_cast<decltype(m.read)>(dlsym(h, "mpg123_read"));
  m.close = reinterpret_cast<decltype(m.close)>(dlsym(h, "mpg123_close"));
  m.del = reinterpret_cast<decltype(m.del)>(dlsym(h, "mpg123_delete"));
  m.ok = m.init && m.make && m.open && m.getformat && m.format_none && m.format &&
         m.read && m.close && m.del;
  if (m.ok) m.init();
  return m;
}

Mpg123& engine() {
  static Mpg123 m = load_mpg123();
  return m;
}

// --- libmp3lame API surface (stable C ABI) ----------------------------------
using lame_t = void*;

struct Lame {
  lame_t (*init)();
  int (*set_in_samplerate)(lame_t, int);
  int (*set_out_samplerate)(lame_t, int);
  int (*set_num_channels)(lame_t, int);
  int (*set_mode)(lame_t, int);  // 3 = MONO, 1 = JOINT_STEREO
  int (*set_brate)(lame_t, int);
  int (*set_quality)(lame_t, int);
  int (*init_params)(lame_t);
  int (*encode_float)(lame_t, const float*, const float*, int, unsigned char*, int);
  int (*flush)(lame_t, unsigned char*, int);
  int (*close)(lame_t);
  bool ok = false;
};

Lame load_lame() {
  Lame l{};
  void* h = dlopen("libmp3lame.so.0", RTLD_NOW | RTLD_GLOBAL);
  if (!h) h = dlopen("libmp3lame.so", RTLD_NOW | RTLD_GLOBAL);
  if (!h) return l;
  l.init = reinterpret_cast<decltype(l.init)>(dlsym(h, "lame_init"));
  l.set_in_samplerate =
      reinterpret_cast<decltype(l.set_in_samplerate)>(dlsym(h, "lame_set_in_samplerate"));
  l.set_out_samplerate =
      reinterpret_cast<decltype(l.set_out_samplerate)>(dlsym(h, "lame_set_out_samplerate"));
  l.set_num_channels =
      reinterpret_cast<decltype(l.set_num_channels)>(dlsym(h, "lame_set_num_channels"));
  l.set_mode = reinterpret_cast<decltype(l.set_mode)>(dlsym(h, "lame_set_mode"));
  l.set_brate = reinterpret_cast<decltype(l.set_brate)>(dlsym(h, "lame_set_brate"));
  l.set_quality = reinterpret_cast<decltype(l.set_quality)>(dlsym(h, "lame_set_quality"));
  l.init_params = reinterpret_cast<decltype(l.init_params)>(dlsym(h, "lame_init_params"));
  l.encode_float = reinterpret_cast<decltype(l.encode_float)>(
      dlsym(h, "lame_encode_buffer_ieee_float"));
  l.flush = reinterpret_cast<decltype(l.flush)>(dlsym(h, "lame_encode_flush"));
  l.close = reinterpret_cast<decltype(l.close)>(dlsym(h, "lame_close"));
  l.ok = l.init && l.set_in_samplerate && l.set_out_samplerate && l.set_num_channels &&
         l.set_mode && l.set_brate && l.set_quality && l.init_params && l.encode_float &&
         l.flush && l.close;
  return l;
}

Lame& lame_engine() {
  static Lame l = load_lame();
  return l;
}

}  // namespace

extern "C" int64_t ovt_mp3_decode(const char* path, float** out, int* sample_rate,
                                  int* channels) {
  Mpg123& m = engine();
  if (!m.ok) return -3;  // engine unavailable

  int err = 0;
  mpg123_handle* h = m.make(nullptr, &err);
  if (!h) return -3;

  // accept only float32 output at every MPEG rate, BEFORE open — format
  // changes after open only apply at the next format event
  static const long kRates[] = {8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000};
  constexpr int kMonoStereo = 3;  // MPG123_MONO | MPG123_STEREO
  m.format_none(h);
  bool use_float = true;
  int enc_ok = 0;
  for (long r : kRates) enc_ok |= (m.format(h, r, kMonoStereo, kEncFloat32) == kMpg123Ok);
  if (!enc_ok) {
    use_float = false;
    m.format_none(h);
    for (long r : kRates) m.format(h, r, kMonoStereo, kEncSigned16);
  }

  if (m.open(h, path) != kMpg123Ok) {
    m.del(h);
    return -1;
  }
  long rate = 0;
  int ch = 0, enc = 0;
  if (m.getformat(h, &rate, &ch, &enc) != kMpg123Ok || rate <= 0 || ch <= 0) {
    m.close(h);
    m.del(h);
    return -2;
  }

  std::vector<float> samples;
  std::vector<unsigned char> buf(1 << 16);
  for (;;) {
    size_t done = 0;
    int rc = m.read(h, buf.data(), buf.size(), &done);
    if (done > 0) {
      if (use_float) {
        size_t n = done / sizeof(float);
        const float* p = reinterpret_cast<const float*>(buf.data());
        samples.insert(samples.end(), p, p + n);
      } else {
        size_t n = done / sizeof(int16_t);
        const int16_t* p = reinterpret_cast<const int16_t*>(buf.data());
        for (size_t i = 0; i < n; i++) samples.push_back(float(p[i]) / 32768.0f);
      }
    }
    if (rc == kMpg123Done) break;
    if (rc == kMpg123NewFormat) {
      // format changed mid-stream: refresh (rare; keep decoding)
      m.getformat(h, &rate, &ch, &enc);
      continue;
    }
    if (rc != kMpg123Ok && done == 0) break;
  }
  m.close(h);
  m.del(h);

  if (samples.empty()) return -2;
  int64_t frames = int64_t(samples.size()) / ch;
  float* result = static_cast<float*>(std::malloc(frames * ch * sizeof(float)));
  if (!result) return -4;
  std::memcpy(result, samples.data(), frames * ch * sizeof(float));
  *out = result;
  *sample_rate = int(rate);
  *channels = ch;
  return frames;
}

// Encode interleaved float32 samples ([-1, 1]) to a CBR mp3 file.
// Returns 0 on success; -1 open/write failure, -2 bad args or encode error,
// -3 libmp3lame unavailable.  kbps is the constant bitrate (e.g. 64..320).
extern "C" int ovt_mp3_encode(const char* path, const float* samples, int64_t frames,
                              int sample_rate, int channels, int kbps) {
  Lame& l = lame_engine();
  if (!l.ok) return -3;
  if (!samples || frames <= 0 || channels < 1 || channels > 2 || sample_rate <= 0 ||
      kbps <= 0)
    return -2;

  lame_t gf = l.init();
  if (!gf) return -3;
  l.set_in_samplerate(gf, sample_rate);
  l.set_out_samplerate(gf, sample_rate);  // never resample inside the codec
  l.set_num_channels(gf, channels);
  l.set_mode(gf, channels == 1 ? 3 /* MONO */ : 1 /* JOINT_STEREO */);
  l.set_brate(gf, kbps);
  l.set_quality(gf, 2);  // high-quality psychoacoustics (0 best, 9 worst)
  if (l.init_params(gf) < 0) {
    l.close(gf);
    return -2;  // e.g. unsupported rate/bitrate combination
  }

  std::FILE* f = std::fopen(path, "wb");
  if (!f) {
    l.close(gf);
    return -1;
  }

  // lame wants per-channel (non-interleaved) float buffers
  std::vector<float> left, right;
  const float* lp = samples;
  const float* rp = samples;
  if (channels == 2) {
    left.resize(frames);
    right.resize(frames);
    for (int64_t i = 0; i < frames; i++) {
      left[i] = samples[2 * i];
      right[i] = samples[2 * i + 1];
    }
    lp = left.data();
    rp = right.data();
  }

  int rc = 0;
  std::vector<unsigned char> buf;
  constexpr int64_t kBlock = 1 << 16;
  buf.resize(kBlock * 5 / 4 + 7200);
  for (int64_t pos = 0; pos < frames && rc == 0; pos += kBlock) {
    int n = int(std::min(kBlock, frames - pos));
    int written = l.encode_float(gf, lp + pos, rp + pos, n, buf.data(), int(buf.size()));
    if (written < 0) rc = -2;
    else if (written > 0 && std::fwrite(buf.data(), 1, written, f) != size_t(written))
      rc = -1;
  }
  if (rc == 0) {
    int written = l.flush(gf, buf.data(), int(buf.size()));
    if (written < 0) rc = -2;
    else if (written > 0 && std::fwrite(buf.data(), 1, written, f) != size_t(written))
      rc = -1;
  }
  l.close(gf);
  if (std::fclose(f) != 0 && rc == 0) rc = -1;
  return rc;
}
