// Ogg/Vorbis decode for the native audio runtime (the ffmpeg/audioread role
// for .ogg reference clips — SURVEY.md §2.4; the reference accepts any
// format its ffmpeg build demuxes, se_extractor.py:9).
//
// Decoding engine: the system's libvorbisfile (present in this image,
// loaded via dlopen with self-declared prototypes — the same honest
// "native codec dependency" position as mpg123/lame in mp3.cc, with a
// clean -3 when the library is absent).
//
// ABI notes: OggVorbis_File is a caller-allocated opaque struct (~944 bytes
// on x86-64); we over-allocate generously.  vorbis_info's layout starts
// {int version; int channels; long rate; ...} — only those leading fields
// are read here.

#include "ovt_audio.h"

#include <dlfcn.h>

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct VorbisInfoHead {
  int version;
  int channels;
  long rate;
};

struct VorbisFileLib {
  int (*fopen)(const char*, void*);
  VorbisInfoHead* (*info)(void*, int);
  long (*read_float)(void*, float***, int, int*);
  int (*clear)(void*);
  bool ok = false;
};

VorbisFileLib load_vorbisfile() {
  VorbisFileLib v{};
  void* h = dlopen("libvorbisfile.so.3", RTLD_NOW | RTLD_GLOBAL);
  if (!h) h = dlopen("libvorbisfile.so", RTLD_NOW | RTLD_GLOBAL);
  if (!h) return v;
  v.fopen = reinterpret_cast<decltype(v.fopen)>(dlsym(h, "ov_fopen"));
  v.info = reinterpret_cast<decltype(v.info)>(dlsym(h, "ov_info"));
  v.read_float = reinterpret_cast<decltype(v.read_float)>(dlsym(h, "ov_read_float"));
  v.clear = reinterpret_cast<decltype(v.clear)>(dlsym(h, "ov_clear"));
  v.ok = v.fopen && v.info && v.read_float && v.clear;
  return v;
}

VorbisFileLib& vorbis_engine() {
  static VorbisFileLib v = load_vorbisfile();
  return v;
}

// sizeof(OggVorbis_File) is 944 on this ABI; 4096 leaves ample margin.
constexpr size_t kOvFileSize = 4096;

// --- encoder side: libogg + libvorbis + libvorbisenc -------------------------
// ogg_packet and ogg_page have PUBLIC, stable layouts (we must read their
// fields); every other struct is caller-allocated opaque storage, passed
// by pointer and generously over-sized.

struct OggPacket {
  unsigned char* packet;
  long bytes;
  long b_o_s;
  long e_o_s;
  int64_t granulepos;
  int64_t packetno;
};

struct OggPage {
  unsigned char* header;
  long header_len;
  unsigned char* body;
  long body_len;
};

struct VorbisEncLib {
  // libvorbis
  void (*info_init)(void*);
  void (*comment_init)(void*);
  int (*analysis_init)(void*, void*);
  int (*block_init)(void*, void*);
  int (*analysis_headerout)(void*, void*, OggPacket*, OggPacket*, OggPacket*);
  float** (*analysis_buffer)(void*, int);
  int (*analysis_wrote)(void*, int);
  int (*analysis_blockout)(void*, void*);
  int (*analysis)(void*, OggPacket*);
  int (*bitrate_addblock)(void*);
  int (*bitrate_flushpacket)(void*, OggPacket*);
  int (*block_clear)(void*);
  void (*dsp_clear)(void*);
  void (*info_clear)(void*);
  void (*comment_clear)(void*);
  // libvorbisenc
  int (*encode_init_vbr)(void*, long, long, float);
  // libogg
  int (*stream_init)(void*, int);
  int (*stream_packetin)(void*, OggPacket*);
  int (*stream_pageout)(void*, OggPage*);
  int (*stream_flush)(void*, OggPage*);
  int (*stream_clear)(void*);
  bool ok = false;
};

VorbisEncLib load_vorbisenc() {
  VorbisEncLib e{};
  void* hv = dlopen("libvorbis.so.0", RTLD_NOW | RTLD_GLOBAL);
  if (!hv) hv = dlopen("libvorbis.so", RTLD_NOW | RTLD_GLOBAL);
  void* he = dlopen("libvorbisenc.so.2", RTLD_NOW | RTLD_GLOBAL);
  if (!he) he = dlopen("libvorbisenc.so", RTLD_NOW | RTLD_GLOBAL);
  void* ho = dlopen("libogg.so.0", RTLD_NOW | RTLD_GLOBAL);
  if (!ho) ho = dlopen("libogg.so", RTLD_NOW | RTLD_GLOBAL);
  if (!hv || !he || !ho) return e;
  e.info_init = reinterpret_cast<decltype(e.info_init)>(dlsym(hv, "vorbis_info_init"));
  e.comment_init = reinterpret_cast<decltype(e.comment_init)>(dlsym(hv, "vorbis_comment_init"));
  e.analysis_init = reinterpret_cast<decltype(e.analysis_init)>(dlsym(hv, "vorbis_analysis_init"));
  e.block_init = reinterpret_cast<decltype(e.block_init)>(dlsym(hv, "vorbis_block_init"));
  e.analysis_headerout = reinterpret_cast<decltype(e.analysis_headerout)>(
      dlsym(hv, "vorbis_analysis_headerout"));
  e.analysis_buffer = reinterpret_cast<decltype(e.analysis_buffer)>(
      dlsym(hv, "vorbis_analysis_buffer"));
  e.analysis_wrote = reinterpret_cast<decltype(e.analysis_wrote)>(
      dlsym(hv, "vorbis_analysis_wrote"));
  e.analysis_blockout = reinterpret_cast<decltype(e.analysis_blockout)>(
      dlsym(hv, "vorbis_analysis_blockout"));
  e.analysis = reinterpret_cast<decltype(e.analysis)>(dlsym(hv, "vorbis_analysis"));
  e.bitrate_addblock = reinterpret_cast<decltype(e.bitrate_addblock)>(
      dlsym(hv, "vorbis_bitrate_addblock"));
  e.bitrate_flushpacket = reinterpret_cast<decltype(e.bitrate_flushpacket)>(
      dlsym(hv, "vorbis_bitrate_flushpacket"));
  e.block_clear = reinterpret_cast<decltype(e.block_clear)>(dlsym(hv, "vorbis_block_clear"));
  e.dsp_clear = reinterpret_cast<decltype(e.dsp_clear)>(dlsym(hv, "vorbis_dsp_clear"));
  e.info_clear = reinterpret_cast<decltype(e.info_clear)>(dlsym(hv, "vorbis_info_clear"));
  e.comment_clear = reinterpret_cast<decltype(e.comment_clear)>(
      dlsym(hv, "vorbis_comment_clear"));
  e.encode_init_vbr = reinterpret_cast<decltype(e.encode_init_vbr)>(
      dlsym(he, "vorbis_encode_init_vbr"));
  e.stream_init = reinterpret_cast<decltype(e.stream_init)>(dlsym(ho, "ogg_stream_init"));
  e.stream_packetin = reinterpret_cast<decltype(e.stream_packetin)>(
      dlsym(ho, "ogg_stream_packetin"));
  e.stream_pageout = reinterpret_cast<decltype(e.stream_pageout)>(
      dlsym(ho, "ogg_stream_pageout"));
  e.stream_flush = reinterpret_cast<decltype(e.stream_flush)>(dlsym(ho, "ogg_stream_flush"));
  e.stream_clear = reinterpret_cast<decltype(e.stream_clear)>(dlsym(ho, "ogg_stream_clear"));
  e.ok = e.info_init && e.comment_init && e.analysis_init && e.block_init &&
         e.analysis_headerout && e.analysis_buffer && e.analysis_wrote &&
         e.analysis_blockout && e.analysis && e.bitrate_addblock &&
         e.bitrate_flushpacket && e.block_clear && e.dsp_clear && e.info_clear &&
         e.comment_clear && e.encode_init_vbr && e.stream_init && e.stream_packetin &&
         e.stream_pageout && e.stream_flush && e.stream_clear;
  return e;
}

VorbisEncLib& vorbis_enc_engine() {
  static VorbisEncLib e = load_vorbisenc();
  return e;
}

// opaque caller-allocated storage sizes (real x86-64 sizes ≤ 912 bytes each)
constexpr size_t kOpaque = 2048;

}  // namespace

extern "C" int64_t ovt_ogg_decode(const char* path, float** out, int* sample_rate,
                                  int* channels) {
  VorbisFileLib& v = vorbis_engine();
  if (!v.ok) return -3;  // engine unavailable

  std::vector<unsigned char> vf(kOvFileSize, 0);
  if (v.fopen(path, vf.data()) != 0) return -1;  // not found / not ogg-vorbis

  VorbisInfoHead* info = v.info(vf.data(), -1);
  if (!info || info->channels <= 0 || info->rate <= 0) {
    v.clear(vf.data());
    return -2;
  }
  const int ch = info->channels;
  const long rate = info->rate;

  std::vector<float> samples;  // interleaved
  int bitstream = 0;
  int consecutive_errors = 0;
  for (;;) {
    float** pcm = nullptr;
    long n = v.read_float(vf.data(), &pcm, 4096, &bitstream);
    if (n == 0) break;   // EOF
    if (n < 0) {         // OV_HOLE / OV_EBADLINK: skip corrupt section —
      // but bounded: a malformed stream returning errors forever (server
      // inputs reach this via load_audio) must fail, not hang the decode
      if (++consecutive_errors > 64) { v.clear(vf.data()); return -2; }
      continue;
    }
    consecutive_errors = 0;
    size_t base = samples.size();
    samples.resize(base + size_t(n) * ch);
    for (long i = 0; i < n; i++)
      for (int c = 0; c < ch; c++) samples[base + size_t(i) * ch + c] = pcm[c][i];
  }
  v.clear(vf.data());

  if (samples.empty()) return -2;
  int64_t frames = int64_t(samples.size()) / ch;
  float* result = static_cast<float*>(std::malloc(samples.size() * sizeof(float)));
  if (!result) return -4;
  std::memcpy(result, samples.data(), samples.size() * sizeof(float));
  *out = result;
  *sample_rate = int(rate);
  *channels = ch;
  return frames;
}

// Encode interleaved float32 ([-1, 1]) to an Ogg/Vorbis file at VBR
// `quality` in [-0.1, 1.0] (libvorbisenc scale; 0.4 ≈ 128 kbps stereo).
// Returns 0 on success; -1 open/write failure, -2 bad args or encode error,
// -3 engines unavailable.
extern "C" int ovt_ogg_encode(const char* path, const float* samples, int64_t frames,
                              int sample_rate, int channels, float quality) {
  VorbisEncLib& e = vorbis_enc_engine();
  if (!e.ok) return -3;
  if (!samples || frames <= 0 || channels < 1 || channels > 2 || sample_rate <= 0 ||
      quality < -0.2f || quality > 1.0f)
    return -2;

  std::vector<unsigned char> vi(kOpaque, 0), vc(kOpaque, 0), vd(kOpaque, 0),
      vb(kOpaque, 0), os(kOpaque, 0);

  e.info_init(vi.data());
  if (e.encode_init_vbr(vi.data(), channels, sample_rate, quality) != 0) {
    e.info_clear(vi.data());
    return -2;
  }
  e.comment_init(vc.data());
  e.analysis_init(vd.data(), vi.data());
  e.block_init(vd.data(), vb.data());
  e.stream_init(os.data(), 0x5059);

  std::FILE* f = std::fopen(path, "wb");
  int rc = 0;
  if (!f) rc = -1;

  OggPage og;
  OggPacket op;
  if (rc == 0) {
    // three header packets → flushed to their own page(s) before audio
    OggPacket header, header_comm, header_code;
    e.analysis_headerout(vd.data(), vc.data(), &header, &header_comm, &header_code);
    e.stream_packetin(os.data(), &header);
    e.stream_packetin(os.data(), &header_comm);
    e.stream_packetin(os.data(), &header_code);
    while (rc == 0 && e.stream_flush(os.data(), &og) != 0) {
      if (std::fwrite(og.header, 1, og.header_len, f) != size_t(og.header_len) ||
          std::fwrite(og.body, 1, og.body_len, f) != size_t(og.body_len))
        rc = -1;
    }
  }

  auto drain = [&]() {
    while (rc == 0 && e.analysis_blockout(vd.data(), vb.data()) == 1) {
      e.analysis(vb.data(), nullptr);
      e.bitrate_addblock(vb.data());
      while (rc == 0 && e.bitrate_flushpacket(vd.data(), &op) == 1) {
        e.stream_packetin(os.data(), &op);
        while (rc == 0 && e.stream_pageout(os.data(), &og) != 0) {
          if (std::fwrite(og.header, 1, og.header_len, f) != size_t(og.header_len) ||
              std::fwrite(og.body, 1, og.body_len, f) != size_t(og.body_len))
            rc = -1;
        }
      }
    }
  };

  constexpr int64_t kBlock = 4096;
  for (int64_t pos = 0; pos < frames && rc == 0; pos += kBlock) {
    int n = int(std::min(kBlock, frames - pos));
    float** buf = e.analysis_buffer(vd.data(), n);
    for (int i = 0; i < n; i++)
      for (int c = 0; c < channels; c++)
        buf[c][i] = samples[(pos + i) * channels + c];
    e.analysis_wrote(vd.data(), n);
    drain();
  }
  if (rc == 0) {
    e.analysis_wrote(vd.data(), 0);  // EOF marker → final packets with e_o_s
    drain();
    while (rc == 0 && e.stream_flush(os.data(), &og) != 0) {
      if (std::fwrite(og.header, 1, og.header_len, f) != size_t(og.header_len) ||
          std::fwrite(og.body, 1, og.body_len, f) != size_t(og.body_len))
        rc = -1;
    }
  }

  e.stream_clear(os.data());
  e.block_clear(vb.data());
  e.dsp_clear(vd.data());
  e.comment_clear(vc.data());
  e.info_clear(vi.data());
  if (f && std::fclose(f) != 0 && rc == 0) rc = -1;
  return rc;
}
