// Universal audio decode/encode via the system ffmpeg libraries
// (libavformat/libavcodec/libswresample — ffmpeg 5.x API).
//
// The reference accepts anything librosa/audioread/ffmpeg decode
// (reference openvoice/api.py:144, se_extractor.py:9); the in-repo codecs
// cover wav/mp3/ogg/flac natively, and THIS translation unit adds the long
// tail (m4a/aac, mp4, wma, …) where the system ships ffmpeg.  It builds as
// a SEPARATE shared library (libovt_ffdec.so) so libovt_audio.so keeps
// zero hard dependencies: Python dlopens this lib only when asked for a
// format the native codecs don't speak (openvoice_tpu/audio/ffdec.py).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct DecodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;

  ~DecodeCtx() {
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }
};

// drain all frames currently available from the decoder into samples
int drain_frames(DecodeCtx& c, int out_ch, std::vector<float>& samples) {
  while (true) {
    int r = avcodec_receive_frame(c.dec, c.frame);
    if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
    if (r < 0) return r;
    int max_out = c.frame->nb_samples + 256;
    size_t base = samples.size();
    samples.resize(base + size_t(max_out) * out_ch);
    uint8_t* out_planes[1] = {reinterpret_cast<uint8_t*>(samples.data() + base)};
    int got = swr_convert(c.swr, out_planes, max_out,
                          const_cast<const uint8_t**>(c.frame->extended_data),
                          c.frame->nb_samples);
    if (got < 0) return got;
    samples.resize(base + size_t(got) * out_ch);
  }
}

}  // namespace

extern "C" int64_t ovt_ff_decode(const char* path, float** out,
                                 int* sample_rate, int* channels) {
  DecodeCtx c;
  if (avformat_open_input(&c.fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(c.fmt, nullptr) < 0) return -2;
  const AVCodec* codec = nullptr;
  int stream = av_find_best_stream(c.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (stream < 0 || !codec) return -2;
  AVStream* st = c.fmt->streams[stream];

  c.dec = avcodec_alloc_context3(codec);
  if (!c.dec) return -4;
  if (avcodec_parameters_to_context(c.dec, st->codecpar) < 0) return -2;
  if (avcodec_open2(c.dec, codec, nullptr) < 0) return -2;

  int out_ch = c.dec->ch_layout.nb_channels;
  if (out_ch < 1) return -2;
  if (out_ch > 8) out_ch = 8;
  AVChannelLayout out_layout;
  av_channel_layout_default(&out_layout, out_ch);
  if (swr_alloc_set_opts2(&c.swr, &out_layout, AV_SAMPLE_FMT_FLT,
                          c.dec->sample_rate, &c.dec->ch_layout,
                          c.dec->sample_fmt, c.dec->sample_rate, 0,
                          nullptr) < 0 ||
      swr_init(c.swr) < 0)
    return -2;

  c.pkt = av_packet_alloc();
  c.frame = av_frame_alloc();
  if (!c.pkt || !c.frame) return -4;

  std::vector<float> samples;
  while (av_read_frame(c.fmt, c.pkt) >= 0) {
    if (c.pkt->stream_index == stream) {
      if (avcodec_send_packet(c.dec, c.pkt) == 0) {
        if (drain_frames(c, out_ch, samples) < 0) {
          av_packet_unref(c.pkt);
          return -2;
        }
      }
    }
    av_packet_unref(c.pkt);
  }
  avcodec_send_packet(c.dec, nullptr);  // flush
  drain_frames(c, out_ch, samples);
  // flush the resampler's tail
  {
    size_t base = samples.size();
    samples.resize(base + size_t(4096) * out_ch);
    uint8_t* out_planes[1] = {reinterpret_cast<uint8_t*>(samples.data() + base)};
    int got = swr_convert(c.swr, out_planes, 4096, nullptr, 0);
    samples.resize(base + size_t(got > 0 ? got : 0) * out_ch);
  }

  if (samples.empty()) return -2;
  float* result = static_cast<float*>(std::malloc(samples.size() * sizeof(float)));
  if (!result) return -4;
  std::memcpy(result, samples.data(), samples.size() * sizeof(float));
  *out = result;
  *sample_rate = c.dec->sample_rate;
  *channels = out_ch;
  return int64_t(samples.size()) / out_ch;
}

// ---------------------------------------------------------------------------
// AAC-in-m4a encode (ffmpeg native aac encoder): interleaved float32 in.
// Returns 0 or negative error (-1 io, -2 format/encode, -4 oom).
// ---------------------------------------------------------------------------

extern "C" int ovt_ff_encode_m4a(const char* path, const float* samples,
                                 int64_t frames, int sample_rate, int channels,
                                 int kbps) {
  if (!samples || frames <= 0 || channels < 1 || channels > 2 ||
      sample_rate <= 0 || kbps <= 0)
    return -2;

  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, "mp4", path) < 0 || !fmt)
    return -2;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  AVCodecContext* enc = codec ? avcodec_alloc_context3(codec) : nullptr;
  SwrContext* swr = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int ret = -2;

  do {
    if (!enc) break;
    av_channel_layout_default(&enc->ch_layout, channels);
    enc->sample_rate = sample_rate;
    enc->sample_fmt = AV_SAMPLE_FMT_FLTP;  // native aac wants planar float
    enc->bit_rate = int64_t(kbps) * 1000;
    enc->time_base = AVRational{1, sample_rate};
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
      enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(enc, codec, nullptr) < 0) break;

    AVStream* st = avformat_new_stream(fmt, nullptr);
    if (!st) break;
    st->time_base = enc->time_base;
    if (avcodec_parameters_from_context(st->codecpar, enc) < 0) break;
    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
      ret = -1;
      break;
    }
    if (avformat_write_header(fmt, nullptr) < 0) break;

    // interleaved FLT → planar FLTP through swresample
    if (swr_alloc_set_opts2(&swr, &enc->ch_layout, AV_SAMPLE_FMT_FLTP,
                            sample_rate, &enc->ch_layout, AV_SAMPLE_FMT_FLT,
                            sample_rate, 0, nullptr) < 0 ||
        swr_init(swr) < 0)
      break;

    frame = av_frame_alloc();
    pkt = av_packet_alloc();
    if (!frame || !pkt) { ret = -4; break; }
    int chunk = enc->frame_size > 0 ? enc->frame_size : 1024;
    frame->format = AV_SAMPLE_FMT_FLTP;
    av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
    frame->sample_rate = sample_rate;

    bool failed = false;
    int64_t pos = 0, pts = 0;

    auto pump_packets = [&]() -> bool {
      while (true) {
        int r = avcodec_receive_packet(enc, pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return true;
        if (r < 0) return false;
        pkt->stream_index = 0;
        av_packet_rescale_ts(pkt, enc->time_base, fmt->streams[0]->time_base);
        if (av_interleaved_write_frame(fmt, pkt) < 0) return false;
      }
    };

    while (pos < frames && !failed) {
      int n = int(frames - pos < chunk ? frames - pos : chunk);
      frame->nb_samples = n;
      if (av_frame_get_buffer(frame, 0) < 0) { failed = true; break; }
      const uint8_t* in_planes[1] = {
          reinterpret_cast<const uint8_t*>(samples + pos * channels)};
      if (swr_convert(swr, frame->extended_data, n, in_planes, n) < 0) {
        failed = true;
        break;
      }
      frame->pts = pts;
      pts += n;
      if (avcodec_send_frame(enc, frame) < 0 || !pump_packets()) failed = true;
      av_frame_unref(frame);
      frame->format = AV_SAMPLE_FMT_FLTP;
      av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
      frame->sample_rate = sample_rate;
      pos += n;
    }
    if (!failed) {
      avcodec_send_frame(enc, nullptr);  // flush encoder
      if (!pump_packets()) failed = true;
    }
    if (!failed && av_write_trailer(fmt) == 0) ret = 0;
  } while (false);

  if (pkt) av_packet_free(&pkt);
  if (frame) av_frame_free(&frame);
  if (swr) swr_free(&swr);
  if (enc) avcodec_free_context(&enc);
  if (fmt) {
    if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb) avio_closep(&fmt->pb);
    avformat_free_context(fmt);
  }
  return ret;
}
