// C ABI for the openvoice-tpu native audio runtime.
//
// TPU-native equivalents of the reference's host-side native dependencies
// (librosa/soundfile/pydub+ffmpeg — SURVEY.md §2.4): file codecs, polyphase
// resampler, VAD, and a threaded prefetch loader feeding the device batcher.
//
// All buffers returned through out-pointers are malloc'd by the library and
// must be released with ovt_free().

#pragma once

#include <cstdint>

extern "C" {

// ---- memory ----------------------------------------------------------------
void ovt_free(void* ptr);

// ---- WAV codec -------------------------------------------------------------
// Returns frame count (samples per channel) or negative error code.
int64_t ovt_wav_read(const char* path, float** out, int* sample_rate, int* channels);
// Writes PCM16 WAV; returns 0 or negative error code.
int64_t ovt_wav_write(const char* path, const float* data, int64_t frames,
                      int sample_rate, int channels);

// ---- MP3 codec -------------------------------------------------------------
// Returns frame count or negative error code (-1 io, -2 format, -3 engine
// unavailable: libmpg123 missing).
int64_t ovt_mp3_decode(const char* path, float** out, int* sample_rate, int* channels);
// Encode interleaved float32 ([-1, 1]) to a CBR mp3 at `kbps`.  Returns 0 or
// negative error code (-1 io, -2 bad args / encode error / unsupported
// rate-bitrate combination, -3 engine unavailable: libmp3lame missing).
int ovt_mp3_encode(const char* path, const float* samples, int64_t frames,
                   int sample_rate, int channels, int kbps);

// ---- Ogg/Vorbis codec ------------------------------------------------------
// Returns frame count or negative error code (-1 open/not-vorbis, -2 format,
// -3 engine unavailable: libvorbisfile missing).
int64_t ovt_ogg_decode(const char* path, float** out, int* sample_rate, int* channels);
// Encode interleaved float32 ([-1, 1]) to Ogg/Vorbis at VBR `quality` in
// [-0.1, 1.0] (0.4 ≈ 128 kbps stereo).  Returns 0 or negative error code
// (-1 io, -2 bad args / encode error, -3 engines unavailable:
// libogg/libvorbis/libvorbisenc missing).
int ovt_ogg_encode(const char* path, const float* samples, int64_t frames,
                   int sample_rate, int channels, float quality);

// ---- FLAC codec ------------------------------------------------------------
// From-scratch FLAC bitstream implementation (no libFLAC dependency).
// Decode returns frame count or negative error (-1 io, -2 format/corrupt,
// -4 oom); supports CONSTANT/VERBATIM/FIXED/LPC subframes, all channel
// decorrelations, wasted bits, 8-32 bit depth.
int64_t ovt_flac_decode(const char* path, float** out, int* sample_rate, int* channels);
// Encode interleaved float32 ([-1, 1]) as 16-bit FLAC (fixed+LPC predictors,
// Rice residuals).  Returns 0 or negative error (-1 io, -2 bad args).
int ovt_flac_encode(const char* path, const float* samples, int64_t frames,
                    int sample_rate, int channels);

// ---- resampler -------------------------------------------------------------
// Kaiser-windowed polyphase resampler, mono float32.
// Returns output length or negative error code.
int64_t ovt_resample(const float* in, int64_t n, int sr_in, int sr_out, float** out);

// ---- energy VAD ------------------------------------------------------------
// Writes up to max_segments (start, end) sample pairs; returns segment count.
int64_t ovt_energy_vad(const float* audio, int64_t n, int sample_rate,
                       float frame_ms, float min_speech_s, float min_silence_s,
                       float threshold_db, int64_t* segments, int64_t max_segments);

// ---- threaded prefetch loader ----------------------------------------------
// Decodes + resamples files on worker threads, delivering mono float32 clips
// in submission order (a bounded queue feeding the device batcher).
typedef struct OvtLoader OvtLoader;
OvtLoader* ovt_loader_create(int n_threads, int target_sr, int queue_capacity);
void ovt_loader_destroy(OvtLoader* loader);
// Enqueue a file; returns a ticket id (>=0) or negative if shutting down.
int64_t ovt_loader_submit(OvtLoader* loader, const char* path);
// Blocks for the next completed clip IN SUBMISSION ORDER.
// Returns ticket id, or -1 when the queue is drained+closed, or -2 on decode
// error (error ticket id in *ticket). Caller frees *out with ovt_free.
int64_t ovt_loader_next(OvtLoader* loader, float** out, int64_t* n, int64_t* ticket);

}  // extern "C"
