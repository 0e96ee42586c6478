// FLAC codec, from scratch — no libFLAC in this image, and the reference
// only reaches FLAC through librosa/audioread/ffmpeg (reference
// openvoice/api.py:144, se_extractor.py:9), so the format logic here is an
// original implementation of the public FLAC bitstream spec.
//
// Decoder: full subframe surface — CONSTANT / VERBATIM / FIXED(0-4) /
// LPC(1-32), Rice and Rice2 residual partitions with escape codes, wasted
// bits, left-side / right-side / mid-side decorrelation, 8/16/20/24/32-bit
// samples, fixed and variable blocksize streams.  Frame-header CRC-8 and
// frame CRC-16 are verified.
//
// Encoder: 4096-sample blocks, independent channels, per-subframe choice of
// CONSTANT / FIXED(0-4) / LPC(order 8, Levinson-Durbin, 12-bit quantized
// coefficients) by estimated Rice cost, partition-order-0 Rice residuals,
// 16-bit PCM.  Output decodes with the decoder above AND any spec-conforming
// reader.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

#include "ovt_audio.h"

namespace {

// ---------------------------------------------------------------------------
// CRCs (FLAC frame header CRC-8 poly 0x07; frame CRC-16 poly 0x8005)
// ---------------------------------------------------------------------------

uint8_t crc8(const uint8_t* data, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; i++) {
    crc ^= data[i];
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x80) ? uint8_t((crc << 1) ^ 0x07) : uint8_t(crc << 1);
  }
  return crc;
}

uint16_t crc16(const uint8_t* data, size_t n) {
  uint16_t crc = 0;
  for (size_t i = 0; i < n; i++) {
    crc ^= uint16_t(data[i]) << 8;
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x8000) ? uint16_t((crc << 1) ^ 0x8005) : uint16_t(crc << 1);
  }
  return crc;
}

// ---------------------------------------------------------------------------
// MSB-first bit reader
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* buf;
  size_t size;      // bytes
  size_t pos = 0;   // byte position
  int bit = 0;      // bit position within buf[pos], 0 = MSB
  bool error = false;

  BitReader(const uint8_t* b, size_t n) : buf(b), size(n) {}

  size_t bits_left() const { return (size - pos) * 8 - bit; }

  uint64_t read(int n) {  // n <= 57
    uint64_t v = 0;
    while (n > 0) {
      if (pos >= size) { error = true; return 0; }
      int avail = 8 - bit;
      int take = n < avail ? n : avail;
      uint8_t chunk = uint8_t(buf[pos] << bit) >> (8 - take);
      v = (v << take) | chunk;
      bit += take;
      n -= take;
      if (bit == 8) { bit = 0; pos++; }
    }
    return v;
  }

  int64_t read_signed(int n) {
    if (n == 0) return 0;
    uint64_t v = read(n);
    uint64_t sign = 1ULL << (n - 1);
    return (v & sign) ? int64_t(v) - (int64_t(1) << n) : int64_t(v);
  }

  // unary: count of 0 bits before the terminating 1
  uint32_t read_unary() {
    uint32_t q = 0;
    for (;;) {
      if (pos >= size) { error = true; return 0; }
      uint8_t rest = uint8_t(buf[pos] << bit);
      if (rest == 0) {           // whole remaining byte is zeros
        q += 8 - bit;
        bit = 0; pos++;
        continue;
      }
      int lead = __builtin_clz(uint32_t(rest)) - 24;  // zeros in this byte
      q += lead;
      bit += lead + 1;           // consume zeros + the 1
      if (bit >= 8) { bit -= 8; pos++; }
      return q;
    }
  }

  void align() { if (bit) { bit = 0; pos++; } }
};

// ---------------------------------------------------------------------------
// MSB-first bit writer
// ---------------------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;

  void write(uint64_t v, int n) {  // n <= 57
    acc = (acc << n) | (v & ((n == 64) ? ~0ULL : ((1ULL << n) - 1)));
    nbits += n;
    while (nbits >= 8) {
      out.push_back(uint8_t(acc >> (nbits - 8)));
      nbits -= 8;
    }
  }

  void write_unary(uint32_t q) {
    while (q >= 32) { write(0, 32); q -= 32; }
    write(1, int(q) + 1);  // q zeros then a 1
  }

  void align() { if (nbits) write(0, 8 - nbits); }
};

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
};

// Rice/escaped residual into res[order..blocksize)
bool decode_residual(BitReader& br, int order, int blocksize, int64_t* res) {
  int method = int(br.read(2));
  if (method > 1) return false;
  int pbits = method == 0 ? 4 : 5;
  int escape = method == 0 ? 15 : 31;
  int po = int(br.read(4));
  int nparts = 1 << po;
  if (blocksize % nparts != 0) return false;
  int psize = blocksize >> po;
  if (psize <= order && nparts == 1) return false;
  int idx = order;
  for (int p = 0; p < nparts; p++) {
    int count = psize - (p == 0 ? order : 0);
    if (count < 0) return false;
    int param = int(br.read(pbits));
    if (param == escape) {
      int raw = int(br.read(5));
      for (int i = 0; i < count; i++) res[idx++] = raw ? br.read_signed(raw) : 0;
    } else {
      for (int i = 0; i < count; i++) {
        uint32_t q = br.read_unary();
        uint64_t v = (uint64_t(q) << param) | br.read(param);
        res[idx++] = int64_t(v >> 1) ^ -int64_t(v & 1);  // zigzag
      }
    }
    if (br.error) return false;
  }
  return idx == blocksize;
}

bool decode_subframe(BitReader& br, int blocksize, int bps, int64_t* x) {
  if (br.read(1) != 0) return false;  // padding bit
  int type = int(br.read(6));
  int wasted = 0;
  if (br.read(1)) wasted = int(br.read_unary()) + 1;
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;

  if (type == 0) {                          // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; i++) x[i] = v;
  } else if (type == 1) {                   // VERBATIM
    for (int i = 0; i < blocksize; i++) x[i] = br.read_signed(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED 0-4
    int order = type & 0x07;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) x[i] = br.read_signed(bps);
    if (!decode_residual(br, order, blocksize, x)) return false;
    switch (order) {  // restore in place: x holds residuals past warmup
      case 0: break;
      case 1: for (int i = 1; i < blocksize; i++) x[i] += x[i-1]; break;
      case 2: for (int i = 2; i < blocksize; i++) x[i] += 2*x[i-1] - x[i-2]; break;
      case 3: for (int i = 3; i < blocksize; i++) x[i] += 3*x[i-1] - 3*x[i-2] + x[i-3]; break;
      case 4: for (int i = 4; i < blocksize; i++) x[i] += 4*x[i-1] - 6*x[i-2] + 4*x[i-3] - x[i-4]; break;
    }
  } else if (type & 0x20) {                 // LPC, order 1-32
    int order = (type & 0x1F) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) x[i] = br.read_signed(bps);
    int precision = int(br.read(4)) + 1;
    if (precision == 16) return false;      // 0b1111 invalid
    int shift = int(br.read_signed(5));
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; i++) coef[i] = br.read_signed(precision);
    if (!decode_residual(br, order, blocksize, x)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int j = 0; j < order; j++) pred += coef[j] * x[i - 1 - j];
      x[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (br.error) return false;
  if (wasted)
    for (int i = 0; i < blocksize; i++) x[i] = int64_t(uint64_t(x[i]) << wasted);
  return true;
}

// decode one frame; returns blocksize or -1
int decode_frame(BitReader& br, const StreamInfo& si,
                 std::vector<std::vector<int64_t>>& ch_buf) {
  size_t frame_start = br.pos;
  if (br.bit != 0) return -1;  // frames are byte-aligned
  if (br.read(14) != 0x3FFE) return -1;  // sync
  br.read(1);                             // reserved
  br.read(1);                             // blocking strategy
  int bs_code = int(br.read(4));
  int sr_code = int(br.read(4));
  int ch_code = int(br.read(4));
  int ss_code = int(br.read(3));
  br.read(1);                             // reserved
  // UTF-8 coded frame/sample number: skip
  uint64_t first = br.read(8);
  int follow = 0;
  for (uint64_t m = 0x80; first & m; m >>= 1) follow++;
  if (follow == 1 || follow > 7) return -1;
  for (int i = 0; i < (follow ? follow - 1 : 0); i++)
    if ((br.read(8) & 0xC0) != 0x80) return -1;

  int blocksize;
  switch (bs_code) {
    case 0: return -1;
    case 1: blocksize = 192; break;
    case 2: case 3: case 4: case 5: blocksize = 576 << (bs_code - 2); break;
    case 6: blocksize = int(br.read(8)) + 1; break;
    case 7: blocksize = int(br.read(16)) + 1; break;
    default: blocksize = 256 << (bs_code - 8); break;
  }
  switch (sr_code) {  // value unused (streaminfo governs) but bits must go
    case 12: br.read(8); break;
    case 13: case 14: br.read(16); break;
    case 15: return -1;
    default: break;
  }
  int bps;
  switch (ss_code) {
    case 0: bps = si.bps; break;
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return -1;
  }
  int channels = ch_code < 8 ? ch_code + 1 : 2;
  if (ch_code > 10 || channels != si.channels) return -1;
  if (br.error || br.bit != 0) return -1;
  // header CRC-8 covers sync byte .. byte before the CRC
  uint8_t want_crc8 = crc8(br.buf + frame_start, br.pos - frame_start);
  if (uint8_t(br.read(8)) != want_crc8) return -1;

  for (int c = 0; c < channels; c++) {
    int sub_bps = bps;
    if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
        (ch_code == 10 && c == 1))
      sub_bps++;  // side channel carries one extra bit
    ch_buf[c].resize(blocksize);
    if (!decode_subframe(br, blocksize, sub_bps, ch_buf[c].data())) return -1;
  }
  // undo inter-channel decorrelation
  if (ch_code == 8) {        // left/side
    for (int i = 0; i < blocksize; i++) ch_buf[1][i] = ch_buf[0][i] - ch_buf[1][i];
  } else if (ch_code == 9) { // right/side: ch0=side ch1=right
    for (int i = 0; i < blocksize; i++) ch_buf[0][i] += ch_buf[1][i];
  } else if (ch_code == 10) {// mid/side
    for (int i = 0; i < blocksize; i++) {
      int64_t side = ch_buf[1][i];
      int64_t mid = (ch_buf[0][i] << 1) | (side & 1);
      ch_buf[0][i] = (mid + side) >> 1;
      ch_buf[1][i] = (mid - side) >> 1;
    }
  }
  br.align();
  uint16_t want_crc16 = crc16(br.buf + frame_start, br.pos - frame_start);
  if (uint16_t(br.read(16)) != want_crc16) return -1;
  if (br.error) return -1;
  return blocksize;
}

}  // namespace

extern "C" int64_t ovt_flac_decode(const char* path, float** out,
                                   int* sample_rate, int* channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 42) { std::fclose(f); return -2; }
  std::vector<uint8_t> data(static_cast<size_t>(fsize));
  if (std::fread(data.data(), 1, size_t(fsize), f) != size_t(fsize)) {
    std::fclose(f); return -1;
  }
  std::fclose(f);

  if (std::memcmp(data.data(), "fLaC", 4) != 0) return -2;
  BitReader br(data.data(), data.size());
  br.pos = 4;

  StreamInfo si;
  bool have_si = false, last = false;
  while (!last) {
    last = br.read(1);
    int type = int(br.read(7));
    uint32_t len = uint32_t(br.read(24));
    if (br.error || br.bits_left() < uint64_t(len) * 8) return -2;
    if (type == 0) {  // STREAMINFO
      br.read(16); br.read(16);  // min/max blocksize
      br.read(24); br.read(24);  // min/max framesize
      si.sample_rate = uint32_t(br.read(20));
      si.channels = int(br.read(3)) + 1;
      si.bps = int(br.read(5)) + 1;
      si.total_samples = br.read(36);
      br.pos += 16;  // md5
      have_si = true;
    } else {
      br.pos += len;
    }
  }
  if (!have_si || br.error || si.sample_rate == 0 || si.channels > 8) return -2;

  std::vector<std::vector<int64_t>> ch_buf(si.channels);
  std::vector<float> samples;  // interleaved
  if (si.total_samples)
    samples.reserve(size_t(si.total_samples) * si.channels);
  float scale = 1.0f / float(1u << (si.bps - 1));
  uint64_t decoded = 0;
  while (br.pos < br.size &&
         (si.total_samples == 0 || decoded < si.total_samples)) {
    if (br.size - br.pos < 10) break;  // trailing junk smaller than a frame
    int n = decode_frame(br, si, ch_buf);
    if (n < 0) {
      if (si.total_samples == 0 && decoded > 0) break;  // EOF heuristic
      return -2;
    }
    size_t base = samples.size();
    samples.resize(base + size_t(n) * si.channels);
    for (int i = 0; i < n; i++)
      for (int c = 0; c < si.channels; c++)
        samples[base + size_t(i) * si.channels + c] = float(ch_buf[c][i]) * scale;
    decoded += uint64_t(n);
  }
  if (si.total_samples && decoded != si.total_samples) return -2;
  if (samples.empty()) return -2;

  float* result = static_cast<float*>(std::malloc(samples.size() * sizeof(float)));
  if (!result) return -4;
  std::memcpy(result, samples.data(), samples.size() * sizeof(float));
  *out = result;
  *sample_rate = int(si.sample_rate);
  *channels = si.channels;
  return int64_t(decoded);
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

namespace {

constexpr int kBlock = 4096;
constexpr int kLpcOrder = 8;
constexpr int kLpcPrecision = 12;

// Rice parameter + total bit cost for a residual set
int rice_param_for(const int64_t* res, int n, uint64_t* cost_out) {
  uint64_t sum = 0;
  for (int i = 0; i < n; i++) {
    int64_t v = res[i];
    sum += uint64_t(v < 0 ? -2 * v - 1 : 2 * v);
  }
  int k = 0;
  while (k < 14 && (uint64_t(n) << (k + 1)) < sum) k++;
  uint64_t cost = 0;
  for (int i = 0; i < n; i++) {
    int64_t v = res[i];
    uint64_t zz = uint64_t(v < 0 ? -2 * v - 1 : 2 * v);
    cost += (zz >> k) + 1 + uint64_t(k);
  }
  *cost_out = cost;
  return k;
}

void rice_encode(BitWriter& bw, const int64_t* res, int n, int k) {
  for (int i = 0; i < n; i++) {
    int64_t v = res[i];
    uint64_t zz = uint64_t(v < 0 ? -2 * v - 1 : 2 * v);
    bw.write_unary(uint32_t(zz >> k));
    if (k) bw.write(zz & ((1ULL << k) - 1), k);
  }
}

void fixed_residual(const int64_t* x, int n, int order, int64_t* res) {
  switch (order) {
    case 0: for (int i = 0; i < n; i++) res[i] = x[i]; break;
    case 1: for (int i = 1; i < n; i++) res[i] = x[i] - x[i-1]; break;
    case 2: for (int i = 2; i < n; i++) res[i] = x[i] - 2*x[i-1] + x[i-2]; break;
    case 3: for (int i = 3; i < n; i++) res[i] = x[i] - 3*x[i-1] + 3*x[i-2] - x[i-3]; break;
    case 4: for (int i = 4; i < n; i++) res[i] = x[i] - 4*x[i-1] + 6*x[i-2] - 4*x[i-3] + x[i-4]; break;
  }
}

// Levinson-Durbin → quantized LPC; returns false if unusable
bool lpc_analyze(const int64_t* x, int n, int64_t* qcoef, int* shift_out) {
  if (n <= kLpcOrder * 2) return false;
  double autoc[kLpcOrder + 1] = {0};
  for (int lag = 0; lag <= kLpcOrder; lag++)
    for (int i = lag; i < n; i++)
      autoc[lag] += double(x[i]) * double(x[i - lag]);
  if (autoc[0] <= 0) return false;
  double err = autoc[0];
  double lpc[kLpcOrder] = {0};
  for (int i = 0; i < kLpcOrder; i++) {
    double acc = autoc[i + 1];
    for (int j = 0; j < i; j++) acc -= lpc[j] * autoc[i - j];
    double k = acc / err;
    lpc[i] = k;
    for (int j = 0; j < i / 2; j++) {
      double t = lpc[j];
      lpc[j] = t - k * lpc[i - 1 - j];
      lpc[i - 1 - j] -= k * t;
    }
    if (i & 1) lpc[i / 2] -= k * lpc[i / 2];
    err *= 1.0 - k * k;
    if (err <= 0) return false;
  }
  double cmax = 0;
  for (int i = 0; i < kLpcOrder; i++) cmax = std::fmax(cmax, std::fabs(lpc[i]));
  if (cmax <= 0) return false;
  int headroom;
  std::frexp(cmax, &headroom);  // cmax in [2^(h-1), 2^h)
  int shift = kLpcPrecision - 1 - headroom;
  if (shift > 15) shift = 15;
  if (shift < 0) return false;
  double e = 0;
  int64_t lim = (1 << (kLpcPrecision - 1)) - 1;
  for (int i = 0; i < kLpcOrder; i++) {
    double v = lpc[i] * double(1 << shift) + e;
    int64_t q = llround(v);
    if (q > lim) q = lim;
    if (q < -lim - 1) q = -lim - 1;
    e = v - double(q);
    qcoef[i] = q;
  }
  *shift_out = shift;
  return true;
}

void write_subframe(BitWriter& bw, const int64_t* x, int n) {
  // CONSTANT?
  bool constant = true;
  for (int i = 1; i < n && constant; i++) constant = x[i] == x[0];
  if (constant) {
    bw.write(0, 1); bw.write(0, 6); bw.write(0, 1);
    bw.write(uint64_t(x[0]) & 0xFFFF, 16);
    return;
  }
  // candidates: fixed 0-4 and LPC-8; pick cheapest rice cost
  static thread_local std::vector<int64_t> res, best_res, lpc_res;
  res.resize(n); best_res.resize(n);
  int best_order = 0;
  uint64_t best_cost = ~0ULL;
  bool best_is_lpc = false;
  int64_t qcoef[kLpcOrder]; int qshift = 0;
  for (int order = 0; order <= 4 && order < n; order++) {
    fixed_residual(x, n, order, res.data());
    uint64_t cost;
    rice_param_for(res.data() + order, n - order, &cost);
    cost += uint64_t(order) * 16;
    if (cost < best_cost) {
      best_cost = cost; best_order = order; best_is_lpc = false;
      std::memcpy(best_res.data(), res.data(), size_t(n) * sizeof(int64_t));
    }
  }
  int64_t c[kLpcOrder]; int sh;
  if (lpc_analyze(x, n, c, &sh)) {
    lpc_res.resize(n);
    for (int i = kLpcOrder; i < n; i++) {
      int64_t pred = 0;
      for (int j = 0; j < kLpcOrder; j++) pred += c[j] * x[i - 1 - j];
      lpc_res[i] = x[i] - (pred >> sh);
    }
    uint64_t cost;
    rice_param_for(lpc_res.data() + kLpcOrder, n - kLpcOrder, &cost);
    cost += uint64_t(kLpcOrder) * (16 + kLpcPrecision) + 9;
    if (cost < best_cost) {
      best_cost = cost; best_is_lpc = true;
      std::memcpy(qcoef, c, sizeof(qcoef)); qshift = sh;
      std::memcpy(best_res.data(), lpc_res.data(), size_t(n) * sizeof(int64_t));
    }
  }

  int order = best_is_lpc ? kLpcOrder : best_order;
  bw.write(0, 1);
  bw.write(best_is_lpc ? uint64_t(0x20 | (kLpcOrder - 1)) : uint64_t(0x08 | order), 6);
  bw.write(0, 1);  // no wasted bits
  for (int i = 0; i < order; i++) bw.write(uint64_t(x[i]) & 0xFFFF, 16);
  if (best_is_lpc) {
    bw.write(kLpcPrecision - 1, 4);
    bw.write(uint64_t(qshift) & 0x1F, 5);
    for (int i = 0; i < kLpcOrder; i++)
      bw.write(uint64_t(qcoef[i]) & ((1u << kLpcPrecision) - 1), kLpcPrecision);
  }
  uint64_t cost;
  int k = rice_param_for(best_res.data() + order, n - order, &cost);
  bw.write(0, 2);  // rice method 0 (4-bit params)
  bw.write(0, 4);  // partition order 0
  bw.write(uint64_t(k), 4);
  rice_encode(bw, best_res.data() + order, n - order, k);
}

void write_utf8(BitWriter& bw, uint64_t v) {
  if (v < 0x80) { bw.write(v, 8); return; }
  int nbytes = 2;
  while (nbytes < 7 && v >= (1ULL << (nbytes * 5 + 1))) nbytes++;
  bw.write((0xFFu << (8 - nbytes)) & 0xFF | uint32_t(v >> (6 * (nbytes - 1))), 8);
  for (int i = nbytes - 2; i >= 0; i--)
    bw.write(0x80 | ((v >> (6 * i)) & 0x3F), 8);
}

int sr_code_for(int sr) {
  switch (sr) {
    case 88200: return 1;  case 176400: return 2; case 192000: return 3;
    case 8000: return 4;   case 16000: return 5;  case 22050: return 6;
    case 24000: return 7;  case 32000: return 8;  case 44100: return 9;
    case 48000: return 10; case 96000: return 11; default: return 0;
  }
}

}  // namespace

extern "C" int ovt_flac_encode(const char* path, const float* samples,
                               int64_t frames, int sample_rate, int channels) {
  if (!samples || frames <= 0 || channels < 1 || channels > 8 ||
      sample_rate <= 0 || sample_rate >= (1 << 20))
    return -2;

  BitWriter bw;
  // "fLaC" + STREAMINFO (last metadata block, type 0, length 34)
  bw.write('f', 8); bw.write('L', 8); bw.write('a', 8); bw.write('C', 8);
  bw.write(1, 1); bw.write(0, 7); bw.write(34, 24);
  int min_bs = frames < kBlock ? int(frames) : kBlock;
  bw.write(uint64_t(min_bs < 16 ? 16 : min_bs), 16);  // min blocksize
  bw.write(kBlock, 16);                               // max blocksize
  bw.write(0, 24); bw.write(0, 24);                   // min/max framesize unknown
  bw.write(uint64_t(sample_rate), 20);
  bw.write(uint64_t(channels - 1), 3);
  bw.write(15, 5);                                    // bps 16
  bw.write(uint64_t(frames), 36);
  for (int i = 0; i < 16; i++) bw.write(0, 8);        // md5 unset

  std::vector<int64_t> ch(static_cast<size_t>(kBlock));
  int64_t pos = 0;
  uint64_t frame_no = 0;
  while (pos < frames) {
    int n = int(frames - pos < kBlock ? frames - pos : kBlock);
    size_t frame_start = bw.out.size();  // byte-aligned here
    bw.write(0x3FFE, 14); bw.write(0, 1); bw.write(0, 1);  // sync, fixed-bs
    int bs_code = (n == kBlock) ? 12 : 7;  // 256<<4 = 4096, else 16-bit at end
    bw.write(uint64_t(bs_code), 4);
    int src = sr_code_for(sample_rate);
    bw.write(uint64_t(src), 4);
    bw.write(uint64_t(channels - 1), 4);   // independent channels
    bw.write(4, 3);                        // 16-bit
    bw.write(0, 1);
    write_utf8(bw, frame_no++);
    if (bs_code == 7) bw.write(uint64_t(n - 1), 16);
    bw.write(crc8(bw.out.data() + frame_start, bw.out.size() - frame_start), 8);

    for (int c = 0; c < channels; c++) {
      for (int i = 0; i < n; i++) {
        float v = samples[(pos + i) * channels + c];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        ch[size_t(i)] = llround(double(v) * 32767.0);
      }
      write_subframe(bw, ch.data(), n);
    }
    bw.align();
    uint16_t fcrc = crc16(bw.out.data() + frame_start, bw.out.size() - frame_start);
    bw.write(fcrc, 16);
    pos += n;
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t written = std::fwrite(bw.out.data(), 1, bw.out.size(), f);
  std::fclose(f);
  return written == bw.out.size() ? 0 : -1;
}
