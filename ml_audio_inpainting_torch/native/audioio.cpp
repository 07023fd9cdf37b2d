// audioio.cpp — native host-side audio codec library of the PyTorch/CUDA
// audio-inpainting package (a copy of the JAX package's codec, so the port
// builds and loads its own).
//
// Replaces the reference's C-backed librosa/soundfile decode path
// (reference utils.py:14-89 load_audio/save_audio) with a self-contained
// C++ implementation exposed to Python over a C ABI (ctypes):
//
//   * FLAC decoder  — full support for constant/verbatim/fixed/LPC subframes,
//                     rice/rice2 residual partitions, all channel
//                     decorrelation modes, UTF-8 frame numbers, wasted bits.
//                     Decoded audio is verified against the MD5 signature
//                     embedded in STREAMINFO.
//   * FLAC encoder  — fixed-predictor encoding with per-partition rice
//                     parameter search; writes a spec-compliant stream with
//                     STREAMINFO + MD5.
//   * WAV reader/writer — PCM 8/16/24/32 and IEEE float32.
//   * MP3 decoder   — binds the operating system's codec (libmpg123) at
//                     runtime, mirroring the reference's own MP3 path
//                     (librosa -> audioread -> system codec); fails fast
//                     with a clear error when the codec is absent.
//
// No external dependencies beyond the optional system MP3 codec (MD5,
// CRC8, CRC16 implemented below).
//
// Build (data/audio_io.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC audioio.cpp -o libaudioio.so -ldl

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

// ---------------------------------------------------------------------------
// MD5 (RFC 1321) — compact implementation
// ---------------------------------------------------------------------------
namespace md5impl {

struct MD5 {
  uint32_t a0 = 0x67452301, b0 = 0xefcdab89, c0 = 0x98badcfe, d0 = 0x10325476;
  uint64_t total = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  static uint32_t rotl(uint32_t x, int c) { return (x << c) | (x >> (32 - c)); }

  void process(const uint8_t* p) {
    static const uint32_t K[64] = {
        0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
        0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
        0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
        0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
        0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
        0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
        0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
        0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
        0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
        0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
        0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
    static const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                              7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                              5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                              4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                              6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                              6, 10, 15, 21};
    uint32_t M[16];
    for (int i = 0; i < 16; i++)
      M[i] = (uint32_t)p[i * 4] | ((uint32_t)p[i * 4 + 1] << 8) |
             ((uint32_t)p[i * 4 + 2] << 16) | ((uint32_t)p[i * 4 + 3] << 24);
    uint32_t A = a0, B = b0, C = c0, D = d0;
    for (int i = 0; i < 64; i++) {
      uint32_t F;
      int g;
      if (i < 16) { F = (B & C) | (~B & D); g = i; }
      else if (i < 32) { F = (D & B) | (~D & C); g = (5 * i + 1) & 15; }
      else if (i < 48) { F = B ^ C ^ D; g = (3 * i + 5) & 15; }
      else { F = C ^ (B | ~D); g = (7 * i) & 15; }
      F = F + A + K[i] + M[g];
      A = D; D = C; C = B;
      B = B + rotl(F, S[i]);
    }
    a0 += A; b0 += B; c0 += C; d0 += D;
  }

  void update(const uint8_t* data, size_t len) {
    total += len;
    while (len > 0) {
      size_t take = 64 - buflen;
      if (take > len) take = len;
      memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      len -= take;
      if (buflen == 64) { process(buf); buflen = 0; }
    }
  }

  void final(uint8_t out[16]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (buflen != 56) update(&z, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (8 * i));
    update(lenb, 8);
    uint32_t h[4] = {a0, b0, c0, d0};
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) out[i * 4 + j] = (uint8_t)(h[i] >> (8 * j));
  }
};

}  // namespace md5impl

// ---------------------------------------------------------------------------
// CRC8 (poly 0x07) and CRC16 (poly 0x8005) as used by FLAC frame headers
// ---------------------------------------------------------------------------
static uint8_t crc8(const uint8_t* data, size_t len) {
  uint8_t crc = 0;
  for (size_t i = 0; i < len; i++) {
    crc ^= data[i];
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
  }
  return crc;
}

static uint16_t crc16(const uint8_t* data, size_t len) {
  uint16_t crc = 0;
  for (size_t i = 0; i < len; i++) {
    crc ^= (uint16_t)data[i] << 8;
    for (int b = 0; b < 8; b++)
      crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005) : (uint16_t)(crc << 1);
  }
  return crc;
}

// ---------------------------------------------------------------------------
// Bit reader (MSB first)
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t bytepos = 0;
  int bitpos = 0;  // 0..7, bits consumed in current byte
  bool error = false;

  BitReader(const uint8_t* d, size_t s) : data(d), size(s) {}

  bool eof() const { return bytepos >= size; }

  uint32_t read_bit() {
    if (bytepos >= size) { error = true; return 0; }
    uint32_t bit = (data[bytepos] >> (7 - bitpos)) & 1;
    if (++bitpos == 8) { bitpos = 0; bytepos++; }
    return bit;
  }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    // Fast path: byte-aligned whole bytes
    while (n >= 8 && bitpos == 0) {
      if (bytepos >= size) { error = true; return 0; }
      v = (v << 8) | data[bytepos++];
      n -= 8;
    }
    for (int i = 0; i < n; i++) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    if (n == 0) return 0;
    uint64_t v = read_bits(n);
    // Sign extend
    if (v & (1ULL << (n - 1))) v |= ~((1ULL << n) - 1);
    return (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!error && read_bit() == 0) q++;
    return q;
  }

  void align_byte() {
    if (bitpos != 0) { bitpos = 0; bytepos++; }
  }
};

// ---------------------------------------------------------------------------
// FLAC decoder
// ---------------------------------------------------------------------------
struct StreamInfo {
  uint32_t min_block = 0, max_block = 0;
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;
  uint8_t md5[16] = {0};
  bool has_md5 = false;
};

static const uint32_t kFlacSampleRates[12] = {0,     88200, 176400, 192000,
                                              8000,  16000, 22050,  24000,
                                              32000, 44100, 48000,  96000};

static bool decode_residual(BitReader& br, int order, uint32_t blocksize,
                            int64_t* out) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t partorder = (uint32_t)br.read_bits(4);
  uint32_t nparts = 1u << partorder;
  if (blocksize % nparts != 0) return false;
  uint32_t psize = blocksize >> partorder;
  if (psize <= (uint32_t)order && nparts == 1) return false;
  uint32_t idx = order;
  for (uint32_t p = 0; p < nparts; p++) {
    uint32_t count = psize - (p == 0 ? order : 0);
    uint32_t param = (uint32_t)br.read_bits(plen);
    if (param == escape) {
      uint32_t rawbits = (uint32_t)br.read_bits(5);
      for (uint32_t i = 0; i < count; i++)
        out[idx++] = rawbits ? br.read_signed((int)rawbits) : 0;
    } else {
      for (uint32_t i = 0; i < count; i++) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits((int)param);
        uint64_t v = ((uint64_t)q << param) | r;
        out[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      }
    }
    if (br.error) return false;
  }
  return idx == blocksize;
}

static bool decode_subframe(BitReader& br, uint32_t blocksize, int bps,
                            std::vector<int64_t>& out) {
  out.assign(blocksize, 0);
  if (br.read_bit() != 0) return false;  // padding bit must be 0
  uint32_t type = (uint32_t)br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) wasted = 1 + (int)br.read_unary();
  int ebps = bps - wasted;

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(ebps);
    for (uint32_t i = 0; i < blocksize; i++) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < blocksize; i++) out[i] = br.read_signed(ebps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    int order = type & 0x07;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(ebps);
    if (!decode_residual(br, order, blocksize, out.data())) return false;
    for (uint32_t i = order; i < blocksize; i++) {
      switch (order) {
        case 0: break;
        case 1: out[i] += out[i - 1]; break;
        case 2: out[i] += 2 * out[i - 1] - out[i - 2]; break;
        case 3: out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4:
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
          break;
      }
    }
  } else if (type & 0x20) {  // LPC
    int order = (int)(type & 0x1F) + 1;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(ebps);
    int prec = (int)br.read_bits(4) + 1;
    if (prec == 16) return false;  // 0b1111 invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; i++) coef[i] = br.read_signed(prec);
    if (!decode_residual(br, order, blocksize, out.data())) return false;
    for (uint32_t i = (uint32_t)order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int j = 0; j < order; j++) pred += coef[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;  // reserved
  }

  if (wasted)
    for (uint32_t i = 0; i < blocksize; i++) out[i] <<= wasted;
  return !br.error;
}

static bool read_utf8_number(BitReader& br, uint64_t* out) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) { v = b0; extra = 0; }
  else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
  else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
  else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
  else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
  else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
  else if (b0 == 0xFE) { v = 0; extra = 6; }
  else return false;
  for (int i = 0; i < extra; i++) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

// Decodes a whole FLAC stream into interleaved float32 in [-1, 1).
static bool decode_flac(const uint8_t* data, size_t size,
                        std::vector<float>* out, int64_t* frames,
                        int32_t* channels, int32_t* rate, int32_t* md5_ok,
                        std::string* err) {
  if (size < 42 || memcmp(data, "fLaC", 4) != 0) {
    *err = "not a FLAC stream";
    return false;
  }
  size_t pos = 4;
  StreamInfo si;
  bool last = false, have_si = false;
  while (!last && pos + 4 <= size) {
    uint8_t hdr = data[pos];
    last = hdr & 0x80;
    int type = hdr & 0x7F;
    uint32_t blen = ((uint32_t)data[pos + 1] << 16) |
                    ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + blen > size) { *err = "truncated metadata"; return false; }
    if (type == 0 && blen >= 34) {
      const uint8_t* p = data + pos;
      si.min_block = ((uint32_t)p[0] << 8) | p[1];
      si.max_block = ((uint32_t)p[2] << 8) | p[3];
      si.sample_rate = ((uint32_t)p[10] << 12) | ((uint32_t)p[11] << 4) | (p[12] >> 4);
      si.channels = ((p[12] >> 1) & 0x07) + 1;
      si.bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si.total_samples = ((uint64_t)(p[13] & 0x0F) << 32) | ((uint64_t)p[14] << 24) |
                         ((uint64_t)p[15] << 16) | ((uint64_t)p[16] << 8) | p[17];
      memcpy(si.md5, p + 18, 16);
      for (int i = 0; i < 16; i++)
        if (si.md5[i]) { si.has_md5 = true; break; }
      have_si = true;
    }
    pos += blen;
  }
  if (!have_si || si.sample_rate == 0) { *err = "missing STREAMINFO"; return false; }

  *channels = (int32_t)si.channels;
  *rate = (int32_t)si.sample_rate;

  md5impl::MD5 md5;
  std::vector<std::vector<int64_t>> chan(si.channels);
  std::vector<int64_t> sub;
  out->clear();
  if (si.total_samples) out->reserve((size_t)si.total_samples * si.channels);
  int bytes_per_sample = (int)((si.bps + 7) / 8);
  std::vector<uint8_t> md5buf;

  BitReader br(data, size);
  br.bytepos = pos;

  uint64_t total = 0;
  while (br.bytepos < size) {
    // Frame sync
    size_t frame_start = br.bytepos;
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) { *err = "lost frame sync"; return false; }
    br.read_bit();  // reserved
    br.read_bit();  // blocking strategy
    uint32_t bs_code = (uint32_t)br.read_bits(4);
    uint32_t sr_code = (uint32_t)br.read_bits(4);
    uint32_t ch_code = (uint32_t)br.read_bits(4);
    uint32_t ss_code = (uint32_t)br.read_bits(3);
    br.read_bit();  // reserved
    uint64_t framenum;
    if (!read_utf8_number(br, &framenum)) { *err = "bad frame number"; return false; }

    uint32_t blocksize;
    if (bs_code == 1) blocksize = 192;
    else if (bs_code >= 2 && bs_code <= 5) blocksize = 576u << (bs_code - 2);
    else if (bs_code == 6) blocksize = (uint32_t)br.read_bits(8) + 1;
    else if (bs_code == 7) blocksize = (uint32_t)br.read_bits(16) + 1;
    else if (bs_code >= 8) blocksize = 256u << (bs_code - 8);
    else { *err = "reserved blocksize"; return false; }

    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    else if (sr_code == 15) { *err = "invalid sample-rate code"; return false; }

    static const int ss_table[8] = {0, 8, 12, 0, 16, 20, 24, 32};
    int bps = ss_code == 0 ? (int)si.bps : ss_table[ss_code];
    if (bps == 0) { *err = "reserved sample size"; return false; }

    // CRC8 check over the header bytes
    size_t hdr_end = br.bytepos;  // byte-aligned here (header is whole bytes)
    uint8_t hcrc = (uint8_t)br.read_bits(8);
    if (crc8(data + frame_start, hdr_end - frame_start) != hcrc) {
      *err = "frame header CRC mismatch";
      return false;
    }

    uint32_t nch;
    bool left_side = false, right_side = false, mid_side = false;
    if (ch_code <= 7) nch = ch_code + 1;
    else if (ch_code == 8) { nch = 2; left_side = true; }
    else if (ch_code == 9) { nch = 2; right_side = true; }
    else if (ch_code == 10) { nch = 2; mid_side = true; }
    else { *err = "reserved channel assignment"; return false; }
    if (nch != si.channels) { *err = "channel count change unsupported"; return false; }

    for (uint32_t c = 0; c < nch; c++) {
      int sub_bps = bps;
      if ((left_side && c == 1) || (right_side && c == 0) || (mid_side && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, blocksize, sub_bps, sub)) {
        *err = "subframe decode failed";
        return false;
      }
      chan[c] = sub;
    }
    br.align_byte();
    size_t frame_body_end = br.bytepos;
    uint16_t fcrc = (uint16_t)br.read_bits(16);
    if (crc16(data + frame_start, frame_body_end - frame_start) != fcrc) {
      *err = "frame CRC16 mismatch";
      return false;
    }

    // Undo channel decorrelation
    if (left_side) {
      for (uint32_t i = 0; i < blocksize; i++) chan[1][i] = chan[0][i] - chan[1][i];
    } else if (right_side) {
      for (uint32_t i = 0; i < blocksize; i++) chan[0][i] = chan[0][i] + chan[1][i];
    } else if (mid_side) {
      for (uint32_t i = 0; i < blocksize; i++) {
        int64_t side = chan[1][i];
        int64_t mid = (chan[0][i] << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }

    // Interleave, scale to float, and feed MD5 (little-endian raw samples)
    double scale = 1.0 / (double)(1LL << (si.bps - 1));
    md5buf.resize((size_t)blocksize * nch * bytes_per_sample);
    size_t mb = 0;
    for (uint32_t i = 0; i < blocksize; i++) {
      for (uint32_t c = 0; c < nch; c++) {
        int64_t s = chan[c][i];
        out->push_back((float)(s * scale));
        for (int b = 0; b < bytes_per_sample; b++) md5buf[mb++] = (uint8_t)(s >> (8 * b));
      }
    }
    md5.update(md5buf.data(), mb);
    total += blocksize;
    if (si.total_samples && total >= si.total_samples) break;
  }

  // Trim trailing padding frames beyond STREAMINFO's declared total
  if (si.total_samples && total > si.total_samples) {
    out->resize((size_t)si.total_samples * si.channels);
    total = si.total_samples;
  }
  *frames = (int64_t)total;

  if (si.has_md5 && (!si.total_samples || total == si.total_samples)) {
    uint8_t digest[16];
    md5.final(digest);
    *md5_ok = memcmp(digest, si.md5, 16) == 0 ? 1 : 0;
  } else {
    *md5_ok = -1;  // unknown (no md5 in header or partial decode)
  }
  return true;
}

// ---------------------------------------------------------------------------
// FLAC encoder (fixed predictors, rice coding)
// ---------------------------------------------------------------------------
struct BitWriter {
  std::vector<uint8_t> bytes;
  uint64_t acc = 0;
  int nbits = 0;

  void write_bits(uint64_t v, int n) {
    if (n == 0) return;
    acc = (acc << n) | (v & ((n == 64) ? ~0ULL : ((1ULL << n) - 1)));
    nbits += n;
    while (nbits >= 8) {
      bytes.push_back((uint8_t)(acc >> (nbits - 8)));
      nbits -= 8;
    }
  }
  void write_unary(uint32_t q) {
    while (q >= 32) { write_bits(0, 32); q -= 32; }
    write_bits(1, (int)q + 1);
  }
  void align() { if (nbits) write_bits(0, 8 - nbits); }
};

static void write_utf8_number(BitWriter& bw, uint64_t v) {
  if (v < 0x80) { bw.write_bits(v, 8); return; }
  int extra;
  if (v < 0x800) extra = 1;
  else if (v < 0x10000) extra = 2;
  else if (v < 0x200000) extra = 3;
  else if (v < 0x4000000) extra = 4;
  else if (v < 0x80000000ULL) extra = 5;
  else extra = 6;
  static const uint32_t lead[7] = {0, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE};
  bw.write_bits(lead[extra] | (uint32_t)(v >> (6 * extra)), 8);
  for (int i = extra - 1; i >= 0; i--)
    bw.write_bits(0x80 | ((v >> (6 * i)) & 0x3F), 8);
}

static int best_rice_param(const int64_t* res, uint32_t n) {
  if (n == 0) return 0;
  uint64_t sum = 0;
  for (uint32_t i = 0; i < n; i++) {
    int64_t v = res[i];
    sum += (uint64_t)((v << 1) ^ (v >> 63));
  }
  double mean = (double)sum / n;
  int k = 0;
  while (k < 14 && (1ULL << (k + 1)) < (uint64_t)(mean + 1)) k++;
  return k;
}

static void encode_residual(BitWriter& bw, const int64_t* res, uint32_t n) {
  bw.write_bits(0, 2);  // method 0: 4-bit rice
  bw.write_bits(0, 4);  // partition order 0
  int k = best_rice_param(res, n);
  bw.write_bits((uint32_t)k, 4);
  for (uint32_t i = 0; i < n; i++) {
    int64_t v = res[i];
    uint64_t u = (uint64_t)((v << 1) ^ (v >> 63));
    bw.write_unary((uint32_t)(u >> k));
    bw.write_bits(u, k);
  }
}

static bool encode_flac(const char* path, const float* pcm, int64_t frames,
                        int32_t channels, int32_t rate, int bps,
                        std::string* err) {
  const uint32_t BS = 4096;
  int64_t maxv = (1LL << (bps - 1)) - 1;
  int64_t minv = -(1LL << (bps - 1));
  int bytes_per_sample = (bps + 7) / 8;

  // Quantize all samples once (also feeds MD5)
  std::vector<int32_t> q((size_t)frames * channels);
  md5impl::MD5 md5;
  std::vector<uint8_t> md5buf((size_t)frames * channels * bytes_per_sample);
  size_t mb = 0;
  double scale = (double)(1LL << (bps - 1));
  for (size_t i = 0; i < (size_t)frames * channels; i++) {
    double v = pcm[i] * scale;
    int64_t s = (int64_t)(v >= 0 ? v + 0.5 : v - 0.5);
    if (s > maxv) s = maxv;
    if (s < minv) s = minv;
    q[i] = (int32_t)s;
    for (int b = 0; b < bytes_per_sample; b++) md5buf[mb++] = (uint8_t)(s >> (8 * b));
  }
  md5.update(md5buf.data(), mb);
  uint8_t digest[16];
  md5.final(digest);

  std::vector<uint8_t> stream;
  stream.insert(stream.end(), {'f', 'L', 'a', 'C'});
  // STREAMINFO (last metadata block)
  uint8_t si[38];
  si[0] = 0x80;  // last-block flag, type 0
  si[1] = 0; si[2] = 0; si[3] = 34;
  uint8_t* p = si + 4;
  p[0] = (uint8_t)(BS >> 8); p[1] = (uint8_t)BS;       // min block
  p[2] = (uint8_t)(BS >> 8); p[3] = (uint8_t)BS;       // max block
  p[4] = p[5] = p[6] = 0;                              // min frame size (unknown)
  p[7] = p[8] = p[9] = 0;                              // max frame size (unknown)
  p[10] = (uint8_t)(rate >> 12);
  p[11] = (uint8_t)(rate >> 4);
  p[12] = (uint8_t)(((rate & 0x0F) << 4) | (((channels - 1) & 0x07) << 1) |
                    (((bps - 1) >> 4) & 1));
  p[13] = (uint8_t)((((bps - 1) & 0x0F) << 4) | ((frames >> 32) & 0x0F));
  p[14] = (uint8_t)(frames >> 24);
  p[15] = (uint8_t)(frames >> 16);
  p[16] = (uint8_t)(frames >> 8);
  p[17] = (uint8_t)frames;
  memcpy(p + 18, digest, 16);
  stream.insert(stream.end(), si, si + 38);

  std::vector<int64_t> ch(BS), res(BS);
  uint64_t framenum = 0;
  for (int64_t start = 0; start < frames; start += BS, framenum++) {
    uint32_t n = (uint32_t)((frames - start) < BS ? (frames - start) : BS);
    BitWriter bw;
    bw.write_bits(0x3FFE, 14);  // sync
    bw.write_bits(0, 1);        // reserved
    bw.write_bits(0, 1);        // fixed blocksize strategy
    bw.write_bits(n == BS ? 12 : 7, 4);  // 4096 = 256<<4 -> code 12; else 16-bit
    bw.write_bits(0, 4);        // sample rate: from STREAMINFO
    bw.write_bits((uint32_t)(channels - 1), 4);  // independent channels
    bw.write_bits(bps == 16 ? 4 : (bps == 24 ? 6 : (bps == 8 ? 1 : 0)), 3);
    bw.write_bits(0, 1);        // reserved
    write_utf8_number(bw, framenum);
    if (n != BS) bw.write_bits(n - 1, 16);
    // header CRC8
    uint8_t hcrc = crc8(bw.bytes.data(), bw.bytes.size());
    bw.write_bits(hcrc, 8);

    for (int32_t c = 0; c < channels; c++) {
      for (uint32_t i = 0; i < n; i++) ch[i] = q[(size_t)(start + i) * channels + c];
      // pick best fixed order by residual magnitude
      int best_order = 0;
      uint64_t best_cost = ~0ULL;
      for (int order = 0; order <= 4 && (uint32_t)order < n; order++) {
        uint64_t cost = 0;
        for (uint32_t i = order; i < n; i++) {
          int64_t r = ch[i];
          switch (order) {
            case 1: r -= ch[i - 1]; break;
            case 2: r -= 2 * ch[i - 1] - ch[i - 2]; break;
            case 3: r -= 3 * ch[i - 1] - 3 * ch[i - 2] + ch[i - 3]; break;
            case 4: r -= 4 * ch[i - 1] - 6 * ch[i - 2] + 4 * ch[i - 3] - ch[i - 4]; break;
          }
          cost += (uint64_t)(r < 0 ? -r : r);
          if (cost > best_cost) break;
        }
        if (cost < best_cost) { best_cost = cost; best_order = order; }
      }
      int order = best_order;
      for (uint32_t i = 0; i < n; i++) {
        int64_t r = ch[i];
        if (i >= (uint32_t)order) {
          switch (order) {
            case 1: r -= ch[i - 1]; break;
            case 2: r -= 2 * ch[i - 1] - ch[i - 2]; break;
            case 3: r -= 3 * ch[i - 1] - 3 * ch[i - 2] + ch[i - 3]; break;
            case 4: r -= 4 * ch[i - 1] - 6 * ch[i - 2] + 4 * ch[i - 3] - ch[i - 4]; break;
          }
        }
        res[i] = r;
      }
      bw.write_bits(0, 1);                    // padding
      bw.write_bits(0x08 | order, 6);         // FIXED subframe
      bw.write_bits(0, 1);                    // no wasted bits
      for (int i = 0; i < order; i++) bw.write_bits((uint64_t)res[i], bps);
      encode_residual(bw, res.data() + order, n - order);
    }
    bw.align();
    uint16_t fcrc = crc16(bw.bytes.data(), bw.bytes.size());
    bw.write_bits(fcrc, 16);
    stream.insert(stream.end(), bw.bytes.begin(), bw.bytes.end());
  }

  FILE* f = fopen(path, "wb");
  if (!f) { *err = "cannot open output file"; return false; }
  size_t w = fwrite(stream.data(), 1, stream.size(), f);
  fclose(f);
  if (w != stream.size()) { *err = "short write"; return false; }
  return true;
}

// ---------------------------------------------------------------------------
// WAV reader / writer
// ---------------------------------------------------------------------------
static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

static bool decode_wav(const uint8_t* data, size_t size, std::vector<float>* out,
                       int64_t* frames, int32_t* channels, int32_t* rate,
                       std::string* err) {
  if (size < 44 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0) {
    *err = "not a WAV file";
    return false;
  }
  size_t pos = 12;
  uint16_t fmt = 0, nch = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* pcm = nullptr;
  uint32_t pcm_len = 0;
  while (pos + 8 <= size) {
    uint32_t clen = rd_u32(data + pos + 4);
    if (memcmp(data + pos, "fmt ", 4) == 0 && clen >= 16) {
      const uint8_t* f = data + pos + 8;
      fmt = rd_u16(f);
      nch = rd_u16(f + 2);
      sr = rd_u32(f + 4);
      bits = rd_u16(f + 14);
      if (fmt == 0xFFFE && clen >= 40) fmt = rd_u16(f + 24);  // WAVE_FORMAT_EXTENSIBLE
    } else if (memcmp(data + pos, "data", 4) == 0) {
      pcm = data + pos + 8;
      pcm_len = clen;
      if (pos + 8 + pcm_len > size) pcm_len = (uint32_t)(size - pos - 8);
    }
    pos += 8 + clen + (clen & 1);
  }
  if (!pcm || nch == 0 || sr == 0) { *err = "missing fmt/data chunk"; return false; }

  size_t bytes_per = bits / 8;
  size_t total = pcm_len / (bytes_per * nch);
  out->resize(total * nch);
  if (fmt == 1) {  // PCM
    if (bits == 16) {
      for (size_t i = 0; i < total * nch; i++)
        (*out)[i] = (float)((int16_t)rd_u16(pcm + i * 2)) / 32768.0f;
    } else if (bits == 8) {
      for (size_t i = 0; i < total * nch; i++)
        (*out)[i] = ((float)pcm[i] - 128.0f) / 128.0f;
    } else if (bits == 24) {
      for (size_t i = 0; i < total * nch; i++) {
        int32_t v = (int32_t)((uint32_t)pcm[i * 3] << 8 | (uint32_t)pcm[i * 3 + 1] << 16 |
                              (uint32_t)pcm[i * 3 + 2] << 24) >> 8;
        (*out)[i] = (float)v / 8388608.0f;
      }
    } else if (bits == 32) {
      for (size_t i = 0; i < total * nch; i++)
        (*out)[i] = (float)(int32_t)rd_u32(pcm + i * 4) / 2147483648.0f;
    } else {
      *err = "unsupported PCM bit depth";
      return false;
    }
  } else if (fmt == 3 && bits == 32) {  // IEEE float
    memcpy(out->data(), pcm, total * nch * 4);
  } else {
    *err = "unsupported WAV format";
    return false;
  }
  *frames = (int64_t)total;
  *channels = nch;
  *rate = (int32_t)sr;
  return true;
}

static bool encode_wav(const char* path, const float* pcm, int64_t frames,
                       int32_t channels, int32_t rate, int bits, std::string* err) {
  if (bits != 16) { *err = "only 16-bit WAV write supported"; return false; }
  uint32_t data_len = (uint32_t)(frames * channels * 2);
  std::vector<uint8_t> hdr(44);
  memcpy(&hdr[0], "RIFF", 4);
  uint32_t riff_len = 36 + data_len;
  memcpy(&hdr[4], &riff_len, 4);
  memcpy(&hdr[8], "WAVEfmt ", 8);
  uint32_t fmt_len = 16;
  memcpy(&hdr[16], &fmt_len, 4);
  uint16_t fmt = 1, nch = (uint16_t)channels, align = (uint16_t)(channels * 2), b = 16;
  uint32_t sr = (uint32_t)rate, byterate = sr * align;
  memcpy(&hdr[20], &fmt, 2);
  memcpy(&hdr[22], &nch, 2);
  memcpy(&hdr[24], &sr, 4);
  memcpy(&hdr[28], &byterate, 4);
  memcpy(&hdr[32], &align, 2);
  memcpy(&hdr[34], &b, 2);
  memcpy(&hdr[36], "data", 4);
  memcpy(&hdr[40], &data_len, 4);

  FILE* f = fopen(path, "wb");
  if (!f) { *err = "cannot open output file"; return false; }
  fwrite(hdr.data(), 1, 44, f);
  std::vector<int16_t> buf((size_t)frames * channels);
  for (size_t i = 0; i < buf.size(); i++) {
    double v = pcm[i] * 32768.0;
    int64_t s = (int64_t)(v >= 0 ? v + 0.5 : v - 0.5);
    if (s > 32767) s = 32767;
    if (s < -32768) s = -32768;
    buf[i] = (int16_t)s;
  }
  fwrite(buf.data(), 2, buf.size(), f);
  fclose(f);
  return true;
}

// ---------------------------------------------------------------------------
// MP3 (MPEG-1/2/2.5 Layer III) — decode via the operating system's codec
// library (libmpg123), loaded lazily with dlopen.
//
// Design note: FLAC and WAV above are implemented from scratch because the
// framework owns those formats end to end (encode + decode + integrity).
// For MP3 the reference's own path is librosa -> audioread -> a *system
// codec* (reference utils.py:14-52 never decodes MP3 itself), so the
// faithful native equivalent is to bind the system codec at this layer:
// same architecture, one dependency owned by the OS, and a fail-fast error
// at the file boundary when the codec is absent.  Decoded output is
// validated in tests against an independent second decoder (SDL_mixer's).
// ---------------------------------------------------------------------------
#include <dlfcn.h>

namespace mp3impl {

// libmpg123 ABI subset (stable since API version 25+).
using new_fn = void* (*)(const char*, int*);
using init_fn = int (*)();
using open_feed_fn = int (*)(void*);
using feed_fn = int (*)(void*, const unsigned char*, size_t);
using getformat_fn = int (*)(void*, long*, int*, int*);
using param_fn = int (*)(void*, int, long, double);
using read_fn = int (*)(void*, unsigned char*, size_t, size_t*);
using close_fn = int (*)(void*);
using delete_fn = void (*)(void*);

constexpr int MPG123_ADD_FLAGS = 2;
constexpr long MPG123_FORCE_FLOAT = 0x400;
constexpr long MPG123_QUIET = 0x20;
constexpr int MPG123_ENC_FLOAT_32 = 0x200;
constexpr int MPG123_OK = 0;
constexpr int MPG123_NEED_MORE = -10;
constexpr int MPG123_NEW_FORMAT = -11;
constexpr int MPG123_DONE = -12;

struct Lib {
  void* handle = nullptr;
  init_fn init{};
  new_fn make{};
  open_feed_fn open_feed{};
  feed_fn feed{};
  getformat_fn getformat{};
  param_fn param{};
  read_fn read{};
  close_fn close{};
  delete_fn del{};
  bool ok = false;
};

static const Lib& lib() {
  static Lib L = [] {
    Lib l;
    l.handle = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!l.handle) l.handle = dlopen("libmpg123.so", RTLD_NOW | RTLD_LOCAL);
    if (!l.handle) return l;
    l.init = (init_fn)dlsym(l.handle, "mpg123_init");
    l.make = (new_fn)dlsym(l.handle, "mpg123_new");
    l.open_feed = (open_feed_fn)dlsym(l.handle, "mpg123_open_feed");
    l.feed = (feed_fn)dlsym(l.handle, "mpg123_feed");
    l.getformat = (getformat_fn)dlsym(l.handle, "mpg123_getformat");
    l.param = (param_fn)dlsym(l.handle, "mpg123_param");
    l.read = (read_fn)dlsym(l.handle, "mpg123_read");
    l.close = (close_fn)dlsym(l.handle, "mpg123_close");
    l.del = (delete_fn)dlsym(l.handle, "mpg123_delete");
    l.ok = l.init && l.make && l.open_feed && l.feed && l.getformat &&
           l.param && l.read && l.close && l.del;
    if (l.ok) l.init();
    return l;
  }();
  return L;
}

// Looks like an MP3 stream: ID3v2 tag, or an MPEG audio frame sync whose
// header declares Layer III.
static bool looks_like_mp3(const uint8_t* d, size_t n) {
  if (n >= 3 && d[0] == 'I' && d[1] == 'D' && d[2] == '3') return true;
  if (n >= 2 && d[0] == 0xFF && (d[1] & 0xE0) == 0xE0) {
    int layer = (d[1] >> 1) & 0x3;  // 01 = Layer III
    return layer == 0x1;
  }
  return false;
}

static bool decode_mp3(const uint8_t* data, size_t size,
                       std::vector<float>* out, int64_t* frames,
                       int32_t* channels, int32_t* rate, std::string* msg) {
  const Lib& L = lib();
  if (!L.ok) {
    *msg = "MP3 decode requires the system codec library (libmpg123); "
           "it is not available on this host";
    return false;
  }
  int err = 0;
  void* h = L.make(nullptr, &err);
  if (!h) { *msg = "mpg123_new failed"; return false; }
  L.param(h, MPG123_ADD_FLAGS, MPG123_FORCE_FLOAT | MPG123_QUIET, 0.0);
  if (L.open_feed(h) != MPG123_OK) {
    L.del(h);
    *msg = "mpg123_open_feed failed";
    return false;
  }
  // Feeding the whole buffer up front keeps this path in-memory like the
  // FLAC/WAV decoders (no second pass over the file).
  if (L.feed(h, data, size) != MPG123_OK) {
    L.close(h); L.del(h);
    *msg = "mpg123_feed failed";
    return false;
  }

  long out_rate = 0;
  int ch = 0, enc = 0;
  std::vector<uint8_t> buf(1 << 16);
  size_t done = 0;
  bool got_format = false, got_audio = false;
  out->clear();
  for (;;) {
    int rc = L.read(h, buf.data(), buf.size(), &done);
    if (done > 0) {
      if (!got_format) {
        L.close(h); L.del(h);
        *msg = "MP3 decoder produced audio before reporting a format";
        return false;
      }
      const float* f = (const float*)buf.data();
      out->insert(out->end(), f, f + done / sizeof(float));
      got_audio = true;
    }
    if (rc == MPG123_NEW_FORMAT) {
      long r2; int c2, e2;
      L.getformat(h, &r2, &c2, &e2);
      if (e2 != MPG123_ENC_FLOAT_32) {
        L.close(h); L.del(h);
        *msg = "MP3 decoder did not honor float output";
        return false;
      }
      if (got_format && (r2 != out_rate || c2 != ch)) {
        L.close(h); L.del(h);
        *msg = "MP3 stream changes format mid-file (unsupported)";
        return false;
      }
      out_rate = r2; ch = c2; enc = e2; got_format = true;
      continue;
    }
    if (rc == MPG123_NEED_MORE || rc == MPG123_DONE) break;  // buffer drained
    if (rc != MPG123_OK) {
      L.close(h); L.del(h);
      *msg = "MP3 decode error (rc=" + std::to_string(rc) + ")";
      return false;
    }
  }
  L.close(h);
  L.del(h);
  (void)enc;
  if (!got_format || !got_audio || ch <= 0 || out_rate <= 0) {
    *msg = "no decodable MPEG audio frames found";
    return false;
  }
  *channels = (int32_t)ch;
  *rate = (int32_t)out_rate;
  *frames = (int64_t)(out->size() / (size_t)ch);
  return true;
}

}  // namespace mp3impl

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
static void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

extern "C" {

// Reads a FLAC or WAV file; returns interleaved float32.  Returns 0 on
// success.  md5_ok: 1 = FLAC MD5 verified, 0 = mismatch, -1 = n/a.
int mai_read_audio(const char* path, float** out_data, int64_t* out_frames,
                   int32_t* out_channels, int32_t* out_rate, int32_t* md5_ok,
                   char* err, int errlen) {
  *out_data = nullptr;
  *md5_ok = -1;
  FILE* f = fopen(path, "rb");
  if (!f) { set_err(err, errlen, "cannot open file"); return 1; }
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize <= 0) { fclose(f); set_err(err, errlen, "empty file"); return 1; }
  std::vector<uint8_t> data((size_t)fsize);
  if (fread(data.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    set_err(err, errlen, "short read");
    return 1;
  }
  fclose(f);

  std::vector<float> samples;
  std::string msg;
  bool ok;
  if (fsize >= 4 && memcmp(data.data(), "fLaC", 4) == 0)
    ok = decode_flac(data.data(), data.size(), &samples, out_frames,
                     out_channels, out_rate, md5_ok, &msg);
  else if (mp3impl::looks_like_mp3(data.data(), data.size()))
    ok = mp3impl::decode_mp3(data.data(), data.size(), &samples, out_frames,
                             out_channels, out_rate, &msg);
  else
    ok = decode_wav(data.data(), data.size(), &samples, out_frames,
                    out_channels, out_rate, &msg);
  if (!ok) { set_err(err, errlen, msg); return 1; }

  float* buf = (float*)malloc(samples.size() * sizeof(float));
  if (!buf) { set_err(err, errlen, "out of memory"); return 1; }
  memcpy(buf, samples.data(), samples.size() * sizeof(float));
  *out_data = buf;
  return 0;
}

int mai_write_audio(const char* path, const float* data, int64_t frames,
                    int32_t channels, int32_t rate, int32_t bits,
                    int32_t format,  // 0 = flac, 1 = wav
                    char* err, int errlen) {
  std::string msg;
  bool ok = format == 1 ? encode_wav(path, data, frames, channels, rate, bits, &msg)
                        : encode_flac(path, data, frames, channels, rate, bits, &msg);
  if (!ok) { set_err(err, errlen, msg); return 1; }
  return 0;
}

void mai_free(void* p) { free(p); }

}  // extern "C"
