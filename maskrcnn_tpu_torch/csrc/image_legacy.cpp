// The last of Pillow's plugins that decode on a host without Ghostscript,
// decoded natively to RGB uint8: the pixels
// np.asarray(PIL.Image.open(f).convert("RGB")) gives with Pillow 12.1 for
// IM, SPIDER, FITS, MCIDAS, IMT, XVTHUMB, PIXAR, GBR, FTEX (raw RGB), XBM,
// XPM, MSP, FLI/FLC and PCD (IPTC's image goes through the PPM and JPEG
// routes, FTEX's DXT1 through bcn_decode.cpp).
//
// * mrt_raw_tiles: Pillow's raw decoder (RawDecode.c: rows of a raw mode
//   from a tile's offset, a stride between rows where one is given,
//   bottom-up where the tile's ystep is negative, an error where the data
//   runs out or the stride is shorter than a row) and its bit decoder
//   (BitDecode.c, IM's "L*n" floats of 2 to 31 bits) into an image of
//   Pillow's mode, through Unpack.c's unpackers of every raw mode these
//   plugins name (1, L, P, P;2, P;4, LA;L, PA;L, RGB, RGB;L, RGBX;L, RGBA,
//   RGBA;L, CMYK;L, YCbCr;L, the R, G and B bands, I, I;32, I;32S, I;32B,
//   F, F;8, F;8S, F;16, F;16S, F;32, F;32S, F;32F, F;32BF, I;16, I;16L,
//   I;16B); then Convert.c's convert("RGB") from that mode ("1", L, P and
//   PA through the palette, black past its entries, LA, RGB(A), CMYK
//   through cmyk2rgb, YCbCr through ConvertYCbCr.c's tables, I and the
//   16-bit modes clipped, F truncated and clipped as F -> L does).
// * mrt_xbm: XbmDecode.c (the two hex digits after each 'x', rows of
//   "1;R" bits, LSB first).
// * mrt_xpm: XpmImagePlugin's Python XpmDecoder (lines from the tile's
//   offset, the "/* pixels */" line skipped once, the text between a
//   line's first and last quote cut into keys of bpp bytes, each looked up
//   in the colour table; every key of a line looked up, lines read until
//   the image's pixels are there; set_as_raw's "not enough image data").
// * mrt_msp: MspImagePlugin's MspDecoder (version 2: the row map, each
//   row's runs, the rows' bytes joined and read as "1" rows).
// * mrt_fli: FliDecode.c over the first frame as ImageFile.load feeds it
//   (blocks of the frame's size; its BLACK, BRUN, COPY, LC and SS2 chunks,
//   COLOR and PSTAMP ignored, any other chunk an error).
// * mrt_pcd: PcdDecode.c over the 768x512 base image (two lines of Y and
//   their Cb and Cr a chunk) and Unpack.c's "YCC;P" PhotoYCC -> RGB.
// * mrt_fits_gzip: FitsImagePlugin's FitsGzipDecoder (Python's
//   gzip.decompress through image_decode.cpp's inflate, the low bytes of
//   each 4-byte value, the rows bottom-up, set_as_raw of its mode).
//
// Host C++17, compiled into the image library with image_decode.cpp
// (maskrcnn_tpu_torch/data/native_image.py reads the headers, as
// data/image_probe.py models each plugin's _open, and calls these once a
// decode, outside the GIL). Entry points return 0, or 1 (what Pillow
// fails on: ValueError) with a message.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "image_codec.h"

namespace {

using mrt::corrupt;
using mrt::guarded;

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
inline uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

// Pillow's modes as native_image.LEGACY_MODES numbers them
enum Mode { k1, kL, kP, kLA, kPA, kRGB, kRGBA, kCMYK, kYCbCr, kI, kF, kI16, kI16L, kI16B };

// Pillow's raw modes as native_image.RAWMODES numbers them
enum Raw {
  r1, r1R, rL, rP, rP2, rP4, rLAL, rPAL, rRGB, rRGBL, rRGBXL, rRGBA, rRGBAL, rCMYKL, rYCbCrL,
  rR, rG, rB, rI, rI32, rI32S, rI32B, rF, rF8, rF8S, rF16, rF16S, rF32, rF32S, rF32F, rF32BF,
  rI16, rI16L, rI16B, rYCCP, kRaws
};

// bits a pixel of each raw mode (Unpack.c's table)
constexpr int kBits[kRaws] = {1,  1,  8,  8,  2,  4,  16, 16, 24, 24, 32, 32, 32, 32, 24, 8,  8, 8,
                              32, 32, 32, 32, 32, 8,  8,  16, 16, 32, 32, 32, 32, 16, 16, 16, 24};

// An image in Pillow's mode: a byte a pixel (1, L, P), four (LA and PA
// in bytes 0 and 3, RGB, RGBA, CMYK, YCbCr), an int32 (I), a float (F) or
// the 16-bit value (I;16, I;16L, I;16B), as Image.core.new leaves it
// (zeros).
struct Image {
  int mode;
  int64_t w, h;
  int ps;
  std::vector<uint8_t> px;
  Image(int m, int64_t width, int64_t height) : mode(m), w(width), h(height) {
    ps = (m == k1 || m == kL || m == kP) ? 1 : (m >= kI16 ? 2 : 4);
    px.assign(static_cast<size_t>(w * h * ps), 0);
  }
  uint8_t* row(int64_t y) { return px.data() + y * w * ps; }
};

inline void put_i32(uint8_t* o, int32_t v) { std::memcpy(o, &v, 4); }
inline void put_f32(uint8_t* o, float v) { std::memcpy(o, &v, 4); }
inline void put_u16(uint8_t* o, uint16_t v) { std::memcpy(o, &v, 2); }
inline float get_f32le(const uint8_t* p) {
  const uint32_t u = le32(p);
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// PhotoYCC -> RGB (Unpack.c's "YCC;P", UnpackYCC.c's tables)
struct PhotoYcc {
  int L[256], CR[256], CB[256], GR[256], GB[256];
  PhotoYcc() {
    for (int i = 0; i < 256; i++) {
      L[i] = static_cast<int>(1.3584 * i + 0.5);
      CR[i] = static_cast<int>(1.8215 * (i - 137) + 0.5);
      CB[i] = static_cast<int>(2.2179 * (i - 156) + 0.5);
      GR[i] = static_cast<int>(-0.9271435 * (i - 137) + 0.5);
      GB[i] = static_cast<int>(-0.4302726 * (i - 156) + 0.5);
    }
  }
};
const PhotoYcc& photo_ycc() {
  static const PhotoYcc t;
  return t;
}
inline uint8_t clip255(int v) { return static_cast<uint8_t>(v <= 0 ? 0 : (v >= 255 ? 255 : v)); }

// One row of `w` pixels of raw mode `raw` from `in` into `out` (a row of
// the image, Pillow's unpacker for the image's mode).
void unpack(int raw, uint8_t* out, const uint8_t* in, int64_t w) {
  switch (raw) {
    case r1:
    case r1R:
      for (int64_t x = 0; x < w; x++) {
        const int bit = raw == r1 ? 7 - (x & 7) : (x & 7);
        out[x] = (in[x >> 3] >> bit) & 1 ? 255 : 0;
      }
      return;
    case rL:
    case rP:
      std::memcpy(out, in, static_cast<size_t>(w));
      return;
    case rP2:
      for (int64_t x = 0; x < w; x++) out[x] = (in[x >> 2] >> (6 - 2 * (x & 3))) & 3;
      return;
    case rP4:
      for (int64_t x = 0; x < w; x++) out[x] = (in[x >> 1] >> (x & 1 ? 0 : 4)) & 15;
      return;
    case rLAL:
    case rPAL:
      for (int64_t x = 0; x < w; x++) {
        out[4 * x] = out[4 * x + 1] = out[4 * x + 2] = in[x];
        out[4 * x + 3] = in[x + w];
      }
      return;
    case rRGB:
      for (int64_t x = 0; x < w; x++) {
        std::memcpy(out + 4 * x, in + 3 * x, 3);
        out[4 * x + 3] = 255;
      }
      return;
    case rRGBA:
      std::memcpy(out, in, static_cast<size_t>(4 * w));
      return;
    case rRGBL:
    case rYCbCrL:
      for (int64_t x = 0; x < w; x++) {
        for (int k = 0; k < 3; k++) out[4 * x + k] = in[x + k * w];
        out[4 * x + 3] = 255;
      }
      return;
    case rRGBXL:
    case rRGBAL:
    case rCMYKL:
      for (int64_t x = 0; x < w; x++)
        for (int k = 0; k < 4; k++) out[4 * x + k] = in[x + k * w];
      return;
    case rR:
    case rG:
    case rB:
      for (int64_t x = 0; x < w; x++) out[4 * x + (raw - rR)] = in[x];
      return;
    case rI:
    case rI32:
    case rI32S:
      for (int64_t x = 0; x < w; x++) put_i32(out + 4 * x, static_cast<int32_t>(le32(in + 4 * x)));
      return;
    case rI32B:
      for (int64_t x = 0; x < w; x++) put_i32(out + 4 * x, static_cast<int32_t>(be32(in + 4 * x)));
      return;
    case rF:
    case rF32F:
      for (int64_t x = 0; x < w; x++) put_f32(out + 4 * x, get_f32le(in + 4 * x));
      return;
    case rF32BF:
      for (int64_t x = 0; x < w; x++) {
        const uint32_t u = be32(in + 4 * x);
        float f;
        std::memcpy(&f, &u, 4);
        put_f32(out + 4 * x, f);
      }
      return;
    case rF8:
      for (int64_t x = 0; x < w; x++) put_f32(out + 4 * x, static_cast<float>(in[x]));
      return;
    case rF8S:
      for (int64_t x = 0; x < w; x++) put_f32(out + 4 * x, static_cast<float>(static_cast<int8_t>(in[x])));
      return;
    case rF16:
      for (int64_t x = 0; x < w; x++) put_f32(out + 4 * x, static_cast<float>(le16(in + 2 * x)));
      return;
    case rF16S:
      for (int64_t x = 0; x < w; x++)
        put_f32(out + 4 * x, static_cast<float>(static_cast<int16_t>(le16(in + 2 * x))));
      return;
    case rF32:
      for (int64_t x = 0; x < w; x++) put_f32(out + 4 * x, static_cast<float>(le32(in + 4 * x)));
      return;
    case rF32S:
      for (int64_t x = 0; x < w; x++)
        put_f32(out + 4 * x, static_cast<float>(static_cast<int32_t>(le32(in + 4 * x))));
      return;
    case rI16:
    case rI16L:
      for (int64_t x = 0; x < w; x++) put_u16(out + 2 * x, static_cast<uint16_t>(le16(in + 2 * x)));
      return;
    case rI16B:
      for (int64_t x = 0; x < w; x++)
        put_u16(out + 2 * x, static_cast<uint16_t>((in[2 * x] << 8) | in[2 * x + 1]));
      return;
    case rYCCP: {
      const PhotoYcc& t = photo_ycc();
      for (int64_t x = 0; x < w; x++) {
        const int l = t.L[in[3 * x]], cb = in[3 * x + 1], cr = in[3 * x + 2];
        out[4 * x] = clip255(l + t.CR[cr]);
        out[4 * x + 1] = clip255(l + t.GR[cr] + t.GB[cb]);
        out[4 * x + 2] = clip255(l + t.CB[cb]);
        out[4 * x + 3] = 255;
      }
      return;
    }
    default:
      corrupt("unknown raw mode");
  }
}

// ConvertYCbCr.c's YCbCr -> RGB tables (SCALE 6)
struct YCbCrTables {
  int Rcr[256], Gcb[256], Gcr[256], Bcb[256];
  YCbCrTables() {
    for (int i = 0; i < 256; i++) {
      Rcr[i] = static_cast<int>(1.40200 * 64 * (i - 128) + 0.5);
      Gcb[i] = static_cast<int>(-0.34414 * 64 * (i - 128) + 0.5);
      Gcr[i] = static_cast<int>(-0.71414 * 64 * (i - 128) + 0.5);
      Bcb[i] = static_cast<int>(1.77200 * 64 * (i - 128) + 0.5);
    }
  }
};

// F -> L: the float truncated, clipped (NaN 0)
inline uint8_t float8(float f) {
  return static_cast<uint8_t>(f > 0 ? (f >= 255 ? 255 : static_cast<int>(f)) : 0);
}

// Convert.c's convert("RGB") of the image into out [h, w, 3]; palette:
// 256 RGB triples (P and PA)
void to_rgb(const Image& im, const uint8_t* palette, uint8_t* out) {
  const int64_t npix = im.w * im.h;
  const uint8_t* p = im.px.data();
  static const YCbCrTables ycc;
  for (int64_t i = 0; i < npix; i++, out += 3) {
    const uint8_t* q = p + i * im.ps;
    switch (im.mode) {
      case k1:
      case kL:
      case kLA:
        out[0] = out[1] = out[2] = q[0];
        break;
      case kP:
      case kPA:
        std::memcpy(out, palette + 3 * q[0], 3);
        break;
      case kRGB:
      case kRGBA:
        std::memcpy(out, q, 3);
        break;
      case kCMYK:
        mrt::cmyk_rgb(q, out);
        break;
      case kYCbCr: {
        const int y = q[0], cb = q[1], cr = q[2];
        out[0] = clip255(y + (ycc.Rcr[cr] >> 6));
        out[1] = clip255(y + ((ycc.Gcb[cb] + ycc.Gcr[cr]) >> 6));
        out[2] = clip255(y + (ycc.Bcb[cb] >> 6));
        break;
      }
      case kI: {
        int32_t v;
        std::memcpy(&v, q, 4);
        out[0] = out[1] = out[2] = static_cast<uint8_t>(v <= 0 ? 0 : (v >= 255 ? 255 : v));
        break;
      }
      case kF: {
        float f;
        std::memcpy(&f, q, 4);
        out[0] = out[1] = out[2] = float8(f);
        break;
      }
      default: {
        uint16_t v;
        std::memcpy(&v, q, 2);
        out[0] = out[1] = out[2] = static_cast<uint8_t>(v > 255 ? 255 : v);
      }
    }
  }
}

[[noreturn]] void truncated(const char* what) {
  corrupt(std::string(what) + ": image file is truncated");
}

// RawDecode.c over one tile, as ImageFile.load feeds it from `offset`
void raw_tile(const uint8_t* d, int64_t n, int64_t offset, int raw, int64_t stride, int64_t ystep,
              Image& im, const char* what) {
  if (raw < 0 || raw >= kRaws) corrupt("unknown raw mode");
  const int64_t bytes = (im.w * kBits[raw] + 7) / 8;
  int64_t skip = 0;
  if (offset < 0) corrupt(std::string(what) + ": a tile before the file's start");
  int64_t avail = offset < n ? n - offset : 0;
  if (stride) {
    skip = stride - bytes;
    if (avail && skip < 0) corrupt(std::string(what) + ": decoder error (a stride shorter than a row)");
  }
  const uint8_t* p = d + std::min(offset, n);
  for (int64_t r = 0; r < im.h; r++) {
    if (avail < bytes) truncated(what);
    unpack(raw, im.row(ystep < 0 ? im.h - 1 - r : r), p, im.w);
    p += bytes;
    avail -= bytes;
    if (r + 1 < im.h) {
      if (avail < skip) truncated(what);
      p += skip;
      avail -= skip;
    }
  }
}

// BitDecode.c over IM's "L*n" floats (n bits, pad 8, fill 3, unsigned,
// bottom-up)
void bit_tile(const uint8_t* d, int64_t n, int64_t offset, int bits, Image& im) {
  if (bits < 1 || bits >= 32) corrupt("IM: decoder error (bits)");
  const unsigned long mask = bits == 31 ? 0x7FFFFFFFul : (1ul << bits) - 1;
  unsigned long buffer = 0;
  int count = 0;
  int64_t x = 0, y = im.h - 1;
  for (int64_t pos = offset;; pos++) {
    if (pos < 0 || pos >= n) truncated("IM");
    const uint8_t byte = d[pos];
    buffer |= static_cast<unsigned long>(byte) << count;
    count += 8;
    while (count >= bits) {
      const unsigned long data = buffer & mask;
      if (count > 32)
        buffer = byte >> (8 - (count - bits));
      else
        buffer >>= bits;
      count -= bits;
      put_f32(im.row(y) + 4 * x, static_cast<float>(data));
      if (++x >= im.w) {
        if (--y < 0) return;
        x = 0;
        count = 0;
      }
    }
  }
}

inline int hex(uint8_t v) {
  return (v >= '0' && v <= '9') ? v - '0'
         : (v >= 'a' && v <= 'f') ? v - 'a' + 10
         : (v >= 'A' && v <= 'F') ? v - 'A' + 10
                                  : 0;
}

void xbm(const uint8_t* d, int64_t n, int64_t pos, Image& im) {
  const int64_t stride = (im.w + 7) / 8;
  std::vector<uint8_t> line(static_cast<size_t>(stride));
  int64_t x = 0, y = 0;
  for (;;) {
    while (pos < n && d[pos] != 'x') pos++;
    if (n - pos < 3) truncated("XBM");
    line[static_cast<size_t>(x)] = static_cast<uint8_t>((hex(d[pos + 1]) << 4) + hex(d[pos + 2]));
    if (++x >= stride) {
      unpack(r1R, im.row(y), line.data(), im.w);
      x = 0;
      if (++y >= im.h) return;
    }
    pos += 3;
  }
}

inline bool is_space(uint8_t c) { return c == ' ' || (c >= '\t' && c <= '\r'); }

// XpmDecoder: keys (their bytes), colours (RGB a key)
void xpm(const uint8_t* d, int64_t n, int64_t pos, int bpp, const std::vector<std::string>& keys,
         const uint8_t* colours, uint8_t* out, int64_t npix) {
  if (bpp <= 0) corrupt("XPM: range() arg 3 must not be zero");
  std::unordered_map<std::string, int> index;
  for (size_t i = 0; i < keys.size(); i++) index[keys[i]] = static_cast<int>(i);
  int64_t have = 0;
  bool header = false;
  while (have < npix && pos < n) {
    const uint8_t* nl = static_cast<const uint8_t*>(std::memchr(d + pos, '\n', static_cast<size_t>(n - pos)));
    const int64_t end = nl ? nl - d + 1 : n;
    const uint8_t* line = d + pos;
    const int64_t len = end - pos;
    pos = end;
    int64_t stripped = len;
    while (stripped > 0 && is_space(line[stripped - 1])) stripped--;
    if (!header && stripped == 12 && std::memcmp(line, "/* pixels */", 12) == 0) {
      header = true;
      continue;
    }
    const uint8_t* first = static_cast<const uint8_t*>(std::memchr(line, '"', static_cast<size_t>(len)));
    if (!first) continue;
    const uint8_t* last = line + len - 1;
    while (last > first && *last != '"') last--;
    if (last == first) continue;
    const int64_t text = last - first - 1;
    for (int64_t k = 0; k < text; k += bpp) {
      const std::string key(reinterpret_cast<const char*>(first + 1 + k),
                            static_cast<size_t>(std::min<int64_t>(bpp, text - k)));
      const auto it = index.find(key);
      if (it == index.end()) corrupt("XPM: a pixel's key is not in the colour table");
      if (have < npix) std::memcpy(out + 3 * have, colours + 3 * it->second, 3);
      have++;
    }
  }
  if (have < npix) corrupt("XPM: not enough image data");
}

// MspDecoder (version 2) into the "1" image
void msp(const uint8_t* d, int64_t n, Image& im) {
  const int64_t stride = (im.w + 7) / 8;
  if (n < 32 || n - 32 < 2 * im.h) corrupt("MSP: Truncated MSP file in row map");
  std::vector<uint8_t> img;
  img.reserve(static_cast<size_t>(stride * im.h));
  int64_t pos = 32 + 2 * im.h;
  for (int64_t y = 0; y < im.h; y++) {
    const int64_t rowlen = le16(d + 32 + 2 * y);
    if (rowlen == 0) {
      img.insert(img.end(), static_cast<size_t>(stride), 0xFF);
      continue;
    }
    if (n - pos < rowlen)
      corrupt("MSP: Truncated MSP file, expected " + std::to_string(rowlen) + " bytes on row " +
              std::to_string(y));
    const uint8_t* row = d + pos;
    pos += rowlen;
    for (int64_t i = 0; i < rowlen;) {
      const int runtype = row[i++];
      if (runtype == 0) {
        if (rowlen - i < 2) corrupt("MSP: Corrupted MSP file in row " + std::to_string(y));
        img.insert(img.end(), row[i], row[i + 1]);
        i += 2;
      } else {
        const int64_t take = std::min<int64_t>(runtype, rowlen - i);
        img.insert(img.end(), row + i, row + i + take);
        i += runtype;
      }
    }
  }
  if (static_cast<int64_t>(img.size()) < stride * im.h) corrupt("MSP: not enough image data");
  for (int64_t y = 0; y < im.h; y++) unpack(r1, im.row(y), img.data() + y * stride, im.w);
}

// FliDecode.c over buf[0, bytes): -1 at the frame's end, else the bytes
// it consumed (0: it needs more data); an error where it fails
int64_t fli_decode(const uint8_t* buf, int64_t bytes, Image& im) {
  const int64_t xsize = im.w, ysize = im.h;
  if (bytes < 4) return 0;
  const uint8_t* ptr = buf;
  const int64_t framesize = le32(ptr);
  if (bytes + (bytes % 2) < framesize) return 0;
  if (bytes < 8) corrupt("FLI: decoder error (overrun)");
  if (le16(ptr + 4) != 0xF1FA) corrupt("FLI: decoder error (not a frame chunk)");
  const int chunks = static_cast<int>(le16(ptr + 6));
  ptr += 16;
  bytes -= 16;
  const auto oob = [&](const uint8_t* data, int64_t k) {
    if (data + k > ptr + bytes) corrupt("FLI: decoder error (overrun)");
  };
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) corrupt("FLI: decoder error (overrun)");
    const uint8_t* data = ptr + 6;
    switch (le16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2, word delta
        const int lines = static_cast<int>(le16(data));
        data += 2;
        int l = 0;
        int64_t y = 0;
        for (; l < lines && y < ysize; l++, y++) {
          uint8_t* local = im.row(y);
          oob(data, 2);
          int packets = static_cast<int>(le16(data));
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= ysize) corrupt("FLI: decoder error (overrun)");
              local = im.row(y);
            } else {
              local[xsize - 1] = static_cast<uint8_t>(packets);
            }
            oob(data, 2);
            packets = static_cast<int>(le16(data));
            data += 2;
          }
          int p = 0;
          int64_t x = 0;
          for (; p < packets; p++) {
            oob(data, 2);
            x += data[0];
            if (data[1] >= 128) {
              oob(data, 4);
              const int64_t i = 256 - data[1];
              if (x + i + i > xsize) break;
              for (int64_t j = 0; j < i; j++) {
                local[x++] = data[2];
                local[x++] = data[3];
              }
              data += 4;
            } else {
              const int64_t i = 2 * static_cast<int64_t>(data[1]);
              if (x + i > xsize) break;
              oob(data, 2 + i);
              std::memcpy(local + x, data + 2, static_cast<size_t>(i));
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) corrupt("FLI: decoder error (overrun)");
        break;
      }
      case 12: {  // LC, byte delta
        int64_t y = le16(data);
        const int64_t ymax = y + le16(data + 2);
        data += 4;
        for (; y < ymax && y < ysize; y++) {
          uint8_t* out = im.row(y);
          oob(data, 1);
          const int packets = *data++;
          int p = 0;
          int64_t x = 0, i = 0;
          for (; p < packets; p++, x += i) {
            oob(data, 2);
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > xsize) break;
              oob(data, 3);
              std::memset(out + x, data[2], static_cast<size_t>(i));
              data += 3;
            } else {
              i = data[1];
              if (x + i > xsize) break;
              oob(data, 2 + i);
              std::memcpy(out + x, data + 2, static_cast<size_t>(i));
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) corrupt("FLI: decoder error (overrun)");
        break;
      }
      case 13:  // BLACK
        std::memset(im.px.data(), 0, im.px.size());
        break;
      case 15:  // BRUN
        for (int64_t y = 0; y < ysize; y++) {
          uint8_t* out = im.row(y);
          data += 1;
          int64_t x = 0, i = 0;
          for (; x < xsize; x += i) {
            oob(data, 2);
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > xsize) break;
              oob(data, i + 1);
              std::memcpy(out + x, data + 1, static_cast<size_t>(i));
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > xsize) break;
              std::memset(out + x, data[1], static_cast<size_t>(i));
              data += 2;
            }
          }
          if (x != xsize) corrupt("FLI: decoder error (overrun)");
        }
        break;
      case 16:  // COPY
        if (data + xsize * ysize > ptr + bytes) return ptr - buf;
        for (int64_t y = 0; y < ysize; y++) {
          std::memcpy(im.row(y), data, static_cast<size_t>(xsize));
          data += xsize;
        }
        break;
      default:
        corrupt("FLI: decoder error (an unknown chunk)");
    }
    const int32_t advance = static_cast<int32_t>(le32(ptr));
    if (advance == 0) corrupt("FLI: decoder error (a chunk of size 0)");
    if (advance < 0 || advance > bytes) corrupt("FLI: decoder error (overrun)");
    ptr += advance;
    bytes -= advance;
  }
  return -1;
}

// The first frame as ImageFile.load feeds FliDecode.c: reads of the
// frame's size (decodermaxblock) appended to what the decoder left
void fli(const uint8_t* d, int64_t n, int64_t offset, Image& im) {
  if (offset < 0 || offset > n || n - offset < 4) truncated("FLI");
  const int64_t block = le32(d + offset);
  int64_t start = offset, have = 0, pos = offset;
  for (;;) {
    const int64_t read = std::min(block, n - pos);
    if (read <= 0) truncated("FLI");
    pos += read;
    have += read;
    const int64_t consumed = fli_decode(d + start, have, im);
    if (consumed < 0) return;
    start += consumed;
    have -= consumed;
  }
}

// PcdDecode.c over the base image at data[offset]: two lines a chunk
void pcd(const uint8_t* d, int64_t n, int64_t offset, Image& im) {
  const int64_t xs = im.w, chunk = 3 * xs;
  std::vector<uint8_t> line(static_cast<size_t>(3 * xs));
  int64_t pos = offset;
  for (int64_t y = 0; y < im.h; y += 2) {
    if (pos > n || n - pos < chunk) truncated("PCD");
    const uint8_t* ptr = d + pos;
    for (int k = 0; k < 2 && y + k < im.h; k++) {
      for (int64_t x = 0; x < xs; x++) {
        line[3 * x] = ptr[x + k * xs];
        line[3 * x + 1] = ptr[(x + 4 * xs) / 2];
        line[3 * x + 2] = ptr[(x + 5 * xs) / 2];
      }
      unpack(rYCCP, im.row(y + k), line.data(), xs);
    }
    pos += chunk;
  }
}

void fits_gzip(const uint8_t* d, int64_t n, int64_t offset, int bitpix, Image& im) {
  if (offset < 0) corrupt("FITS: a tile before the file's start");
  std::vector<uint8_t> value;
  mrt::gzip_decompress(d + std::min(offset, n), n - std::min(offset, n), "FITS: gzip", value);
  // min(bitpix // 8, 4) bytes a value, its last ones
  const int nb = std::min(bitpix >= 0 ? bitpix / 8 : -((-bitpix + 7) / 8), 4);
  const int64_t npix = im.w * im.h;
  if (nb <= 0 || static_cast<int64_t>(value.size()) < 4 * npix)
    corrupt("FITS: not enough image data");
  const int raw = im.mode == kL ? rL : im.mode == kI16 ? rI16 : rI;
  if (kBits[raw] != 8 * nb) corrupt("FITS: not enough image data");
  std::vector<uint8_t> row(static_cast<size_t>(nb * im.w));
  for (int64_t y = 0; y < im.h; y++) {
    const uint8_t* src = value.data() + 4 * y * im.w;
    for (int64_t x = 0; x < im.w; x++)
      std::memcpy(&row[static_cast<size_t>(nb * x)], src + 4 * x + 4 - nb, static_cast<size_t>(nb));
    unpack(raw, im.row(im.h - 1 - y), row.data(), im.w);
  }
}

}  // namespace

extern "C" {

// Raw tiles (5 int64 each: offset, raw mode, stride, ystep, bits; bits
// > 0 is BitDecode.c's F of that many bits) into an image of `mode`, then
// convert("RGB") into out [height, width, 3]; palette: 256 RGB triples
int mrt_raw_tiles(const uint8_t* data, int64_t n, const int64_t* tiles, int32_t ntiles, int32_t mode,
                  const uint8_t* palette, uint8_t* out, int32_t height, int32_t width,
                  const char* what, char* msg, int32_t msg_len) {
  return guarded(what, msg, msg_len, [&] {
    Image im(mode, width, height);
    for (int t = 0; t < ntiles; t++) {
      const int64_t* tile = tiles + 5 * t;
      if (tile[4] > 0)
        bit_tile(data, n, tile[0], static_cast<int>(tile[4]), im);
      else
        raw_tile(data, n, tile[0], static_cast<int>(tile[1]), tile[2], tile[3], im, what);
    }
    to_rgb(im, palette, out);
  });
}

int mrt_xbm(const uint8_t* data, int64_t n, int64_t offset, uint8_t* out, int32_t height,
            int32_t width, char* msg, int32_t msg_len) {
  return guarded("XBM", msg, msg_len, [&] {
    Image im(k1, width, height);
    xbm(data, n, offset, im);
    to_rgb(im, nullptr, out);
  });
}

// XPM's pixels from data[offset]: nkeys keys (keys: their bytes joined,
// lengths: each one's), colours: RGB a key
int mrt_xpm(const uint8_t* data, int64_t n, int64_t offset, int32_t bpp, const uint8_t* keys,
            const int32_t* lengths, int32_t nkeys, const uint8_t* colours, uint8_t* out,
            int32_t height, int32_t width, char* msg, int32_t msg_len) {
  return guarded("XPM", msg, msg_len, [&] {
    std::vector<std::string> k;
    for (int i = 0; i < nkeys; i++) {
      k.emplace_back(reinterpret_cast<const char*>(keys), static_cast<size_t>(lengths[i]));
      keys += lengths[i];
    }
    xpm(data, n, offset, bpp, k, colours, out, int64_t(width) * height);
  });
}

int mrt_msp(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width, char* msg,
            int32_t msg_len) {
  return guarded("MSP", msg, msg_len, [&] {
    Image im(k1, width, height);
    msp(data, n, im);
    to_rgb(im, nullptr, out);
  });
}

// FLI's first frame from data[offset]; palette: 256 RGB triples
int mrt_fli(const uint8_t* data, int64_t n, int64_t offset, const uint8_t* palette, uint8_t* out,
            int32_t height, int32_t width, char* msg, int32_t msg_len) {
  return guarded("FLI", msg, msg_len, [&] {
    Image im(kP, width, height);
    fli(data, n, offset, im);
    to_rgb(im, palette, out);
  });
}

// PCD's 768x512 base image from data[offset], as it is stored (its
// orientation turned by the caller)
int mrt_pcd(const uint8_t* data, int64_t n, int64_t offset, uint8_t* out, int32_t height,
            int32_t width, char* msg, int32_t msg_len) {
  return guarded("PCD", msg, msg_len, [&] {
    Image im(kRGB, width, height);
    pcd(data, n, offset, im);
    to_rgb(im, nullptr, out);
  });
}

// FITS's GZIP_COMPRESSED_DATA from data[offset]: BITPIX, mode L, I;16 or I
int mrt_fits_gzip(const uint8_t* data, int64_t n, int64_t offset, int32_t bitpix, int32_t mode,
                  uint8_t* out, int32_t height, int32_t width, char* msg, int32_t msg_len) {
  return guarded("FITS", msg, msg_len, [&] {
    Image im(mode, width, height);
    fits_gzip(data, n, offset, bitpix, im);
    to_rgb(im, nullptr, out);
  });
}

}  // extern "C"
