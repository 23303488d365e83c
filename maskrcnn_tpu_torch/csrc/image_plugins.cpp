// Pillow's small lossless image plugins, decoded natively to RGB uint8:
// the pixels np.asarray(PIL.Image.open(f).convert("RGB")) gives with
// Pillow 12.1 for PPM/PGM/PBM/PFM (PpmImagePlugin), TGA (TgaImagePlugin),
// QOI (QoiImagePlugin), PCX and DCX (PcxImagePlugin, DcxImagePlugin), SGI
// (SgiImagePlugin) and Sun raster (SunImagePlugin). ICO, CUR and DIB go
// through image_decode.cpp's BMP decoder (mrt_dib_*) and its PNG route.
//
// Host C++17, compiled into the same library as image_decode.cpp
// (maskrcnn_tpu_torch/data/native_image.py) and called through ctypes,
// outside the GIL: for each format a size call, then the whole decode into
// [height, width, 3]. The header is read as the plugin's _open reads it;
// the pixels as the decoder Pillow picks reads them: its raw decoder
// (rows of the raw mode, bottom-up where the tile's orientation is -1, an
// error where the data runs out), the Python decoders of the PPM and QOI
// plugins (PpmPlainDecoder's blocks of ImageFile.SAFEBLOCK bytes with its
// comment and token rules, PpmDecoder's and the plain decoder's rounding
// of maxval-scaled samples), and the C decoders TgaRleDecode.c,
// PcxDecode.c, SgiRleDecode.c and SunRleDecode.c with their edge
// behaviour (packets across rows, short rows, the row buffers kept from
// row to row). Then Convert.c's conversion to RGB: palettes (black past
// the palette's entries), "I" and "F" clipped to 0-255 ("F" truncated),
// CMYK through cmyk2rgb, alpha dropped.
//
// Entry points return 0, 1 (a corrupt file, or what Pillow raises on:
// ValueError) or 2 (a mode not read: NotImplementedError), with a message.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "image_codec.h"

namespace {

using mrt::corrupt;
using mrt::guarded;

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }
inline uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}
inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
inline uint8_t clip8(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

using mrt::cmyk_rgb;

// F -> RGB: the float truncated to an integer, clipped (NaN 0)
inline uint8_t float8(float f) {
  return static_cast<uint8_t>(f > 0 ? (f >= 255 ? 255 : static_cast<int>(f)) : 0);
}

// A palette as Pillow holds it after putpalette: `entries` RGB triples,
// black past them
struct Palette {
  uint8_t rgb[256 * 3] = {};
  void at(int i, uint8_t* o) const { std::memcpy(o, rgb + 3 * i, 3); }
};

// Row order of a raw tile: orientation -1 stores the bottom row first.
inline int64_t row_y(int64_t r, int64_t h, bool bottom_up) { return bottom_up ? h - 1 - r : r; }

// ------------------------------------------------------------------- PPM

const char* const kWhitespace = " \t\n\x0b\x0c\r";
inline bool is_ws(uint8_t c) { return c && std::strchr(kWhitespace, c) != nullptr; }

// Python's int() of an ASCII token (a sign, digits, single underscores
// between digits): false where it raises
bool py_int(const std::string& t, int64_t* v) {
  size_t i = 0;
  bool neg = false;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) neg = t[i++] == '-';
  if (i == t.size()) return false;
  int64_t x = 0;
  bool digit = false;
  for (; i < t.size(); i++) {
    const char c = t[i];
    if (c >= '0' && c <= '9') {
      x = std::min<int64_t>(x * 10 + (c - '0'), int64_t{1} << 50);
      digit = true;
    } else if (c == '_' && digit && i + 1 < t.size() && t[i + 1] >= '0' && t[i + 1] <= '9') {
      digit = false;
    } else {
      return false;
    }
  }
  *v = neg ? -x : x;
  return true;
}

enum class PpmMode { One, L, I, RGB, RGBA, CMYK, P, F };

int bands_of(PpmMode m) {
  switch (m) {
    case PpmMode::RGB: return 3;
    case PpmMode::RGBA: case PpmMode::CMYK: return 4;
    default: return 1;
  }
}

// PpmImageFile._open
struct Ppm {
  PpmMode mode = PpmMode::L;
  bool plain = false;
  bool little = false;     // Pf with a negative scale
  int64_t width = 0, height = 0, maxval = 255, offset = 0;
  const uint8_t* d;
  int64_t n, pos = 0;

  int get() { return pos < n ? d[pos++] : -1; }

  std::string token() {
    std::string t;
    while (t.size() <= 10) {
      const int c = get();
      if (c < 0) break;
      if (is_ws(static_cast<uint8_t>(c))) {
        if (t.empty()) continue;
        break;
      }
      if (c == '#') {
        for (;;) {
          const int e = get();
          if (e < 0 || e == '\r' || e == '\n') break;
        }
        continue;
      }
      t += static_cast<char>(c);
    }
    if (t.empty()) corrupt("PPM: reached the end of the file in its header");
    if (t.size() > 10) corrupt("PPM: a header token is too long");
    return t;
  }

  int64_t number() {
    int64_t v;
    if (!py_int(token(), &v)) corrupt("PPM: a header value is not an integer");
    return v;
  }

  Ppm(const uint8_t* data, int64_t size) : d(data), n(size) {
    std::string magic;
    for (int i = 0; i < 6; i++) {
      const int c = get();
      if (c < 0 || is_ws(static_cast<uint8_t>(c))) break;
      magic += static_cast<char>(c);
    }
    struct { const char* magic; PpmMode mode; bool plain; } const kModes[] = {
        {"P1", PpmMode::One, true}, {"P2", PpmMode::L, true}, {"P3", PpmMode::RGB, true},
        {"P4", PpmMode::One, false}, {"P5", PpmMode::L, false}, {"P6", PpmMode::RGB, false},
        {"P0CMYK", PpmMode::CMYK, false}, {"Pf", PpmMode::F, false}, {"PyP", PpmMode::P, false},
        {"PyRGBA", PpmMode::RGBA, false}, {"PyCMYK", PpmMode::CMYK, false}};
    bool found = false;
    for (const auto& m : kModes) {
      if (magic == m.magic) {
        mode = m.mode;
        plain = m.plain;
        found = true;
      }
    }
    if (!found) corrupt("not a PPM file");
    width = number();
    height = number();
    if (width <= 0 || height <= 0) corrupt("PPM: an empty image size");
    if (mode == PpmMode::F) {
      // the probe holds the scale to Python's float(): here its sign
      little = token()[0] == '-';
    } else if (mode != PpmMode::One) {
      maxval = number();
      if (maxval <= 0 || maxval >= 65536)
        corrupt("PPM: maxval must be greater than 0 and less than 65536");
      if (maxval > 255 && mode == PpmMode::L) mode = PpmMode::I;
    }
    offset = pos;
  }
};

// Python's round(value / maxval * out_max)
inline int64_t scaled(int64_t value, int64_t maxval, int64_t out_max) {
  return static_cast<int64_t>(std::nearbyint(static_cast<double>(value) /
                                             static_cast<double>(maxval) *
                                             static_cast<double>(out_max)));
}

constexpr int64_t kSafeBlock = 1024 * 1024;

// PpmPlainDecoder: its blocks, comments and tokens, as Python reads them
struct PlainReader {
  const uint8_t* d;
  int64_t n, pos;
  bool spans = false;

  std::string block() {
    const int64_t k = std::min(kSafeBlock, n - pos);
    std::string b(reinterpret_cast<const char*>(d + pos), static_cast<size_t>(std::max<int64_t>(k, 0)));
    pos += std::max<int64_t>(k, 0);
    return b;
  }

  static int64_t comment_end(const std::string& b, size_t start) {
    const int64_t a = b.find('\n', start) == std::string::npos ? -1 : static_cast<int64_t>(b.find('\n', start));
    const int64_t c = b.find('\r', start) == std::string::npos ? -1 : static_cast<int64_t>(b.find('\r', start));
    return a * c > 0 ? std::min(a, c) : std::max(a, c);
  }

  std::string uncommented(std::string b) {
    if (spans) {
      while (!b.empty()) {
        const int64_t e = comment_end(b, 0);
        if (e != -1) {
          b = b.substr(static_cast<size_t>(e + 1));
          break;
        }
        b = block();
      }
    }
    spans = false;
    for (;;) {
      const size_t s = b.find('#');
      if (s == std::string::npos) break;
      const int64_t e = comment_end(b, s);
      if (e != -1) {
        b = b.substr(0, s) + b.substr(static_cast<size_t>(e + 1));
      } else {
        b = b.substr(0, s);
        spans = true;
        break;
      }
    }
    return b;
  }
};

std::vector<std::string> split_ws(const std::string& b) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < b.size()) {
    while (i < b.size() && is_ws(static_cast<uint8_t>(b[i]))) i++;
    size_t j = i;
    while (j < b.size() && !is_ws(static_cast<uint8_t>(b[j]))) j++;
    if (j > i) out.push_back(b.substr(i, j - i));
    i = j;
  }
  return out;
}

// the samples of a plain (P1-P3) file: mode "1" bytes 0/255, else one
// value a band (0-255, or 0-65535 for "I")
std::vector<int64_t> ppm_plain(const Ppm& p) {
  PlainReader r{p.d, p.n, p.offset};
  const int bands = bands_of(p.mode);
  const int64_t total = p.width * p.height * bands;
  std::vector<int64_t> data;
  data.reserve(static_cast<size_t>(std::min<int64_t>(total, int64_t{1} << 26)));
  if (p.mode == PpmMode::One) {
    while (static_cast<int64_t>(data.size()) != total) {
      std::string b = r.block();
      if (b.empty()) break;
      b = r.uncommented(b);
      for (const std::string& t : split_ws(b)) {
        for (char c : t) {
          if (c != '0' && c != '1') corrupt("PPM: invalid token for this mode");
        }
      }
      for (const std::string& t : split_ws(b)) {
        for (char c : t) {
          if (static_cast<int64_t>(data.size()) < total) data.push_back(c == '1' ? 0 : 255);
        }
      }
    }
  } else {
    const int64_t out_max = p.mode == PpmMode::I ? 65535 : 255;
    std::string half;
    while (static_cast<int64_t>(data.size()) != total) {
      std::string b = r.block();
      if (b.empty()) {
        if (half.empty()) break;
        b = " ";
      }
      b = r.uncommented(b);
      if (!half.empty()) {
        b = half + b;
        half.clear();
      }
      std::vector<std::string> tokens = split_ws(b);
      if (!b.empty() && !is_ws(static_cast<uint8_t>(b.back()))) {
        half = tokens.back();
        tokens.pop_back();
        if (half.size() > 10) corrupt("PPM: token too long found in data");
      }
      for (const std::string& t : tokens) {
        if (t.size() > 10) corrupt("PPM: token too long found in data");
        int64_t v;
        if (!py_int(t, &v)) corrupt("PPM: invalid literal for int() in data");
        if (v < 0) corrupt("PPM: channel value is negative");
        if (v > p.maxval) corrupt("PPM: channel value too large for this mode");
        data.push_back(scaled(v, p.maxval, out_max));
        if (static_cast<int64_t>(data.size()) == total) break;
      }
    }
  }
  if (static_cast<int64_t>(data.size()) < total) corrupt("PPM: not enough image data");
  return data;
}

// the samples of a binary file scaled by maxval (PpmDecoder; maxval 255,
// and 65535 for "I", read as they are, as the raw decoder reads them)
std::vector<int64_t> ppm_binary(const Ppm& p) {
  const int bands = bands_of(p.mode);
  const int64_t total = p.width * p.height * bands;
  const int in_bytes = p.maxval < 256 ? 1 : 2;
  if ((p.n - p.offset) / in_bytes < total) corrupt("PPM: image file is truncated");
  std::vector<int64_t> data(static_cast<size_t>(total));
  const uint8_t* s = p.d + p.offset;
  const int64_t out_max = p.mode == PpmMode::I ? 65535 : 255;
  const bool raw = p.maxval == 255 || (p.maxval == 65535 && p.mode == PpmMode::I);
  for (int64_t i = 0; i < total; i++) {
    const int64_t v = in_bytes == 1 ? s[i] : static_cast<int64_t>(be16(s + 2 * i));
    data[static_cast<size_t>(i)] = raw ? v : std::min(out_max, scaled(v, p.maxval, out_max));
  }
  return data;
}

void decode_ppm(const uint8_t* d, int64_t n, uint8_t* out, int64_t height, int64_t width) {
  Ppm p(d, n);
  if (p.width != width || p.height != height) corrupt("PPM: the image's size changed");
  const int64_t npix = width * height;
  if (p.mode == PpmMode::F) {
    // "F;32F" or "F;32BF", the bottom row first
    if ((n - p.offset) / 4 < npix) corrupt("PPM: image file is truncated");
    for (int64_t r = 0; r < height; r++) {
      const int64_t y = row_y(r, height, true);
      for (int64_t x = 0; x < width; x++) {
        const uint8_t* s = d + p.offset + 4 * (r * width + x);
        const uint32_t bits = p.little ? le32(s) : be32(s);
        float f;
        std::memcpy(&f, &bits, 4);
        uint8_t* o = out + 3 * (y * width + x);
        o[0] = o[1] = o[2] = float8(f);
      }
    }
    return;
  }
  if (p.mode == PpmMode::One && !p.plain) {
    // "1;I": rows of bits, 1 black
    const int64_t stride = (width + 7) / 8;
    if ((n - p.offset) / stride < height) corrupt("PPM: image file is truncated");
    for (int64_t y = 0; y < height; y++) {
      for (int64_t x = 0; x < width; x++) {
        const int bit = (d[p.offset + y * stride + x / 8] >> (7 - x % 8)) & 1;
        uint8_t* o = out + 3 * (y * width + x);
        o[0] = o[1] = o[2] = bit ? 0 : 255;
      }
    }
    return;
  }
  const int bands = bands_of(p.mode);
  if (!p.plain && p.maxval == 255 && (p.mode == PpmMode::RGB || p.mode == PpmMode::L)) {
    // the raw decoder's "RGB" and "L": the bytes as they are
    if ((n - p.offset) / bands < npix) corrupt("PPM: image file is truncated");
    const uint8_t* s = d + p.offset;
    if (p.mode == PpmMode::RGB) {
      std::memcpy(out, s, static_cast<size_t>(3 * npix));
    } else {
      for (int64_t i = 0; i < npix; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = s[i];
    }
    return;
  }
  const std::vector<int64_t> s = p.plain ? ppm_plain(p) : ppm_binary(p);
  for (int64_t i = 0; i < npix; i++) {
    const int64_t* v = &s[static_cast<size_t>(i * bands)];
    uint8_t* o = out + 3 * i;
    switch (p.mode) {
      case PpmMode::RGB: case PpmMode::RGBA:
        for (int k = 0; k < 3; k++) o[k] = static_cast<uint8_t>(v[k]);
        break;
      case PpmMode::CMYK: {
        const uint8_t c[4] = {static_cast<uint8_t>(v[0]), static_cast<uint8_t>(v[1]),
                              static_cast<uint8_t>(v[2]), static_cast<uint8_t>(v[3])};
        cmyk_rgb(c, o);
        break;
      }
      case PpmMode::P:
        // the plugin sets no palette: every index is black
        o[0] = o[1] = o[2] = 0;
        break;
      default:
        o[0] = o[1] = o[2] = clip8(v[0]);
    }
  }
}

// ------------------------------------------------------------------- TGA

// "BGRA;15Z" and "BGR;15": 5-bit fields, red highest
inline void rgb15(uint32_t p, uint8_t* o) {
  o[0] = static_cast<uint8_t>(((p >> 10) & 31) * 255 / 31);
  o[1] = static_cast<uint8_t>(((p >> 5) & 31) * 255 / 31);
  o[2] = static_cast<uint8_t>((p & 31) * 255 / 31);
}

// TgaImageFile._open and its tile
struct Tga {
  int64_t width = 0, height = 0, offset = 0;
  int imagetype = 0, depth = 0, bytes_px = 0;
  bool bottom_up = true, flip = false, rle = false;
  bool has_map = false;
  int map_entries = 0;        // start + entries read
  Palette palette;
  char mode = 'L';            // '1', 'L' (with LA), 'P', 'R' (RGB, RGBA)

  Tga(const uint8_t* d, int64_t n) {
    if (n < 18) corrupt("TGA: header too short");
    const int id_len = d[0], maptype = d[1];
    imagetype = d[2];
    depth = d[16];
    const int flags = d[17];
    width = le16(d + 12);
    height = le16(d + 14);
    if (maptype > 1 || width <= 0 || height <= 0 ||
        (depth != 1 && depth != 8 && depth != 16 && depth != 24 && depth != 32))
      corrupt("not a TGA file");
    if (imagetype == 3 || imagetype == 11) {
      mode = depth == 1 ? '1' : 'L';
    } else if (imagetype == 1 || imagetype == 9) {
      mode = maptype ? 'P' : 'L';
    } else if (imagetype == 2 || imagetype == 10) {
      mode = 'R';
    } else {
      corrupt("unknown TGA mode");
    }
    bottom_up = !(flags & 0x20);
    flip = (flags & 0x10) != 0;
    rle = (imagetype & 8) != 0;
    int64_t pos = std::min<int64_t>(18 + id_len, n);
    if (maptype) {
      const int start = le16(d + 3), size = le16(d + 5), mapdepth = d[7];
      const int k = mapdepth == 16 ? 2 : mapdepth == 24 ? 3 : mapdepth == 32 ? 4 : 0;
      if (!k) corrupt("unknown TGA map depth");
      // a 32-bit map's "BGRA" has no palette unpacker: Pillow raises at load
      if (k == 4) corrupt("TGA: unrecognized raw mode (a 32-bit colour map)");
      const int64_t got = std::min<int64_t>(static_cast<int64_t>(k) * size, n - pos);
      const int64_t entries = start + got / k;
      has_map = true;
      // putpalette's check, at load
      if (entries > 256) corrupt("TGA: invalid palette size");
      map_entries = static_cast<int>(entries);
      for (int64_t i = start; i < entries; i++) {
        const uint8_t* e = d + pos + (i - start) * k;
        uint8_t* o = palette.rgb + 3 * i;
        if (k == 2) {
          rgb15(le16(e), o);
        } else {
          o[0] = e[2];
          o[1] = e[1];
          o[2] = e[0];
        }
      }
      pos += got;
    }
    offset = pos;
    // MODES: the (type, depth) pairs with a tile; others cannot be loaded
    const int base = imagetype & 7;
    const bool tile = (base == 1 && depth == 8) || (base == 3 && (depth == 1 || depth == 8 || depth == 16)) ||
                      (base == 2 && (depth == 16 || depth == 24 || depth == 32));
    if (!tile) corrupt("TGA: cannot load this image (type " + std::to_string(imagetype) +
                       ", depth " + std::to_string(depth) + ")");
    // the raw mode against the image's mode: "P" into "L" (type 1
    // without a map) has no unpacker; a palette cannot be put on RGB or
    // bilevel images
    if (base == 1 && !maptype) corrupt("TGA: unknown raw mode for given image mode");
    if (has_map && (mode == 'R' || mode == '1')) corrupt("TGA: unrecognized image mode");
    bytes_px = depth == 1 ? 0 : depth / 8;
  }

  // one pixel of a row buffer to RGB
  void rgb(const uint8_t* row, int64_t x, uint8_t* o) const {
    if (depth == 1) {
      const uint8_t v = ((row[x / 8] >> (7 - x % 8)) & 1) ? 255 : 0;
      o[0] = o[1] = o[2] = v;
      return;
    }
    const uint8_t* s = row + x * bytes_px;
    if (mode == 'P' || (has_map && mode == 'L')) {
      palette.at(s[0], o);
    } else if (mode == 'L') {
      o[0] = o[1] = o[2] = s[0];
    } else if (depth == 16) {
      rgb15(le16(s), o);
    } else {
      o[0] = s[2];
      o[1] = s[1];
      o[2] = s[0];
    }
  }

  int64_t row_bytes() const { return depth == 1 ? (width + 7) / 8 : width * bytes_px; }
};

void tga_row(const Tga& t, const uint8_t* row, int64_t y, uint8_t* out) {
  for (int64_t x = 0; x < t.width; x++) {
    const int64_t ox = t.flip ? t.width - 1 - x : x;
    t.rgb(row, x, out + 3 * (y * t.width + ox));
  }
}

// TgaRleDecode.c: packets of a pixel count and a run's pixel or the
// literal pixels; a literal packet runs on across rows (what passes the
// last row is dropped), a run past its row's end is an overrun; the
// data's end before the last row is an error
void tga_rle(const Tga& t, const uint8_t* d, int64_t n, uint8_t* out) {
  const int depth = t.depth / 8;
  const int64_t bytes = t.row_bytes();
  std::vector<uint8_t> buf(static_cast<size_t>(bytes), 0);
  int64_t x = 0, r = 0, pos = t.offset;
  for (;;) {
    if (pos >= n) corrupt("TGA: image file is truncated");
    const uint8_t c = d[pos];
    int64_t count = static_cast<int64_t>(depth) * ((c & 0x7f) + 1);
    if (c & 0x80) {
      if (n - pos < 1 + depth) corrupt("TGA: image file is truncated");
      if (x + count > bytes) corrupt("TGA: buffer overrun when reading image file");
      for (int64_t i = 0; i < count; i++) buf[static_cast<size_t>(x + i)] = d[pos + 1 + i % depth];
      pos += 1 + depth;
      x += count;
      if (x >= bytes) {
        tga_row(t, buf.data(), row_y(r, t.height, t.bottom_up), out);
        x = 0;
        if (++r >= t.height) return;
      }
      continue;
    }
    if (n - pos < 1 + count) corrupt("TGA: image file is truncated");
    const uint8_t* src = d + pos + 1;
    pos += 1 + count;
    while (count > 0) {
      const int64_t k = std::min(count, bytes - x);
      std::memcpy(&buf[static_cast<size_t>(x)], src, static_cast<size_t>(k));
      src += k;
      x += k;
      count -= k;
      if (x >= bytes) {
        tga_row(t, buf.data(), row_y(r, t.height, t.bottom_up), out);
        x = 0;
        if (++r >= t.height) return;
      }
    }
  }
}

void decode_tga(const uint8_t* d, int64_t n, uint8_t* out, int64_t height, int64_t width) {
  Tga t(d, n);
  if (t.width != width || t.height != height) corrupt("TGA: the image's size changed");
  if (t.rle) {
    // the decoder's pixel size is depth / 8 bytes: 0 for bilevel, whose
    // packets never fill a row
    if (t.depth == 1) corrupt("TGA: image file is truncated");
    tga_rle(t, d, n, out);
    return;
  }
  const int64_t stride = t.row_bytes();
  if (t.offset > n || (n - t.offset) / stride < t.height) corrupt("TGA: image file is truncated");
  for (int64_t r = 0; r < t.height; r++)
    tga_row(t, d + t.offset + r * stride, row_y(r, t.height, t.bottom_up), out);
}

// ------------------------------------------------------------------- QOI

struct Qoi {
  int64_t width = 0, height = 0;
  int channels = 3;
  Qoi(const uint8_t* d, int64_t n) {
    if (n < 13 || std::memcmp(d, "qoif", 4) != 0) corrupt("not a QOI file");
    width = be32(d + 4);
    height = be32(d + 8);
    channels = d[12] == 3 ? 3 : 4;
    if (width <= 0 || height <= 0) corrupt("QOI: an empty image size");
  }
};

// QoiDecoder.decode: the ops from byte 14 until the image is full (the
// end marker is not read); the data's end first is an error
void decode_qoi(const uint8_t* d, int64_t n, uint8_t* out, int64_t height, int64_t width) {
  Qoi q(d, n);
  if (q.width != width || q.height != height) corrupt("QOI: the image's size changed");
  const int64_t npix = width * height;
  uint8_t seen[64][4];
  bool have[64] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t pos = 14, px = 0;
  auto need = [&](int64_t k) {
    if (n - pos < k) corrupt("QOI: the data ends early");
  };
  auto put = [&](const uint8_t* v) {
    if (px < npix) std::memcpy(out + 3 * px, v, 3);
    px++;
  };
  while (px < npix) {
    need(1);
    const uint8_t b = d[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      need(3);
      std::memcpy(v, d + pos, 3);
      v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      need(4);
      std::memcpy(v, d + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {
      if (have[b & 63]) {
        std::memcpy(v, seen[b & 63], 4);
      } else {
        std::memset(v, 0, 4);
      }
    } else if ((b >> 6) == 1) {
      v[0] = static_cast<uint8_t>(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = static_cast<uint8_t>(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = static_cast<uint8_t>(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      need(1);
      const uint8_t s = d[pos++];
      const int dg = (b & 63) - 32;
      v[0] = static_cast<uint8_t>(prev[0] + dg + ((s >> 4) & 15) - 8);
      v[1] = static_cast<uint8_t>(prev[1] + dg);
      v[2] = static_cast<uint8_t>(prev[2] + dg + (s & 15) - 8);
      v[3] = prev[3];
    } else {
      // a run repeats the previous pixel and is not hashed
      for (int i = 0; i <= (b & 63); i++) put(prev);
      continue;
    }
    std::memcpy(prev, v, 4);
    const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(seen[h], v, 4);
    have[h] = true;
    put(v);
  }
}

// ------------------------------------------------------------- PCX, DCX

enum class PcxMode { One, P2, P4, L, P, RGB };

// PcxImageFile._open at `at` (0, or a DCX page's offset). `path`: the
// file is read from a path, where the VGA palette's seek before the
// file's start raises
struct Pcx {
  int64_t width = 0, height = 0, offset = 0, bytes = 0, stride = 0;
  int planes = 0, bits = 0;
  PcxMode mode = PcxMode::L;
  Palette palette;

  Pcx(const uint8_t* d, int64_t n, int64_t at, bool path) {
    if (at < 0 || at > n - 68) corrupt("PCX: header too short");
    const uint8_t* s = d + at;
    if (s[0] != 10 || (s[1] != 0 && s[1] != 2 && s[1] != 3 && s[1] != 5)) corrupt("not a PCX file");
    const int64_t x0 = le16(s + 4), y0 = le16(s + 6), x1 = le16(s + 8) + 1, y1 = le16(s + 10) + 1;
    if (x1 <= x0 || y1 <= y0) corrupt("bad PCX image size");
    const int version = s[1];
    bits = s[3];
    planes = s[65];
    const int64_t provided = le16(s + 66);
    if (bits == 1 && planes == 1) {
      mode = PcxMode::One;
    } else if (bits == 1 && (planes == 2 || planes == 4)) {
      mode = planes == 2 ? PcxMode::P2 : PcxMode::P4;
      for (int i = 0; i < 16; i++) std::memcpy(palette.rgb + 3 * i, s + 16 + 3 * i, 3);
    } else if (version == 5 && bits == 8 && planes == 1) {
      mode = PcxMode::L;
      if (n < 769 && path) corrupt("PCX: [Errno 22] Invalid argument (the palette's seek)");
      const int64_t at769 = std::max<int64_t>(n - 769, 0);
      if (n - at769 == 769 && d[at769] == 12) {
        const uint8_t* p = d + at769 + 1;
        for (int i = 0; i < 256; i++) {
          if (p[3 * i] != i || p[3 * i + 1] != i || p[3 * i + 2] != i) {
            mode = PcxMode::P;
            break;
          }
        }
        if (mode == PcxMode::P) std::memcpy(palette.rgb, p, 768);
      }
    } else if (version == 5 && bits == 8 && planes == 3) {
      mode = PcxMode::RGB;
    } else {
      corrupt("PCX: unknown PCX mode");
    }
    width = x1 - x0;
    height = y1 - y0;
    stride = (width * bits + 7) / 8;
    if (provided != stride) stride += stride % 2;
    bytes = planes * stride;
    offset = at + 128;
  }

  int unpack_bits() const {
    switch (mode) {
      case PcxMode::One: return 1;
      case PcxMode::P2: return 2;
      case PcxMode::P4: return 4;
      case PcxMode::RGB: return 24;
      default: return 8;
    }
  }

  void row(const uint8_t* b, int64_t y, uint8_t* out) const {
    const int64_t w = width, s = stride;
    for (int64_t x = 0; x < w; x++) {
      uint8_t* o = out + 3 * (y * w + x);
      const int m = 128 >> (x % 8);
      const int64_t j = x / 8;
      switch (mode) {
        case PcxMode::One:
          o[0] = o[1] = o[2] = (b[j] & m) ? 255 : 0;
          break;
        case PcxMode::P2:
          palette.at(((b[j] & m) ? 1 : 0) + ((b[j + s] & m) ? 2 : 0), o);
          break;
        case PcxMode::P4:
          palette.at(((b[j] & m) ? 1 : 0) + ((b[j + s] & m) ? 2 : 0) + ((b[j + 2 * s] & m) ? 4 : 0) +
                         ((b[j + 3 * s] & m) ? 8 : 0),
                     o);
          break;
        case PcxMode::L:
          o[0] = o[1] = o[2] = b[x];
          break;
        case PcxMode::P:
          palette.at(b[x], o);
          break;
        case PcxMode::RGB:
          o[0] = b[x];
          o[1] = b[x + w];
          o[2] = b[x + 2 * w];
      }
    }
  }
};

// PcxDecode.c
void decode_pcx_at(const uint8_t* d, int64_t n, uint8_t* out, int64_t height, int64_t width,
                   int64_t at, bool path) {
  Pcx p(d, n, at, path);
  if (p.width != width || p.height != height) corrupt("PCX: the image's size changed");
  const int64_t bytes = p.bytes, w = p.width;
  if ((w * p.unpack_bits() + 7) / 8 > bytes) corrupt("PCX: buffer overrun");
  // the unpacker reads its planes at (w + 7) / 8 apart, which may pass
  // the row's bytes: the buffer is kept large enough
  std::vector<uint8_t> buf(static_cast<size_t>(std::max<int64_t>(bytes, 4 * ((w + 7) / 8)) + 3 * w), 0);
  bool overrun = false;
  int64_t x = 0, y = 0, pos = p.offset;
  for (;;) {
    if (pos >= n) corrupt("PCX: image file is truncated");
    if ((d[pos] & 0xC0) == 0xC0) {
      if (n - pos < 2) corrupt("PCX: image file is truncated");
      int k = d[pos] & 0x3F;
      while (k > 0) {
        if (x >= bytes) {
          overrun = true;
          break;
        }
        buf[static_cast<size_t>(x++)] = d[pos + 1];
        k--;
      }
      pos += 2;
    } else {
      buf[static_cast<size_t>(x++)] = d[pos++];
    }
    if (x >= bytes) {
      // the three planes of an RGB line moved together past their padding
      if (p.mode == PcxMode::RGB && bytes % w && bytes > w) {
        const int64_t bands = bytes / w, band_stride = bytes / bands;
        for (int64_t i = 1; i < bands; i++)
          std::memmove(&buf[static_cast<size_t>(i * w)], &buf[static_cast<size_t>(i * band_stride)],
                       static_cast<size_t>(w));
      }
      p.row(buf.data(), y, out);
      x = 0;
      if (++y >= p.height) break;
    }
  }
  if (overrun) corrupt("PCX: buffer overrun");
}

int64_t dcx_first(const uint8_t* d, int64_t n) {
  if (n < 8 || le32(d) != 987654321u) corrupt("not a DCX file");
  const int64_t off = le32(d + 4);
  if (off == 0) corrupt("DCX: no pages");
  return off;
}

// ------------------------------------------------------------------- SGI

struct Sgi {
  int64_t width = 0, height = 0;
  int compression = 0, bpc = 1, bands = 1;
  Sgi(const uint8_t* d, int64_t n) {
    if (n < 512 || be16(d) != 474) corrupt("SGI: not an SGI image file");
    compression = d[2];
    bpc = d[3];
    const int dimension = be16(d + 4), zsize = be16(d + 10);
    width = be16(d + 6);
    height = be16(d + 8);
    const bool ok = (bpc == 1 || bpc == 2) &&
                    (((dimension == 1 || dimension == 2) && zsize == 1) ||
                     (dimension == 3 && (zsize == 3 || zsize == 4)));
    if (!ok) corrupt("SGI: unsupported SGI image mode");
    bands = zsize;
    if (width <= 0 || height <= 0) corrupt("SGI: an empty image size");
    if (compression > 1) corrupt("SGI: cannot load this image (compression " +
                                 std::to_string(compression) + ")");
  }
};

inline void sgi_pixel(const uint8_t* v, int bands, uint8_t* o) {
  if (bands == 1) {
    o[0] = o[1] = o[2] = v[0];
  } else {
    std::memcpy(o, v, 3);
  }
}

// SgiRleDecode.c's expandrow (bpc 1) and expandrow2 (bpc 2, its 16-bit
// samples' high byte kept) over src[at, ...) of a buffer whose last byte
// is at `end`: -1 an overrun, 1 a last byte that is not a row's end (the
// decode stops there, without an error), 0 done (a zero count, or n
// units read). Its bounds checks are kept as they are (a literal that
// ends on the buffer's last byte is an overrun).
int sgi_row(uint8_t* dest, const uint8_t* p, int64_t at, int64_t n, int z, int64_t xsize,
            int64_t end, int bpc) {
  int64_t x = 0;
  for (; n > 0; n--) {
    if (at + (bpc - 1) > end) return -1;
    const uint8_t pixel = p[at + bpc - 1];
    at += bpc;
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (at + static_cast<int64_t>(bpc) * count > end) return -1;
      while (count--) {
        *dest = p[at];
        at += bpc;
        dest += z;
      }
    } else {
      if (bpc == 1 ? at > end : at + 2 > end) return -1;
      const uint8_t v = p[at];
      while (count--) {
        *dest = v;
        dest += z;
      }
      at += bpc;
    }
  }
  return 0;
}

void decode_sgi(const uint8_t* d, int64_t n, uint8_t* out, int64_t height, int64_t width) {
  Sgi s(d, n);
  if (s.width != width || s.height != height) corrupt("SGI: the image's size changed");
  const int64_t w = s.width, h = s.height, page = w * h;
  const int z = s.bands;
  if (s.compression == 0) {
    // one raw plane a band ("SGI16": "L;16B", its high byte), bottom-up
    if ((n - 512) / s.bpc / z < page) corrupt("SGI: image file is truncated");
    for (int64_t r = 0; r < h; r++) {
      const int64_t y = row_y(r, h, true);
      for (int64_t x = 0; x < w; x++) {
        uint8_t v[4];
        for (int b = 0; b < z; b++) v[b] = d[512 + s.bpc * (b * page + r * w + x)];
        sgi_pixel(v, z, out + 3 * (y * w + x));
      }
    }
    return;
  }
  const int64_t bufsize = n - 512, tablen = static_cast<int64_t>(z) * h;
  if (bufsize < 8 * tablen) corrupt("SGI: buffer overrun (offset tables)");
  const uint8_t* p = d + 512;
  std::vector<uint8_t> buf(static_cast<size_t>(w * z), 0);
  std::memset(out, 0, static_cast<size_t>(3 * page));
  for (int64_t r = 0; r < h; r++) {
    for (int c = 0; c < z; c++) {
      const int64_t start = be32(p + 4 * (r + c * h));
      // the decoder's row length is a C int: past 2**31 it is negative
      // and the row reads nothing
      const int64_t length = static_cast<int32_t>(be32(p + 4 * (tablen + r + c * h)));
      if (start < 512) corrupt("SGI: buffer overrun (a row before the data)");
      const int status = sgi_row(&buf[static_cast<size_t>(c)], p, start - 512, length, z,
                                 w, bufsize - 1, s.bpc);
      if (status == -1) corrupt("SGI: buffer overrun");
      if (status == 1) return;
    }
    const int64_t y = row_y(r, h, true);
    for (int64_t x = 0; x < w; x++) sgi_pixel(&buf[static_cast<size_t>(x * z)], z, out + 3 * (y * w + x));
  }
}

// ------------------------------------------------------------ Sun raster

struct Sun {
  int64_t width = 0, height = 0, offset = 32, stride = 0;
  int depth = 0, type = 0;
  bool rgb_order = false;     // type 3: RGB, else BGR
  bool has_palette = false;
  Palette palette;

  Sun(const uint8_t* d, int64_t n) {
    if (n < 32 || be32(d) != 0x59A66A95u) corrupt("not an SUN raster file");
    width = be32(d + 4);
    height = be32(d + 8);
    depth = static_cast<int>(be32(d + 12));
    type = static_cast<int>(be32(d + 20));
    const uint32_t palette_type = be32(d + 24), palette_length = be32(d + 28);
    if (be32(d + 12) > 32 || (depth != 1 && depth != 4 && depth != 8 && depth != 24 && depth != 32))
      corrupt("Unsupported Mode/Bit Depth");
    rgb_order = type == 3;
    if (palette_length) {
      if (palette_length > 1024) corrupt("Unsupported Color Palette Length");
      if (palette_type != 1) corrupt("Unsupported Palette Type");
      offset += palette_length;
      if (depth == 4 || depth == 8) {
        has_palette = true;
        const int64_t got = std::min<int64_t>(palette_length, n - 32);
        const int64_t entries = got / 3;
        if (entries > 256) corrupt("SUN: invalid palette size");
        for (int64_t i = 0; i < entries; i++)
          for (int k = 0; k < 3; k++) palette.rgb[3 * i + k] = d[32 + i + k * entries];
      } else {
        corrupt("SUN: unrecognized image mode (a palette on a " + std::to_string(depth) + "-bit image)");
      }
    }
    if (be32(d + 20) > 5) corrupt("Unsupported Sun Raster file type");
    if (width <= 0 || height <= 0) corrupt("SUN: an empty image size");
    stride = ((width * depth + 15) / 16) * 2;
  }

  void row(const uint8_t* b, int64_t y, uint8_t* out) const {
    if (depth >= 24) {
      const int k = depth / 8, r = rgb_order ? 0 : 2, bl = 2 - r;
      uint8_t* o = out + 3 * y * width;
      for (int64_t x = 0; x < width; x++, b += k, o += 3) {
        o[0] = b[r];
        o[1] = b[1];
        o[2] = b[bl];
      }
      return;
    }
    for (int64_t x = 0; x < width; x++) {
      uint8_t* o = out + 3 * (y * width + x);
      switch (depth) {
        case 1:
          o[0] = o[1] = o[2] = ((b[x / 8] >> (7 - x % 8)) & 1) ? 0 : 255;
          break;
        case 4: {
          const int v = (b[x / 2] >> (x % 2 ? 0 : 4)) & 15;
          if (has_palette) {
            palette.at(v, o);
          } else {
            o[0] = o[1] = o[2] = static_cast<uint8_t>(v * 17);
          }
          break;
        }
        case 8:
          if (has_palette) {
            palette.at(b[x], o);
          } else {
            o[0] = o[1] = o[2] = b[x];
          }
          break;
      }
    }
  }
};

// SunRleDecode.c: 0x80 0 a literal 0x80, 0x80 n v a run of n + 1, other
// bytes literal; runs cross rows; rows are (width * depth + 7) / 8 bytes
// (no 16-bit padding); the data's end before the last row is an error
void sun_rle(const Sun& s, const uint8_t* d, int64_t n, uint8_t* out) {
  const int64_t bytes = (s.width * s.depth + 7) / 8;
  std::vector<uint8_t> buf(static_cast<size_t>(bytes), 0);
  int64_t x = 0, y = 0, pos = s.offset;
  // a full row buffer unpacked; true once the last row is
  auto row_done = [&] {
    if (x < bytes) return false;
    s.row(buf.data(), y, out);
    x = 0;
    return ++y >= s.height;
  };
  for (;;) {
    if (pos >= n) corrupt("SUN: image file is truncated");
    if (d[pos] != 0x80) {
      buf[static_cast<size_t>(x++)] = d[pos++];
      if (row_done()) return;
      continue;
    }
    if (n - pos < 2) corrupt("SUN: image file is truncated");
    if (d[pos + 1] == 0) {
      pos += 2;
      buf[static_cast<size_t>(x++)] = 0x80;
      if (row_done()) return;
      continue;
    }
    if (n - pos < 3) corrupt("SUN: image file is truncated");
    int64_t count = d[pos + 1] + 1;
    const uint8_t v = d[pos + 2];
    pos += 3;
    while (count > 0) {
      const int64_t k = std::min(count, bytes - x);
      std::memset(&buf[static_cast<size_t>(x)], v, static_cast<size_t>(k));
      x += k;
      count -= k;
      if (row_done()) return;
    }
  }
}

void decode_sun(const uint8_t* d, int64_t n, uint8_t* out, int64_t height, int64_t width) {
  Sun s(d, n);
  if (s.width != width || s.height != height) corrupt("SUN: the image's size changed");
  if (s.type == 2) {
    sun_rle(s, d, n, out);
    return;
  }
  // the raw decoder reads a row's padding only before the next row
  const int64_t last = (s.width * s.depth + 7) / 8;
  if (s.offset > n || n - s.offset < last || (n - s.offset - last) / s.stride < s.height - 1)
    corrupt("SUN: image file is truncated");
  for (int64_t y = 0; y < s.height; y++) s.row(d + s.offset + y * s.stride, y, out);
}

template <class T>
void size_of(const T& t, int32_t* height, int32_t* width) {
  *height = static_cast<int32_t>(std::min<int64_t>(t.height, INT32_MAX));
  *width = static_cast<int32_t>(std::min<int64_t>(t.width, INT32_MAX));
}

}  // namespace

// IcnsImagePlugin.read_32 (read_32t: after its 4 zero bytes): a packed
// RGB icon of w x h pixels at d[start, start + length): the three bands
// raw where `length` is three times the pixels, else each band in turn
// as Apple's RLE (a byte of 0x80 or more: the next byte, that less 125
// times; else that plus one bytes as they are), read on past the
// entry's end as Pillow's file reads run on; a band not exactly full, or
// short of bytes, fails as Pillow fails.
void decode_icns_rgb(const uint8_t* d, int64_t n, int64_t start, int64_t length, bool prefix,
                     int64_t w, int64_t h, uint8_t* out) {
  if (start < 0 || start > n) start = n;
  if (prefix) {
    if (n - start < 4 || std::memcmp(d + start, "\0\0\0\0", 4) != 0)
      corrupt("ICNS: Unknown signature, expecting 0x00000000");
    start += 4;
    length -= 4;
  }
  const int64_t sizesq = w * h;
  if (length == sizesq * 3) {
    if (n - start < length) corrupt("ICNS: not enough image data");
    std::memcpy(out, d + start, static_cast<size_t>(length));
    return;
  }
  int64_t pos = start;
  std::vector<uint8_t> band;
  for (int b = 0; b < 3; b++) {
    band.clear();
    int64_t left = sizesq;
    while (left > 0) {
      if (pos >= n) break;
      const int c = d[pos++];
      int64_t run;
      if (c & 0x80) {
        run = c - 125;
        if (pos < n) {
          band.insert(band.end(), static_cast<size_t>(run), d[pos]);
          pos++;
        }
      } else {
        run = c + 1;
        const int64_t take = std::min<int64_t>(run, n - pos);
        band.insert(band.end(), d + pos, d + pos + take);
        pos += take;
      }
      left -= run;
      if (left <= 0) break;
    }
    if (left != 0)
      corrupt("ICNS: Error reading channel [" + std::to_string(left) + " left]");
    if (static_cast<int64_t>(band.size()) != sizesq) corrupt("ICNS: not enough image data");
    for (int64_t i = 0; i < sizesq; i++) out[3 * i + b] = band[i];
  }
}

extern "C" {

// Each format: its image's size, then the whole decode into out
// [height, width, 3] (that size, checked again).
int mrt_ppm_size(const uint8_t* data, int64_t n, int32_t* height, int32_t* width, char* msg,
                 int32_t msg_len) {
  return guarded("PPM", msg, msg_len, [&] { size_of(Ppm(data, n), height, width); });
}

int mrt_ppm_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width,
                   char* msg, int32_t msg_len) {
  return guarded("PPM", msg, msg_len, [&] { decode_ppm(data, n, out, height, width); });
}

int mrt_tga_size(const uint8_t* data, int64_t n, int32_t* height, int32_t* width, char* msg,
                 int32_t msg_len) {
  return guarded("TGA", msg, msg_len, [&] { size_of(Tga(data, n), height, width); });
}

int mrt_tga_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width,
                   char* msg, int32_t msg_len) {
  return guarded("TGA", msg, msg_len, [&] { decode_tga(data, n, out, height, width); });
}

int mrt_qoi_size(const uint8_t* data, int64_t n, int32_t* height, int32_t* width, char* msg,
                 int32_t msg_len) {
  return guarded("QOI", msg, msg_len, [&] { size_of(Qoi(data, n), height, width); });
}

int mrt_qoi_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width,
                   char* msg, int32_t msg_len) {
  return guarded("QOI", msg, msg_len, [&] { decode_qoi(data, n, out, height, width); });
}

// PCX and DCX (its first page): `path` nonzero reads a file Pillow opens
// from a path (Pcx)
int mrt_pcx_size(const uint8_t* data, int64_t n, int32_t* height, int32_t* width, char* msg,
                 int32_t msg_len, int32_t path) {
  return guarded("PCX", msg, msg_len, [&] { size_of(Pcx(data, n, 0, path != 0), height, width); });
}

int mrt_pcx_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width,
                   char* msg, int32_t msg_len, int32_t path) {
  return guarded("PCX", msg, msg_len, [&] { decode_pcx_at(data, n, out, height, width, 0, path != 0); });
}

int mrt_dcx_size(const uint8_t* data, int64_t n, int32_t* height, int32_t* width, char* msg,
                 int32_t msg_len, int32_t path) {
  return guarded("DCX", msg, msg_len,
                 [&] { size_of(Pcx(data, n, dcx_first(data, n), path != 0), height, width); });
}

int mrt_dcx_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width,
                   char* msg, int32_t msg_len, int32_t path) {
  return guarded("DCX", msg, msg_len, [&] {
    decode_pcx_at(data, n, out, height, width, dcx_first(data, n), path != 0);
  });
}

int mrt_sgi_size(const uint8_t* data, int64_t n, int32_t* height, int32_t* width, char* msg,
                 int32_t msg_len) {
  return guarded("SGI", msg, msg_len, [&] { size_of(Sgi(data, n), height, width); });
}

int mrt_sgi_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width,
                   char* msg, int32_t msg_len) {
  return guarded("SGI", msg, msg_len, [&] { decode_sgi(data, n, out, height, width); });
}

int mrt_sun_size(const uint8_t* data, int64_t n, int32_t* height, int32_t* width, char* msg,
                 int32_t msg_len) {
  return guarded("SUN", msg, msg_len, [&] { size_of(Sun(data, n), height, width); });
}

int mrt_sun_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width,
                   char* msg, int32_t msg_len) {
  return guarded("SUN", msg, msg_len, [&] { decode_sun(data, n, out, height, width); });
}

// An ICNS file's packed RGB icon (decode_icns_rgb): the entry at start,
// `length` bytes, `prefix`: it32's 4-byte prefix, into out [height, width, 3].
int mrt_icns_rgb(const uint8_t* data, int64_t n, int64_t start, int64_t length, int32_t prefix,
                 uint8_t* out, int32_t height, int32_t width, char* msg, int32_t msg_len) {
  return guarded("ICNS", msg, msg_len, [&] {
    decode_icns_rgb(data, n, start, length, prefix != 0, width, height, out);
  });
}

}  // extern "C"
