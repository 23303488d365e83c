// Host image decoder of the port: JPEG, PNG (after inflate), BMP and GIF
// to RGB uint8, the pixels np.asarray(PIL.Image.open(f).convert("RGB"))
// gives with Pillow 12.1 over libjpeg-turbo 3.1 (WebP: webp_decode.cpp).
//
// Host C++17, no CUDA: maskrcnn_tpu_torch/data/native_image.py compiles it
// with g++ on first use and calls it through ctypes, which releases the
// GIL for the whole call.
//
// JPEG follows libjpeg-turbo's C path as Pillow configures it (its SIMD
// paths give the same bits): jdhuff.c / jdphuff.c entropy decoding
// (baseline, extended sequential and progressive Huffman, restart
// intervals), every coefficient of the image kept until the last scan,
// jidctint.c's islow IDCT with the range-limit table, jdsample.c's
// upsamplers (fancy h2v1, h1v2 and h2v2 where libjpeg-turbo picks them,
// box replication elsewhere, edges replicated at the component's
// downsampled size as jdmainct.c's context rows are), jdcolor.c's
// fixed-point YCbCr -> RGB and YCCK -> CMYK tables, the colour space chosen
// by jdapimin.c's default_decompress_parms, and for 4 components Pillow's
// own steps: the "CMYK;I" unpack (samples inverted) and Convert.c's
// cmyk2rgb. Refused, with the mode named: arithmetic coding, lossless and
// hierarchical frames, samples of other than 8 bits, 2 components,
// sampling factors that do not divide the largest or that make an
// interleaved MCU of more than 10 blocks, and a progressive file
// whose scans leave a low-frequency coefficient incomplete (libjpeg-turbo
// smooths such blocks; jdcoefct.c smoothing_ok).
//
// PNG: the five row filters, the seven Adam7 passes, bit depths 1, 2, 4,
// 8 and 16, and Pillow's conversions to RGB: gray 1-bit as 0/255, 2- and
// 4-bit scaled by 85 and 17, 16-bit gray ("I;16") clipped to 255, the
// high byte of every other 16-bit sample, alpha dropped, palette indices
// looked up (black past the palette).
//
// BMP as BmpImagePlugin.py reads it: the 12-byte OS/2 header and the
// 40- to 124-byte Windows ones, 1/4/8-bit palettes (black past a short
// one; a grayscale palette's 8-bit indices read as gray levels), 16-bit
// 5-5-5 and 5-6-5, 24-bit, 32-bit with the bit-field layouts Pillow
// takes (alpha dropped), BI_RLE8 and BI_RLE4 through Pillow's own RLE
// decoder (a delta skips two bytes before its offsets; deltas and line
// ends leave index 0; absolute runs align to the file's even offsets),
// rows bottom-up or top-down. Channels narrower than 8 bits widen as
// Pillow's unpackers do: v * 255 / (2**bits - 1).
//
// GIF: the first frame as GifImagePlugin.py and GifDecode.c give it: the
// logical screen grown to hold the frame, pixels outside the frame filled
// with the transparency index or 0, global or local colour table (a
// table of the grays 0, 1, 2, ... opens as mode "L": indices as gray
// levels; black past a short table), LZW with any code size Pillow takes
// (clear and end codes, a full table kept without a clear code),
// interlaced rows.
//
// Entry points return 0, 1 (a corrupt file: ValueError) or 2 (a mode not
// read: NotImplementedError), with a message.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Error{1, m}; }
[[noreturn]] void refuse(const std::string& m) { throw Error{2, m}; }

int report(const Error& e, char* msg, int32_t msg_len) {
  if (msg && msg_len > 0) {
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", e.msg.c_str());
  }
  return e.code;
}

// ------------------------------------------------------------------- JPEG

// the zigzag position k's coefficient in natural order, with 16 entries
// past the end as jpeg_natural_order has (a corrupt run lands on 63)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  // (code length << 8) | symbol for codes of at most kLookBits bits, else 0
  uint16_t look[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

// jdhuff.c jpeg_make_d_derived_tbl
void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* symbols,
                   int total, bool dc) {
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < counts[l - 1]; i++) size[p++] = static_cast<uint8_t>(l);
  }
  size[p] = 0;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1u << si)) corrupt("JPEG: bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      t.valoffset[l] = p - static_cast<int32_t>(code_of[p]);
      p += counts[l - 1];
      t.maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 1; i <= counts[l - 1]; i++, p++) {
      uint32_t base = code_of[p] << (kLookBits - l);
      for (uint32_t c = 0; c < (1u << (kLookBits - l)); c++) {
        t.look[base + c] = static_cast<uint16_t>((l << 8) | symbols[p]);
      }
    }
  }
  std::memcpy(t.vals, symbols, static_cast<size_t>(total));
  std::memset(t.vals + total, 0, static_cast<size_t>(256 - total));
  if (dc) {
    for (int i = 0; i < total; i++) {
      if (symbols[i] > 15) corrupt("JPEG: bad DC Huffman table");
    }
  }
  t.defined = true;
}

// The entropy-coded bits of a scan: stuffed zeros removed, and zero bits
// supplied past a marker (libjpeg's fill_bit_buffer); once a decode reads
// such a bit, `insufficient` is set and the rest of the restart interval
// is left as it is (jdhuff.c's insufficient_data).
struct Bits {
  const uint8_t* d;
  int64_t n;
  int64_t pos;
  uint64_t buf = 0;  // the next bits, most significant first
  int nbits = 0;
  int padded = 0;  // zero bits at the end of buf that follow a marker
  bool at_marker = false;
  bool insufficient = false;

  Bits(const uint8_t* data, int64_t size, int64_t start)
      : d(data), n(size), pos(start) {}

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && pos < n) {
        byte = d[pos];
        if (byte == 0xFF) {
          int64_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;  // fill bytes
          if (q < n && d[q] == 0) {
            pos = q + 1;
          } else {
            at_marker = true;
            pos = q - 1;  // the 0xFF before the marker code
            byte = 0;
            padded += 8;
          }
        } else {
          pos++;
        }
      } else {
        padded += 8;
      }
      buf |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }

  inline void consume(int k) {
    buf <<= k;
    nbits -= k;
    if (nbits < padded) {
      insufficient = true;
      padded = nbits;
    }
  }

  inline uint32_t peek(int k) {
    if (nbits < k) fill();
    return static_cast<uint32_t>(buf >> (64 - k));
  }

  inline uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    consume(k);
    return v;
  }

  inline int decode(const Huffman& t) {
    uint32_t w = peek(16);
    uint16_t e = t.look[w >> (16 - kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(w >> (16 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = static_cast<int32_t>(w >> (16 - l));
    }
    if (l > 16) {
      // jpeg_huff_decode: a corrupt code gives a zero
      consume(16);
      return 0;
    }
    consume(l);
    return t.vals[code + t.valoffset[l]];
  }

  // a restart marker: the buffered bits dropped, the next marker read and
  // swallowed when it is a restart (read_restart_marker)
  void restart() {
    buf = 0;
    nbits = 0;
    padded = 0;
    at_marker = false;
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF) break;
      pos++;
    }
    if (pos + 1 < n && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
      pos += 2;
      insufficient = false;
    }
  }
};

inline int extend(uint32_t v, int s) {
  // HUFF_EXTEND
  return (s && v < (1u << (s - 1))) ? static_cast<int>(v) - ((1 << s) - 1)
                                    : static_cast<int>(v);
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // coefficient blocks a row and rows (MCU grid)
  int cw = 0, ch = 0;          // downsampled width and height
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  int32_t quant[64];           // latched at the component's first scan
  bool latched = false;
  int coef_bits[64];           // progressive: the bit each coefficient is known to
  int dc_last = 0;
};

const char* sof_mode(int marker) {
  switch (marker) {
    case 0xC3: return "lossless";
    case 0xC5: return "hierarchical sequential";
    case 0xC6: return "hierarchical progressive";
    case 0xC7: return "hierarchical lossless";
    case 0xC9: return "arithmetic-coded sequential";
    case 0xCA: return "arithmetic-coded progressive";
    case 0xCB: return "arithmetic-coded lossless";
    case 0xCD: return "arithmetic-coded hierarchical sequential";
    case 0xCE: return "arithmetic-coded hierarchical progressive";
    case 0xCF: return "arithmetic-coded hierarchical lossless";
    default: return nullptr;
  }
}

enum class Space { Gray, YCbCr, RGB, CMYK, YCCK };

inline uint16_t be16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

struct Jpeg {
  const uint8_t* d;
  int64_t n;
  int width = 0, height = 0;
  bool progressive = false, have_frame = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int32_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  Huffman dc_tables[4], ac_tables[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int transform = 0;

  Jpeg(const uint8_t* data, int64_t size) : d(data), n(size) {}

  // Reads the markers; with `header_only`, stops after the frame header.
  void run(bool header_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) corrupt("not a JPEG file");
    int64_t pos = 2;
    for (;;) {
      // next_marker: skip anything up to a 0xFF, then fill bytes
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) {
        if (!have_frame) corrupt("JPEG: no frame header");
        corrupt("JPEG: no EOI marker (the file is truncated)");
      }
      int marker = d[pos++];
      if (marker == 0xD9) break;  // EOI
      if (marker == 0xD8) corrupt("JPEG: a second SOI marker");
      if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      if (pos + 2 > n) corrupt("JPEG: a marker segment runs past the end");
      int length = be16(d + pos);
      if (length < 2 || pos + length > n)
        corrupt("JPEG: a marker segment runs past the end");
      const uint8_t* body = d + pos + 2;
      int blen = length - 2;
      pos += length;
      if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
        frame(body, blen, marker == 0xC2);
        if (header_only) return;
      } else if (const char* mode = sof_mode(marker)) {
        refuse(std::string("JPEG: ") + mode + " mode is not supported "
               "(baseline, extended sequential and progressive Huffman only)");
      } else if (marker == 0xC4) {
        dht(body, blen);
      } else if (marker == 0xCC) {
        refuse("JPEG: arithmetic coding (DAC marker) is not supported");
      } else if (marker == 0xDB) {
        dqt(body, blen);
      } else if (marker == 0xDD) {
        if (blen < 2) corrupt("JPEG: bad DRI marker");
        restart_interval = be16(body);
      } else if (marker == 0xE0) {
        // jdmarker.c examine_app0: at least 14 bytes, "JFIF\0"
        if (blen >= 14 && std::memcmp(body, "JFIF\0", 5) == 0) jfif = true;
      } else if (marker == 0xEE) {
        // examine_app14: at least 12 bytes, "Adobe"
        if (blen >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
          adobe = true;
          transform = body[11];
        }
      } else if (marker == 0xDA) {
        if (!have_frame) corrupt("JPEG: scan before the frame header");
        pos = scan(body, blen, pos);
      } else if (marker == 0xDC) {
        refuse("JPEG: a DNL marker (height defined after the scan) is not "
               "supported");
      }
      // APPn, COM and the rest: skipped
    }
    if (!have_frame) corrupt("JPEG: no frame header");
  }

  void frame(const uint8_t* b, int len, bool prog) {
    if (have_frame) corrupt("JPEG: a second frame header");
    if (len < 6) corrupt("JPEG: bad frame header");
    int precision = b[0];
    height = be16(b + 1);
    width = be16(b + 3);
    int nc = b[5];
    if (precision != 8)
      refuse("JPEG: " + std::to_string(precision) +
             "-bit samples are not supported (8-bit only)");
    if (height == 0)
      refuse("JPEG: a DNL marker (height defined after the scan) is not "
             "supported");
    if (width == 0) corrupt("JPEG: image width 0");
    if (nc != 1 && nc != 3 && nc != 4)
      refuse("JPEG: " + std::to_string(nc) +
             " components are not supported (1, 3 or 4)");
    if (len < 6 + 3 * nc) corrupt("JPEG: bad frame header");
    progressive = prog;
    comps.resize(nc);
    hmax = vmax = 1;
    for (int i = 0; i < nc; i++) {
      Component& c = comps[i];
      c.id = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        corrupt("JPEG: bad sampling factors");
      if (c.tq > 3) corrupt("JPEG: bad quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (const Component& c : comps) {
      if (hmax % c.h || vmax % c.v)
        refuse("JPEG: fractional sampling factors (a component's factors do "
               "not divide the largest) are not supported");
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    have_frame = true;
  }

  void allocate() {
    for (Component& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.cw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.ch = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
  }

  void dht(const uint8_t* b, int len) {
    int i = 0;
    while (i < len) {
      if (i + 17 > len) corrupt("JPEG: bad DHT marker");
      int tc = b[i] >> 4, th = b[i] & 15;
      if (tc > 1 || th > 3) corrupt("JPEG: bad Huffman table index");
      int total = 0;
      for (int l = 0; l < 16; l++) total += b[i + 1 + l];
      if (total > 256 || i + 17 + total > len)
        corrupt("JPEG: bad Huffman table");
      build_huffman(tc == 0 ? dc_tables[th] : ac_tables[th], b + i + 1,
                    b + i + 17, total, tc == 0);
      i += 17 + total;
    }
  }

  void dqt(const uint8_t* b, int len) {
    int i = 0;
    while (i < len) {
      int pq = b[i] >> 4, tq = b[i] & 15;
      if (tq > 3) corrupt("JPEG: bad quantization table index");
      int size = pq ? 128 : 64;
      if (i + 1 + size > len) corrupt("JPEG: bad DQT marker");
      for (int k = 0; k < 64; k++) {
        int v = pq ? be16(b + i + 1 + 2 * k) : b[i + 1 + k];
        qtables[tq][kNatural[k]] = v;
      }
      qdefined[tq] = true;
      i += 1 + size;
    }
  }

  // The scan's entropy-coded data from `pos`; returns where the next
  // marker starts.
  int64_t scan(const uint8_t* b, int len, int64_t pos) {
    if (comps.front().coef.empty()) allocate();
    if (len < 1) corrupt("JPEG: bad SOS marker");
    int ns = b[0];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) corrupt("JPEG: bad SOS marker");
    std::vector<int> in_scan(ns), dct(ns), act(ns);
    for (int k = 0; k < ns; k++) {
      int cid = b[1 + 2 * k], t = b[2 + 2 * k];
      int ci = -1;
      for (size_t j = 0; j < comps.size(); j++) {
        if (comps[j].id == cid) ci = static_cast<int>(j);
      }
      if (ci < 0) corrupt("JPEG: a scan names an unknown component");
      in_scan[k] = ci;
      dct[k] = t >> 4;
      act[k] = t & 15;
      if (dct[k] > 3 || act[k] > 3) corrupt("JPEG: bad Huffman table index");
    }
    int ss = b[1 + 2 * ns], se = b[2 + 2 * ns];
    int ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
    // jdinput.c latch_quant_tables: a component's table at its first scan
    for (int ci : in_scan) {
      Component& c = comps[ci];
      if (!c.latched) {
        if (!qdefined[c.tq]) corrupt("JPEG: a quantization table is missing");
        std::memcpy(c.quant, qtables[c.tq], sizeof(c.quant));
        c.latched = true;
      }
    }
    if (progressive) {
      bool dc_band = ss == 0;
      bool bad = false;
      if (dc_band) {
        if (se != 0) bad = true;
      } else {
        if (ss > se || se > 63 || ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) corrupt("JPEG: bad progressive scan parameters");
      for (int ci : in_scan) {
        for (int k = ss; k <= se; k++) comps[ci].coef_bits[k] = al;
      }
    } else {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) {
        // libjpeg warns and decodes the whole band
      }
    }
    for (int k = 0; k < ns; k++) {
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss != 0;
      if (need_dc && !dc_tables[dct[k]].defined)
        corrupt("JPEG: a Huffman table is missing");
      if (need_ac && !ac_tables[act[k]].defined)
        corrupt("JPEG: a Huffman table is missing");
    }

    // the scan's blocks: (component, block index) in decode order
    struct Slot { int ci; const Huffman* dc; const Huffman* ac; };
    std::vector<Slot> layout;
    std::vector<int> offs;  // within an MCU: block offset from the MCU's origin
    int64_t mcus;
    int per_row;
    if (ns == 1) {
      Component& c = comps[in_scan[0]];
      per_row = (c.cw + 7) / 8;
      int rows = (c.ch + 7) / 8;
      mcus = static_cast<int64_t>(per_row) * rows;
      layout.push_back({in_scan[0], &dc_tables[dct[0]], &ac_tables[act[0]]});
      offs.push_back(0);
    } else {
      per_row = mcux;
      mcus = static_cast<int64_t>(mcux) * mcuy;
      for (int k = 0; k < ns; k++) {
        Component& c = comps[in_scan[k]];
        for (int y = 0; y < c.v; y++) {
          for (int x = 0; x < c.h; x++) {
            layout.push_back({in_scan[k], &dc_tables[dct[k]], &ac_tables[act[k]]});
            offs.push_back(y * c.bw + x);
          }
        }
      }
    }
    if (layout.size() > 10)
      refuse("JPEG: an interleaved scan of more than 10 blocks an MCU "
             "(sampling factors too large) is not supported");

    Bits bits(d, n, pos);
    for (Component& c : comps) c.dc_last = 0;
    int eobrun = 0;
    for (int64_t m = 0; m < mcus; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        bits.restart();
        for (Component& c : comps) c.dc_last = 0;
        eobrun = 0;
      }
      if (bits.insufficient) continue;
      int my = static_cast<int>(m / per_row), mx = static_cast<int>(m % per_row);
      for (size_t s = 0; s < layout.size(); s++) {
        Component& c = comps[layout[s].ci];
        int64_t block;
        if (ns == 1) {
          block = static_cast<int64_t>(my) * c.bw + mx;
        } else {
          block = static_cast<int64_t>(my) * c.v * c.bw +
                  static_cast<int64_t>(mx) * c.h + offs[s];
        }
        int16_t* blk = c.coef.data() + block * 64;
        if (!progressive) {
          sequential_block(bits, *layout[s].dc, *layout[s].ac, c.dc_last, blk);
        } else if (ss == 0) {
          if (ah == 0) {
            int sdc = bits.decode(*layout[s].dc);
            int diff = extend(bits.get(sdc), sdc);
            c.dc_last += diff;
            blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_last) << al);
          } else if (bits.get(1)) {
            blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
          }
        } else if (ah == 0) {
          ac_first(bits, *layout[s].ac, ss, se, al, eobrun, blk);
        } else {
          ac_refine(bits, *layout[s].ac, ss, se, al, eobrun, blk);
        }
      }
    }
    // the next marker: past the scan's data (next_marker skips the rest)
    int64_t p = bits.pos;
    while (p + 1 < n) {
      if (d[p] == 0xFF && d[p + 1] != 0 && d[p + 1] != 0xFF &&
          !(d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7))
        break;
      p++;
    }
    return p;
  }

  static void sequential_block(Bits& bits, const Huffman& dc,
                               const Huffman& ac, int& last, int16_t* blk) {
    int s = bits.decode(dc);
    int diff = extend(bits.get(s), s);
    last += diff;
    blk[0] = static_cast<int16_t>(last);
    for (int k = 1; k < 64; k++) {
      int rs = bits.decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(bits.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void ac_first(Bits& bits, const Huffman& ac, int ss, int se, int al,
                       int& eobrun, int16_t* blk) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = bits.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(bits.get(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += static_cast<int>(bits.get(r));
        eobrun--;
        break;
      }
    }
  }

  static void ac_refine(Bits& bits, const Huffman& ac, int ss, int se, int al,
                        int& eobrun, int16_t* blk) {
    int p1 = 1 << al;
    int m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = bits.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(bits.get(r));
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (bits.get(1)) {
              if ((*coef & p1) == 0) {
                *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
              }
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (bits.get(1)) {
            if ((*coef & p1) == 0) {
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          }
        }
      }
      eobrun--;
    }
  }

  // jdcoefct.c smoothing_ok at the output pass: progressive, every
  // component's DC at least partly known and its first ten quantizers
  // nonzero, and some coefficient 1-9 of some component not fully known
  bool would_smooth() const {
    if (!progressive) return false;
    bool useful = false;
    for (const Component& c : comps) {
      if (!c.latched) return false;
      for (int k = 0; k < 10; k++) {
        if (c.quant[kNatural[k]] == 0) return false;
      }
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++) {
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  Space space() const {
    // jdapimin.c default_decompress_parms
    if (comps.size() == 1) return Space::Gray;
    if (comps.size() == 3) {
      if (jfif) return Space::YCbCr;
      if (adobe) return transform == 0 ? Space::RGB : Space::YCbCr;
      if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66)
        return Space::RGB;
      return Space::YCbCr;
    }
    if (adobe) return transform == 0 ? Space::CMYK : Space::YCCK;
    return Space::CMYK;
  }
};

// jidctint.c
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270;
constexpr int32_t F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137;
constexpr int32_t F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

struct Tables {
  uint8_t idct_limit[1024];   // descaled IDCT value & 1023 -> sample
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  Tables() {
    for (int i = 0; i < 1024; i++) {
      int x = i >= 512 ? i - 1024 : i;
      idct_limit[i] = static_cast<uint8_t>(std::min(255, std::max(0, x + 128)));
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    const int64_t half = 1 << 15;
    auto fix = [](double v) { return static_cast<int64_t>(v * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int32_t>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int32_t>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + half);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jpeg_idct_islow: dequantize a block (natural order) and write 8x8
// samples at out with row stride `stride`
void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out,
                int stride, const uint8_t* limit) {
  int32_t ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* c = in + col;
    const int32_t* qq = q + col;
    if (c[8] == 0 && c[16] == 0 && c[24] == 0 && c[32] == 0 && c[40] == 0 &&
        c[48] == 0 && c[56] == 0) {
      int32_t dc = (c[0] * qq[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) ws[r * 8 + col] = dc;
      continue;
    }
    int32_t z2 = c[16] * qq[16], z3 = c[48] * qq[48];
    int32_t z1 = (z2 + z3) * F0541;
    int32_t tmp2 = z1 + z3 * (-F1847);
    int32_t tmp3 = z1 + z2 * F0765;
    z2 = c[0] * qq[0];
    z3 = c[32] * qq[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int32_t t0 = c[56] * qq[56], t1 = c[40] * qq[40];
    int32_t t2 = c[24] * qq[24], t3 = c[8] * qq[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int32_t z4 = t1 + t3;
    int32_t z5 = (z3 + z4) * F1175;
    t0 *= F0298;
    t1 *= F2053;
    t2 *= F3072;
    t3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * (-F1961) + z5;
    z4 = z4 * (-F0390) + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    constexpr int sh = kConstBits - kPass1Bits;
    constexpr int32_t rnd = 1 << (sh - 1);
    ws[0 * 8 + col] = (tmp10 + t3 + rnd) >> sh;
    ws[7 * 8 + col] = (tmp10 - t3 + rnd) >> sh;
    ws[1 * 8 + col] = (tmp11 + t2 + rnd) >> sh;
    ws[6 * 8 + col] = (tmp11 - t2 + rnd) >> sh;
    ws[2 * 8 + col] = (tmp12 + t1 + rnd) >> sh;
    ws[5 * 8 + col] = (tmp12 - t1 + rnd) >> sh;
    ws[3 * 8 + col] = (tmp13 + t0 + rnd) >> sh;
    ws[4 * 8 + col] = (tmp13 - t0 + rnd) >> sh;
  }
  constexpr int sh = kConstBits + kPass1Bits + 3;
  constexpr int32_t rnd = 1 << (sh - 1);
  for (int row = 0; row < 8; row++) {
    const int32_t* w = ws + row * 8;
    uint8_t* o = out + static_cast<int64_t>(row) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = limit[((w[0] + (1 << (kPass1Bits + 2))) >> (kPass1Bits + 3)) & 1023];
      std::memset(o, v, 8);
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * F0541;
    int32_t tmp2 = z1 + z3 * (-F1847);
    int32_t tmp3 = z1 + z2 * F0765;
    int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int32_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int32_t t0 = w[7], t1 = w[5], t2 = w[3], t3 = w[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int32_t z4 = t1 + t3;
    int32_t z5 = (z3 + z4) * F1175;
    t0 *= F0298;
    t1 *= F2053;
    t2 *= F3072;
    t3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * (-F1961) + z5;
    z4 = z4 * (-F0390) + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    o[0] = limit[((tmp10 + t3 + rnd) >> sh) & 1023];
    o[7] = limit[((tmp10 - t3 + rnd) >> sh) & 1023];
    o[1] = limit[((tmp11 + t2 + rnd) >> sh) & 1023];
    o[6] = limit[((tmp11 - t2 + rnd) >> sh) & 1023];
    o[2] = limit[((tmp12 + t1 + rnd) >> sh) & 1023];
    o[5] = limit[((tmp12 - t1 + rnd) >> sh) & 1023];
    o[3] = limit[((tmp13 + t0 + rnd) >> sh) & 1023];
    o[4] = limit[((tmp13 - t0 + rnd) >> sh) & 1023];
  }
}

// A component's samples at full size, [height][width], from its
// downsampled plane (cw x ch valid of a `stride`-wide buffer), with the
// upsampler jdsample.c jinit_upsampler picks for the ratio (hr, vr).
void upsample(const uint8_t* src, int stride, int cw, int ch, int hr, int vr,
              uint8_t* dst, int width, int height) {
  auto row = [&](int r) { return src + static_cast<int64_t>(r) * stride; };
  std::vector<int> colsum(static_cast<size_t>(cw));
  std::vector<uint8_t> wide(static_cast<size_t>(cw) * hr + 8);
  for (int y = 0; y < height; y++) {
    uint8_t* o = dst + static_cast<int64_t>(y) * width;
    int r = y / vr;
    if (hr == 1 && vr == 1) {
      std::memcpy(o, row(y), static_cast<size_t>(width));
    } else if (hr == 2 && vr == 1 && cw > 2) {
      // h2v1_fancy_upsample
      const uint8_t* in = row(r);
      uint8_t* w = wide.data();
      w[0] = in[0];
      w[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < cw - 1; x++) {
        int v = in[x] * 3;
        w[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
        w[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
      }
      int v = in[cw - 1];
      w[2 * cw - 2] = static_cast<uint8_t>((v * 3 + in[cw - 2] + 1) >> 2);
      w[2 * cw - 1] = static_cast<uint8_t>(v);
      std::memcpy(o, w, static_cast<size_t>(width));
    } else if (hr == 1 && vr == 2) {
      // h1v2_fancy_upsample: the nearer input row 3x, the other 1x
      int above = y % 2 == 0;
      int other = above ? std::max(r - 1, 0) : std::min(r + 1, ch - 1);
      int bias = above ? 1 : 2;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(other);
      for (int x = 0; x < width; x++) {
        o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    } else if (hr == 2 && vr == 2 && cw > 2) {
      // h2v2_fancy_upsample
      int above = y % 2 == 0;
      int other = above ? std::max(r - 1, 0) : std::min(r + 1, ch - 1);
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(other);
      int* cs = colsum.data();
      for (int x = 0; x < cw; x++) cs[x] = in0[x] * 3 + in1[x];
      uint8_t* w = wide.data();
      w[0] = static_cast<uint8_t>((cs[0] * 4 + 8) >> 4);
      w[1] = static_cast<uint8_t>((cs[0] * 3 + cs[1] + 7) >> 4);
      for (int x = 1; x < cw - 1; x++) {
        w[2 * x] = static_cast<uint8_t>((cs[x] * 3 + cs[x - 1] + 8) >> 4);
        w[2 * x + 1] = static_cast<uint8_t>((cs[x] * 3 + cs[x + 1] + 7) >> 4);
      }
      w[2 * cw - 2] = static_cast<uint8_t>((cs[cw - 1] * 3 + cs[cw - 2] + 8) >> 4);
      w[2 * cw - 1] = static_cast<uint8_t>((cs[cw - 1] * 4 + 7) >> 4);
      std::memcpy(o, w, static_cast<size_t>(width));
    } else {
      // int_upsample, h2v1_upsample, h2v2_upsample: box replication
      const uint8_t* in = row(r);
      for (int x = 0; x < width; x++) o[x] = in[x / hr];
    }
  }
}

void decode_jpeg(Jpeg& j, uint8_t* out) {
  j.run(false);
  if (j.comps.front().coef.empty()) j.allocate();
  if (j.would_smooth())
    refuse("JPEG: a progressive file whose scans leave low-frequency "
           "coefficients incomplete is block-smoothed by libjpeg-turbo; "
           "block smoothing is not supported");
  const Tables& t = tables();
  const int W = j.width, H = j.height;
  size_t nc = j.comps.size();
  std::vector<std::vector<uint8_t>> full(nc);
  std::vector<uint8_t> plane;
  for (size_t ci = 0; ci < nc; ci++) {
    Component& c = j.comps[ci];
    int bx = (c.cw + 7) / 8, by = (c.ch + 7) / 8;
    int stride = bx * 8;
    plane.assign(static_cast<size_t>(stride) * by * 8, 0);
    for (int y = 0; y < by; y++) {
      for (int x = 0; x < bx; x++) {
        idct_islow(c.coef.data() + (static_cast<int64_t>(y) * c.bw + x) * 64,
                   c.quant, plane.data() + static_cast<int64_t>(y) * 8 * stride + x * 8,
                   stride, t.idct_limit);
      }
    }
    std::vector<int16_t>().swap(c.coef);
    full[ci].resize(static_cast<size_t>(W) * H);
    upsample(plane.data(), stride, c.cw, c.ch, j.hmax / c.h, j.vmax / c.v,
             full[ci].data(), W, H);
  }
  const int64_t npix = static_cast<int64_t>(W) * H;
  Space s = j.space();
  if (s == Space::Gray) {
    const uint8_t* g = full[0].data();
    for (int64_t i = 0; i < npix; i++) {
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
    }
  } else if (s == Space::RGB) {
    for (int64_t i = 0; i < npix; i++) {
      out[3 * i] = full[0][i];
      out[3 * i + 1] = full[1][i];
      out[3 * i + 2] = full[2][i];
    }
  } else if (s == Space::YCbCr) {
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
    for (int64_t i = 0; i < npix; i++) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i] = clamp255(y + t.cr_r[cr]);
      out[3 * i + 1] = clamp255(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + t.cb_b[cb]);
    }
  } else {
    // CMYK from libjpeg (YCCK through ycck_cmyk_convert), then Pillow's
    // "CMYK;I" unpack (255 - v) and Convert.c cmyk2rgb
    const uint8_t *P0 = full[0].data(), *P1 = full[1].data(),
                  *P2 = full[2].data(), *P3 = full[3].data();
    for (int64_t i = 0; i < npix; i++) {
      int c0 = P0[i], c1 = P1[i], c2 = P2[i];
      if (s == Space::YCCK) {
        int y = c0, cb = c1, cr = c2;
        c0 = clamp255(255 - (y + t.cr_r[cr]));
        c1 = clamp255(255 - (y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
        c2 = clamp255(255 - (y + t.cb_b[cb]));
      }
      int nk = P3[i];  // 255 - (255 - k)
      int cmy[3] = {255 - c0, 255 - c1, 255 - c2};
      for (int k = 0; k < 3; k++) {
        int tmp = cmy[k] * nk + 128;
        int mul = ((tmp >> 8) + tmp) >> 8;
        out[3 * i + k] = clamp255(nk - mul);
      }
    }
  }
}

// -------------------------------------------------------------------- PNG

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Undo the row filters of one image (or Adam7 pass) of `rows` rows of
// `stride` bytes, each after its filter byte; returns the bytes read.
int64_t unfilter(const uint8_t* raw, int64_t avail, int rows, int64_t stride,
                 int bpp, uint8_t* out) {
  int64_t need = static_cast<int64_t>(rows) * (stride + 1);
  if (avail < need) corrupt("PNG: image data too short");
  std::vector<uint8_t> zero(static_cast<size_t>(stride), 0);
  const uint8_t* prior = zero.data();
  for (int y = 0; y < rows; y++) {
    const uint8_t* in = raw + y * (stride + 1);
    uint8_t* cur = out + y * stride;
    int kind = in[0];
    in++;
    switch (kind) {
      case 0:
        std::memcpy(cur, in, static_cast<size_t>(stride));
        break;
      case 1:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = static_cast<uint8_t>(in[i] + prior[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = static_cast<uint8_t>(
              in[i] + (((i >= bpp ? cur[i - bpp] : 0) + prior[i]) >> 1));
        break;
      case 4:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int c = i >= bpp ? prior[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(in[i] + paeth(a, prior[i], c));
        }
        break;
      default:
        corrupt("PNG: unknown row filter " + std::to_string(kind));
    }
    prior = cur;
  }
  return need;
}

struct PngFormat {
  int channels;
  int depth;
  int color;
  const uint8_t* palette;
  int entries;
};

// sample i of a row of `depth`-bit samples
inline int sample(const uint8_t* row, int64_t i, int depth) {
  switch (depth) {
    case 8: return row[i];
    case 16: return (row[2 * i] << 8) | row[2 * i + 1];
    default: {
      int64_t bit = i * depth;
      int shift = 8 - depth - static_cast<int>(bit & 7);
      return (row[bit >> 3] >> shift) & ((1 << depth) - 1);
    }
  }
}

// one row of unfiltered pixels -> RGB at out[3 * x * step] for its xs
void convert_row(const PngFormat& f, const uint8_t* row, int count,
                 uint8_t* out, int step) {
  for (int x = 0; x < count; x++) {
    uint8_t* o = out + static_cast<int64_t>(3) * x * step;
    int64_t s0 = static_cast<int64_t>(x) * f.channels;
    if (f.color == 3) {
      int idx = sample(row, s0, f.depth);
      if (idx < f.entries) {
        o[0] = f.palette[3 * idx];
        o[1] = f.palette[3 * idx + 1];
        o[2] = f.palette[3 * idx + 2];
      } else {
        o[0] = o[1] = o[2] = 0;
      }
      continue;
    }
    if (f.color == 0 || f.color == 4) {
      int v = sample(row, s0, f.depth);
      uint8_t g;
      switch (f.depth) {
        case 1: g = v ? 255 : 0; break;
        case 2: g = static_cast<uint8_t>(v * 85); break;
        case 4: g = static_cast<uint8_t>(v * 17); break;
        case 8: g = static_cast<uint8_t>(v); break;
        default:
          // gray 16 opens as "I;16", clipped to 255; gray + alpha 16 as
          // "LA;16B", the high byte
          g = f.color == 0 ? static_cast<uint8_t>(std::min(v, 255))
                           : static_cast<uint8_t>(v >> 8);
      }
      o[0] = o[1] = o[2] = g;
      continue;
    }
    for (int k = 0; k < 3; k++) {
      int v = sample(row, s0 + k, f.depth);
      o[k] = static_cast<uint8_t>(f.depth == 16 ? v >> 8 : v);
    }
  }
}

void decode_png(const uint8_t* raw, int64_t n, int width, int height,
                int depth, int color, int interlace, const uint8_t* palette,
                int entries, uint8_t* out) {
  int channels;
  bool ok;
  switch (color) {
    case 0: channels = 1; ok = depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16; break;
    case 2: channels = 3; ok = depth == 8 || depth == 16; break;
    case 3: channels = 1; ok = depth == 1 || depth == 2 || depth == 4 || depth == 8; break;
    case 4: channels = 2; ok = depth == 8 || depth == 16; break;
    case 6: channels = 4; ok = depth == 8 || depth == 16; break;
    default: corrupt("PNG: unknown colour type " + std::to_string(color));
  }
  if (!ok)
    corrupt("PNG: bit depth " + std::to_string(depth) +
            " is not valid for colour type " + std::to_string(color));
  if (interlace > 1) corrupt("PNG: unknown interlace method");
  if (color == 3 && palette == nullptr)
    corrupt("PNG: palette image without a PLTE chunk");
  PngFormat f{channels, depth, color, palette, entries};
  int bits_pp = channels * depth;
  int bpp = std::max(1, bits_pp / 8);
  // Adam7 passes: x0, y0, dx, dy
  static const int passes[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                   {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                   {0, 1, 1, 2}};
  static const int whole[1][4] = {{0, 0, 1, 1}};
  const int(*plan)[4] = interlace ? passes : whole;
  int count = interlace ? 7 : 1;
  int64_t at = 0;
  std::vector<uint8_t> buf;
  for (int p = 0; p < count; p++) {
    int x0 = plan[p][0], y0 = plan[p][1], dx = plan[p][2], dy = plan[p][3];
    int pw = (width - x0 + dx - 1) / dx, ph = (height - y0 + dy - 1) / dy;
    if (width <= x0) pw = 0;
    if (height <= y0) ph = 0;
    if (pw == 0 || ph == 0) continue;  // an empty pass holds no bytes
    int64_t stride = (static_cast<int64_t>(pw) * bits_pp + 7) / 8;
    buf.resize(static_cast<size_t>(stride) * ph);
    at += unfilter(raw + at, n - at, ph, stride, bpp, buf.data());
    for (int y = 0; y < ph; y++) {
      int64_t oy = y0 + static_cast<int64_t>(y) * dy;
      convert_row(f, buf.data() + y * stride, pw,
                  out + (oy * width + x0) * 3, dx);
    }
  }
}

// -------------------------------------------------------------------- BMP

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// A BMP as BmpImagePlugin.py opens it.
struct Bmp {
  int64_t width = 0, height = 0;
  int bits = 0;
  uint32_t compression = 0;
  bool top_down = false;
  int64_t offset = 0;             // the pixel data (or RLE data)
  // mode "P": a palette lookup (black past the file's entries); mode "L"
  // (a grayscale palette of 8-bit indices): the index itself
  std::vector<uint8_t> palette;   // RGB triples
  bool gray = false;
  int rgb_at[3] = {2, 1, 0};      // 32-bit: byte of R, G and B in a pixel
  int depth16 = 15;               // 16-bit: 5-5-5 ("BGR;15") or 5-6-5

  Bmp(const uint8_t* d, int64_t n) {
    if (n < 18 || d[0] != 'B' || d[1] != 'M') corrupt("not a BMP file");
    offset = le32(d + 10);
    uint32_t hs = le32(d + 14);
    int64_t pos = 14;
    if (hs < 4 || pos + hs > n) corrupt("BMP: truncated header");
    const uint8_t* h = d + 18;
    uint32_t colors = 0;
    int padding = 4;
    uint32_t mask[4] = {0, 0, 0, 0};
    if (hs == 12) {
      width = le16(h);
      height = le16(h + 2);
      bits = static_cast<int>(le16(h + 6));
      padding = 3;
      pos += hs;
    } else if (hs == 40 || hs == 52 || hs == 56 || hs == 64 || hs == 108 ||
               hs == 124) {
      top_down = h[7] == 0xFF;
      width = le32(h);
      height = top_down ? (int64_t{1} << 32) - le32(h + 4) : le32(h + 4);
      bits = static_cast<int>(le16(h + 10));
      compression = le32(h + 12);
      colors = le32(h + 28);
      pos += hs;
      if (compression == 3) {
        if (hs >= 52) {
          for (int i = 0; i < 3; i++) mask[i] = le32(h + 36 + 4 * i);
          if (hs >= 56) mask[3] = le32(h + 48);
        } else {
          if (pos + 12 > n) corrupt("BMP: truncated bit fields");
          for (int i = 0; i < 3; i++) mask[i] = le32(d + pos + 4 * i);
          pos += 12;
        }
      }
    } else {
      refuse("BMP: header type " + std::to_string(hs) + " is not supported");
    }
    if (colors == 0) colors = bits < 32 ? 1u << bits : 0u;
    if (offset == 14 + static_cast<int64_t>(hs) && bits <= 8)
      offset += 4 * static_cast<int64_t>(colors);
    if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 &&
        bits != 32)
      refuse("BMP: pixel depth " + std::to_string(bits) +
             " is not supported");
    if (compression == 3) {
      // the bit-field layouts Pillow reads
      static const uint32_t k32[8][4] = {
          {0xFF0000, 0xFF00, 0xFF, 0x0},
          {0xFF000000, 0xFF0000, 0xFF00, 0x0},
          {0xFF000000, 0xFF00, 0xFF, 0x0},
          {0xFF000000, 0xFF0000, 0xFF00, 0xFF},
          {0xFF, 0xFF00, 0xFF0000, 0xFF000000},
          {0xFF0000, 0xFF00, 0xFF, 0xFF000000},
          {0xFF000000, 0xFF00, 0xFF, 0xFF0000},
          {0x0, 0x0, 0x0, 0x0}};
      bool ok = false;
      if (bits == 32) {
        for (const auto& m : k32) {
          if (std::equal(m, m + 4, mask)) {
            ok = true;
            if (mask[0] == 0) break;  // all zero: "BGRA"
            for (int c = 0; c < 3; c++)
              rgb_at[c] = __builtin_ctz(mask[c]) / 8;
            break;
          }
        }
      } else if (bits == 24) {
        ok = mask[0] == 0xFF0000 && mask[1] == 0xFF00 && mask[2] == 0xFF;
      } else if (bits == 16) {
        if (mask[0] == 0xF800 && mask[1] == 0x7E0 && mask[2] == 0x1F) {
          ok = true;
          depth16 = 16;
        } else {
          ok = mask[0] == 0x7C00 && mask[1] == 0x3E0 && mask[2] == 0x1F;
        }
      }
      if (!ok) refuse("BMP: this bit-fields layout is not supported");
    } else if (compression == 1 || compression == 2) {
      if (bits > 8)
        refuse("BMP: RLE compression of " + std::to_string(bits) +
               "-bit pixels is not supported");
    } else if (compression != 0) {
      const char* name = compression == 4   ? " (JPEG)"
                         : compression == 5 ? " (PNG)"
                                            : "";
      refuse("BMP: compression " + std::to_string(compression) + name +
             " is not supported");
    }
    if (bits <= 8) {
      if (colors == 0 || colors > 65536)
        refuse("BMP: palette size " + std::to_string(colors) +
               " is not supported");
      int64_t avail = std::max<int64_t>(0, std::min<int64_t>(
          n - pos, static_cast<int64_t>(padding) * colors));
      const uint8_t* p = d + pos;
      gray = true;
      for (uint32_t i = 0; i < colors; i++) {
        uint8_t v = colors == 2 ? (i ? 255 : 0) : static_cast<uint8_t>(i);
        int64_t at = static_cast<int64_t>(i) * padding;
        if (at + 3 > avail || p[at] != v || p[at + 1] != v || p[at + 2] != v) {
          gray = false;
          break;
        }
      }
      int64_t entries = std::min<int64_t>(avail / padding, 256);
      palette.assign(256 * 3, 0);
      for (int64_t i = 0; i < entries; i++) {
        palette[3 * i] = p[i * padding + 2];
        palette[3 * i + 1] = p[i * padding + 1];
        palette[3 * i + 2] = p[i * padding];
      }
      if (gray) {
        // mode "1" over 1-bit pixels and mode "L" over 8-bit ones are a
        // lookup in this palette; Pillow reads other bit depths under a
        // grayscale palette with the wrong unpacker
        bool one = colors == 2 && bits == 1 && compression == 0;
        bool l8 = colors != 2 && bits == 8;
        bool rle_l = colors != 2 && (compression == 1 || compression == 2);
        if (!one && !l8 && !rle_l)
          refuse("BMP: a " + std::to_string(bits) +
                 "-bit image under a grayscale palette of " +
                 std::to_string(colors) + " colours is not supported");
        gray = !one;
      }
    }
    if (offset == 0) offset = pos + (bits <= 8 ? static_cast<int64_t>(padding) * colors : 0);
  }
};

// BmpRleDecoder.decode of BmpImagePlugin.py: the indices of the whole
// image in file row order (rows of width), or a ValueError when they do
// not fill it.
std::vector<uint8_t> bmp_rle(const uint8_t* d, int64_t n, int64_t pos,
                             int64_t width, int64_t height, bool rle4) {
  const int64_t need = width * height;
  std::vector<uint8_t> data;
  data.reserve(static_cast<size_t>(need));
  int64_t x = 0;
  while (static_cast<int64_t>(data.size()) < need) {
    if (pos + 2 > n) break;
    int num = d[pos], byte = d[pos + 1];
    pos += 2;
    if (num) {
      if (x + num > width) num = static_cast<int>(std::max<int64_t>(0, width - x));
      for (int i = 0; i < num; i++)
        data.push_back(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte);
      x += num;
    } else if (byte == 0) {
      while (data.size() % width) data.push_back(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      // Pillow reads two bytes it drops, then right and up
      if (pos + 2 > n) break;
      if (pos + 4 > n) corrupt("BMP: truncated RLE delta");
      int64_t right = d[pos + 2], up = d[pos + 3];
      pos += 4;
      data.resize(data.size() + right + up * width, 0);
      x = static_cast<int64_t>(data.size() % width);
    } else {
      int64_t count = rle4 ? byte / 2 : byte;
      int64_t got = std::min(count, n - pos);
      for (int64_t i = 0; i < got; i++) {
        uint8_t b = d[pos + i];
        if (rle4) {
          data.push_back(b >> 4);
          data.push_back(b & 15);
        } else {
          data.push_back(b);
        }
      }
      pos += got;
      if (got < count) break;
      x += byte;
      if (pos % 2) pos++;
    }
  }
  if (static_cast<int64_t>(data.size()) < need)
    corrupt("BMP: not enough image data");
  data.resize(static_cast<size_t>(need));
  return data;
}

// into out [height, width, 3]: the size mrt_bmp_size gave
void decode_bmp(const uint8_t* d, int64_t n, uint8_t* out, int64_t height,
                int64_t width) {
  Bmp b(d, n);
  if (b.width != width || b.height != height)
    corrupt("BMP: the image's size changed");
  const int64_t w = b.width, h = b.height;
  auto index_out = [&](uint8_t v, uint8_t* o) {
    if (b.gray) {
      o[0] = o[1] = o[2] = v;
    } else {
      std::memcpy(o, &b.palette[3 * v], 3);
    }
  };
  if (b.compression == 1 || b.compression == 2) {
    std::vector<uint8_t> idx = bmp_rle(d, n, b.offset, w, h, b.compression == 2);
    for (int64_t r = 0; r < h; r++) {
      int64_t y = b.top_down ? r : h - 1 - r;
      for (int64_t x = 0; x < w; x++)
        index_out(idx[r * w + x], out + (y * w + x) * 3);
    }
    return;
  }
  const int64_t stride = ((w * b.bits + 31) >> 3) & ~int64_t{3};
  if (b.offset < 0 || b.offset > n || (n - b.offset) / std::max<int64_t>(stride, 1) < h)
    corrupt("BMP: image file is truncated");
  for (int64_t r = 0; r < h; r++) {
    const uint8_t* row = d + b.offset + r * stride;
    int64_t y = b.top_down ? r : h - 1 - r;
    uint8_t* o = out + y * w * 3;
    switch (b.bits) {
      case 1:
      case 4:
      case 8: {
        const int per = 8 / b.bits, mask = (1 << b.bits) - 1;
        for (int64_t x = 0; x < w; x++) {
          int shift = 8 - b.bits * (static_cast<int>(x % per) + 1);
          index_out((row[x / per] >> shift) & mask, o + x * 3);
        }
        break;
      }
      case 16:
        for (int64_t x = 0; x < w; x++) {
          uint32_t p = le16(row + 2 * x);
          if (b.depth16 == 16) {
            o[3 * x] = static_cast<uint8_t>(((p >> 11) & 31) * 255 / 31);
            o[3 * x + 1] = static_cast<uint8_t>(((p >> 5) & 63) * 255 / 63);
          } else {
            o[3 * x] = static_cast<uint8_t>(((p >> 10) & 31) * 255 / 31);
            o[3 * x + 1] = static_cast<uint8_t>(((p >> 5) & 31) * 255 / 31);
          }
          o[3 * x + 2] = static_cast<uint8_t>((p & 31) * 255 / 31);
        }
        break;
      case 24:
        for (int64_t x = 0; x < w; x++) {
          o[3 * x] = row[3 * x + 2];
          o[3 * x + 1] = row[3 * x + 1];
          o[3 * x + 2] = row[3 * x];
        }
        break;
      default:
        for (int64_t x = 0; x < w; x++)
          for (int c = 0; c < 3; c++) o[3 * x + c] = row[4 * x + b.rgb_at[c]];
    }
  }
}

// -------------------------------------------------------------------- GIF

// The first frame of a GIF as GifImagePlugin.py opens it.
struct Gif {
  int64_t width = 0, height = 0;  // the screen, grown to hold the frame
  int64_t x0 = 0, y0 = 0, fw = 0, fh = 0;
  bool interlace = false;
  int code_size = 0;
  int transparency = -1;
  bool has_palette = false;       // mode "P"; else "L"
  std::vector<uint8_t> palette;   // 256 RGB triples, black past the file's
  int64_t data = 0;               // the first sub-block of image data

  // _is_palette_needed: false for the table 0, 1, 2, ... of grays
  static bool palette_needed(const uint8_t* p, int64_t len) {
    for (int64_t i = 0; i < len; i += 3) {
      if (i + 2 >= len || p[i] != i / 3 || p[i + 1] != p[i] ||
          p[i + 2] != p[i])
        return true;
    }
    return false;
  }

  void set_palette(const uint8_t* p, int64_t len) {
    has_palette = true;
    palette.assign(256 * 3, 0);
    std::memcpy(palette.data(), p, static_cast<size_t>(std::min<int64_t>(len / 3, 256) * 3));
  }

  Gif(const uint8_t* d, int64_t n) {
    if (n < 13 || (std::memcmp(d, "GIF87a", 6) && std::memcmp(d, "GIF89a", 6)))
      corrupt("not a GIF file");
    width = le16(d + 6);
    height = le16(d + 8);
    int64_t pos = 13;
    uint8_t flags = d[10];
    if (flags & 128) {
      int64_t len = std::min<int64_t>(3 << ((flags & 7) + 1), n - pos);
      if (palette_needed(d + pos, len)) set_palette(d + pos, len);
      pos += len;
    }
    // the blocks up to the first image: extensions are skipped, but for
    // the graphic control extension's transparency index
    auto sub_block = [&](int64_t& at, const uint8_t** body) -> int64_t {
      if (at >= n || d[at] == 0) {
        if (at < n) at++;
        return 0;
      }
      int64_t len = std::min<int64_t>(d[at], n - at - 1);
      *body = d + at + 1;
      at += 1 + len;
      return len;
    };
    for (;;) {
      if (pos >= n || d[pos] == ';') corrupt("GIF: no image in the file");
      uint8_t s = d[pos++];
      if (s == '!') {
        if (pos >= n) corrupt("GIF: no image in the file");
        uint8_t label = d[pos++];
        const uint8_t* body = nullptr;
        int64_t len = sub_block(pos, &body);
        if (label == 249 && len) {
          if (len < 3 || ((body[0] & 1) && len < 4))
            corrupt("GIF: short graphic control extension");
          if (body[0] & 1) transparency = body[3];
        }
        while (len) len = sub_block(pos, &body);
      } else if (s == ',') {
        if (pos + 9 > n) corrupt("GIF: truncated image descriptor");
        x0 = le16(d + pos);
        y0 = le16(d + pos + 2);
        fw = le16(d + pos + 4);
        fh = le16(d + pos + 6);
        uint8_t lflags = d[pos + 8];
        pos += 9;
        width = std::max(width, x0 + fw);
        height = std::max(height, y0 + fh);
        interlace = lflags & 64;
        if (lflags & 128) {
          int64_t len = std::min<int64_t>(3 << ((lflags & 7) + 1), n - pos);
          if (palette_needed(d + pos, len)) {
            set_palette(d + pos, len);
          } else {
            has_palette = false;  // a grayscale local table: mode "L"
          }
          pos += len;
        }
        if (pos >= n) corrupt("GIF: truncated image");
        code_size = d[pos++];
        data = pos;
        return;
      }
    }
  }
};

// GifDecode.c's LZW decoder over the sub-blocks from `pos`, into the
// frame's indices (rows in display order).
void gif_lzw(const Gif& g, const uint8_t* d, int64_t n, uint8_t* image) {
  constexpr int kTable = 4096;
  const int bits = g.code_size;
  if (bits > 12) corrupt("GIF: LZW code size " + std::to_string(bits));
  if (g.fw == 0 || g.fh == 0) return;
  const int clear = 1 << bits, end = clear + 1;
  std::vector<uint8_t> data(kTable), buffer(kTable);
  std::vector<uint16_t> link(kTable);
  int state = 1, next = 0, codesize = 0, codemask = 0, bufferindex = kTable;
  int lastcode = 0;
  uint8_t lastdata = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0;
  int64_t blocksize = 0, pos = g.data;
  int64_t x = 0, y = 0;
  int step = g.interlace ? 8 : 1, pass = g.interlace ? 1 : 0;
  auto newline = [&]() -> bool {   // false: the frame is full
    x = 0;
    y += step;
    while (y >= g.fh) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 0; break;
        default: return false;
      }
    }
    return true;
  };
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      bufferindex = kTable;
      state = 2;
    }
    const uint8_t* p;
    int count;
    if (bufferindex < kTable) {
      count = kTable - bufferindex;
      p = &buffer[bufferindex];
      bufferindex = kTable;
    } else {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= static_cast<uint32_t>(d[pos++]) << bitcount;
          bitcount += 8;
          blocksize--;
        } else {
          if (pos >= n || pos + 1 + d[pos] > n)
            corrupt("GIF: the image data ends before the frame is full");
          blocksize = d[pos++];
        }
      }
      int c = static_cast<int>(bitbuffer & codemask);
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) state = 1;
        continue;
      }
      if (c == end)
        corrupt("GIF: the image data ends before the frame is full");
      count = 1;
      p = &lastdata;
      if (state == 2) {
        if (c > clear) corrupt("GIF: bad LZW code");
        lastdata = static_cast<uint8_t>(c);
        lastcode = c;
        state = 3;
      } else {
        int thiscode = c;
        if (c > next) corrupt("GIF: bad LZW code");
        if (c == next) {
          if (bufferindex <= 0) corrupt("GIF: bad LZW code");
          buffer[--bufferindex] = lastdata;
          c = lastcode;
        }
        while (c >= clear) {
          if (bufferindex <= 0 || c >= kTable) corrupt("GIF: bad LZW code");
          buffer[--bufferindex] = data[c];
          c = link[c];
        }
        lastdata = static_cast<uint8_t>(c);
        if (next < kTable) {
          data[next] = static_cast<uint8_t>(c);
          link[next] = static_cast<uint16_t>(lastcode);
          if (next == codemask && codesize < 12) {
            codesize++;
            codemask = (1 << codesize) - 1;
          }
          next++;
        }
        // the string's first byte goes out now, the buffered rest next
        lastcode = thiscode;
      }
    }
    for (int i = 0; i < count; i++) {
      image[y * g.fw + x] = p[i];
      if (++x >= g.fw && !newline()) return;
    }
  }
}

// into out [height, width, 3]: the size mrt_gif_size gave
void decode_gif(const uint8_t* d, int64_t n, uint8_t* out, int64_t height,
                int64_t width) {
  Gif g(d, n);
  if (g.width != width || g.height != height)
    corrupt("GIF: the image's size changed");
  std::vector<uint8_t> frame(static_cast<size_t>(g.fw * g.fh));
  gif_lzw(g, d, n, frame.data());
  const uint8_t fill = static_cast<uint8_t>(g.transparency >= 0 ? g.transparency : 0);
  auto put = [&](uint8_t v, uint8_t* o) {
    if (g.has_palette) {
      std::memcpy(o, &g.palette[3 * v], 3);
    } else {
      o[0] = o[1] = o[2] = v;
    }
  };
  for (int64_t y = 0; y < g.height; y++) {
    for (int64_t x = 0; x < g.width; x++) {
      int64_t fx = x - g.x0, fy = y - g.y0;
      bool inside = fx >= 0 && fy >= 0 && fx < g.fw && fy < g.fh;
      put(inside ? frame[fy * g.fw + fx] : fill, out + (y * g.width + x) * 3);
    }
  }
}

// Runs f, reporting a thrown Error or an allocation failure.
template <class F>
int guarded(const char* format, char* msg, int32_t msg_len, F f) {
  try {
    f();
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(Error{1, std::string(format) + ": out of memory"}, msg,
                  msg_len);
  }
}

template <class T>
void size_of(const T& t, int32_t* height, int32_t* width) {
  // the caller's check_size refuses what does not fit
  *height = static_cast<int32_t>(std::min<int64_t>(t.height, INT32_MAX));
  *width = static_cast<int32_t>(std::min<int64_t>(t.width, INT32_MAX));
}

}  // namespace

extern "C" {

// The frame's size: 0 and *height, *width, or an error code and message.
int mrt_jpeg_size(const uint8_t* data, int64_t n, int32_t* height,
                  int32_t* width, char* msg, int32_t msg_len) {
  try {
    Jpeg j(data, n);
    j.run(true);
    if (!j.have_frame) corrupt("JPEG: no frame header");
    *height = j.height;
    *width = j.width;
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(Error{1, "JPEG: out of memory"}, msg, msg_len);
  }
}

// The whole decode into out [height, width, 3] (mrt_jpeg_size's size).
int mrt_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                    int32_t height, int32_t width, char* msg,
                    int32_t msg_len) {
  try {
    Jpeg j(data, n);
    decode_jpeg(j, out);
    if (j.height != height || j.width != width)
      corrupt("JPEG: the frame's size changed");
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(Error{1, "JPEG: out of memory"}, msg, msg_len);
  }
}

// A PNG's inflated image data (all IDAT chunks) to out [height, width, 3].
// palette: `entries` RGB triples or null.
int mrt_png_decode(const uint8_t* raw, int64_t n, int32_t width,
                   int32_t height, int32_t depth, int32_t color,
                   int32_t interlace, const uint8_t* palette,
                   int32_t entries, uint8_t* out, char* msg,
                   int32_t msg_len) {
  try {
    decode_png(raw, n, width, height, depth, color, interlace, palette,
               entries, out);
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(Error{1, "PNG: out of memory"}, msg, msg_len);
  }
}

// BMP and GIF: the image's size, then the whole decode into out
// [height, width, 3] (that size, checked again).
int mrt_bmp_size(const uint8_t* data, int64_t n, int32_t* height,
                 int32_t* width, char* msg, int32_t msg_len) {
  return guarded("BMP", msg, msg_len,
                 [&] { size_of(Bmp(data, n), height, width); });
}

int mrt_bmp_decode(const uint8_t* data, int64_t n, uint8_t* out,
                   int32_t height, int32_t width, char* msg,
                   int32_t msg_len) {
  return guarded("BMP", msg, msg_len,
                 [&] { decode_bmp(data, n, out, height, width); });
}

int mrt_gif_size(const uint8_t* data, int64_t n, int32_t* height,
                 int32_t* width, char* msg, int32_t msg_len) {
  return guarded("GIF", msg, msg_len,
                 [&] { size_of(Gif(data, n), height, width); });
}

int mrt_gif_decode(const uint8_t* data, int64_t n, uint8_t* out,
                   int32_t height, int32_t width, char* msg,
                   int32_t msg_len) {
  return guarded("GIF", msg, msg_len,
                 [&] { decode_gif(data, n, out, height, width); });
}

}  // extern "C"
