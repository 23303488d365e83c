// What the sources of the host image decoder library share: its error
// type (jpeg2000_decode.cpp's too), JPEG 2000's HT code-block decoder
// (jpeg2000_ht.cpp), the TIFF codecs that live in sources
// of their own
// (tiff_zstd.cpp, tiff_xz.cpp, tiff_fax.cpp) beside image_decode.cpp, and
// the JPEG decoder's Huffman bit reader and its arithmetic and lossless
// scan decoders (jpeg_arith.cpp, jpeg_lossless.cpp).
// All of them are compiled together into one library
// (maskrcnn_tpu_torch/data/native_image.py).

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace mrt {

// code 1: a corrupt file (ValueError); 2: a mode not read
// (NotImplementedError)
struct Error {
  int code;
  std::string msg;
};

[[noreturn]] inline void corrupt(const std::string& m) { throw Error{1, m}; }
[[noreturn]] inline void refuse(const std::string& m) { throw Error{2, m}; }

// An entry point's return: the error's code, its message into msg.
inline int report(const Error& e, char* msg, int32_t msg_len) {
  if (msg && msg_len > 0) {
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", e.msg.c_str());
  }
  return e.code;
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

// Convert.c's cmyk2rgb of one pixel (CMYK as the image holds it)
inline void cmyk_rgb(const uint8_t* c, uint8_t* o) {
  const int nk = 255 - c[3];
  for (int k = 0; k < 3; k++) {
    const int tmp = c[k] * nk + 128;
    const int v = nk - (((tmp >> 8) + tmp) >> 8);
    o[k] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

// Python's gzip.decompress over d[0, n): every member (its header's
// fields, its raw deflate through image_decode.cpp's inflate, its CRC-32
// and length), the zero bytes between members skipped; an Error, its
// message prefixed with `what`, where Python raises.
void gzip_decompress(const uint8_t* d, int64_t n, const char* what, std::vector<uint8_t>& out);

// One HT code-block (ISO 15444-15) as jpeg2000_decode.cpp's tier 2 leaves
// it, for jpeg2000_ht.cpp: its chunks' bytes in order, the first two
// segments' lengths and passes, its size, numbps and Mb (the band's
// magnitude bit-planes) as OpenJPEG's t2.c sets them, the tile-component's
// ROI shift, VSC, and `align` the address of its bytes mod 4 where
// OpenJPEG decodes them.
struct HtBlock {
  const uint8_t* data;
  uint32_t len, nchunks, numsegs;
  uint32_t seg_len[2], seg_passes[2];
  uint32_t width, height, numbps, mb, roishift;
  bool causal;
  uint32_t align;
};

// OpenJPEG 2.5.4's opj_t1_ht_decode_cblk: the block's samples into out
// (width x height), an Error where OpenJPEG fails on the block.
void jpeg2000_ht_block(const HtBlock& b, std::vector<int32_t>& out);

// libtiff 4.7's ZSTDDecode over one strip or tile, as it drives libzstd
// 1.5.7: d[0, n) decoded into out[0, cap), an Error where libtiff fails.
void tiff_zstd(const uint8_t* d, int64_t n, uint8_t* out, int64_t cap);

// libtiff 4.7's LZMADecode over one strip or tile, as it drives liblzma
// 5.8 (an .xz stream): d[0, n) decoded into out[0, cap).
void tiff_xz(const uint8_t* d, int64_t n, uint8_t* out, int64_t cap);

// libtiff 4.7's fax codecs (tif_fax3.c) over one strip or tile of
// `rows` rows of `width` pixels: 1 bit a pixel, rows padded to a byte,
// 0 white as photometric 0 stores it.
struct FaxParams {
  int compression = 3;    // 2 (modified Huffman), 3 (T.4), 4 (T.6), 32771 (RLEW)
  uint32_t options = 0;   // T4Options or T6Options
  bool msb2lsb = true;    // FillOrder 1
  int64_t width = 0;
};
// What the codec keeps from one strip or tile of an image to the next:
// its run arrays (a corrupt row may read past the reference line's runs
// into what earlier rows left there) and whether T.4 data is read
// without EOLs.
struct FaxState {
  std::vector<uint32_t> runs;
  bool noeol = false;
};
void tiff_fax(const uint8_t* d, int64_t n, uint8_t* out, int64_t cap, int64_t rows,
              const FaxParams& p, FaxState& state);

// ------------------------------------------------------------------- JPEG
// What image_decode.cpp's JPEG decoder (the frame, its Huffman DCT scans,
// the IDCT, the upsamplers and the colour conversion) shares with the
// sources of its other entropy decoders: jpeg_arith.cpp (arithmetic
// scans, SOF9 and SOF10) and jpeg_lossless.cpp (lossless frames, SOF3).

// the zigzag position k's coefficient in natural order, with 16 entries
// past the end as jpeg_natural_order has (a corrupt run lands on 63)
inline constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  // jpeg_make_d_derived_tbl's checks, made where a scan uses the table:
  // the code lengths fit, and the largest symbol (a DC table's at most
  // 15, 16 in a lossless frame)
  bool valid = false;
  int max_symbol = 0;
  // (code length << 8) | symbol for codes of at most kLookBits bits, else 0
  uint16_t look[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

// jdhuff.c jpeg_make_d_derived_tbl
inline void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* symbols,
                          int total) {
  t.defined = true;
  t.valid = false;
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
    if (code >= (1u << si)) return;
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
  t.max_symbol = 0;
  for (int i = 0; i < total; i++) t.max_symbol = std::max<int>(t.max_symbol, symbols[i]);
  t.valid = true;
}

// The bytes of a scan as libjpeg's source manager gives them, from the
// end of its SOS segment: Pillow's decoder hands libjpeg the file in
// blocks of 65536 bytes and suspends it at a block's end, which an
// arithmetic scan cannot survive ("broken data stream": its bytes must
// lie below `limit`, the end of the block in which its SOS segment
// ends, and below the file's end); libtiff hands it the whole strip and
// a fake EOI marker past its end (`fake_eoi`). (A Huffman or lossless
// scan's restart marker is read from the whole file: `limit` its end.)
struct JpegSource {
  const uint8_t* d = nullptr;
  int64_t n = 0;
  int64_t pos = 0;
  int64_t limit = 0;
  bool fake_eoi = false;
  int unread_marker = 0;  // cinfo->unread_marker: a marker the scan ran into

  int get_byte() {
    if (pos < limit) return d[pos++];
    if (!fake_eoi && limit < n)
      corrupt("JPEG: an arithmetic-coded scan reads past the block of the file "
              "Pillow's decoder holds (libjpeg cannot suspend it)");
    if (!fake_eoi) corrupt("JPEG: the file is truncated (libjpeg runs out of data within a scan)");
    return (pos++ - limit) & 1 ? 0xD9 : 0xFF;
  }
  // jdmarker.c next_marker: the next marker's code, set as unread_marker
  void next_marker();
  // jdmarker.c read_restart_marker with jpeg_resync_to_restart: the
  // expected restart swallowed, or another marker kept unread (the next
  // interval then decodes as zero data) or skipped as libjpeg decides
  void read_restart_marker(int& next_restart_num);
  // where the marker reader goes on after the scan: the unread marker,
  // else the first marker past the scan's data that is not a restart
  int64_t marker_pos() const;
};

// The entropy-coded bits of a scan: stuffed zeros removed, and zero bits
// supplied past a marker (libjpeg's fill_bit_buffer); once a decode reads
// such a bit, `insufficient` is set and the rest of the restart interval
// is left as it is (jdhuff.c's insufficient_data).
//
// Under Pillow (`pillow`), whose source suspends libjpeg at the end of
// the data it holds, a scan or restart interval whose data ends with no
// marker also keeps count of libjpeg's own bit buffer (`model`):
// jpeg_fill_bit_buffer runs when fewer bits are buffered than a decode
// needs and reads on to 57 bits; where the data ends before that, libjpeg
// suspends and Pillow, with no more of the file, calls it truncated. Data
// that a marker ends never suspends, and decodes without the count.
// (Under libtiff the end is a fake EOI marker.)
struct Bits {
  const uint8_t* d;
  int64_t n;
  int64_t pos;
  uint64_t buf = 0;  // the next bits, most significant first
  int nbits = 0;
  int padded = 0;  // zero bits at the end of buf that follow a marker
  bool at_marker = false;
  bool insufficient = false;
  bool pillow = false;
  bool model = false;      // libjpeg's buffer counted (set by measure)
  int64_t data_bits = 0;   // the data's bits up to the file's end
  int64_t loaded = 0;      // data bits read into buf since the scan or restart
  int64_t consumed = 0;    // bits decoded since then
  int64_t lib_loaded = 0;  // bits libjpeg's buffer has read since then

  Bits(const uint8_t* data, int64_t size, int64_t start, bool pillow_source = false)
      : d(data), n(size), pos(start), pillow(pillow_source) {
    if (pillow) measure();
  }

  // Where the data from here ends: at a marker (no model), or at the
  // file's end after data_bits bits (model).
  void measure() {
    int64_t have = 0, p = pos;
    while (p < n) {
      // the plain bytes up to the next 0xFF, then what follows it
      const void* ff = std::memchr(d + p, 0xFF, static_cast<size_t>(n - p));
      const int64_t at = ff ? static_cast<const uint8_t*>(ff) - d : n;
      have += 8 * (at - p);
      p = at;
      if (p >= n) break;
      int64_t q = p + 1;
      while (q < n && d[q] == 0xFF) q++;
      if (q >= n) break;
      if (d[q] != 0) return;  // a marker
      p = q + 1;  // a stuffed 0xFF: one data byte
      have += 8;
    }
    data_bits = have;
    model = true;
  }

  // libjpeg's CHECK_BIT_BUFFER(k) (HUFF_DECODE's is 8)
  __attribute__((always_inline)) inline void need(int k) {
    if (model && lib_loaded - consumed < k) lib_fill();
  }
  // jpeg_fill_bit_buffer: on to 57 bits, or a suspension at the data's end
  __attribute__((noinline)) void lib_fill() {
    const int64_t want = lib_loaded + 8 * ((57 - (lib_loaded - consumed) + 7) / 8);
    if (want > data_bits)
      corrupt("JPEG: the file is truncated (libjpeg runs out of data within a scan)");
    lib_loaded = want;
  }

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
        if (!at_marker) loaded += 8;
      } else {
        padded += 8;
      }
      buf |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }

  __attribute__((always_inline)) inline void consume(int k) {
    buf <<= k;
    nbits -= k;
    consumed += k;
    if (nbits < padded) {
      insufficient = true;
      padded = nbits;
    }
  }

  __attribute__((always_inline)) inline uint32_t peek(int k) {
    if (nbits < k) fill();
    return static_cast<uint32_t>(buf >> (64 - k));
  }

  __attribute__((always_inline)) inline uint32_t get(int k) {
    if (k == 0) return 0;
    need(k);
    uint32_t v = peek(k);
    consume(k);
    return v;
  }

  __attribute__((always_inline)) inline int decode(const Huffman& t) {
    need(8);
    uint32_t w = peek(16);
    uint16_t e = t.look[w >> (16 - kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    while (l <= 16 && static_cast<int32_t>(w >> (16 - l)) > t.maxcode[l]) l++;
    if (l > 16) {
      // jpeg_huff_decode: a corrupt code gives a zero, after the 17 bits
      // that reach maxcode[17]'s sentinel
      need(17);
      if (nbits < 17) fill();
      consume(17);
      return 0;
    }
    if (l > 8) need(l);
    const int32_t code = static_cast<int32_t>(w >> (16 - l));
    consume(l);
    return t.vals[code + t.valoffset[l]];
  }

  // jdhuff.c / jdphuff.c / jdlhuff.c process_restart: the buffered bits
  // dropped and the marker read by read_restart_marker. Where that keeps
  // a marker unread, the next interval decodes from zero bits and keeps
  // `insufficient` as it was; else it decodes afresh.
  // whether the marker libjpeg's read_restart_marker reads next (past any
  // bytes before it) is the restart expected: where it is not, libjpeg
  // resyncs through the source's resync_to_restart
  bool next_is_restart(int num) const {
    int64_t p = pos;
    if (at_marker) return p + 1 < n && d[p + 1] == 0xD0 + num;
    for (;;) {
      while (p < n && d[p] != 0xFF) p++;
      while (p < n && d[p] == 0xFF) p++;
      if (p >= n) return false;
      if (d[p] != 0) return d[p] == 0xD0 + num;
      p++;
    }
  }

  void restart(int& next_restart_num) {
    JpegSource src;
    src.d = d;
    src.n = n;
    src.limit = n;
    src.fake_eoi = !pillow;
    if (at_marker && pos + 1 < n) {
      src.unread_marker = d[pos + 1];
      src.pos = pos + 2;
    } else {
      src.pos = at_marker ? n : pos;  // (0xFF bytes up to the file's end)
    }
    src.read_restart_marker(next_restart_num);
    const bool was_insufficient = insufficient;
    *this = Bits(d, n, src.unread_marker ? src.marker_pos() : src.pos, pillow);
    if (src.unread_marker) {
      fill();  // up against the marker: zero bits
      insufficient = was_insufficient;
    }
  }
};

inline int extend(uint32_t v, int s) {
  // HUFF_EXTEND
  return (s && v < (1u << (s - 1))) ? static_cast<int>(v) - ((1 << s) - 1)
                                    : static_cast<int>(v);
}

// libjpeg-turbo 3.1's jdarith.c over one scan: sequential (SOF9) or a
// progressive (SOF10) DC first, DC refinement, AC first or AC
// refinement scan, into the blocks of 64 coefficients (natural order)
// the Huffman scans fill; corrupt data is what libjpeg makes of it (a
// bad code or a spectral overflow leaves the rest of the restart interval
// as it is, a warning only).
struct ArithScan {
  JpegSource src;
  bool progressive = false;
  int ss = 0, se = 63, ah = 0, al = 0;
  int ncomp = 1;                    // components in the scan
  int dc_tbl[4] = {}, ac_tbl[4] = {};
  const uint8_t* dc_L = nullptr;    // the DAC conditioning of tables 0-15
  const uint8_t* dc_U = nullptr;
  const uint8_t* ac_K = nullptr;
  int restart_interval = 0;

  // start_pass: statistics, predictions and the decoder reset
  void start();
  // one MCU: block b of the MCU at blocks[b], of the scan's component comp[b]
  void decode_mcu(int16_t* const* blocks, const int* comp, int nblocks);

 private:
  int64_t c_ = 0, a_ = 0;
  int ct_ = -16;
  int next_restart_num_ = 0;
  int restarts_to_go_ = 0;
  int last_dc_[4] = {}, dc_context_[4] = {};
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  uint8_t fixed_bin_[4] = {113, 0, 0, 0};

  int decode(uint8_t* st);
  void restart();
  bool dc_diff(int ci, int& v);
  bool magnitude(uint8_t* stats, uint8_t* st, int kx, int& v);
};

// libjpeg-turbo 3.1's lossless decoder (jdlhuff.c, jddiffct.c,
// jdlossls.c) at 8-bit precision over one scan: Huffman-coded
// differences, predictor Ss (1-7), point transform Al, restarts every
// `restart_interval` MCUs (whole MCU rows), into each component's
// samples (`plane`: `ch` rows of `cw`).
struct LosslessComp {
  uint8_t* plane = nullptr;
  int cw = 0, ch = 0;
  int h = 1, v = 1;                 // sampling factors (interleaved scans)
  const Huffman* table = nullptr;
};
// pillow: Pillow's source (libjpeg suspends where the data ends), else
// libtiff's (a fake EOI there); end: where the marker reader goes on.
void lossless_scan(const uint8_t* d, int64_t n, int64_t pos, int psv, int pt,
                   int restart_interval, int mcux, int mcuy, bool pillow,
                   std::vector<LosslessComp>& comps, int64_t& end);

}  // namespace mrt
