// Host image decoder of the port: JPEG, PNG, BMP (and the DIB frames of
// DIB, ICO and CUR files), GIF and TIFF to RGB uint8, the pixels
// np.asarray(PIL.Image.open(f).convert("RGB")) gives with Pillow 12.1
// over libjpeg-turbo 3.1, libtiff 4.7, zlib, libzstd 1.5 and liblzma 5.8
// (WebP: webp_decode.cpp; Pillow's small lossless plugins:
// image_plugins.cpp).
//
// Host C++17, no CUDA: maskrcnn_tpu_torch/data/native_image.py compiles it
// with g++ on first use and calls it through ctypes, which releases the
// GIL for the whole call.
//
// JPEG follows libjpeg-turbo as Pillow configures it: jdhuff.c /
// jdphuff.c entropy decoding (baseline, extended sequential and
// progressive Huffman, restart intervals; the standard tables a
// sequential scan takes for an undefined slot 0 or 1), the arithmetic
// and lossless decoders of jpeg_arith.cpp and jpeg_lossless.cpp
// (image_codec.h), every coefficient of the image kept until the last
// scan, jdcoefct.c's block smoothing of a progressive file whose scans
// leave coefficients 1-9 incomplete (decompress_smooth_data, with the
// bits from before a scan cut short past its last whole iMCU row), the
// islow IDCT as its SIMD code computes it (16-bit products and sums,
// saturated passes: jidctint.c's C on valid data), jdsample.c's
// upsamplers (fancy h2v1, h1v2 and h2v2 where libjpeg-turbo picks them,
// box replication elsewhere and for lossless frames, edges replicated at
// the component's downsampled size as jdmainct.c's context rows are),
// jdcolor.c's fixed-point YCbCr -> RGB and YCCK -> CMYK tables, the
// colour space chosen by jdapimin.c's default_decompress_parms, and for 4
// components Pillow's own steps: the "CMYK;I" unpack (samples inverted)
// and Convert.c's cmyk2rgb. Pillow's decoder is part of the outcome: it
// gives libjpeg the file in 65536-byte blocks (an arithmetic scan cannot
// cross the end of one), and a single-scan file's markers after its rows
// may run out (libtiff's source ends in a fake EOI instead); jdmarker.c's
// marker walk decides what else is an error. Refused, with the mode
// named: arithmetic lossless and hierarchical frames, samples of other
// than 8 bits, 2 components, sampling factors that do not divide the
// largest or that make an interleaved MCU of more than 10 blocks.
//
// PNG: the image data inflated by the inflate written here (TIFF's
// Deflate shares it) as Pillow's decoder drives zlib: up to the image's
// last byte, so a stream cut in its trailer still decodes, the five row
// filters, the seven Adam7 passes, bit depths 1, 2, 4,
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
// rows bottom-up or top-down (the last row's padding not needed); a DIB
// header at an offset, as Pillow's DIB plugin, IcoFile.frame (the height
// halved, the AND mask or alpha bytes read) and CurImageFile read one.
// Channels narrower than 8 bits widen as
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
// TIFF as Pillow's TiffImagePlugin opens the first image of the file:
// Pillow's reading of the header (II, MM, their byte-swapped magics and
// BigTIFF's) and of the first IFD, its OPEN_INFO table of (byte order,
// photometric, sample format, fill order, bits, extra samples) -> (mode,
// raw mode), its own "raw" tiles for uncompressed data (offsets in file
// order, byte counts unread) and libtiff's decoding of everything
// compressed, with the directory as libtiff's TIFFReadDirectory reads it
// again (LibtiffDir), as TiffDecode.c drives it: strips or tiles (edge tiles
// cropped), contiguous or separate planes, FillOrder 2, PackBits, LZW
// (libtiff's codes and the old LSB-first ones), Deflate through the
// inflate written here (zlib's checks and messages, its Adler-32), ZSTD,
// LZMA and CCITT (2, 3, 4, 32771) through the decoders in tiff_zstd.cpp,
// tiff_xz.cpp and tiff_fax.cpp (image_codec.h; the fax codec reads the
// fill order itself, keeps its run arrays and its EOL mode from strip to
// strip, and a fax tile's failure keeps the tile, as TIFFReadEncodedTile
// takes the decoder's -1), JPEG
// through the decoder above (JPEGTables and the tables of the strips
// before kept, each strip or tile its own stream, the colour transform
// libtiff picks: YCbCr to RGB for contiguous YCbCr as Pillow asks with
// JPEGCOLORMODE_RGB, the components as they are otherwise), predictors 2
// and 3, samples of more than 8 bits in the host's byte order as libtiff
// leaves them; then Pillow's unpacker for the raw mode (Unpack.c: bit
// depths 1-16, 12-bit, signed 16, 32-bit integer and float, palettes
// with their 16-bit ColorMap, LA, PA, RGB and RGBA of 8 and 16 bits with
// associated alpha un-premultiplied, CMYK), Convert.c's conversion to
// RGB, and ImageOps.exif_transpose's Orientation (the tag, or XMP's
// tiff:Orientation where it is absent); a file Pillow opens from a path
// and memory-maps (one uncompressed strip or tile of a mapped mode,
// Orientation 5-8) as that view turned (Tiff::map_stride; a view whose
// last row would run past the file's end is an error). Refused, with the mode
// named: WebP, old-style JPEG, ThunderScan and SGILog compression, an xz
// BCJ filter, LAB, YCbCr that is not JPEG-compressed with contiguous
// samples, 16-bit CMYK; what Pillow itself refuses is a ValueError.
//
// Entry points return 0, 1 (a corrupt file: ValueError) or 2 (a mode not
// read: NotImplementedError), with a message.

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <iterator>
#include <new>
#include <string>
#include <vector>

// The IDCT (idct_islow) is libjpeg-turbo's SSE2 one, lane for lane: the
// only one the tests hold to Pillow's bits.
#if !defined(__SSE2__)
#error "image_decode.cpp needs SSE2 (an x86-64 host): its IDCT is libjpeg-turbo's SSE2 code"
#endif
#include <emmintrin.h>

#include "image_codec.h"

namespace {

using mrt::corrupt;
using mrt::Error;
using mrt::guarded;
using mrt::refuse;
using mrt::report;
using mrt::Bits;
using mrt::build_huffman;
using mrt::extend;
using mrt::Huffman;
using mrt::kNatural;

// ------------------------------------------------------------------- JPEG

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // coefficient blocks a row and rows (MCU grid)
  int cw = 0, ch = 0;          // downsampled width and height
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  int32_t quant[64];           // latched at the component's first scan
  int16_t quant16[64];         // ... as the IDCT multiplies it (a 16-bit short)
  bool latched = false;
  int coef_bits[64];           // progressive: the bit each coefficient is known to
  int prev_bits[64];           // ... before the last scan of the component
  int dc_last = 0;
  std::vector<uint8_t> samples;  // lossless: ch rows of cw samples
};

const char* sof_mode(int marker) {
  switch (marker) {
    case 0xC5: return "hierarchical sequential";
    case 0xC8: return "JPG (reserved frame type)";
    case 0xC6: return "hierarchical progressive";
    case 0xC7: return "hierarchical lossless";
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
  bool arith = false, lossless = false;  // SOF9/SOF10, SOF3
  int scans = 0;                // SOS markers read (input_scan_number)
  // the last iMCU row the last scan decoded whole (jdcoefct.c's
  // last_good_iMCU_row: past it, block smoothing takes the coefficient
  // bits from before that scan)
  int last_good_row = INT_MAX;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int32_t qtables[4][64] = {};
  bool qdefined[4] = {false, false, false, false};
  Huffman dc_tables[4], ac_tables[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int transform = 0;
  // DAC conditioning of the arithmetic tables 0-15 (L, U; Kx), as SOI
  // resets them
  uint8_t dac_L[16], dac_U[16], dac_K[16];
  // libtiff's source (a strip or tile, a fake EOI past its end), not
  // Pillow's 65536-byte blocks of the file
  bool in_tiff = false;
  // libtiff's old-style JPEG source: a restart marker out of turn, or the
  // end of the data within a scan, is an error (its resync_to_restart
  // fails, and so does its fill past the end); the MCU it happens at
  bool ojpeg = false;
  int64_t fail_mcu = -1;
  // BLP1's JPEG: BlpImagePlugin sets a CMYK frame's jpegmode to "CMYK",
  // which makes JpegDecode.c set libjpeg's jpeg_color_space to JCS_CMYK:
  // an Adobe transform 2 (YCCK) is read as CMYK, unconverted
  bool force_cmyk = false;

  Jpeg(const uint8_t* data, int64_t size) : d(data), n(size) {
    std::memset(dac_L, 0, sizeof(dac_L));
    std::memset(dac_U, 1, sizeof(dac_U));
    std::memset(dac_K, 5, sizeof(dac_K));
  }

  // The quantization and Huffman tables of another stream (TIFF's
  // JPEGTables, or the strip before: libjpeg keeps them in the object).
  void take_tables(const Jpeg& t) {
    std::memcpy(qtables, t.qtables, sizeof(qtables));
    std::memcpy(qdefined, t.qdefined, sizeof(qdefined));
    for (int i = 0; i < 4; i++) {
      dc_tables[i] = t.dc_tables[i];
      ac_tables[i] = t.ac_tables[i];
    }
  }

  // Reads the markers; with `header_only`, stops after the frame header;
  // with `tables`, reads a tables-only stream (no frame: TIFF's
  // JPEGTables).
  void run(bool header_only, bool tables = false) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) corrupt("not a JPEG file");
    int64_t pos = 2;
    // Where the data may end without an EOI: under libtiff, after any scan
    // (its source gives a fake EOI); under Pillow, after the scan of a
    // single-scan file, whose rows are all out before libjpeg reads the
    // markers after it (jpeg_finish_decompress suspends there, and Pillow
    // is done).
    bool may_end = false;
    bool single_scan = false;
    for (;;) {
      // next_marker: skip anything up to a 0xFF, then fill bytes
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) {
        if (may_end) break;
        if (!have_frame) corrupt("JPEG: no frame header");
        corrupt("JPEG: no EOI marker (the file is truncated)");
      }
      int marker = d[pos++];
      if (marker == 0) continue;  // a stuffed zero: next_marker goes on
      if (marker == 0xD9) break;  // EOI
      if (marker == 0xD8) corrupt("JPEG: a second SOI marker");
      if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      // jdmarker.c read_markers: what it reads; the rest is an error
      const bool skipped = (marker >= 0xE0 && marker <= 0xEF) || marker == 0xFE ||
                           marker == 0xDC;
      if (!skipped && !(marker >= 0xC0 && marker <= 0xCF) && marker != 0xDA &&
          marker != 0xDB && marker != 0xDD) {
        char hex[8];
        std::snprintf(hex, sizeof(hex), "0x%02X", marker);
        corrupt(std::string("JPEG: unsupported marker type ") + hex);
      }
      // a frame marker: what libjpeg refuses, before the segment is read
      const bool sof = marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xCC;
      if (sof && !tables) {
        if (const char* mode = sof_mode(marker))
          corrupt(std::string("JPEG: ") + mode + " mode, which libjpeg-turbo does not "
                  "decode (Pillow: broken data stream)");
        if (have_frame) corrupt("JPEG: a second frame header");
      }
      if (pos + 2 > n) {
        if (may_end) break;
        corrupt("JPEG: a marker segment runs past the end");
      }
      int length = be16(d + pos);
      if (length < 2 && skipped) {
        pos += 2;  // skip_variable: nothing to skip
        continue;
      }
      if (pos + length > n && may_end) {
        // the data ends within the segment: libjpeg reads it as far as the
        // data goes, and only what it finds wrong on the way is an error
        if (!in_tiff && !skipped) partial_segment(marker, pos);
        break;
      }
      if (length < 2) corrupt("JPEG: bad marker length");
      if (pos + length > n) corrupt("JPEG: a marker segment runs past the end");
      const uint8_t* body = d + pos + 2;
      int blen = length - 2;
      pos += length;
      if (tables && (marker == 0xDA || (marker >= 0xC0 && marker <= 0xCF &&
                                        marker != 0xC4 && marker != 0xC8 &&
                                        marker != 0xCC)))
        corrupt("TIFF: bogus JPEGTables field (an image in the tables)");
      if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2 || marker == 0xC3 ||
          marker == 0xC9 || marker == 0xCA) {
        frame(body, blen, marker == 0xC2 || marker == 0xCA);
        arith = marker == 0xC9 || marker == 0xCA;
        lossless = marker == 0xC3;
        if (header_only) return;
      } else if (marker == 0xC4) {
        dht(body, blen);
      } else if (marker == 0xCC) {
        dac(body, blen);
      } else if (marker == 0xDB) {
        dqt(body, blen);
      } else if (marker == 0xDD) {
        if (blen != 2) corrupt("JPEG: bad DRI marker");
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
        if (single_scan) corrupt("JPEG: a second scan where EOI was expected");
        const bool first = !may_end && comps.front().coef.empty() &&
                           comps.front().samples.empty();
        pos = scan(body, blen, pos);
        // jdinput.c: a first scan of every component, not progressive,
        // is the file's only one
        single_scan = first && !progressive && blen >= 1 &&
                      body[0] == static_cast<int>(comps.size());
        // libtiff's JPEGDecode takes jpeg_finish_decompress's failure (-1)
        // for success: nothing after a single scan's data counts
        if (single_scan && in_tiff) break;
        may_end = in_tiff || single_scan;
      }
      // APPn, COM and the rest: skipped
    }
    if (!have_frame && !tables) corrupt("JPEG: no frame header");
  }

  // A DQT, DHT, DAC, DRI or SOS segment from `pos` (its length field) to
  // the end of the data, which comes first, read as jdmarker.c reads it
  // under a suspending source: the checks it makes on the way raise;
  // running out of data does not (after a single scan Pillow is done).
  void partial_segment(int marker, int64_t pos) const {
    int64_t p = pos;
    auto have = [&](int64_t k) { return p + k <= n; };
    if (!have(2)) return;
    int64_t length = be16(d + p) - 2;
    p += 2;
    if (marker == 0xDB) {
      while (length > 0) {
        if (!have(1)) return;
        const int prec = d[p] >> 4, index = d[p] & 15;
        p++;
        if (index >= 4) corrupt("JPEG: bad DQT table index " + std::to_string(index));
        const int size = prec ? 128 : 64;
        if (!have(size)) return;
        p += size;
        length -= 1 + size;
      }
    } else if (marker == 0xC4) {
      while (length > 16) {
        if (!have(17)) return;
        int count = 0;
        for (int i = 1; i <= 16; i++) count += d[p + i];
        const int index = d[p];
        p += 17;
        length -= 17;
        if (count > 256 || count > length) corrupt("JPEG: bad Huffman table");
        if (!have(count)) return;
        p += count;
        length -= count;
        if ((index & ~0x10) >= 4) corrupt("JPEG: bad DHT table index " + std::to_string(index));
      }
    } else if (marker == 0xCC) {
      while (length > 0) {
        if (!have(2)) return;
        const int index = d[p], val = d[p + 1];
        p += 2;
        length -= 2;
        if (index >= 32) corrupt("JPEG: bad DAC table index " + std::to_string(index));
        if (index < 16 && (val & 15) > (val >> 4))
          corrupt("JPEG: bad DAC value " + std::to_string(val));
      }
    } else if (marker == 0xDD) {
      if (length != 2) corrupt("JPEG: bad DRI marker");
      return;
    } else if (marker == 0xDA) {
      if (!have(1)) return;
      const int ns = d[p];
      if (length != 2 * ns + 4 || ns < 1 || ns > 4) corrupt("JPEG: bad SOS marker");
      return;  // a whole one ends the single-scan file with an error: EOI was expected
    } else {
      return;
    }
    if (length != 0) corrupt("JPEG: bad marker length");
  }

  void frame(const uint8_t* b, int len, bool prog) {
    if (have_frame) corrupt("JPEG: a second frame header");
    if (len < 6) corrupt("JPEG: bad frame header");
    int precision = b[0];
    height = be16(b + 1);
    width = be16(b + 3);
    int nc = b[5];
    if (precision != 8)
      corrupt("JPEG: " + std::to_string(precision) +
              "-bit samples, which Pillow's 8-bit decoder does not take");
    if (height == 0)
      corrupt("JPEG: an empty image (a height defined by a DNL marker), which libjpeg-turbo "
              "refuses");
    if (width == 0) corrupt("JPEG: image width 0");
    if (nc != 1 && nc != 3 && nc != 4)
      corrupt("JPEG: " + std::to_string(nc) +
              " components, which Pillow does not take (1, 3 or 4)");
    if (len != 6 + 3 * nc) corrupt("JPEG: bad frame header");
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
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (const Component& c : comps) {
      if (hmax % c.h || vmax % c.v)
        corrupt("JPEG: fractional sampling factors (a component's factors do "
                "not divide the largest), which libjpeg-turbo does not decode "
                "(Pillow: broken data stream)");
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    have_frame = true;
  }

  // jstdhuff.c std_huff_tables, which libjpeg-turbo's sequential Huffman
  // decoder (jdhuff.c) runs as it starts: slots 0 and 1 that no DHT has
  // filled get the tables of ITU T.81 Annex K.3 (for Motion-JPEG streams)
  void std_tables() {
    static const uint8_t kDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                           {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
    static const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
    static const uint8_t kAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
                                           {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
    static const uint8_t kAcVals[2][162] = {
        {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
         0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
         0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
         0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
         0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
         0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
         0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
         0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
         0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
         0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
         0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
         0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
        {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
         0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
         0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
         0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
         0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
         0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
         0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
         0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
         0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
         0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
         0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
         0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};
    for (int t = 0; t < 2; t++) {
      if (!dc_tables[t].defined) build_huffman(dc_tables[t], kDcBits[t], kDcVals, 12);
      if (!ac_tables[t].defined) build_huffman(ac_tables[t], kAcBits[t], kAcVals[t], 162);
    }
  }

  void allocate() {
    for (Component& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.cw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.ch = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      // (value-initialised: zeroed as one block, which assign() is not)
      if (lossless) {
        c.samples = std::vector<uint8_t>(static_cast<size_t>(c.cw) * c.ch);
      } else {
        c.coef = std::vector<int16_t>(static_cast<size_t>(c.bw) * c.bh * 64);
      }
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
      for (int k = 0; k < 64; k++) c.prev_bits[k] = -1;
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
                    b + i + 17, total);
      i += 17 + total;
    }
  }

  // jdmarker.c get_dac
  void dac(const uint8_t* b, int len) {
    if (len % 2) corrupt("JPEG: bad DAC marker length");
    for (int i = 0; i < len; i += 2) {
      const int index = b[i], val = b[i + 1];
      if (index >= 32) corrupt("JPEG: bad DAC table index " + std::to_string(index));
      if (index >= 16) {
        dac_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        dac_L[index] = static_cast<uint8_t>(val & 15);
        dac_U[index] = static_cast<uint8_t>(val >> 4);
        if (dac_L[index] > dac_U[index])
          corrupt("JPEG: bad DAC value " + std::to_string(val));
      }
    }
  }

  // a table a scan uses, held to jpeg_make_d_derived_tbl's checks
  void check_table(int index, bool dc, int max_dc_symbol) const {
    const Huffman* t = index > 3 ? nullptr : dc ? &dc_tables[index] : &ac_tables[index];
    if (!t || !t->defined) corrupt("JPEG: a Huffman table is missing");
    if (!t->valid || (dc && t->max_symbol > max_dc_symbol))
      corrupt("JPEG: bad Huffman table");
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
    if (comps.front().coef.empty() && comps.front().samples.empty()) {
      allocate();
      if (!arith && !progressive && !lossless) std_tables();
    }
    scans++;
    if (len < 1) corrupt("JPEG: bad SOS marker");
    int ns = b[0];
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) corrupt("JPEG: bad SOS marker");
    std::vector<int> in_scan(ns), dct(ns), act(ns);
    for (int k = 0; k < ns; k++) {
      int cid = b[1 + 2 * k], t = b[2 + 2 * k];
      int ci = -1;
      for (size_t j = 0; j < comps.size(); j++) {
        if (comps[j].id == cid) ci = static_cast<int>(j);
      }
      if (ci < 0) corrupt("JPEG: a scan names an unknown component");
      for (int q = 0; q < k; q++) {
        if (in_scan[q] == ci) corrupt("JPEG: a scan names a component twice");
      }
      in_scan[k] = ci;
      dct[k] = t >> 4;
      act[k] = t & 15;
    }
    int ss = b[1 + 2 * ns], se = b[2 + 2 * ns];
    int ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
    if (lossless) return lossless_scan(in_scan, dct, ss, se, ah, al, pos);
    // jdinput.c latch_quant_tables: a component's table at its first scan
    for (int ci : in_scan) {
      Component& c = comps[ci];
      if (!c.latched) {
        if (c.tq > 3 || !qdefined[c.tq]) corrupt("JPEG: a quantization table is missing");
        std::memcpy(c.quant, qtables[c.tq], sizeof(c.quant));
        for (int k = 0; k < 64; k++) c.quant16[k] = static_cast<int16_t>(c.quant[k]);
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
        Component& c = comps[ci];
        for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
          c.prev_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
        for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
      }
    } else {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) {
        // libjpeg warns and decodes the whole band
      }
    }
    if (!arith) {
      // the Huffman tables the scan uses (an arithmetic scan's tables
      // 0-15 always exist)
      for (int k = 0; k < ns; k++) {
        if (!progressive || (ss == 0 && ah == 0)) check_table(dct[k], true, 15);
        if (!progressive || ss != 0) check_table(act[k], false, 255);
      }
    }

    // the scan's blocks: (component, its index in the scan, block index)
    // in decode order
    struct Slot { int ci, k; };
    std::vector<Slot> layout;
    std::vector<int> offs;  // within an MCU: block offset from the MCU's origin
    int64_t mcus;
    int per_row;
    if (ns == 1) {
      Component& c = comps[in_scan[0]];
      per_row = (c.cw + 7) / 8;
      int rows = (c.ch + 7) / 8;
      mcus = static_cast<int64_t>(per_row) * rows;
      layout.push_back({in_scan[0], 0});
      offs.push_back(0);
    } else {
      per_row = mcux;
      mcus = static_cast<int64_t>(mcux) * mcuy;
      for (int k = 0; k < ns; k++) {
        Component& c = comps[in_scan[k]];
        for (int y = 0; y < c.v; y++) {
          for (int x = 0; x < c.h; x++) {
            layout.push_back({in_scan[k], k});
            offs.push_back(y * c.bw + x);
          }
        }
      }
    }
    if (layout.size() > 10)
      corrupt("JPEG: an interleaved scan of more than 10 blocks an MCU "
              "(sampling factors too large), which libjpeg-turbo refuses");
    // block s of the MCU at MCU row my, column mx
    auto block_at = [&](int64_t my, int64_t mx, size_t s) {
      Component& c = comps[layout[s].ci];
      const int64_t block = ns == 1 ? my * c.bw + mx : (my * c.v * c.bw + mx * c.h + offs[s]);
      return c.coef.data() + block * 64;
    };

    int64_t p;
    if (arith) {
      mrt::ArithScan a;
      a.src.d = d;
      a.src.n = n;
      a.src.pos = pos;
      a.src.fake_eoi = in_tiff;
      // Pillow's decoder: the block of the file in which the SOS segment ends
      a.src.limit = in_tiff ? n : std::min<int64_t>(n, (pos + 65535) / 65536 * 65536);
      a.progressive = progressive;
      a.ss = ss;
      a.se = se;
      a.ah = ah;
      a.al = al;
      a.ncomp = ns;
      for (int k = 0; k < ns; k++) {
        a.dc_tbl[k] = dct[k];
        a.ac_tbl[k] = act[k];
      }
      a.dc_L = dac_L;
      a.dc_U = dac_U;
      a.ac_K = dac_K;
      a.restart_interval = restart_interval;
      a.start();
      int16_t* blocks[10];
      int comp[10];
      const int nb = static_cast<int>(layout.size());
      for (int s = 0; s < nb; s++) comp[s] = layout[s].k;
      for (int64_t m = 0, my = 0, mx = 0; m < mcus; m++) {
        for (int s = 0; s < nb; s++) blocks[s] = block_at(my, mx, static_cast<size_t>(s));
        a.decode_mcu(blocks, comp, nb);
        if (++mx == per_row) mx = 0, my++;
      }
      p = a.src.marker_pos();
      last_good_row = INT_MAX;
    } else {
      Bits bits(d, n, pos, !in_tiff);
      for (Component& c : comps) c.dc_last = 0;
      int eobrun = 0;
      // the iMCU rows: an MCU row of an interleaved scan, v block rows of
      // one component's
      const int rows_per_imcu = ns == 1 ? comps[in_scan[0]].v : 1;
      last_good_row = 0;
      int64_t my = 0, mx = -1, to_restart = restart_interval;
      int next_restart_num = 0;
      for (int64_t m = 0; m < mcus; m++) {
        if (++mx == per_row) mx = 0, my++;
        // the MCU row starting: where an iMCU row starts, the last good one
        if (mx == 0 && my % rows_per_imcu == 0 && !bits.insufficient)
          last_good_row = static_cast<int>(my / rows_per_imcu);
        if (restart_interval && m > 0 && --to_restart == 0) {
          to_restart = restart_interval;
          if (ojpeg && !bits.next_is_restart(next_restart_num)) {
            fail_mcu = m;
            break;
          }
          bits.restart(next_restart_num);
          for (Component& c : comps) c.dc_last = 0;
          eobrun = 0;
        }
        if (bits.insufficient) {
          if (ojpeg && !bits.at_marker) {
            fail_mcu = m - 1;
            break;
          }
          continue;
        }
        for (size_t s = 0; s < layout.size(); s++) {
          Component& c = comps[layout[s].ci];
          // (a table the scan does not use may be an index past 3)
          const int k = layout[s].k;
          const Huffman& dc = dc_tables[dct[k] & 3];
          const Huffman& ac = ac_tables[act[k] & 3];
          int16_t* blk = block_at(my, mx, s);
          if (!progressive) {
            sequential_block(bits, dc, ac, c.dc_last, blk);
          } else if (ss == 0) {
            if (ah == 0) {
              int sdc = bits.decode(dc);
              int diff = extend(bits.get(sdc), sdc);
              c.dc_last += diff;
              blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.dc_last) << al);
            } else if (bits.get(1)) {
              blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
            }
          } else if (ah == 0) {
            ac_first(bits, ac, ss, se, al, eobrun, blk);
          } else {
            ac_refine(bits, ac, ss, se, al, eobrun, blk);
          }
        }
      }
      if (!bits.insufficient) last_good_row = INT_MAX;  // the scan's last row
      p = bits.pos;
    }
    return next_marker_at(p);
  }

  // the next marker past the scan's data (next_marker skips the rest, and
  // the marker reader skips restart markers)
  int64_t next_marker_at(int64_t p) const {
    while (p + 1 < n) {
      if (d[p] == 0xFF && d[p + 1] != 0 && d[p + 1] != 0xFF &&
          !(d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7))
        break;
      p++;
    }
    return p;
  }

  // A lossless scan (jpeg_lossless.cpp) into the components' samples.
  int64_t lossless_scan(const std::vector<int>& in_scan, const std::vector<int>& dct,
                        int ss, int se, int ah, int al, int64_t pos) {
    const int ns = static_cast<int>(in_scan.size());
    int blocks = 0;
    for (int ci : in_scan) blocks += comps[ci].h * comps[ci].v;
    if (ns > 1 && blocks > 10)
      corrupt("JPEG: an interleaved scan of more than 10 blocks an MCU "
              "(sampling factors too large), which libjpeg-turbo refuses");
    // jddiffct.c / jdlossls.c start_pass: the predictor and point transform
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
      corrupt("JPEG: bad lossless scan parameters");
    std::vector<mrt::LosslessComp> lc(static_cast<size_t>(ns));
    for (int k = 0; k < ns; k++) {
      check_table(dct[k], true, 16);
      Component& c = comps[in_scan[k]];
      lc[k].plane = c.samples.data();
      lc[k].cw = c.cw;
      lc[k].ch = c.ch;
      lc[k].h = c.h;
      lc[k].v = c.v;
      lc[k].table = &dc_tables[dct[k]];
    }
    const int lx = (width + hmax - 1) / hmax, ly = (height + vmax - 1) / vmax;
    int64_t end = pos;
    mrt::lossless_scan(d, n, pos, ss, al, restart_interval, lx, ly, !in_tiff, lc, end);
    return next_marker_at(end);
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
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  Tables() {
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

// jdcolor.c ycc_rgb_convert of one pixel
inline void ycc_to_rgb(const Tables& t, int y, int cb, int cr, uint8_t* o) {
  o[0] = clamp255(y + t.cr_r[cr]);
  o[1] = clamp255(y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
  o[2] = clamp255(y + t.cb_b[cb]);
}

// libjpeg-turbo's islow IDCT as Pillow's build runs it on x86-64, the
// SIMD one (jidctint-sse2.asm; the AVX2 one gives the same bits): it
// equals jidctint.c's wherever no intermediate leaves its range, and on
// the coefficients of corrupt data it is its own. The coefficients are
// dequantized by 16-bit multiplies (the quantizer a 16-bit short), the
// sums of two terms before a multiply are 16-bit and wrap, the products
// and the rest are 32-bit, each pass's results saturate to 16 bits and
// the samples to -128..127 before the +128; a block whose rows 1-7 are all
// zero takes the first pass's DC shortcut (a 16-bit shift). Eight columns
// (then rows) at a time, as jidctint-sse2.asm lays them out: pmullw
// products, paddw/psubw sums, pmaddwd pairs, packssdw and packsswb
// saturation.
inline __m128i madd_pairs(__m128i a, __m128i b, int16_t ca, int16_t cb) {
  return _mm_madd_epi16(_mm_unpacklo_epi16(a, b), _mm_set_epi16(cb, ca, cb, ca, cb, ca, cb, ca));
}
inline __m128i madd_pairs_hi(__m128i a, __m128i b, int16_t ca, int16_t cb) {
  return _mm_madd_epi16(_mm_unpackhi_epi16(a, b), _mm_set_epi16(cb, ca, cb, ca, cb, ca, cb, ca));
}

// one pass over x[0..7] (registers of 8 lanes), descaled by `sh` and
// saturated to 16 bits into y[0..7]
inline void idct_pass_sse2(const __m128i* x, __m128i* y, int sh) {
  const __m128i rnd = _mm_set1_epi32(1 << (sh - 1));
  const __m128i zero = _mm_setzero_si128();
  __m128i o_lo[8], o_hi[8];
  for (int half = 0; half < 2; half++) {
    auto madd = half ? madd_pairs_hi : madd_pairs;
    auto widen = [&](__m128i v) {  // (v << 16) >> 3: v << 13 in 32 bits
      return _mm_srai_epi32(half ? _mm_unpackhi_epi16(zero, v) : _mm_unpacklo_epi16(zero, v),
                            16 - kConstBits);
    };
    const __m128i tmp3 = madd(x[2], x[6], F0541 + F0765, F0541);
    const __m128i tmp2 = madd(x[2], x[6], F0541, F0541 - F1847);
    const __m128i tmp0 = widen(_mm_add_epi16(x[0], x[4]));
    const __m128i tmp1 = widen(_mm_sub_epi16(x[0], x[4]));
    const __m128i tmp10 = _mm_add_epi32(tmp0, tmp3), tmp13 = _mm_sub_epi32(tmp0, tmp3);
    const __m128i tmp11 = _mm_add_epi32(tmp1, tmp2), tmp12 = _mm_sub_epi32(tmp1, tmp2);
    const __m128i z3s = _mm_add_epi16(x[3], x[7]), z4s = _mm_add_epi16(x[1], x[5]);
    const __m128i z3p = madd(z3s, z4s, F1175 - F1961, F1175);
    const __m128i z4p = madd(z3s, z4s, F1175, F1175 - F0390);
    const __m128i t0 = _mm_add_epi32(madd(x[7], x[1], F0298 - F0899, -F0899), z3p);
    const __m128i t3 = _mm_add_epi32(madd(x[7], x[1], -F0899, F1501 - F0899), z4p);
    const __m128i t1 = _mm_add_epi32(madd(x[5], x[3], F2053 - F2562, -F2562), z4p);
    const __m128i t2 = _mm_add_epi32(madd(x[5], x[3], -F2562, F3072 - F2562), z3p);
    __m128i* o = half ? o_hi : o_lo;
    o[0] = _mm_add_epi32(tmp10, t3);
    o[7] = _mm_sub_epi32(tmp10, t3);
    o[1] = _mm_add_epi32(tmp11, t2);
    o[6] = _mm_sub_epi32(tmp11, t2);
    o[2] = _mm_add_epi32(tmp12, t1);
    o[5] = _mm_sub_epi32(tmp12, t1);
    o[3] = _mm_add_epi32(tmp13, t0);
    o[4] = _mm_sub_epi32(tmp13, t0);
  }
  const __m128i count = _mm_cvtsi32_si128(sh);
  for (int k = 0; k < 8; k++)
    y[k] = _mm_packs_epi32(_mm_sra_epi32(_mm_add_epi32(o_lo[k], rnd), count),
                           _mm_sra_epi32(_mm_add_epi32(o_hi[k], rnd), count));
}

inline void transpose8x8(__m128i* r) {
  const __m128i a0 = _mm_unpacklo_epi16(r[0], r[1]), a1 = _mm_unpackhi_epi16(r[0], r[1]);
  const __m128i a2 = _mm_unpacklo_epi16(r[2], r[3]), a3 = _mm_unpackhi_epi16(r[2], r[3]);
  const __m128i a4 = _mm_unpacklo_epi16(r[4], r[5]), a5 = _mm_unpackhi_epi16(r[4], r[5]);
  const __m128i a6 = _mm_unpacklo_epi16(r[6], r[7]), a7 = _mm_unpackhi_epi16(r[6], r[7]);
  const __m128i b0 = _mm_unpacklo_epi32(a0, a2), b1 = _mm_unpackhi_epi32(a0, a2);
  const __m128i b2 = _mm_unpacklo_epi32(a1, a3), b3 = _mm_unpackhi_epi32(a1, a3);
  const __m128i b4 = _mm_unpacklo_epi32(a4, a6), b5 = _mm_unpackhi_epi32(a4, a6);
  const __m128i b6 = _mm_unpacklo_epi32(a5, a7), b7 = _mm_unpackhi_epi32(a5, a7);
  r[0] = _mm_unpacklo_epi64(b0, b4);
  r[1] = _mm_unpackhi_epi64(b0, b4);
  r[2] = _mm_unpacklo_epi64(b1, b5);
  r[3] = _mm_unpackhi_epi64(b1, b5);
  r[4] = _mm_unpacklo_epi64(b2, b6);
  r[5] = _mm_unpackhi_epi64(b2, b6);
  r[6] = _mm_unpacklo_epi64(b3, b7);
  r[7] = _mm_unpackhi_epi64(b3, b7);
}

// Writes the 8x8 samples at out with row stride `stride`.
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  __m128i x[8];
  __m128i ac = _mm_setzero_si128();
  for (int k = 0; k < 8; k++) {
    x[k] = _mm_mullo_epi16(_mm_loadu_si128(reinterpret_cast<const __m128i*>(in + 8 * k)),
                           _mm_loadu_si128(reinterpret_cast<const __m128i*>(q + 8 * k)));
    if (k) ac = _mm_or_si128(ac, _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + 8 * k)));
  }
  __m128i ws[8];
  if (_mm_movemask_epi8(_mm_cmpeq_epi8(ac, _mm_setzero_si128())) == 0xFFFF) {
    const __m128i dc = _mm_slli_epi16(x[0], kPass1Bits);  // psllw: wraps
    for (int k = 0; k < 8; k++) ws[k] = dc;
  } else {
    idct_pass_sse2(x, ws, kConstBits - kPass1Bits);
  }
  transpose8x8(ws);
  __m128i y[8];
  idct_pass_sse2(ws, y, kConstBits + kPass1Bits + 3);
  transpose8x8(y);
  const __m128i bias = _mm_set1_epi8(static_cast<char>(0x80));
  for (int k = 0; k < 8; k += 2) {
    const __m128i b = _mm_add_epi8(_mm_packs_epi16(y[k], y[k + 1]), bias);
    _mm_storel_epi64(reinterpret_cast<__m128i*>(out + static_cast<int64_t>(k) * stride), b);
    _mm_storel_epi64(reinterpret_cast<__m128i*>(out + static_cast<int64_t>(k + 1) * stride),
                     _mm_unpackhi_epi64(b, b));
  }
}

// A component's samples at full size, [height][width], from its
// downsampled plane (cw x ch valid of a `stride`-wide buffer), with the
// upsampler jdsample.c jinit_upsampler picks for the ratio (hr, vr).
void upsample(const uint8_t* src, int stride, int cw, int ch, int hr, int vr,
              uint8_t* dst, int width, int height, bool fancy) {
  auto row = [&](int r) { return src + static_cast<int64_t>(r) * stride; };
  std::vector<int> colsum(static_cast<size_t>(cw));
  std::vector<uint8_t> wide(static_cast<size_t>(cw) * hr + 8);
  for (int y = 0; y < height; y++) {
    uint8_t* o = dst + static_cast<int64_t>(y) * width;
    int r = y / vr;
    if (hr == 1 && vr == 1) {
      std::memcpy(o, row(y), static_cast<size_t>(width));
    } else if (fancy && hr == 2 && vr == 1 && cw > 2) {
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
    } else if (fancy && hr == 1 && vr == 2) {
      // h1v2_fancy_upsample: the nearer input row 3x, the other 1x
      int above = y % 2 == 0;
      int other = above ? std::max(r - 1, 0) : std::min(r + 1, ch - 1);
      int bias = above ? 1 : 2;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(other);
      for (int x = 0; x < width; x++) {
        o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    } else if (fancy && hr == 2 && vr == 2 && cw > 2) {
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

// jdcoefct.c decompress_smooth_data as libjpeg-turbo 3.1 runs it when
// smoothing_ok (Jpeg::would_smooth) holds at the output pass, every scan
// read: each block's coefficients 1-9 that are still zero and not known
// to full precision estimated from the DC values of its 5x5 neighbourhood
// (edge blocks replicated; the rows above and below as the iMCU rows
// address them), within the limit coef_bits gives; and where a component
// has no AC data at all, its DC value smoothed too. Then the IDCT.
void idct_smoothed(const Component& c, int imcu_rows, int last_good_row, bool first_scan_only,
                   uint8_t* plane, int stride) {
  const int bx = (c.cw + 7) / 8, by = (c.ch + 7) / 8;
  // smoothing_ok's latches: the bits now, and before the last scan (-1
  // where there was no scan before)
  int now[10], before[10];
  for (int k = 0; k < 10; k++) {
    now[k] = c.coef_bits[k];
    before[k] = k == 0 ? 0 : first_scan_only ? -1 : c.prev_bits[k];
  }
  int64_t q[64];
  for (int k = 0; k < 64; k++) q[k] = c.quant[k];
  const int64_t Q00 = q[0];
  // a coefficient's estimate from num, for quantizer qk, within the bits
  // al it is known to
  auto predict = [](int64_t num, int64_t qk, int al) {
    int pred;
    if (num >= 0) {
      pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return pred;
  };
  const int vs = c.v;
  int16_t ws[64];
  for (int R = 0; R < imcu_rows; R++) {
    const int* cb = R > last_good_row ? before : now;
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && cb[k] == -1;
    int block_rows = vs;
    if (R == imcu_rows - 1) {
      block_rows = by % vs;
      if (block_rows == 0) block_rows = vs;
    }
    const int image_block_rows = block_rows * imcu_rows;
    for (int br = 0; br < block_rows; br++) {
      const int row = R * vs + br;
      if (row >= by) break;
      const int ibr = R * block_rows + br;  // as libjpeg counts it
      const int prev = ibr > 0 ? row - 1 : row;
      const int pprev = ibr > 1 ? row - 2 : prev;
      const int next = ibr < image_block_rows - 1 ? row + 1 : row;
      const int nnext = ibr < image_block_rows - 2 ? row + 2 : next;
      const int rows[5] = {pprev, prev, row, next, nnext};
      for (int x = 0; x < bx; x++) {
        // DC[r][k]: row r of the five, column x - 2 + k clamped
        int DC[5][5];
        for (int r = 0; r < 5; r++) {
          const int16_t* base = c.coef.data() + static_cast<int64_t>(rows[r]) * c.bw * 64;
          for (int k = 0; k < 5; k++) {
            const int col = std::min(std::max(x - 2 + k, 0), bx - 1);
            DC[r][k] = base[static_cast<int64_t>(col) * 64];
          }
        }
        const int DC01 = DC[0][0], DC02 = DC[0][1], DC03 = DC[0][2], DC04 = DC[0][3],
                  DC05 = DC[0][4], DC06 = DC[1][0], DC07 = DC[1][1], DC08 = DC[1][2],
                  DC09 = DC[1][3], DC10 = DC[1][4], DC11 = DC[2][0], DC12 = DC[2][1],
                  DC13 = DC[2][2], DC14 = DC[2][3], DC15 = DC[2][4], DC16 = DC[3][0],
                  DC17 = DC[3][1], DC18 = DC[3][2], DC19 = DC[3][3], DC20 = DC[3][4],
                  DC21 = DC[4][0], DC22 = DC[4][1], DC23 = DC[4][2], DC24 = DC[4][3],
                  DC25 = DC[4][4];
        std::memcpy(ws, c.coef.data() + (static_cast<int64_t>(row) * c.bw + x) * 64,
                    sizeof(ws));
        int al;
        // AC01
        if ((al = cb[1]) != 0 && ws[1] == 0) {
          const int64_t num = Q00 * (change_dc
              ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
              : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = static_cast<int16_t>(predict(num, q[1], al));
        }
        // AC10
        if ((al = cb[2]) != 0 && ws[8] == 0) {
          const int64_t num = Q00 * (change_dc
              ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
              : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = static_cast<int16_t>(predict(num, q[8], al));
        }
        // AC20
        if ((al = cb[3]) != 0 && ws[16] == 0) {
          const int64_t num = Q00 * (change_dc
              ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
              : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = static_cast<int16_t>(predict(num, q[16], al));
        }
        // AC11
        if ((al = cb[4]) != 0 && ws[9] == 0) {
          const int64_t num = Q00 * (change_dc
              ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25)
              : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 +
                 DC04 - DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = static_cast<int16_t>(predict(num, q[9], al));
        }
        // AC02
        if ((al = cb[5]) != 0 && ws[2] == 0) {
          const int64_t num = Q00 * (change_dc
              ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
              : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = static_cast<int16_t>(predict(num, q[2], al));
        }
        if (change_dc) {
          // AC03, AC12, AC21, AC30
          if ((al = cb[6]) != 0 && ws[3] == 0) {
            const int64_t num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            ws[3] = static_cast<int16_t>(predict(num, q[3], al));
          }
          if ((al = cb[7]) != 0 && ws[10] == 0) {
            const int64_t num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            ws[10] = static_cast<int16_t>(predict(num, q[10], al));
          }
          if ((al = cb[8]) != 0 && ws[17] == 0) {
            const int64_t num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            ws[17] = static_cast<int16_t>(predict(num, q[17], al));
          }
          if ((al = cb[9]) != 0 && ws[24] == 0) {
            const int64_t num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            ws[24] = static_cast<int16_t>(predict(num, q[24], al));
          }
          // the DC value itself
          const int64_t num = Q00 *
              (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
               6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
               152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
               6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
               2 * DC25);
          ws[0] = static_cast<int16_t>(predict(num, Q00, 0));
        }
        idct_islow(ws, c.quant16, plane + static_cast<int64_t>(row) * 8 * stride + x * 8,
                   stride);
      }
    }
  }
}

// Every component's samples at the frame's full size ([height][width]
// each): the entropy-coded data, the IDCT (block-smoothed where
// libjpeg-turbo smooths) or a lossless frame's samples, and the
// upsampler.
std::vector<std::vector<uint8_t>> jpeg_planes(Jpeg& j, bool ran = false) {
  if (!ran) j.run(false);
  if (j.comps.front().coef.empty() && j.comps.front().samples.empty()) j.allocate();
  const bool smooth = j.would_smooth();
    const int W = j.width, H = j.height;
  size_t nc = j.comps.size();
  std::vector<std::vector<uint8_t>> full(nc);
  std::vector<uint8_t> plane;
  for (size_t ci = 0; ci < nc; ci++) {
    Component& c = j.comps[ci];
    full[ci].resize(static_cast<size_t>(W) * H);
    if (j.lossless) {
      // no DCT: libjpeg-turbo's upsampler has no context rows (box only)
      upsample(c.samples.data(), c.cw, c.cw, c.ch, j.hmax / c.h, j.vmax / c.v,
               full[ci].data(), W, H, false);
      std::vector<uint8_t>().swap(c.samples);
      continue;
    }
    int bx = (c.cw + 7) / 8, by = (c.ch + 7) / 8;
    int stride = bx * 8;
    plane.assign(static_cast<size_t>(stride) * by * 8, 0);
    if (smooth) {
      idct_smoothed(c, j.mcuy, j.last_good_row, j.scans <= 1, plane.data(), stride);
    } else {
      for (int y = 0; y < by; y++) {
        for (int x = 0; x < bx; x++) {
          idct_islow(c.coef.data() + (static_cast<int64_t>(y) * c.bw + x) * 64,
                     c.quant16, plane.data() + static_cast<int64_t>(y) * 8 * stride + x * 8,
                     stride);
        }
      }
    }
    std::vector<int16_t>().swap(c.coef);
    upsample(plane.data(), stride, c.cw, c.ch, j.hmax / c.h, j.vmax / c.v,
             full[ci].data(), W, H, true);
  }
  return full;
}

// libjpeg's raw data output: each component's samples at its own
// (downsampled) resolution, its blocks' IDCT into a plane of whole blocks
// (`planes`), their row strides returned
std::vector<int> jpeg_raw_planes(Jpeg& j, std::vector<std::vector<uint8_t>>& planes) {
  if (j.comps.front().coef.empty()) j.allocate();
  std::vector<int> strides;
  planes.assign(j.comps.size(), {});
  for (size_t ci = 0; ci < j.comps.size(); ci++) {
    Component& c = j.comps[ci];
    const int bx = (c.cw + 7) / 8, by = (c.ch + 7) / 8;
    const int stride = bx * 8;
    planes[ci].assign(static_cast<size_t>(stride) * by * 8, 0);
    for (int y = 0; y < by; y++)
      for (int x = 0; x < bx; x++)
        idct_islow(c.coef.data() + (static_cast<int64_t>(y) * c.bw + x) * 64, c.quant16,
                   planes[ci].data() + static_cast<int64_t>(y) * 8 * stride + x * 8, stride);
    strides.push_back(stride);
  }
  return strides;
}

void decode_jpeg(Jpeg& j, uint8_t* out) {
  std::vector<std::vector<uint8_t>> full = jpeg_planes(j);
  const Tables& t = tables();
  const int64_t npix = static_cast<int64_t>(j.width) * j.height;
  Space s = j.space();
  // libjpeg-turbo converts no colour space in a lossless frame: YCbCr or
  // YCCK components, which Pillow's RGB or CMYK output would convert,
  // are an error
  if (j.lossless && (s == Space::YCbCr || s == Space::YCCK))
    corrupt("JPEG: unsupported color conversion request (a lossless frame of YCbCr or "
            "YCCK components)");
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
    for (int64_t i = 0; i < npix; i++) ycc_to_rgb(t, Y[i], Cb[i], Cr[i], out + 3 * i);
  } else {
    // CMYK from libjpeg (YCCK through ycck_cmyk_convert), then Pillow's
    // "CMYK;I" unpack (255 - v) and Convert.c cmyk2rgb
    const uint8_t *P0 = full[0].data(), *P1 = full[1].data(),
                  *P2 = full[2].data(), *P3 = full[3].data();
    for (int64_t i = 0; i < npix; i++) {
      int c0 = P0[i], c1 = P1[i], c2 = P2[i];
      if (s == Space::YCCK && !j.force_cmyk) {
        int y = c0, cb = c1, cr = c2;
        c0 = clamp255(255 - (y + t.cr_r[cr]));
        c1 = clamp255(255 - (y + ((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
        c2 = clamp255(255 - (y + t.cb_b[cb]));
      }
      const uint8_t inv[4] = {uint8_t(255 - c0), uint8_t(255 - c1), uint8_t(255 - c2),
                              uint8_t(255 - P3[i])};
      mrt::cmyk_rgb(inv, out + 3 * i);
    }
  }
}

// One JPEG file's whole decode into out [height, width, 3], the size its
// size call gave; force_cmyk: BLP1's jpegmode "CMYK" (Jpeg::force_cmyk)
void jpeg_entry(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width,
                bool force_cmyk) {
  Jpeg j(data, n);
  j.force_cmyk = force_cmyk;
  decode_jpeg(j, out);
  if (j.height != height || j.width != width) corrupt("JPEG: the frame's size changed");
}

// ------------------------------------------------------------------- zlib

// zlib's inflate (RFC 1950 and 1951), PNG's and TIFF's: a whole stream as
// zlib.decompress gives it (a PNG's image data), or one strip or tile as
// libtiff's ZIPDecode drives it: the output buffer is filled, and decoding
// goes on past a full buffer only for what needs no output (block
// headers, the last block's end and its Adler-32 check), as zlib's state
// machine does. Its checks and messages are zlib's.
struct InflateEnd {};  // the input ran out

constexpr int kZFast = 11;

struct ZHuff {
  int16_t count[16];
  int16_t symbol[320];
  uint16_t fast[1 << kZFast];  // (code length << 9) | symbol, codes of <= kZFast bits
  bool empty = false;  // no codes at all: every code is invalid
};

// zlib's inflate_table: false for an over-subscribed set, or an incomplete
// one where zlib refuses it (the code-length code, or a set whose longest
// code is not a single 1-bit code).
bool build_zhuff(ZHuff& h, const uint8_t* lens, int n, bool code_lengths) {
  std::memset(h.count, 0, sizeof(h.count));
  std::memset(h.fast, 0, sizeof(h.fast));
  for (int i = 0; i < n; i++) h.count[lens[i]]++;
  int max = 15;
  while (max >= 1 && h.count[max] == 0) max--;
  h.empty = max == 0;
  if (h.empty) return !code_lengths;
  int left = 1;
  for (int len = 1; len <= 15; len++) {
    left <<= 1;
    left -= h.count[len];
    if (left < 0) return false;
  }
  if (left > 0 && (code_lengths || max != 1)) return false;
  int16_t offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; len++) offs[len + 1] = static_cast<int16_t>(offs[len] + h.count[len]);
  for (int i = 0; i < n; i++)
    if (lens[i]) h.symbol[offs[lens[i]]++] = static_cast<int16_t>(i);
  // the fast table: canonical codes, stored bit-reversed (LSB first)
  int code = 0, k = 0;
  for (int len = 1; len <= kZFast; len++) {
    for (int c = 0; c < h.count[len]; c++, k++, code++) {
      int rev = 0;
      for (int b = 0; b < len; b++) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int i = rev; i < (1 << kZFast); i += 1 << len)
        h.fast[i] = static_cast<uint16_t>((len << 9) | h.symbol[k]);
    }
    code <<= 1;
  }
  return true;
}

class Inflater {
 public:
  // what: the prefix of its errors ("TIFF: Deflate data", ...)
  Inflater(const uint8_t* d, int64_t n, const char* what) : d_(d), n_(n), what_(what) {}

  // Fills out[0, cap): libtiff's ZIPDecode over one strip or tile, its
  // Adler-32 checked only where the stream ends inside the strip.
  int64_t run(uint8_t* out, int64_t cap) { return inflate(out, cap); }

  // The whole stream into v, grown from its size as the data needs and
  // cut to the data: zlib.decompress (its end and Adler-32 checked, what
  // follows the stream ignored).
  void run(std::vector<uint8_t>& v) {
    if (v.empty()) v.resize(1);
    grow_ = &v;
    v.resize(static_cast<size_t>(inflate(v.data(), static_cast<int64_t>(v.size()))));
  }

  // A raw deflate stream (no zlib header or Adler-32) into v, as
  // zlib.decompressobj(wbits=-15) inflates it: the offset of its end in
  // the input, where its unused data starts.
  int64_t run_raw(std::vector<uint8_t>& v) {
    raw_ = true;
    run(v);
    return end_;
  }

 private:
  int64_t inflate(uint8_t* out, int64_t cap) {
    out_ = out;
    cap_ = cap;
    len_ = 0;
    try {
      if (!raw_) {
        int cmf = static_cast<int>(bits(8)), flg = static_cast<int>(bits(8));
        if ((cmf * 256 + flg) % 31) fail("incorrect header check");
        if ((cmf & 15) != 8) fail("unknown compression method");
        if ((cmf >> 4) + 8 > 15) fail("invalid window size");
        if (flg & 0x20) fail("a preset dictionary is needed");
      }
      for (;;) {
        const bool last = bits(1);
        const int type = static_cast<int>(bits(2));
        if (type == 0) {
          stored();
        } else if (type == 1) {
          fixed_tables();
          codes(lit_, dist_);
        } else if (type == 2) {
          dynamic_tables();
          codes(lit_, dist_);
        } else {
          fail("invalid block type");
        }
        if (stop_) return len_;
        if (last) break;
      }
      // the Adler-32 of the data, big-endian, after the last block
      drop(bitcnt_ & 7);
      if (raw_) {
        end_ = pos_ - bitcnt_ / 8;
        return len_;
      }
      uint32_t want = 0;
      for (int i = 0; i < 4; i++) want = (want << 8) | static_cast<uint32_t>(bits(8));
      if (want != adler()) fail("incorrect data check");
      if (!grow_ && len_ < cap_) fail_short();
      return len_;
    } catch (const InflateEnd&) {
      if (grow_) fail("incomplete or truncated stream");
      if (len_ == cap_) return len_;
      fail_short();
    }
  }

  const uint8_t* d_;
  int64_t n_;
  const char* what_;
  int64_t pos_ = 0;
  uint64_t bitbuf_ = 0;
  int bitcnt_ = 0;
  uint8_t* out_ = nullptr;
  int64_t cap_ = 0, len_ = 0;
  std::vector<uint8_t>* grow_ = nullptr;
  bool stop_ = false;
  bool raw_ = false;
  int64_t end_ = 0;
  ZHuff lit_, dist_;

  [[noreturn]] void fail(const char* why) const {
    corrupt(std::string(what_) + ": " + why);
  }
  [[noreturn]] void fail_short() const {
    corrupt(std::string(what_) + ": not enough data (short " +
            std::to_string(cap_ - len_) + " bytes)");
  }

  void refill() {
    if (pos_ + 8 <= n_) {
      // a whole word: the bits past bitcnt_ are the stream's next bits,
      // so or-ing them in again later changes nothing
      uint64_t word;
      std::memcpy(&word, d_ + pos_, 8);
      bitbuf_ |= word << bitcnt_;
      const int take = (63 - bitcnt_) >> 3;
      pos_ += take;
      bitcnt_ += 8 * take;
      return;
    }
    while (bitcnt_ <= 56 && pos_ < n_) {
      bitbuf_ |= static_cast<uint64_t>(d_[pos_++]) << bitcnt_;
      bitcnt_ += 8;
    }
  }
  uint32_t bits(int k) {
    if (k == 0) return 0;
    if (bitcnt_ < k) {
      refill();
      if (bitcnt_ < k) throw InflateEnd{};
    }
    const uint32_t v = static_cast<uint32_t>(bitbuf_ & ((uint64_t{1} << k) - 1));
    drop(k);
    return v;
  }
  void drop(int k) {
    bitbuf_ >>= k;
    bitcnt_ -= k;
  }

  int decode(const ZHuff& h) {
    if (h.empty) return -1;
    if (bitcnt_ < 15) refill();
    const uint16_t e = h.fast[bitbuf_ & ((1 << kZFast) - 1)];
    if (e && (e >> 9) <= bitcnt_) {
      drop(e >> 9);
      return e & 511;
    }
    // puff.c's decode, a bit at a time
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; len++) {
      code |= static_cast<int>(bits(1));
      const int count = h.count[len];
      if (code - count < first) return h.symbol[index + (code - first)];
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    return -1;
  }

  // false where k more bytes fit (the whole-stream buffer grown for
  // them); a strip's buffer ends the strip once it is full
  bool full(int64_t k = 1) {
    if (k <= cap_ - len_) return false;
    if (grow_) {
      grow_->resize(static_cast<size_t>(std::max(len_ + k, 2 * cap_)));
      out_ = grow_->data();
      cap_ = static_cast<int64_t>(grow_->size());
      return false;
    }
    if (len_ < cap_) return false;
    stop_ = true;
    return true;
  }

  void stored() {
    drop(bitcnt_ & 7);
    const uint32_t len = bits(16), nlen = bits(16);
    if (len != (~nlen & 0xffff)) fail("invalid stored block lengths");
    for (uint32_t i = 0; i < len; i++) {
      if (full()) return;
      out_[len_++] = static_cast<uint8_t>(bits(8));
    }
  }

  void fixed_tables() {
    uint8_t lens[320];
    for (int i = 0; i < 144; i++) lens[i] = 8;
    for (int i = 144; i < 256; i++) lens[i] = 9;
    for (int i = 256; i < 280; i++) lens[i] = 7;
    for (int i = 280; i < 288; i++) lens[i] = 8;
    build_zhuff(lit_, lens, 288, false);
    for (int i = 0; i < 32; i++) lens[i] = 5;
    build_zhuff(dist_, lens, 32, false);
  }

  void dynamic_tables() {
    const int nlen = static_cast<int>(bits(5)) + 257;
    const int ndist = static_cast<int>(bits(5)) + 1;
    const int ncode = static_cast<int>(bits(4)) + 4;
    if (nlen > 286 || ndist > 30) fail("too many length or distance symbols");
    static const uint8_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                      11, 4, 12, 3, 13, 2, 14, 1, 15};
    uint8_t lens[320] = {0};
    for (int i = 0; i < ncode; i++) lens[order[i]] = static_cast<uint8_t>(bits(3));
    ZHuff cl;
    if (!build_zhuff(cl, lens, 19, true)) fail("invalid code lengths set");
    int have = 0;
    std::memset(lens, 0, sizeof(lens));
    while (have < nlen + ndist) {
      const int sym = decode(cl);
      if (sym < 0) fail("invalid code lengths set");
      if (sym < 16) {
        lens[have++] = static_cast<uint8_t>(sym);
        continue;
      }
      int len = 0, rep;
      if (sym == 16) {
        if (have == 0) fail("invalid bit length repeat");
        len = lens[have - 1];
        rep = 3 + static_cast<int>(bits(2));
      } else if (sym == 17) {
        rep = 3 + static_cast<int>(bits(3));
      } else {
        rep = 11 + static_cast<int>(bits(7));
      }
      if (have + rep > nlen + ndist) fail("invalid bit length repeat");
      while (rep--) lens[have++] = static_cast<uint8_t>(len);
    }
    if (lens[256] == 0) fail("invalid code -- missing end-of-block");
    if (!build_zhuff(lit_, lens, nlen, false)) fail("invalid literal/lengths set");
    if (!build_zhuff(dist_, lens + nlen, ndist, false)) fail("invalid distances set");
  }

  void codes(const ZHuff& lit, const ZHuff& dist) {
    static const uint16_t lbase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                                       31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const uint8_t lext[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                     2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    static const uint16_t dbase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                                       193, 257, 385, 513, 769, 1025, 1537, 2049, 3073,
                                       4097, 6145, 8193, 12289, 16385, 24577};
    static const uint8_t dext[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                     6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
    for (;;) {
      int sym = decode(lit);
      if (sym < 256) {
        if (sym < 0) fail("invalid literal/length code");
        if (len_ == cap_ && full()) return;
        out_[len_++] = static_cast<uint8_t>(sym);
        continue;
      }
      if (sym == 256) return;
      sym -= 257;
      if (sym >= 29) fail("invalid literal/length code");
      int64_t length = lbase[sym] + bits(lext[sym]);
      const int dsym = decode(dist);
      if (dsym < 0 || dsym >= 30) fail("invalid distance code");
      const int64_t distance = dbase[dsym] + bits(dext[dsym]);
      if (full(length)) return;
      if (distance > len_) fail("invalid distance too far back");
      const int64_t n = std::min(length, cap_ - len_);
      uint8_t* dst = out_ + len_;
      const uint8_t* src = dst - distance;
      if (distance == 1) {
        std::memset(dst, src[0], static_cast<size_t>(n));
      } else {
        // chunks of at most `distance` bytes: each reads only bytes
        // already written
        for (int64_t i = 0; i < n; i += distance)
          std::memcpy(dst + i, src + i, static_cast<size_t>(std::min(distance, n - i)));
      }
      len_ += n;
      if (n < length && full()) return;
    }
  }

  // 16 bytes a step: b gains 16 a and the bytes weighted 16 to 1
  uint32_t adler() const {
    uint64_t a = 1, b = 0;
    for (int64_t i = 0; i < len_;) {
      const int64_t end = std::min<int64_t>(len_, i + 5552);
      for (; i + 16 <= end; i += 16) {
        uint32_t sum = 0, weighted = 0;
        for (int k = 0; k < 16; k++) {
          sum += out_[i + k];
          weighted += static_cast<uint32_t>(16 - k) * out_[i + k];
        }
        b += 16 * a + weighted;
        a += sum;
      }
      for (; i < end; i++) {
        a += out_[i];
        b += a;
      }
      a %= 65521;
      b %= 65521;
    }
    return static_cast<uint32_t>((b << 16) | a);
  }
};

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

// Adam7 passes: x0, y0, dx, dy
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
const int kWhole[1][4] = {{0, 0, 1, 1}};

// The width and height of Adam7 pass p (or of the whole image).
void png_pass(int width, int height, const int (&plan)[4], int* pw, int* ph) {
  const int x0 = plan[0], y0 = plan[1], dx = plan[2], dy = plan[3];
  *pw = width <= x0 ? 0 : (width - x0 + dx - 1) / dx;
  *ph = height <= y0 ? 0 : (height - y0 + dy - 1) / dy;
}

// z: the image data (all IDAT chunks), inflated here as zlib.decompress
// inflates it.
void decode_png(const uint8_t* z, int64_t zn, int width, int height,
                int depth, int color, int interlace, const uint8_t* palette,
                int entries, uint8_t* out) {
  const int (*plan)[4] = interlace ? kAdam7 : kWhole;
  const int count = interlace ? 7 : 1;
  // the inflate's buffer starts at the size a valid header's data takes
  const int64_t guess_bits = static_cast<int64_t>(color == 2 ? 3 : color == 4 ? 2 : color == 6 ? 4 : 1) *
                             std::min(std::max(depth, 1), 16);
  int64_t size = 0;
  for (int p = 0; p < count; p++) {
    int pw, ph;
    png_pass(width, height, plan[p], &pw, &ph);
    if (pw > 0) size += static_cast<int64_t>(ph) * (1 + (pw * guess_bits + 7) / 8);
  }
  // Pillow's ZipDecode inflates a row at a time and stops at the image's
  // last row: zlib goes on past a full buffer only for what gives no
  // output (a block's end, the next block's header, the Adler-32 check
  // where the stream ends there), so what follows the image's bytes is
  // not read, and a stream that ends on them is whole without its
  // trailer. The strip route's inflate stops the same way.
  std::vector<uint8_t> data(static_cast<size_t>(std::max<int64_t>(size, 1)));
  data.resize(static_cast<size_t>(Inflater(z, zn, "PNG: bad image data").run(data.data(), size)));
  const uint8_t* raw = data.data();
  const int64_t n = static_cast<int64_t>(data.size());
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
  int64_t at = 0;
  std::vector<uint8_t> buf;
  for (int p = 0; p < count; p++) {
    const int x0 = plan[p][0], y0 = plan[p][1], dx = plan[p][2], dy = plan[p][3];
    int pw, ph;
    png_pass(width, height, plan[p], &pw, &ph);
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

// A BMP as BmpImagePlugin.py opens it: a "BM" file, or a DIB header at
// `at` (BmpImageFile._bitmap without a file header: Pillow's DIB plugin,
// an ICO or CUR frame). What Pillow itself refuses (header types, depths,
// bit-field layouts, compressions, palette sizes its _bitmap raises on) is
// a ValueError.
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
  int misread = 0;                // the bits a pixel of Pillow's wrong unpacker, where it has one

  Bmp(const uint8_t* d, int64_t n) {
    if (n < 18 || d[0] != 'B' || d[1] != 'M') corrupt("not a BMP file");
    parse(d, n, 14, le32(d + 10));
  }

  Bmp(const uint8_t* d, int64_t n, int64_t at) {
    if (at < 0 || at > n - 4) corrupt("DIB: truncated header");
    parse(d, n, at, 0);
  }

  void parse(const uint8_t* d, int64_t n, int64_t at, int64_t file_offset) {
    offset = file_offset;
    uint32_t hs = le32(d + at);
    int64_t pos = at;
    if (hs < 4 || pos + hs > n) corrupt("BMP: truncated header");
    const uint8_t* h = d + at + 4;
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
      corrupt("BMP: header type " + std::to_string(hs) + " is not supported");
    }
    if (colors == 0) colors = bits < 32 ? 1u << bits : 0u;
    if (offset == 14 + static_cast<int64_t>(hs) && bits <= 8)
      offset += 4 * static_cast<int64_t>(colors);
    if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 &&
        bits != 32)
      corrupt("BMP: pixel depth " + std::to_string(bits) + " is not supported");
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
      if (!ok) corrupt("BMP: this bit-fields layout is not supported");
    } else if (compression == 1 || compression == 2) {
      // (Pillow's RLE decoder has no raw mode for wider pixels)
      if (bits > 8)
        corrupt("BMP: RLE compression of " + std::to_string(bits) +
                "-bit pixels: unknown raw mode for given image mode, as Pillow raises");
    } else if (compression != 0) {
      const char* name = compression == 4   ? " (JPEG)"
                         : compression == 5 ? " (PNG)"
                                            : "";
      corrupt("BMP: compression " + std::to_string(compression) + name + " is not supported");
    }
    if (bits <= 8) {
      if (colors == 0 || colors > 65536)
        corrupt("BMP: palette size " + std::to_string(colors) + " is not supported");
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
        // grayscale palette with the wrong unpacker: "1" (a bit a pixel)
        // or "L" (a byte a pixel) over the rows of `bits`-bit pixels
        bool one = colors == 2 && bits == 1 && compression == 0;
        bool l8 = colors != 2 && bits == 8;
        bool rle_l = colors != 2 && (compression == 1 || compression == 2);
        if (!one && !l8 && !rle_l) {
          if (compression != 0)
            refuse("BMP: RLE pixels under a grayscale palette of 2 colours (Pillow's mode "
                   "\"1\" over the decoded indices) are not supported");
          misread = colors == 2 ? 1 : 8;
        }
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

// into out [h, b.width, 3]: the first h rows of the bitmap in file order
// (h = b.height; an ICO or CUR frame's XOR image, its height halved)
void decode_bmp(const Bmp& b, const uint8_t* d, int64_t n, uint8_t* out,
                int64_t h) {
  const int64_t w = b.width;
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
  // the raw decoder reads a row's padding only before the next row
  const int64_t stride = ((w * b.bits + 31) >> 3) & ~int64_t{3};
  const int64_t last = (w * (b.misread ? b.misread : b.bits) + 7) / 8;
  // Pillow's raw decoder refuses a row longer than the stride
  if (last > stride) corrupt("BMP: codec configuration error (a row of the raw mode is longer than the stride)");
  if (b.offset < 0 || b.offset > n || (n - b.offset - last) / std::max<int64_t>(stride, 1) < h - 1 ||
      n - b.offset < last)
    corrupt("BMP: image file is truncated");
  for (int64_t r = 0; r < h; r++) {
    const uint8_t* row = d + b.offset + r * stride;
    int64_t y = b.top_down ? r : h - 1 - r;
    uint8_t* o = out + y * w * 3;
    if (b.misread == 8) {
      for (int64_t x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[x];
      continue;
    }
    if (b.misread == 1) {
      for (int64_t x = 0; x < w; x++)
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = (row[x / 8] >> (7 - x % 8)) & 1 ? 255 : 0;
      continue;
    }
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

// ------------------------------------------------------------------- TIFF

// libtiff's LZWDecode over one strip or tile into out[0, cap): codes of 9
// to 12 bits MSB first with the early change of code width, or, when the
// data starts with a clear code written LSB first, LZWDecodeCompat's
// old-style codes (LSB first, the width changed one code later). Data
// that ends without the end code ends the strip as libtiff does; a strip
// left short is an error.
void tiff_lzw(const uint8_t* d, int64_t n, uint8_t* out, int64_t cap) {
  // libtiff's table: 12-bit codes, and CSIZE entries (1,024 past 4,095)
  // that corrupt data may go on filling before a clear code
  constexpr int kSize = 4095 + 1024, kClear = 256, kEnd = 257, kFirst = 258;
  const bool compat = n >= 2 && d[0] == 0 && (d[1] & 1);
  std::vector<uint16_t> prefix(kSize), length(kSize);
  std::vector<uint8_t> value(kSize), first(kSize);
  for (int i = 0; i < 256; i++) {
    length[i] = 1;
    value[i] = first[i] = static_cast<uint8_t>(i);
  }
  int nbits = 9;
  int maxcode = compat ? 511 : 510;
  int free_ent = kFirst;
  int old = -1;  // LZWPreDecode's dec_oldcodep before the table: no code yet
  uint64_t acc = 0;
  int nacc = 0;
  int64_t pos = 0, len = 0;
  auto next = [&]() -> int {
    while (nacc < nbits) {
      if (pos >= n) return kEnd;  // not terminated with the end code
      if (compat) {
        acc |= static_cast<uint64_t>(d[pos++]) << nacc;
      } else {
        acc = (acc << 8) | d[pos++];
      }
      nacc += 8;
    }
    int code;
    if (compat) {
      code = static_cast<int>(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      code = static_cast<int>((acc >> (nacc - nbits)) & ((1u << nbits) - 1));
    }
    nacc -= nbits;
    if (!compat) acc &= (uint64_t{1} << nacc) - 1;
    return code;
  };
  auto put = [&](int code) {
    const int64_t l = length[code];
    if (l > cap - len) {
      // the start of the string that fits
      int c = code;
      int64_t cl = l;
      while (cl > cap - len) {
        c = prefix[c];
        cl--;
      }
      for (int64_t i = cl - 1; i >= 0; i--, c = prefix[c]) out[len + i] = value[c];
      len = cap;
      return;
    }
    int c = code;
    for (int64_t i = l - 1; i >= 0; i--, c = prefix[c]) out[len + i] = value[c];
    len += l;
  };
  while (len < cap) {
    int code = next();
    if (code == kEnd) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        nbits = 9;
        maxcode = compat ? 511 : 510;
        code = next();
      } while (code == kClear);
      if (code == kEnd) break;
      if (code > kClear) corrupt("TIFF: LZW data: corrupted LZW table");
      out[len++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    // a code past the next free entry, or a full table (only a clear or
    // the end code may follow)
    if (code > free_ent || free_ent >= kSize || old < 0)
      corrupt("TIFF: LZW data: corrupted LZW table");
    prefix[free_ent] = static_cast<uint16_t>(old);
    first[free_ent] = first[old];
    length[free_ent] = static_cast<uint16_t>(length[old] + 1);
    value[free_ent] = code < free_ent ? first[code] : first[old];
    if (++free_ent > maxcode) {
      if (++nbits > 12) nbits = 12;
      maxcode = (1 << nbits) - (compat ? 1 : 2);
    }
    old = code;
    put(code);
  }
  if (len < cap)
    corrupt("TIFF: LZW data: not enough data (short " + std::to_string(cap - len) +
            " bytes)");
}

// libtiff's PackBitsDecode over one strip or tile into out[0, cap).
void tiff_packbits(const uint8_t* d, int64_t n, uint8_t* out, int64_t cap) {
  int64_t pos = 0, len = 0;
  while (pos < n && len < cap) {
    int k = d[pos++];
    if (k >= 128) k -= 256;
    if (k < 0) {
      if (k == -128) continue;
      int64_t run = -k + 1;
      if (run > cap - len) run = cap - len;
      if (pos >= n) break;
      std::memset(out + len, d[pos++], static_cast<size_t>(run));
      len += run;
    } else {
      int64_t lit = k + 1;
      if (lit > cap - len) lit = cap - len;
      if (n - pos < lit) break;
      std::memcpy(out + len, d + pos, static_cast<size_t>(lit));
      len += lit;
      pos += lit;
    }
  }
  if (len < cap)
    corrupt("TIFF: PackBits data: not enough data (short " +
            std::to_string(cap - len) + " bytes)");
}

// libtiff's ThunderScan decoder (tif_thunder.c ThunderDecodeRow): rows of
// `width` 4-bit pixels, each row `scan` bytes apart in out[0, cap); runs,
// 2- and 3-bit deltas from the last pixel and raw pixels. A row whose
// codes give more or fewer pixels fails after its bytes past the last
// pixel are zeroed.
void tiff_thunder(const uint8_t* d, int64_t n, uint8_t* out, int64_t cap, int64_t width,
                  int64_t scan) {
  static const int kTwo[4] = {0, 1, 0, -1};
  static const int kThree[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  if (scan <= 0 || cap % scan) corrupt("TIFF: ThunderScan: Fractional scanlines cannot be read");
  int64_t at = 0;  // input read
  for (int64_t row = 0; row < cap; row += scan) {
    uint8_t* op0 = out + row;
    int64_t op = 0;  // output byte
    const int64_t bytes = (width + 1) / 2;
    unsigned last = 0;
    int64_t np = 0;
    auto put = [&](int v) {
      last = static_cast<unsigned>(v) & 0xf;
      if (np < width) {
        if (np++ & 1)
          op0[op++] |= static_cast<uint8_t>(last);
        else
          op0[op] = static_cast<uint8_t>(last << 4);
      }
    };
    while (at < n && np < width) {
      int c = d[at++];
      switch (c & 0xc0) {
        case 0x00: {  // a run of the last pixel, c & 0x3f long
          int k = c;
          if (np & 1) {
            op0[op] |= static_cast<uint8_t>(last);
            last = op0[op++];
            np++;
            k--;
          } else {
            last |= last << 4;
          }
          np += k;
          if (np <= width)
            for (; k > 0; k -= 2) op0[op++] = static_cast<uint8_t>(last);
          if (k == -1) op0[--op] &= 0xf0;
          last &= 0xf;
          break;
        }
        case 0x40:
          if (((c >> 4) & 3) != 2) put(static_cast<int>(last) + kTwo[(c >> 4) & 3]);
          if (((c >> 2) & 3) != 2) put(static_cast<int>(last) + kTwo[(c >> 2) & 3]);
          if ((c & 3) != 2) put(static_cast<int>(last) + kTwo[c & 3]);
          break;
        case 0x80:
          if (((c >> 3) & 7) != 4) put(static_cast<int>(last) + kThree[(c >> 3) & 7]);
          if ((c & 7) != 4) put(static_cast<int>(last) + kThree[c & 7]);
          break;
        default:
          put(c);
          break;
      }
    }
    if (np != width) {
      if (op < bytes) std::memset(op0 + op, 0, static_cast<size_t>(bytes - op));
      corrupt(std::string("TIFF: ThunderScan: ") + (np < width ? "Not enough" : "Too much") +
              " data at scanline " + std::to_string(row / scan) + " (" + std::to_string(np) +
              " != " + std::to_string(width) + ")");
    }
  }
}

// Pillow's TiffImagePlugin.OPEN_INFO: (big-endian, photometric, sample
// format, fill order, bits per sample, extra samples) -> (mode, raw mode)
struct OpenInfo {
  int mm, photometric, format, fill;
  const char* bps;
  const char* extra;
  const char* mode;
  const char* raw;
};

const OpenInfo kOpenInfo[] = {
    {0, 0, 1, 1, "1", "", "1", "1;I"},
    {1, 0, 1, 1, "1", "", "1", "1;I"},
    {0, 0, 1, 2, "1", "", "1", "1;IR"},
    {1, 0, 1, 2, "1", "", "1", "1;IR"},
    {0, 1, 1, 1, "1", "", "1", "1"},
    {1, 1, 1, 1, "1", "", "1", "1"},
    {0, 1, 1, 2, "1", "", "1", "1;R"},
    {1, 1, 1, 2, "1", "", "1", "1;R"},
    {0, 0, 1, 1, "2", "", "L", "L;2I"},
    {1, 0, 1, 1, "2", "", "L", "L;2I"},
    {0, 0, 1, 2, "2", "", "L", "L;2IR"},
    {1, 0, 1, 2, "2", "", "L", "L;2IR"},
    {0, 1, 1, 1, "2", "", "L", "L;2"},
    {1, 1, 1, 1, "2", "", "L", "L;2"},
    {0, 1, 1, 2, "2", "", "L", "L;2R"},
    {1, 1, 1, 2, "2", "", "L", "L;2R"},
    {0, 0, 1, 1, "4", "", "L", "L;4I"},
    {1, 0, 1, 1, "4", "", "L", "L;4I"},
    {0, 0, 1, 2, "4", "", "L", "L;4IR"},
    {1, 0, 1, 2, "4", "", "L", "L;4IR"},
    {0, 1, 1, 1, "4", "", "L", "L;4"},
    {1, 1, 1, 1, "4", "", "L", "L;4"},
    {0, 1, 1, 2, "4", "", "L", "L;4R"},
    {1, 1, 1, 2, "4", "", "L", "L;4R"},
    {0, 0, 1, 1, "8", "", "L", "L;I"},
    {1, 0, 1, 1, "8", "", "L", "L;I"},
    {0, 0, 1, 2, "8", "", "L", "L;IR"},
    {1, 0, 1, 2, "8", "", "L", "L;IR"},
    {0, 1, 1, 1, "8", "", "L", "L"},
    {1, 1, 1, 1, "8", "", "L", "L"},
    {0, 1, 2, 1, "8", "", "L", "L"},
    {1, 1, 2, 1, "8", "", "L", "L"},
    {0, 1, 1, 2, "8", "", "L", "L;R"},
    {1, 1, 1, 2, "8", "", "L", "L;R"},
    {0, 1, 1, 1, "12", "", "I;16", "I;12"},
    {0, 0, 1, 1, "16", "", "I;16", "I;16"},
    {0, 1, 1, 1, "16", "", "I;16", "I;16"},
    {1, 1, 1, 1, "16", "", "I;16B", "I;16B"},
    {0, 1, 1, 2, "16", "", "I;16", "I;16R"},
    {0, 1, 2, 1, "16", "", "I", "I;16S"},
    {1, 1, 2, 1, "16", "", "I", "I;16BS"},
    {0, 0, 3, 1, "32", "", "F", "F;32F"},
    {1, 0, 3, 1, "32", "", "F", "F;32BF"},
    {0, 1, 1, 1, "32", "", "I", "I;32N"},
    {0, 1, 2, 1, "32", "", "I", "I;32S"},
    {1, 1, 2, 1, "32", "", "I", "I;32BS"},
    {0, 1, 3, 1, "32", "", "F", "F;32F"},
    {1, 1, 3, 1, "32", "", "F", "F;32BF"},
    {0, 1, 1, 1, "8,8", "2", "LA", "LA"},
    {1, 1, 1, 1, "8,8", "2", "LA", "LA"},
    {0, 2, 1, 1, "8,8,8", "", "RGB", "RGB"},
    {1, 2, 1, 1, "8,8,8", "", "RGB", "RGB"},
    {0, 2, 1, 2, "8,8,8", "", "RGB", "RGB;R"},
    {1, 2, 1, 2, "8,8,8", "", "RGB", "RGB;R"},
    {0, 2, 1, 1, "8,8,8,8", "", "RGBA", "RGBA"},
    {1, 2, 1, 1, "8,8,8,8", "", "RGBA", "RGBA"},
    {0, 2, 1, 1, "8,8,8,8", "0", "RGB", "RGBX"},
    {1, 2, 1, 1, "8,8,8,8", "0", "RGB", "RGBX"},
    {0, 2, 1, 1, "8,8,8,8,8", "0,0", "RGB", "RGBXX"},
    {1, 2, 1, 1, "8,8,8,8,8", "0,0", "RGB", "RGBXX"},
    {0, 2, 1, 1, "8,8,8,8,8,8", "0,0,0", "RGB", "RGBXXX"},
    {1, 2, 1, 1, "8,8,8,8,8,8", "0,0,0", "RGB", "RGBXXX"},
    {0, 2, 1, 1, "8,8,8,8", "1", "RGBA", "RGBa"},
    {1, 2, 1, 1, "8,8,8,8", "1", "RGBA", "RGBa"},
    {0, 2, 1, 1, "8,8,8,8,8", "1,0", "RGBA", "RGBaX"},
    {1, 2, 1, 1, "8,8,8,8,8", "1,0", "RGBA", "RGBaX"},
    {0, 2, 1, 1, "8,8,8,8,8,8", "1,0,0", "RGBA", "RGBaXX"},
    {1, 2, 1, 1, "8,8,8,8,8,8", "1,0,0", "RGBA", "RGBaXX"},
    {0, 2, 1, 1, "8,8,8,8", "2", "RGBA", "RGBA"},
    {1, 2, 1, 1, "8,8,8,8", "2", "RGBA", "RGBA"},
    {0, 2, 1, 1, "8,8,8,8,8", "2,0", "RGBA", "RGBAX"},
    {1, 2, 1, 1, "8,8,8,8,8", "2,0", "RGBA", "RGBAX"},
    {0, 2, 1, 1, "8,8,8,8,8,8", "2,0,0", "RGBA", "RGBAXX"},
    {1, 2, 1, 1, "8,8,8,8,8,8", "2,0,0", "RGBA", "RGBAXX"},
    {0, 2, 1, 1, "8,8,8,8", "999", "RGBA", "RGBA"},
    {1, 2, 1, 1, "8,8,8,8", "999", "RGBA", "RGBA"},
    {0, 2, 1, 1, "16,16,16", "", "RGB", "RGB;16L"},
    {1, 2, 1, 1, "16,16,16", "", "RGB", "RGB;16B"},
    {0, 2, 1, 1, "16,16,16,16", "", "RGBA", "RGBA;16L"},
    {1, 2, 1, 1, "16,16,16,16", "", "RGBA", "RGBA;16B"},
    {0, 2, 1, 1, "16,16,16,16", "0", "RGB", "RGBX;16L"},
    {1, 2, 1, 1, "16,16,16,16", "0", "RGB", "RGBX;16B"},
    {0, 2, 1, 1, "16,16,16,16", "1", "RGBA", "RGBa;16L"},
    {1, 2, 1, 1, "16,16,16,16", "1", "RGBA", "RGBa;16B"},
    {0, 2, 1, 1, "16,16,16,16", "2", "RGBA", "RGBA;16L"},
    {1, 2, 1, 1, "16,16,16,16", "2", "RGBA", "RGBA;16B"},
    {0, 3, 1, 1, "1", "", "P", "P;1"},
    {1, 3, 1, 1, "1", "", "P", "P;1"},
    {0, 3, 1, 2, "1", "", "P", "P;1R"},
    {1, 3, 1, 2, "1", "", "P", "P;1R"},
    {0, 3, 1, 1, "2", "", "P", "P;2"},
    {1, 3, 1, 1, "2", "", "P", "P;2"},
    {0, 3, 1, 2, "2", "", "P", "P;2R"},
    {1, 3, 1, 2, "2", "", "P", "P;2R"},
    {0, 3, 1, 1, "4", "", "P", "P;4"},
    {1, 3, 1, 1, "4", "", "P", "P;4"},
    {0, 3, 1, 2, "4", "", "P", "P;4R"},
    {1, 3, 1, 2, "4", "", "P", "P;4R"},
    {0, 3, 1, 1, "8", "", "P", "P"},
    {1, 3, 1, 1, "8", "", "P", "P"},
    {0, 3, 1, 1, "8,8", "0", "P", "PX"},
    {1, 3, 1, 1, "8,8", "0", "P", "PX"},
    {0, 3, 1, 1, "8,8", "2", "PA", "PA"},
    {1, 3, 1, 1, "8,8", "2", "PA", "PA"},
    {0, 3, 1, 2, "8", "", "P", "P;R"},
    {1, 3, 1, 2, "8", "", "P", "P;R"},
    {0, 5, 1, 1, "8,8,8,8", "", "CMYK", "CMYK"},
    {1, 5, 1, 1, "8,8,8,8", "", "CMYK", "CMYK"},
    {0, 5, 1, 1, "8,8,8,8,8", "0", "CMYK", "CMYKX"},
    {1, 5, 1, 1, "8,8,8,8,8", "0", "CMYK", "CMYKX"},
    {0, 5, 1, 1, "8,8,8,8,8,8", "0,0", "CMYK", "CMYKXX"},
    {1, 5, 1, 1, "8,8,8,8,8,8", "0,0", "CMYK", "CMYKXX"},
    {0, 5, 1, 1, "16,16,16,16", "", "CMYK", "CMYK;16L"},
    {1, 5, 1, 1, "16,16,16,16", "", "CMYK", "CMYK;16B"},
    {0, 6, 1, 1, "8", "", "L", "L"},
    {1, 6, 1, 1, "8", "", "L", "L"},
    {0, 6, 1, 1, "8,8,8", "", "RGB", "RGBX"},
    {1, 6, 1, 1, "8,8,8", "", "RGB", "RGBX"},
    {0, 8, 1, 1, "8,8,8", "", "LAB", "LAB"},
    {1, 8, 1, 1, "8,8,8", "", "LAB", "LAB"},
};

// How Pillow's unpacker for a raw mode fills a pixel of the image's mode
// (Unpack.c). The image holds a word a pixel: the value for "1", "L",
// "P", "I;16" ("I;16B"), "I" and "F" (the float's bits); bytes 0-3 for
// the bands of "LA", "PA" (L or P in byte 0), "RGB", "RGBA" and "CMYK".
enum class PMode { One, L, P, I16, I, F, LA, PA, RGB, RGBA, CMYK, Lab };

struct Unpack {
  enum Kind { Bits, U16, I12, S16, I32, F32, Chan8, Chan16, Band8, Lab8 } kind = Bits;
  int bits = 8;           // bits a pixel
  int depth = 8;          // Bits: bits a sample
  bool gray = false;      // Bits: scaled to 0-255 ("1", "L"), else an index
  bool invert = false, reverse = false;
  bool big = false;       // 16- and 32-bit samples big-endian
  std::string chans;      // Chan8, Chan16: a band letter a sample
  int band = 0;           // Band8
};

const uint8_t* bitrev() {
  static uint8_t t[256];
  static bool done = false;
  if (!done) {
    for (int i = 0; i < 256; i++) {
      int r = 0;
      for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
      t[i] = static_cast<uint8_t>(r);
    }
    done = true;
  }
  return t;
}

PMode pmode(const std::string& m) {
  if (m == "1") return PMode::One;
  if (m == "L") return PMode::L;
  if (m == "P") return PMode::P;
  if (m == "I;16" || m == "I;16B") return PMode::I16;
  if (m == "I") return PMode::I;
  if (m == "F") return PMode::F;
  if (m == "LA") return PMode::LA;
  if (m == "PA") return PMode::PA;
  if (m == "RGB") return PMode::RGB;
  if (m == "RGBA") return PMode::RGBA;
  if (m == "CMYK") return PMode::CMYK;
  return PMode::Lab;
}

int bands(PMode m) {
  switch (m) {
    case PMode::LA: case PMode::PA: return 2;
    case PMode::RGB: case PMode::Lab: return 3;
    case PMode::RGBA: case PMode::CMYK: return 4;
    default: return 1;
  }
}

// Pillow's unpacker of `raw` for an image of `mode`: false where Pillow
// has none ("unknown raw mode").
bool make_unpack(const std::string& raw, PMode mode, Unpack& u) {
  if (raw == "LAB") {
    // ImagingUnpackLAB: a* and b* signed outside, unsigned in the image
    u.kind = Unpack::Lab8;
    u.bits = 24;
    return mode == PMode::Lab;
  }
  if (mode == PMode::Lab && raw.size() == 1 && std::strchr("LAB", raw[0])) {
    // a plane a band, its bytes as they are
    u.kind = Unpack::Band8;
    u.bits = 8;
    u.band = static_cast<int>(std::strchr("LAB", raw[0]) - "LAB");
    return true;
  }
  struct BitsMode { const char* name; int depth; char family; bool inv, rev; };
  static const BitsMode kBits[] = {
      {"1", 1, '1', false, false}, {"1;I", 1, '1', true, false},
      {"1;R", 1, '1', false, true}, {"1;IR", 1, '1', true, true},
      {"L;2", 2, 'L', false, false}, {"L;2I", 2, 'L', true, false},
      {"L;2R", 2, 'L', false, true}, {"L;2IR", 2, 'L', true, true},
      {"L;4", 4, 'L', false, false}, {"L;4I", 4, 'L', true, false},
      {"L;4R", 4, 'L', false, true}, {"L;4IR", 4, 'L', true, true},
      {"L", 8, 'L', false, false}, {"L;I", 8, 'L', true, false},
      {"L;R", 8, 'L', false, true}, {"P;1", 1, 'P', false, false},
      {"P;2", 2, 'P', false, false}, {"P;4", 4, 'P', false, false},
      {"P", 8, 'P', false, false}, {"P;R", 8, 'P', false, true}};
  // (OPEN_INFO's "L;IR", "P;1R", "P;2R" and "P;4R" have no unpacker in
  // Pillow: uncompressed files of those layouts raise there, and here)
  for (const BitsMode& b : kBits) {
    if (raw != b.name) continue;
    const PMode want = b.family == '1' ? PMode::One : b.family == 'L' ? PMode::L : PMode::P;
    if (mode != want) return false;
    u.kind = Unpack::Bits;
    u.depth = u.bits = b.depth;
    u.gray = b.family != 'P';
    u.invert = b.inv;
    u.reverse = b.rev;
    return true;
  }
  if (raw == "I;16" || raw == "I;16N" || raw == "I;16B" || raw == "I;16R") {
    u.kind = Unpack::U16;
    u.bits = 16;
    u.big = raw == "I;16B";
    u.reverse = raw == "I;16R";
    return mode == PMode::I16;
  }
  if (raw == "I;12") {
    u.kind = Unpack::I12;
    u.bits = 12;
    return mode == PMode::I16;
  }
  if (raw == "I;16S" || raw == "I;16BS") {
    u.kind = Unpack::S16;
    u.bits = 16;
    u.big = raw == "I;16BS";
    return mode == PMode::I;
  }
  if (raw == "I;32N" || raw == "I;32S" || raw == "I;32BS" || raw == "I") {
    u.kind = Unpack::I32;
    u.bits = 32;
    u.big = raw == "I;32BS";
    return mode == PMode::I;
  }
  if (raw == "F;32F" || raw == "F;32BF" || raw == "F") {
    u.kind = Unpack::F32;
    u.bits = 32;
    u.big = raw == "F;32BF";
    return mode == PMode::F;
  }
  if (raw.size() == 1 && std::strchr("RGBACMYK", raw[0])) {
    u.kind = Unpack::Band8;
    u.bits = 8;
    u.band = static_cast<int>(std::strchr("RGBA", raw[0]) ? std::strchr("RGBA", raw[0]) - "RGBA"
                                                          : std::strchr("CMYK", raw[0]) - "CMYK");
    if (std::strchr("CMYK", raw[0])) return mode == PMode::CMYK;
    if (raw[0] == 'A') return mode == PMode::RGBA;
    return mode == PMode::RGB || mode == PMode::RGBA;
  }
  static const char* kChan8[] = {"LA", "PA", "PX", "RGB", "RGB;R", "RGBA", "RGBX",
                                 "RGBXX", "RGBXXX", "RGBa", "RGBaX", "RGBaXX",
                                 "RGBAX", "RGBAXX", "CMYK", "CMYKX", "CMYKXX"};
  for (const char* c : kChan8) {
    if (raw != c) continue;
    u.kind = Unpack::Chan8;
    u.reverse = raw == "RGB;R";
    u.chans = raw.substr(0, raw.find(';'));
    u.bits = 8 * static_cast<int>(u.chans.size());
    return true;
  }
  const size_t semi = raw.find(";16");
  if (semi != std::string::npos && semi + 4 == raw.size()) {
    const char e = raw.back();
    u.kind = Unpack::Chan16;
    u.chans = raw.substr(0, semi);
    u.big = e == 'B';
    u.bits = 16 * static_cast<int>(u.chans.size());
    return (e == 'L' || e == 'B' || e == 'N') &&
           (u.chans == "RGB" || u.chans == "RGBA" || u.chans == "RGBX" || u.chans == "RGBa" ||
            u.chans == "CMYK");
  }
  return false;
}

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

inline uint32_t set_band(uint32_t px, int band, uint32_t v) {
  const int s = 8 * band;
  return (px & ~(0xffu << s)) | ((v & 0xffu) << s);
}

// One row of `count` pixels from `in` into the image's words at `out`, as
// Pillow's unpacker writes them.
void unpack_row(const Unpack& u, const uint8_t* in, int64_t count, uint32_t* out) {
  const uint8_t* rev = bitrev();
  switch (u.kind) {
    case Unpack::Bits: {
      const int per = 8 / u.depth, mask = (1 << u.depth) - 1;
      const int scale = u.depth == 1 ? 255 : u.depth == 2 ? 0x55 : u.depth == 4 ? 0x11 : 1;
      for (int64_t x = 0; x < count; x++) {
        uint8_t byte = in[x / per];
        if (u.reverse) byte = rev[byte];
        const int shift = 8 - u.depth * (static_cast<int>(x % per) + 1);
        int v = (byte >> shift) & mask;
        if (u.gray) {
          v *= scale;
          if (u.invert) v = 255 - v;
        }
        out[x] = static_cast<uint32_t>(v);
      }
      return;
    }
    case Unpack::U16:
      for (int64_t x = 0; x < count; x++) {
        uint8_t b0 = in[2 * x], b1 = in[2 * x + 1];
        if (u.reverse) {
          b0 = rev[b0];
          b1 = rev[b1];
        }
        out[x] = u.big ? (b0 << 8) | b1 : (b1 << 8) | b0;
      }
      return;
    case Unpack::I12:
      for (int64_t x = 0; x < count; x++) {
        const uint8_t* p = in + (x / 2) * 3;
        out[x] = x % 2 == 0 ? (p[0] << 4) | (p[1] >> 4) : ((p[1] & 15) << 8) | p[2];
      }
      return;
    case Unpack::S16:
      for (int64_t x = 0; x < count; x++) {
        const uint8_t b0 = in[2 * x], b1 = in[2 * x + 1];
        const int16_t v = static_cast<int16_t>(u.big ? (b0 << 8) | b1 : (b1 << 8) | b0);
        out[x] = static_cast<uint32_t>(static_cast<int32_t>(v));
      }
      return;
    case Unpack::I32:
    case Unpack::F32:
      for (int64_t x = 0; x < count; x++) {
        const uint8_t* p = in + 4 * x;
        out[x] = u.big ? (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3]
                       : (static_cast<uint32_t>(p[3]) << 24) | (p[2] << 16) | (p[1] << 8) | p[0];
      }
      return;
    case Unpack::Band8:
      for (int64_t x = 0; x < count; x++) out[x] = set_band(out[x], u.band, in[x]);
      return;
    case Unpack::Lab8:
      for (int64_t x = 0; x < count; x++, in += 3)
        out[x] = in[0] | ((in[1] ^ 128u) << 8) | ((in[2] ^ 128u) << 16) | 0xff000000u;
      return;
    case Unpack::Chan8:
    case Unpack::Chan16: {
      const int n = static_cast<int>(u.chans.size());
      if (u.kind == Unpack::Chan8 && !u.reverse && (u.chans == "RGB" || u.chans == "RGBX")) {
        for (int64_t x = 0; x < count; x++, in += n)
          out[x] = in[0] | (in[1] << 8) | (in[2] << 16) | 0xff000000u;
        return;
      }
      const int size = u.kind == Unpack::Chan8 ? 1 : 2;
      const int hi = size == 1 ? 0 : (u.big ? 0 : 1);
      const bool premul = u.chans.find('a') != std::string::npos;
      for (int64_t x = 0; x < count; x++) {
        const uint8_t* p = in + static_cast<int64_t>(x) * n * size;
        uint32_t v[4] = {0, 0, 0, 255};
        for (int k = 0; k < n; k++) {
          uint8_t s = p[k * size + hi];
          if (u.reverse) s = rev[s];
          switch (u.chans[k]) {
            case 'L': case 'P': case 'R': case 'C': v[0] = s; break;
            case 'G': case 'M': v[1] = s; break;
            case 'B': case 'Y': v[2] = s; break;
            case 'A': case 'a': case 'K': v[3] = s; break;
            default: break;  // X: skipped
          }
        }
        if (premul) {
          // unpackRGBa: premultiplied colour back to straight
          const uint32_t a = v[3];
          if (a == 0) {
            v[0] = v[1] = v[2] = 0;
          } else if (a != 255) {
            for (int k = 0; k < 3; k++) v[k] = clip8(static_cast<int>(v[k] * 255 / a));
          }
        }
        out[x] = v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
      }
      return;
    }
  }
}

// A TIFF file as Pillow 12.1's TiffImagePlugin opens its first image:
// Pillow's own reading of the header and the first IFD (its tag types,
// the last of a repeated tag), its mode and raw mode, its tiles for
// uncompressed data, and libtiff's decoding for everything compressed.
struct TiffEntry {
  int type = 0;
  uint64_t count = 0;
  const uint8_t* data = nullptr;
};

inline int tiff_type_size(int type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: case 13: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    default: return 0;
  }
}

// the codecs Pillow's libtiff cannot decode any file of: WebP is not
// configured in it, and SGILog needs a LogL or LogLuv photometric, which
// Pillow's TIFF plugin does not open
void tiff_never_decoded(int compression) {
  if (compression == 50001)
    corrupt("TIFF: WEBP compression support is not configured (Pillow's libtiff)");
  if (compression == 34676 || compression == 34677)
    corrupt("TIFF: SGILog compression: inappropriate photometric interpretation (libtiff "
            "decodes LogL and LogLuv only, which Pillow does not open)");
}

inline bool tiff_fax(int compression) {
  return compression == 2 || compression == 3 || compression == 4 || compression == 32771;
}

// libtiff 4.7.1's own reading of the first IFD (TIFFReadDirectory), which
// Pillow's TiffDecode.c leaves the decode of a compressed image to
// (TIFFClientOpen over the mapped file, then TIFFSetSubDirectory): it
// reads every entry again under rules of its own, beside Pillow's
// ImageFileDirectory: the first of a repeated tag (Pillow keeps the
// last), the types each tag's reader takes with their range checks
// (tif_dirread.c TIFFReadDirEntryShort, Long, Long8Array,
// PersampleShort), the tags whose fault ends the open (SamplesPerPixel,
// Compression, the image and tile sizes, PlanarConfiguration,
// RowsPerStrip, ExtraSamples, BitsPerSample, SampleFormat) and those
// whose fault only drops the tag (Photometric, FillOrder, Predictor,
// ...), the strip arrays padded with zeros to the strip count, a missing
// or zero StripByteCounts estimated (EstimateStripByteCounts), the
// Colormap a palette image needs, and the zero sizes it refuses.
struct LibtiffDir {
  struct Entry {
    int tag = 0, type = 0;
    uint64_t count = 0;
    const uint8_t* field = nullptr;  // the value field (4 or 8 bytes)
  };
  enum Err { kOk, kCount, kType, kIo, kRange, kPsdif, kSizesan };

  const uint8_t* d;
  int64_t n;
  bool be, big;
  std::vector<Entry> dir;  // every entry, in the directory's order
  uint16_t ndir = 0;

  uint32_t width = 0, height = 0, depth = 1;
  uint16_t bps = 1, compression = 1, spp = 1, planar = 1, fillorder = 1;
  uint16_t predictor = 1, sampleformat = 1;
  int photometric = -1;            // -1: unset
  uint32_t rps = 0xFFFFFFFFu;      // unset: the whole image
  bool tiled = false;
  uint32_t tw = 0, th = 0, tdepth = 1;
  bool colormap = false;
  const Entry* jpegtables = nullptr;
  std::vector<uint16_t> ycbcr_sub;  // YCbCrSubsampling, where read
  std::vector<float> luma, refbw;   // YCbCrCoefficients, ReferenceBlackWhite, where read
  // old-style JPEG's tags (tif_ojpeg.c's fields): JPEGInterchangeFormat
  // and its length, JPEGRestartInterval, and the tables' offsets
  uint64_t jif = 0, jif_len = 0;
  uint16_t ojpeg_restart = 0;
  std::vector<uint64_t> qtables, dctables, actables;
  bool counts_tag = false;
  uint32_t t4 = 0, t6 = 0;
  bool bps_read = false, spp_read = false;
  std::vector<uint16_t> extrasamples;
  int ink_bump = -1;  // the InkNames entry whose count libtiff raises by one
  uint64_t nstrips = 0;
  std::vector<uint64_t> offsets, counts;

  LibtiffDir(const uint8_t* data, int64_t size, bool be_, bool big_)
      : d(data), n(size), be(be_), big(big_) {}

  // YCbCrSubsampling as TIFFGetFieldDefaulted gives it (2x2 unset)
  int sub_h() const { return ycbcr_sub.empty() ? 2 : ycbcr_sub[0]; }
  int sub_v() const { return ycbcr_sub.empty() ? 2 : ycbcr_sub[1]; }

  uint64_t rd(const uint8_t* p, int bytes) const {
    uint64_t v = 0;
    for (int i = 0; i < bytes; i++) v = be ? (v << 8) | p[i] : v | (static_cast<uint64_t>(p[i]) << (8 * i));
    return v;
  }

  [[noreturn]] static void fail(const std::string& why) {
    corrupt("TIFF: libtiff refuses the directory (" + why + ")");
  }

  // TIFFReadDirEntryArrayWithLimit and the element conversions of the
  // Short, Long and Long8 readers: the first `take` values, each at most
  // `max`, from inline data or the file (where the whole count puts it)
  Err array(const Entry& e, uint64_t take, uint64_t max, int dest,
            std::vector<uint64_t>& out) const {
    out.clear();
    switch (e.type) {
      case 1: case 3: case 4: case 6: case 8: case 9: case 16: case 17: break;
      default: return kType;
    }
    const int size = tiff_type_size(e.type);
    take = std::min(take, e.count);
    if (take == 0) return kOk;
    if (2147483647u / size < take || 2147483647u / dest < take) return kSizesan;
    const uint64_t clamped = std::min<uint64_t>(e.count, 10) * size;
    const uint64_t bytes = take * size;
    const uint64_t inline_size = big ? 8 : 4;
    const uint8_t* p = e.field;
    if (!(clamped <= inline_size && bytes <= inline_size)) {
      const uint64_t off = rd(e.field, big ? 8 : 4);
      if (off > static_cast<uint64_t>(n) || bytes > static_cast<uint64_t>(n) - off) return kIo;
      p = d + off;
    }
    out.reserve(static_cast<size_t>(take));
    for (uint64_t i = 0; i < take; i++) {
      const uint8_t* q = p + i * size;
      uint64_t v;
      bool neg = false;
      switch (e.type) {
        case 1: v = q[0]; break;
        case 6: neg = static_cast<int8_t>(q[0]) < 0; v = q[0]; break;
        case 3: v = rd(q, 2); break;
        case 8: neg = static_cast<int16_t>(rd(q, 2)) < 0; v = rd(q, 2); break;
        case 4: v = rd(q, 4); break;
        case 9: neg = static_cast<int32_t>(rd(q, 4)) < 0; v = rd(q, 4); break;
        case 16: v = rd(q, 8); break;
        default: neg = static_cast<int64_t>(rd(q, 8)) < 0; v = rd(q, 8); break;
      }
      if (neg || v > max) return kRange;
      out.push_back(v);
    }
    return kOk;
  }

  // TIFFReadDirEntryFloatArray: the values of an integer, rational,
  // float or double entry as floats (a rational of denominator 0 is 0);
  // `out` stays empty where libtiff drops the tag
  void floats(const Entry& e, std::vector<float>& out) const {
    out.clear();
    const int size = tiff_type_size(e.type);
    switch (e.type) {
      case 1: case 3: case 4: case 5: case 6: case 8: case 9: case 10: case 11: case 12:
      case 13: case 16: case 17: case 18: break;
      default: return;
    }
    const uint64_t bytes = e.count * size;
    const uint8_t* p = e.field;
    if (bytes > (big ? 8u : 4u)) {
      const uint64_t off = rd(e.field, big ? 8 : 4);
      if (off > static_cast<uint64_t>(n) || bytes > static_cast<uint64_t>(n) - off) return;
      p = d + off;
    }
    for (uint64_t i = 0; i < e.count; i++) {
      const uint8_t* q = p + i * size;
      float f;
      switch (e.type) {
        case 1: f = static_cast<float>(q[0]); break;
        case 6: f = static_cast<float>(static_cast<int8_t>(q[0])); break;
        case 3: f = static_cast<float>(rd(q, 2)); break;
        case 8: f = static_cast<float>(static_cast<int16_t>(rd(q, 2))); break;
        case 4: case 13: f = static_cast<float>(static_cast<uint32_t>(rd(q, 4))); break;
        case 9: f = static_cast<float>(static_cast<int32_t>(rd(q, 4))); break;
        case 16: case 18: f = static_cast<float>(rd(q, 8)); break;
        case 17: f = static_cast<float>(static_cast<int64_t>(rd(q, 8))); break;
        case 5: {
          const uint32_t a = static_cast<uint32_t>(rd(q, 4)), b = static_cast<uint32_t>(rd(q + 4, 4));
          f = b == 0 ? 0.0f : static_cast<float>(a) / static_cast<float>(b);
          break;
        }
        case 10: {
          const int32_t a = static_cast<int32_t>(rd(q, 4));
          const uint32_t b = static_cast<uint32_t>(rd(q + 4, 4));
          f = b == 0 ? 0.0f : static_cast<float>(a) / static_cast<float>(b);
          break;
        }
        case 11: {
          const uint32_t bits = static_cast<uint32_t>(rd(q, 4));
          std::memcpy(&f, &bits, 4);
          break;
        }
        default: {
          const uint64_t bits = rd(q, 8);
          double v;
          std::memcpy(&v, &bits, 8);
          f = v > FLT_MAX ? FLT_MAX : v < -FLT_MAX ? -FLT_MAX : static_cast<float>(v);
          break;
        }
      }
      out.push_back(f);
    }
  }

  // TIFFReadDirEntryShort / Long: exactly one value
  Err one(const Entry& e, uint64_t max, uint64_t& v) const {
    if (e.count != 1) return kCount;
    std::vector<uint64_t> a;
    const Err err = array(e, 1, max, max > 0xFFFF ? 4 : 2, a);
    if (err == kOk) v = a[0];
    return err;
  }

  // ... or, where the count is not one, TIFFReadDirEntryPersampleShort:
  // at least SamplesPerPixel values, the first SamplesPerPixel equal
  Err short_or_persample(const Entry& e, uint64_t& v) const {
    Err err = one(e, 0xFFFF, v);
    if (err != kCount) return err;
    if (e.count < spp) return kCount;
    std::vector<uint64_t> a;
    err = array(e, e.count, 0xFFFF, 2, a);
    if (err != kOk || a.empty()) return err;
    v = a[0];
    for (uint16_t i = 1; i < spp; i++)
      if (a[i] != v) return kPsdif;
    return kOk;
  }

  // _TIFFCheckFieldIsValidForCodec: a codec's own tags count only under it
  bool valid_for_codec(int tag) const {
    switch (tag) {
      case 317: return compression == 5 || compression == 8 || compression == 32946 ||
                       compression == 32909 || compression == 34925 || compression == 50000 ||
                       compression == 34887;
      case 347: return compression == 7 || compression == 6;
      case 512: case 513: case 514: case 515: case 517: case 518: case 519: case 520: case 521:
        return compression == 6;
      case 292: return compression == 3;
      case 293: return compression == 4;
      default: return true;
    }
  }

  void read(uint64_t diroff) {
    // TIFFFetchDirectory over the mapped file
    if (diroff == 0) fail("no first directory");
    uint64_t count;
    uint64_t pos = diroff;
    if (!big) {
      if (pos > static_cast<uint64_t>(n) || n - pos < 2) fail("cannot read the directory count");
      count = rd(d + pos, 2);
      pos += 2;
    } else {
      if (pos > static_cast<uint64_t>(n) || n - pos < 8) fail("cannot read the directory count");
      count = rd(d + pos, 8);
      pos += 8;
    }
    if (count > 4096) fail("a directory count past the sanity limit");
    if (count == 0) fail("a directory of no tags");
    const uint64_t esize = big ? 20 : 12;
    if (count * esize > static_cast<uint64_t>(n) - pos) fail("cannot read the directory");
    ndir = static_cast<uint16_t>(count);
    std::vector<bool> ignore(count, false);
    for (uint64_t i = 0; i < count; i++) {
      const uint8_t* e = d + pos + i * esize;
      Entry t;
      t.tag = static_cast<int>(rd(e, 2));
      t.type = static_cast<int>(rd(e + 2, 2));
      t.count = big ? rd(e + 4, 8) : rd(e + 4, 4);
      t.field = e + (big ? 12 : 8);
      dir.push_back(t);
    }
    // a repeated tag: the first one counts
    for (size_t i = 0; i < dir.size(); i++)
      for (size_t j = i + 1; j < dir.size(); j++)
        if (dir[j].tag == dir[i].tag) ignore[j] = true;
    auto first = [&](int tag) -> int {
      for (size_t i = 0; i < dir.size(); i++)
        if (!ignore[i] && dir[i].tag == tag) return static_cast<int>(i);
      return -1;
    };
    uint64_t v = 0;
    int i = first(277);
    if (i >= 0) {
      if (one(dir[i], 0xFFFF, v) != kOk) fail("SamplesPerPixel");
      if (v == 0) fail("SamplesPerPixel 0");
      spp = static_cast<uint16_t>(v);
      spp_read = true;
      ignore[i] = true;
    }
    i = first(259);
    if (i >= 0) {
      if (short_or_persample(dir[i], v) != kOk) fail("Compression");
      compression = static_cast<uint16_t>(v);
      ignore[i] = true;
    }
    // the first pass: the tags that size the image
    bool dims = false, have_offsets = false;
    for (size_t k = 0; k < dir.size(); k++) {
      if (ignore[k]) continue;
      const Entry& e = dir[k];
      switch (e.tag) {
        case 273: case 324: have_offsets = true; break;
        case 256: case 257: case 32997: case 322: case 323: case 32998: case 278:
          if (one(e, 0xFFFFFFFFu, v) != kOk) fail("tag " + std::to_string(e.tag));
          if (e.tag == 256) width = static_cast<uint32_t>(v), dims = true;
          if (e.tag == 257) height = static_cast<uint32_t>(v), dims = true;
          if (e.tag == 32997) depth = static_cast<uint32_t>(v);
          if (e.tag == 322) tw = static_cast<uint32_t>(v), tiled = true;
          if (e.tag == 323) th = static_cast<uint32_t>(v), tiled = true;
          if (e.tag == 32998) tdepth = static_cast<uint32_t>(v);
          if (e.tag == 278) {
            if (v == 0) fail("RowsPerStrip 0");
            rps = static_cast<uint32_t>(v);
          }
          ignore[k] = true;
          break;
        case 284:
          if (one(e, 0xFFFF, v) != kOk) fail("PlanarConfiguration");
          if (v != 1 && v != 2) fail("bad value " + std::to_string(v) + " for PlanarConfiguration");
          planar = static_cast<uint16_t>(v);
          ignore[k] = true;
          break;
        case 338: {
          std::vector<uint64_t> a;
          if (e.count > 0xFFFF) fail("ExtraSamples");
          if (array(e, e.count, 0xFFFF, 2, a) != kOk) fail("ExtraSamples");
          if (a.size() > spp) fail("ExtraSamples past SamplesPerPixel");
          extrasamples.clear();
          for (uint64_t x : a) {
            if (x > 2 && x != 999) fail("an ExtraSamples value");
            extrasamples.push_back(static_cast<uint16_t>(x == 999 ? 2 : x));
          }
          ignore[k] = true;
          break;
        }
        default:
          if (!valid_for_codec(e.tag)) ignore[k] = true;
          break;
      }
    }
    if (!dims) fail("no ImageLength");
    // TIFFhowmany_32: 0 where x + y - 1 would pass 32 bits
    auto howmany = [](uint64_t x, uint64_t y) -> uint64_t {
      if (y == 0 || x >= 0xFFFFFFFFull - (y - 1)) return 0;
      return (x + y - 1) / y;
    };
    if (!tiled) {
      nstrips = rps == 0xFFFFFFFFu ? 1 : howmany(height, rps);
    } else {
      // (a size of 0xFFFFFFFF is the image's)
      const uint64_t dx = tw == 0xFFFFFFFFu ? width : tw, dy = th == 0xFFFFFFFFu ? height : th;
      const uint64_t dz = tdepth == 0xFFFFFFFFu ? depth : tdepth;
      nstrips = dx == 0 || dy == 0 || dz == 0
                    ? 0
                    : howmany(width, dx) * howmany(height, dy) * howmany(depth, dz);
    }
    if (planar == 2) nstrips *= spp;
    if (nstrips == 0 || nstrips > 0xFFFFFFFFull) fail("no strips or tiles");
    // (old-style JPEG in one strip may do without: its stream holds all)
    if (!have_offsets && !(compression == 6 && !tiled && nstrips == 1))
      fail(tiled ? "no TileOffsets" : "no StripOffsets");
    // the second pass
    int offsets_entry = -1, counts_entry = -1;
    for (size_t k = 0; k < dir.size(); k++) {
      if (ignore[k]) continue;
      const Entry& e = dir[k];
      switch (e.tag) {
        case 258: case 339: case 280: case 281: case 32996:
          if (short_or_persample(e, v) != kOk) fail("tag " + std::to_string(e.tag));
          if (e.tag == 258) bps = static_cast<uint16_t>(v), bps_read = true;
          if (e.tag == 339) {
            if (v < 1 || v > 6) fail("bad SampleFormat " + std::to_string(v));
            sampleformat = static_cast<uint16_t>(v);
          }
          if (e.tag == 32996) {
            if (v > 3) fail("bad DataType " + std::to_string(v));
            sampleformat = static_cast<uint16_t>(v == 0 ? 4 : v == 3 ? 3 : v == 1 ? 2 : 1);
          }
          break;
        case 340: case 341: {
          // SMin/SMaxSampleValue: SamplesPerPixel values of any numeric type
          const int size = tiff_type_size(e.type);
          if (e.count != spp || size == 0 || e.type == 2 || e.type == 7 || e.type == 13 ||
              e.type == 18)
            fail("tag " + std::to_string(e.tag));
          const uint64_t bytes = e.count * size;
          if (bytes > (big ? 8u : 4u)) {
            const uint64_t off = rd(e.field, big ? 8 : 4);
            if (off > static_cast<uint64_t>(n) || bytes > static_cast<uint64_t>(n) - off)
              fail("tag " + std::to_string(e.tag));
          }
          break;
        }
        case 273: case 324: offsets_entry = static_cast<int>(k); break;
        case 279: case 325: counts_entry = static_cast<int>(k); break;
        case 320: {
          // ColorMap: read once BitsPerSample is, at its exact count
          bool bps_read = false;
          for (size_t q = 0; q < k; q++) bps_read = bps_read || (!ignore[q] && dir[q].tag == 258);
          if (!bps_read || bps > 24) break;
          std::vector<uint64_t> a;
          if (e.count == 3ull << bps && array(e, e.count, 0xFFFF, 2, a) == kOk) colormap = true;
          break;
        }
        case 262:
          if (one(e, 0xFFFF, v) == kOk) photometric = static_cast<int>(v);
          break;
        case 266:
          if (one(e, 0xFFFF, v) == kOk && (v == 1 || v == 2)) fillorder = static_cast<uint16_t>(v);
          break;
        case 317:
          if (one(e, 0xFFFF, v) == kOk) predictor = static_cast<uint16_t>(v);
          break;
        case 292:
          if (one(e, 0xFFFFFFFFu, v) == kOk) t4 = static_cast<uint32_t>(v);
          break;
        case 293:
          if (one(e, 0xFFFFFFFFu, v) == kOk) t6 = static_cast<uint32_t>(v);
          break;
        case 347:
          if (e.count > 0 && tiff_type_size(e.type) == 1 && e.count <= static_cast<uint64_t>(n))
            jpegtables = &e;
          break;
        case 333: {
          // InkNames: read as text, and where no byte of it is a NUL,
          // TIFFFetchNormalTag adds one to the entry's count (which
          // EstimateStripByteCounts then sizes)
          std::vector<uint64_t> a;
          Err err = kOk;
          if (e.type == 2 || e.type == 7) {
            const uint64_t bytes = e.count;
            const uint8_t* p = e.field;
            if (bytes > (big ? 8u : 4u)) {
              const uint64_t off = rd(e.field, big ? 8 : 4);
              if (off > static_cast<uint64_t>(n) || bytes > static_cast<uint64_t>(n) - off)
                err = kIo;
              else
                p = d + off;
            }
            if (err == kOk)
              for (uint64_t i = 0; i < bytes; i++) a.push_back(p[i]);
          } else {
            err = array(e, e.count, 255, 1, a);
          }
          if (err == kOk && !a.empty() &&
              std::find(a.begin(), a.end(), 0) == a.end())
            ink_bump = static_cast<int>(k);
          break;
        }
        case 530: {
          std::vector<uint64_t> a;
          if (e.count == 2 && array(e, 2, 0xFFFF, 2, a) == kOk)
            ycbcr_sub = {static_cast<uint16_t>(a[0]), static_cast<uint16_t>(a[1])};
          break;
        }
        case 529:
          if (e.count == 3) floats(e, luma);
          break;
        case 513: case 514: case 515:
          if (compression == 6 && one(e, e.tag == 515 ? 0xFFFF : UINT64_MAX, v) == kOk) {
            if (e.tag == 513) jif = v;
            if (e.tag == 514) jif_len = v;
            if (e.tag == 515) ojpeg_restart = static_cast<uint16_t>(v);
          }
          break;
        case 519: case 520: case 521: {
          // OJPEGVSetField takes at most 3 offsets
          std::vector<uint64_t> a;
          if (compression == 6 && e.count <= 3 && array(e, e.count, UINT64_MAX, 8, a) == kOk)
            (e.tag == 519 ? qtables : e.tag == 520 ? dctables : actables) = a;
          break;
        }
        case 532:
          if (e.count == 6) floats(e, refbw);
          break;

        default: break;
      }
    }
    if (compression == 6) {
      // TIFFReadDirectory's old-style JPEG hack: a missing photometric or
      // RGB is YCbCr, missing bits a sample are 8, missing samples a pixel 3
      if (photometric < 0 || photometric == 2) photometric = 6;
      if (!bps_read) bps = 8;
      if (!spp_read && photometric == 6) spp = 3;
    }
    if (photometric == 3 && !colormap) {
      if (bps >= 8 && spp == 3) {
        photometric = 2;
      } else if (bps >= 8) {
        photometric = 1;
      } else {
        fail("a palette image without a Colormap");
      }
    }
    // the strip arrays (TIFFFetchStripThing): nstrips values, zeros past
    // a short tag
    auto strip_array = [&](int k, std::vector<uint64_t>& out, const char* what) {
      if (array(dir[k], nstrips, UINT64_MAX, 8, out) != kOk) fail(what);
      out.resize(static_cast<size_t>(nstrips), 0);
    };
    if (offsets_entry >= 0) {
      strip_array(offsets_entry, offsets, "StripOffsets");
    } else {
      offsets.assign(static_cast<size_t>(nstrips), 0);
    }
    counts_tag = counts_entry >= 0;
    if (compression == 6) {
      // old-style JPEG's byte counts are left as they are (0 past the tag)
      if (counts_entry >= 0) strip_array(counts_entry, counts, "StripByteCounts");
      counts.resize(static_cast<size_t>(nstrips), 0);
    } else if (counts_entry < 0) {
      if ((planar == 1 && nstrips > 1) || (planar == 2 && nstrips != spp))
        fail(tiled ? "no TileByteCounts" : "no StripByteCounts");
      estimate();
    } else {
      strip_array(counts_entry, counts, "StripByteCounts");
      // ByteCountLooksBad for a compressed single strip
      if (nstrips == 1 && !tiled && offsets[0] != 0 && counts[0] == 0) estimate();
    }
    // TIFFScanlineSize and TIFFStripSize / TIFFTileSize are not zero
    const uint64_t samples = planar == 1 ? spp : 1;
    if (static_cast<uint64_t>(tiled ? tw : width) * samples * bps == 0) fail("a scanline of zero bytes");
    // (old-style JPEG's subsampling is its stream's: Tiff::ojpeg_subsampling)
    if (photometric == 6 && planar == 1 && spp == 3 && compression != 6) {
      // packed YCbCr: a row of sampling blocks over the vertical subsampling
      const int hs = sub_h(), vs = sub_v();
      if ((hs != 1 && hs != 2 && hs != 4) || (vs != 1 && vs != 2 && vs != 4))
        fail("Invalid YCbCr subsampling");
      if ((width + hs - 1) / hs * (hs * vs + 2) * bps / 8 / vs == 0) fail("a scanline of zero bytes");
    }
    if (!tiled && std::min<uint64_t>(rps, height) == 0) fail("a strip of zero bytes");
  }

  // EstimateStripByteCounts for compressed data: the file less the header,
  // the directory and its entries' data, a plane's share each, the last
  // strip cut at the end of the file
  void estimate() {
    uint64_t space = big ? 16 + 8 + ndir * 20ull + 8 : 8 + 2 + ndir * 12ull + 4;
    for (size_t k = 0; k < dir.size(); k++) {
      const Entry& e = dir[k];
      const int w = tiff_type_size(e.type);
      if (w == 0) fail("a tag of unknown type while estimating StripByteCounts");
      const uint64_t size = (e.count + (static_cast<int>(k) == ink_bump)) * w;
      if (size > (big ? 8u : 4u)) space += size;
    }
    space = static_cast<uint64_t>(n) < space ? n : n - space;
    if (planar == 2) space /= spp;
    counts.assign(static_cast<size_t>(nstrips), space);
    const uint64_t last = offsets.back();
    if (last + counts.back() > static_cast<uint64_t>(n))
      counts.back() = last >= static_cast<uint64_t>(n) ? 0 : n - last;
  }
};

// Pillow's LAB -> RGB (Image.convert through ImageCms): LittleCMS 2.17's
// transform of its D50 Lab profile to sRGB, perceptual, TYPE_Lab_8 to
// TYPE_RGBA_8, as lcms evaluates it after OptimizeByResampling: a 33³
// CLUT of 16-bit RGB nodes (the float pipeline sampled at the nodes;
// data/lab_srgb_clut.zlib, set once by mrt_lab_clut) under PrelinEval8's
// tetrahedral interpolation of 8-bit inputs (FROM_8_TO_16 in, the
// fixed-point domain of 32 intervals), FROM_16_TO_8 out.
uint16_t g_lab_clut[33 * 33 * 33 * 3];
bool g_lab_ready = false;

uint32_t lab_to_rgb(int L, int a, int b) {
  struct Axis {
    int32_t base[256], rest[256];
  };
  static const Axis* axes = [] {
    static Axis t[3];
    const int32_t opta[3] = {33 * 33 * 3, 33 * 3, 3};
    for (int k = 0; k < 3; k++)
      for (int v = 0; v < 256; v++) {
        const int32_t in = v * 257 * 32;
        const int32_t fx = in + (in + 0x7fff) / 0xffff;  // _cmsToFixedDomain
        t[k].base[v] = opta[k] * (fx >> 16);
        t[k].rest[v] = fx & 0xffff;
      }
    return t;
  }();
  const int32_t X0 = axes[0].base[L], Y0 = axes[1].base[a], Z0 = axes[2].base[b];
  const int32_t rx = axes[0].rest[L], ry = axes[1].rest[a], rz = axes[2].rest[b];
  const int32_t X1 = X0 + (rx == 0 ? 0 : 33 * 33 * 3), Y1 = Y0 + (ry == 0 ? 0 : 33 * 3),
                Z1 = Z0 + (rz == 0 ? 0 : 3);
  uint32_t rgb = 0;
  for (int k = 0; k < 3; k++) {
    auto D = [&](int32_t x, int32_t y, int32_t z) -> int32_t { return g_lab_clut[x + y + z + k]; };
    const int32_t c0 = D(X0, Y0, Z0);
    int32_t c1, c2, c3;
    if (rx >= ry && ry >= rz) {
      c1 = D(X1, Y0, Z0) - c0;
      c2 = D(X1, Y1, Z0) - D(X1, Y0, Z0);
      c3 = D(X1, Y1, Z1) - D(X1, Y1, Z0);
    } else if (rx >= rz && rz >= ry) {
      c1 = D(X1, Y0, Z0) - c0;
      c2 = D(X1, Y1, Z1) - D(X1, Y0, Z1);
      c3 = D(X1, Y0, Z1) - D(X1, Y0, Z0);
    } else if (rz >= rx && rx >= ry) {
      c1 = D(X1, Y0, Z1) - D(X0, Y0, Z1);
      c2 = D(X1, Y1, Z1) - D(X1, Y0, Z1);
      c3 = D(X0, Y0, Z1) - c0;
    } else if (ry >= rx && rx >= rz) {
      c1 = D(X1, Y1, Z0) - D(X0, Y1, Z0);
      c2 = D(X0, Y1, Z0) - c0;
      c3 = D(X1, Y1, Z1) - D(X1, Y1, Z0);
    } else if (ry >= rz && rz >= rx) {
      c1 = D(X1, Y1, Z1) - D(X0, Y1, Z1);
      c2 = D(X0, Y1, Z0) - c0;
      c3 = D(X0, Y1, Z1) - D(X0, Y1, Z0);
    } else {
      c1 = D(X1, Y1, Z1) - D(X0, Y1, Z1);
      c2 = D(X0, Y1, Z1) - D(X0, Y0, Z1);
      c3 = D(X0, Y0, Z1) - c0;
    }
    const int32_t rest = c1 * rx + c2 * ry + c3 * rz + 0x8001;
    const uint32_t out16 = static_cast<uint16_t>(c0 + ((rest + (rest >> 16)) >> 16));
    rgb |= ((out16 * 65281u + 8388608u) >> 24) << (8 * k);
  }
  return rgb;
}

// A zeroed buffer from calloc (pages untouched until written)
struct ZeroBuffer {
  uint8_t* p = nullptr;
  ZeroBuffer() = default;
  ZeroBuffer(const ZeroBuffer&) = delete;
  ZeroBuffer& operator=(const ZeroBuffer&) = delete;
  ZeroBuffer(ZeroBuffer&& o) noexcept : p(o.p) { o.p = nullptr; }
  ~ZeroBuffer() { std::free(p); }
  void allocate(size_t n) {
    std::free(p);
    p = static_cast<uint8_t*>(std::calloc(n ? n : 1, 1));
    if (!p) throw std::bad_alloc();
  }
  uint8_t* data() { return p; }
};

// tif_color.c's TIFFYCbCrToRGBInit and TIFFYCbCrtoRGB, as tif_getimage.c's
// initYCbCrConversion sets them up: YCbCrCoefficients (CCIR 601-1's
// luma by default) and ReferenceBlackWhite (0, 255, 128, 255, 128, 255 by
// default) into fixed-point tables, in float arithmetic as the C source
// does it; the RGBA raster's word for a YCbCr triple.
struct YccToRgb {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];

  static float clampf(float f, float lo, float hi) { return !(f >= lo) ? lo : f > hi ? hi : f; }
  static int32_t fix(float x) { return static_cast<int32_t>(static_cast<double>(x * 65536.0f) + 0.5); }
  // Code2V: (c - (int32)RB) * CR / (RW - RB, or 1)
  static float code2v(int c, float rb, float rw, int cr) {
    const float span = (rw - rb != 0) ? rw - rb : 1.0f;
    return static_cast<float>(c - static_cast<int32_t>(rb)) * static_cast<float>(cr) / span;
  }

  void init(const std::vector<float>& luma_tag, const std::vector<float>& rbw_tag) {
    const float kLuma[3] = {0.299f, 0.587f, 0.114f};
    const float kRbw[6] = {0.0f, 255.0f, 128.0f, 255.0f, 128.0f, 255.0f};
    const float* luma = luma_tag.size() == 3 ? luma_tag.data() : kLuma;
    const float* rbw = rbw_tag.size() == 6 ? rbw_tag.data() : kRbw;
    if (std::isnan(luma[0]) || luma[1] == 0.0f || std::isnan(luma[1]) || std::isnan(luma[2]))
      corrupt("TIFF: initYCbCrConversion: Invalid values for YCbCrCoefficients tag");
    for (int i = 0; i < 6; i++)
      if (!(rbw[i] > static_cast<float>(-0x7FFFFFFF + 128) && rbw[i] < static_cast<float>(0x7FFFFFFF)))
        corrupt("TIFF: initYCbCrConversion: Invalid values for ReferenceBlackWhite tag");
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clampf(f1, 0.0f, 2.0f));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clampf(f2, 0.0f, 2.0f));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clampf(f3, 0.0f, 2.0f));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clampf(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; i++, x++) {
      const int32_t cr = static_cast<int32_t>(
          clampf(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      const int32_t cb = static_cast<int32_t>(
          clampf(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      cr_r[i] = (d1 * cr + (1 << 15)) >> 16;
      cb_b[i] = (d3 * cb + (1 << 15)) >> 16;
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + (1 << 15);
      y[i] = static_cast<int32_t>(clampf(code2v(x + 128, rbw[0], rbw[1], 255), -128.0f * 32, 128.0f * 32));
    }
  }

  // PACK(r, g, b): the raster's word, bytes R, G, B, 255
  uint32_t rgb(int Y, int Cb, int Cr) const {
    auto c8 = [](int32_t v) { return static_cast<uint32_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint32_t r = c8(y[Y] + cr_r[Cr]);
    const uint32_t g = c8(y[Y] + ((cb_g[Cb] + cr_g[Cr]) >> 16));
    const uint32_t b = c8(y[Y] + cb_b[Cb]);
    return r | (g << 8) | (b << 16) | 0xff000000u;
  }
};

struct Tiff {
  const uint8_t* d;
  int64_t n;
  bool be = false, big = false;
  std::vector<std::pair<int, TiffEntry>> entries;
  int64_t width = 0, height = 0;      // the image as stored
  int64_t out_w = 0, out_h = 0;       // after the orientation
  int compression = 1, photometric = 0, planar = 1, fillorder = 1;
  int orientation = 1, spp = 1, bps_count = 1;
  std::vector<int64_t> bps, sample_format, extra;
  std::string mode, rawmode;
  PMode pm = PMode::L;
  uint8_t palette[256 * 3];
  std::vector<uint32_t> img;

  int64_t mapped = 0;  // map_stride() of a file Pillow opens from a path

  Tiff(const uint8_t* data, int64_t size, bool path = false) : d(data), n(size) {
    read_ifd();
    setup();
    if (path && (mapped = map_stride())) {
      // the view's size, which exif_transpose swaps back
      out_w = width;
      out_h = height;
    }
  }

  uint64_t rd(const uint8_t* p, int bytes) const {
    uint64_t v = 0;
    for (int i = 0; i < bytes; i++) v = be ? (v << 8) | p[i] : v | (static_cast<uint64_t>(p[i]) << (8 * i));
    return v;
  }

  const TiffEntry* find(int tag) const {
    for (const auto& e : entries)
      if (e.first == tag) return &e.second;
    return nullptr;
  }

  // value i of an integer tag (a non-integer type reads as 0)
  int64_t value(const TiffEntry& e, uint64_t i) const {
    const uint8_t* p = e.data + i * tiff_type_size(e.type);
    switch (e.type) {
      case 1: case 2: case 7: return p[0];
      case 6: return static_cast<int8_t>(p[0]);
      case 3: return static_cast<int64_t>(rd(p, 2));
      case 8: return static_cast<int16_t>(rd(p, 2));
      case 4: case 13: return static_cast<int64_t>(rd(p, 4));
      case 9: return static_cast<int32_t>(rd(p, 4));
      case 17: return static_cast<int64_t>(rd(p, 8));
      case 16: case 18:  // unsigned: past 2**63 - 1 saturated, not negative
        return static_cast<int64_t>(std::min<uint64_t>(rd(p, 8), INT64_MAX));
      default: return 0;
    }
  }

  bool has(int tag) const { return find(tag) != nullptr; }

  int64_t get(int tag, int64_t fallback) const {
    const TiffEntry* e = find(tag);
    return e ? value(*e, 0) : fallback;
  }

  std::vector<int64_t> list(int tag) const {
    std::vector<int64_t> out;
    const TiffEntry* e = find(tag);
    if (e)
      for (uint64_t i = 0; i < e->count; i++) out.push_back(value(*e, i));
    return out;
  }

  // ImageFileDirectory_v2.load: an entry of a type it does not read is
  // skipped, one whose data lies past the end ends the tags, as does a
  // short directory (the libtiff route reads the directory again:
  // LibtiffDir)
  void read_ifd() {
    if (n < 8) corrupt("TIFF: truncated header");
    be = d[0] == 'M';
    big = d[2] == 43;
    if (big && n < 16) corrupt("TIFF: truncated header");
    uint64_t pos = big ? rd(d + 8, 8) : rd(d + 4, 4);
    const uint64_t esize = big ? 20 : 12, inline_size = big ? 8 : 4;
    if (pos > static_cast<uint64_t>(n) || n - pos < (big ? 8u : 2u)) return;
    const uint64_t count = big ? rd(d + pos, 8) : rd(d + pos, 2);
    pos += big ? 8 : 2;
    for (uint64_t i = 0; i < count; i++) {
      if (n - pos < esize) return;
      const uint8_t* e = d + pos;
      pos += esize;
      TiffEntry t;
      const int tag = static_cast<int>(rd(e, 2));
      t.type = static_cast<int>(rd(e + 2, 2));
      t.count = big ? rd(e + 4, 8) : rd(e + 4, 4);
      const int size = tiff_type_size(t.type);
      if (size == 0 || !(t.type <= 13 || t.type == 16)) continue;
      // a tag whose data runs past the file: Pillow's ImageFileDirectory
      // load stops there (its _safe_read raises, the load warns and
      // returns), dropping the tags after it
      if (t.count > static_cast<uint64_t>(n)) return;
      const uint64_t total = t.count * size;
      if (total == 0) continue;
      const uint8_t* val = e + (big ? 12 : 8);
      if (total > inline_size) {
        const uint64_t off = rd(val, big ? 8 : 4);
        if (off > static_cast<uint64_t>(n) || total > n - off) return;
        t.data = d + off;
      } else {
        t.data = val;
      }
      bool replaced = false;
      for (auto& old : entries) {
        if (old.first == tag) {
          old.second = t;
          replaced = true;
        }
      }
      if (!replaced) entries.emplace_back(tag, t);
    }
  }

  static std::string join(const std::vector<int64_t>& v) {
    std::string s;
    for (size_t i = 0; i < v.size(); i++) s += (i ? "," : "") + std::to_string(v[i]);
    return s;
  }

  const OpenInfo* lookup(int fill) const {
    if (sample_format.size() != 1) return nullptr;
    const std::string b = join(bps), e = join(extra);
    for (const OpenInfo& o : kOpenInfo) {
      if (o.mm == static_cast<int>(be) && o.photometric == photometric &&
          o.format == sample_format[0] && o.fill == fill && b == o.bps && e == o.extra)
        return &o;
    }
    return nullptr;
  }

  // TiffImageFile._setup, the ImageOps.exif_transpose that load_end runs,
  // and the modes this decoder refuses
  // Whether Pillow reads the tag as integers: BYTE, ASCII and UNDEFINED
  // load as bytes or text, RATIONAL, FLOAT and DOUBLE as numbers of their
  // own, which _setup's lookups and comparisons fail on
  bool integral(int tag) const {
    const TiffEntry* e = find(tag);
    if (!e) return true;
    switch (e->type) {
      case 3: case 4: case 6: case 8: case 9: case 13: case 16: return true;
      default: return false;
    }
  }

  void setup() {
    if (has(0xBC01)) corrupt("TIFF: Windows Media Photo files not yet supported");
    for (int tag : {256, 257, 258, 259, 262, 266, 277, 338, 339}) {
      if (!integral(tag))
        corrupt("TIFF: tag " + std::to_string(tag) + " of a type Pillow does not read as "
                "integers (bytes, text or a fraction)");
    }
    compression = static_cast<int>(get(259, 1));
    static const int kKnown[] = {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809,
                                 32946, 34676, 34677, 34925, 50000, 50001};
    if (std::find(std::begin(kKnown), std::end(kKnown), compression) == std::end(kKnown))
      corrupt("TIFF: unknown compression " + std::to_string(compression));
    // (a PlanarConfiguration Pillow reads as bytes or a fraction is not 2)
    planar = integral(284) ? static_cast<int>(get(284, 1)) : 1;
    photometric = static_cast<int>(get(262, 0));
    if (compression == 6) photometric = 6;
    fillorder = static_cast<int>(get(266, 1));
    if (!has(256) || !has(257)) corrupt("TIFF: missing dimensions");
    width = get(256, 0);
    height = get(257, 0);
    if (width < 1 || height < 1) corrupt("TIFF: image size 0");
    // (an Orientation Pillow reads as bytes or a fraction turns nothing,
    // and keeps XMP's out)
    orientation = integral(274) ? static_cast<int>(get(274, 0)) : 1;
    if (!has(274)) orientation = xmp_orientation();
    const bool swap = orientation >= 5 && orientation <= 8;
    out_w = swap ? height : width;
    out_h = swap ? width : height;
    sample_format = has(339) ? list(339) : std::vector<int64_t>{1};
    if (sample_format.size() > 1 &&
        std::all_of(sample_format.begin(), sample_format.end(), [](int64_t v) { return v == 1; }))
      sample_format = {1};
    bps = has(258) ? list(258) : std::vector<int64_t>{1};
    extra = list(338);
    bps_count = (photometric == 2 || photometric == 6 || photometric == 8 ? 3
                 : photometric == 5 ? 4 : 1) + static_cast<int>(extra.size());
    spp = static_cast<int>(get(277, compression == 6 && (photometric == 2 || photometric == 6) ? 3 : 1));
    if (spp > 6) corrupt("TIFF: invalid value for samples per pixel");
    if (spp < static_cast<int>(bps.size())) {
      bps.resize(std::max(spp, 0));
    } else if (spp > static_cast<int>(bps.size()) && bps.size() == 1) {
      bps.assign(spp, bps[0]);
    }
    if (static_cast<int>(bps.size()) != spp || spp < 1) corrupt("TIFF: unknown data organization");
    const OpenInfo* o = lookup(fillorder);
    if (!o) {
      corrupt("TIFF: unknown pixel mode (photometric " + std::to_string(photometric) +
              ", " + join(bps) + " bits a sample, sample format " + join(sample_format) +
              ", extra samples " + (extra.empty() ? std::string("none") : join(extra)) +
              ", fill order " + std::to_string(fillorder) + "), which Pillow does not read");
    }
    mode = o->mode;
    rawmode = o->raw;
    pm = pmode(mode);
    if (compression != 1) {
      // _setup's libtiff route: the fill order left to libtiff, the raw
      // mode as libtiff's samples are laid out
      const OpenInfo* o1 = lookup(1);
      if (o1) {
        mode = o1->mode;
        rawmode = o1->raw;
        pm = pmode(mode);
      }
      if (photometric == 6 && compression == 7 && planar == 1) {
        rawmode = "RGB";
      } else if (rawmode == "I;16") {
        rawmode = "I;16N";
      } else if (rawmode.size() > 4 && (rawmode.compare(rawmode.size() - 4, 4, ";16B") == 0 ||
                                        rawmode.compare(rawmode.size() - 4, 4, ";16L") == 0)) {
        rawmode = rawmode.substr(0, rawmode.size() - 1) + "N";
      }
    }
    if (pm == PMode::P || pm == PMode::PA) {
      const TiffEntry* cm = find(320);
      if (!cm) corrupt("TIFF: a palette image without a ColorMap");
      const int64_t entries = static_cast<int64_t>(cm->count / 3);
      if (entries > 256) corrupt("TIFF: a ColorMap of more than 256 entries");
      std::memset(palette, 0, sizeof(palette));
      for (int64_t i = 0; i < entries; i++)
        for (int k = 0; k < 3; k++)
          palette[3 * i + k] = static_cast<uint8_t>(value(*cm, k * entries + i) / 256);
    }
    // what this decoder refuses
    tiff_never_decoded(compression);
    if (pm == PMode::Lab && !g_lab_ready)
      refuse("TIFF: LAB (CIELab) images need LittleCMS's LAB -> sRGB table (mrt_lab_clut)");
  }

  // Image.getexif's XMP fallback: tiff:Orientation="N or tiff:Orientation>N
  int xmp_orientation() const {
    const TiffEntry* e = find(700);
    if (!e || tiff_type_size(e->type) != 1) return 0;
    const std::string key = "tiff:Orientation";
    const uint8_t* end = e->data + e->count;
    for (const uint8_t* p = e->data; p + key.size() <= end; p++) {
      if (std::memcmp(p, key.data(), key.size())) continue;
      const uint8_t* q = p + key.size();
      if (q + 2 < end && q[0] == '=' && q[1] == '"' && q[2] >= '0' && q[2] <= '9')
        return q[2] - '0';
      if (q + 1 < end && q[0] == '>' && q[1] >= '0' && q[1] <= '9') return q[1] - '0';
    }
    return 0;
  }

  // ------------------------------------------------ uncompressed: Pillow
  // ImageFile.load over _setup's tiles: one "raw" tile a strip or tile
  // (the last offset alone when one strip covers the image; a plane's
  // band of the raw mode each for PlanarConfiguration 2), in file order,
  // consecutive duplicates dropped; each read from its offset on, its
  // byte count unread
  struct Tile {
    int64_t offset, x0, y0, x1, y1, stride;
    std::string raw;
  };

  // _setup's tiles, in the order of the offsets
  std::vector<Tile> raw_tiles() const {
    std::vector<int64_t> offsets;
    int64_t w, h;
    if (has(273)) {
      offsets = list(273);
      h = get(278, height);
      w = width;
    } else if (has(324)) {
      offsets = list(324);
      if (!has(322) || !has(323)) corrupt("TIFF: invalid tile dimensions");
      w = get(322, 0);
      h = get(323, 0);
    } else {
      corrupt("TIFF: unknown data organization (no strip or tile offsets)");
    }
    if (w < 1 || h < 1) corrupt("TIFF: a tile or strip of no pixels");
    if (w == width && h == height && planar != 2 && !offsets.empty())
      offsets.erase(offsets.begin(), offsets.end() - 1);
    int64_t sum = 0;
    for (int64_t b : bps) sum += b;
    std::vector<Tile> tiles;
    int64_t x = 0, y = 0;
    size_t layer = 0;
    // (w and h may be near 2**63: x + w and y + h are not formed past the
    // image's edge)
    for (int64_t off : offsets) {
      const bool past = w > width - x;
      double stride = past ? static_cast<double>(w) * sum / 8.0 : 0.0;
      std::string raw = rawmode;
      if (planar == 2) {
        if (layer >= rawmode.size()) corrupt("TIFF: more planes than the raw mode has bands");
        raw = rawmode.substr(layer, 1);
        stride /= bps_count;
      }
      // Pillow's raw decoder takes the stride as a C int
      if (stride >= 2147483648.0)
        corrupt("TIFF: a tile's row stride of more than 2**31 - 1 bytes, which Pillow's "
                "raw decoder refuses");
      tiles.push_back({off, x, y, past ? width : x + w, h > height - y ? height : y + h,
                       static_cast<int64_t>(stride), raw});
      x = past ? width : x + w;
      if (x >= width) {
        x = 0;
        y = h > height - y ? height : y + h;
        if (y >= height) {
          y = 0;
          layer++;
        }
      }
    }
    return tiles;
  }

  // ImageFile.load's memory map, for a file Pillow opens from a path: one
  // raw tile whose raw mode is the image's mode and one of Image._MAPMODES
  // is viewed in place at the size _setup gives, which an Orientation tag
  // of 5-8 swaps; exif_transpose then turns that view. The view's rows
  // (as many as the stored width, of the stored height's pixels) step by
  // the tile's stride, or else by the row of that many pixels; map_buffer
  // refuses a file too short for them. A tile's stride may be shorter
  // than a view row, whose last row then runs past the rows' bytes:
  // Pillow reads past the end of its map there, and the port refuses the
  // file. 0: not mapped; else the row step.
  int64_t map_stride() const {
    const int64_t tag = get(274, 0);
    if (compression != 1 || tag < 5 || tag > 8) return 0;
    static const char* const kMapModes[] = {"L", "P", "RGBX", "RGBA", "CMYK",
                                            "I;16", "I;16L", "I;16B"};
    if (std::find_if(std::begin(kMapModes), std::end(kMapModes),
                     [&](const char* m) { return mode == m; }) == std::end(kMapModes))
      return 0;
    const std::vector<Tile> tiles = raw_tiles();
    if (tiles.size() != 1 || tiles[0].raw != mode) return 0;
    const Tile& t = tiles[0];
    if (t.offset < 0) corrupt("TIFF: Tile offset cannot be negative");
    // (the size check before map_buffer falls back to decoding)
    int64_t need;
    if (t.stride > 0 && (__builtin_mul_overflow(width, t.stride, &need) || need > n - t.offset))
      return 0;
    const int64_t pixel = mode == "L" || mode == "P" ? 1 : mode.compare(0, 4, "I;16") == 0 ? 2 : 4;
    int64_t row;  // a view row's bytes
    if (__builtin_mul_overflow(height, pixel, &row))
      corrupt("TIFF: buffer is not large enough (Pillow's memory map of the file)");
    const int64_t stride = t.stride > 0 ? t.stride : row;
    if (__builtin_mul_overflow(width, stride, &need) || need > n - t.offset)
      corrupt("TIFF: buffer is not large enough (Pillow's memory map of the file)");
    int64_t last;
    if (__builtin_mul_overflow(width - 1, stride, &last) ||
        __builtin_add_overflow(last, row, &last) || last > n - t.offset)
      corrupt("TIFF: the memory-mapped view's last row runs past the end of the file");
    return stride;
  }

  // the mapped view as the image: `width` rows of `height` pixels
  void map_route(int64_t stride) {
    Unpack u;
    if (!make_unpack(rawmode, pm, u))
      corrupt("TIFF: unknown raw mode " + rawmode + " for an image of mode " + mode);
    const int64_t off = raw_tiles()[0].offset;
    std::swap(width, height);
    img.assign(static_cast<size_t>(width * height), 0);
    for (int64_t r = 0; r < height; r++) unpack_row(u, d + off + r * stride, width, img.data() + r * width);
  }

  void raw_route() {
    std::vector<Tile> tiles = raw_tiles();
    std::stable_sort(tiles.begin(), tiles.end(),
                     [](const Tile& a, const Tile& b) { return a.offset < b.offset; });
    std::vector<Tile> kept;
    for (size_t i = 0; i < tiles.size(); i++) {
      const Tile& t = tiles[i];
      if (i + 1 < tiles.size()) {
        const Tile& u = tiles[i + 1];
        if (t.x0 == u.x0 && t.y0 == u.y0 && t.x1 == u.x1 && t.y1 == u.y1 &&
            t.stride == u.stride && t.raw == u.raw)
          continue;
      }
      kept.push_back(t);
    }
    for (const Tile& t : kept) {
      Unpack u;
      if (!make_unpack(t.raw, pm, u))
        corrupt("TIFF: unknown raw mode " + t.raw + " for an image of mode " + mode);
      const int64_t xs = t.x1 - t.x0, ys = t.y1 - t.y0;
      const int64_t bytes = (xs * u.bits + 7) / 8;
      const int64_t skip = t.stride ? t.stride - bytes : 0;
      if (skip < 0) corrupt("TIFF: a tile's rows overlap");
      int64_t rows_bytes, skips, need;
      if (__builtin_mul_overflow(ys, bytes, &rows_bytes) ||
          __builtin_mul_overflow(ys - 1, skip, &skips) ||
          __builtin_add_overflow(rows_bytes, skips, &need) ||
          t.offset < 0 || t.offset > n || need > n - t.offset)
        corrupt("TIFF: image file is truncated");
      for (int64_t r = 0; r < ys; r++)
        unpack_row(u, d + t.offset + r * (bytes + skip), xs,
                   img.data() + (t.y0 + r) * width + t.x0);
    }
  }

  // ---------------------------------------------- compressed: libtiff
  // the image as libtiff reads it (LibtiffDir) and Pillow's TiffDecode.c
  // decodes it from there
  struct Layout {
    bool tiled = false;
    int bits = 8, predictor = 1, format = 1;
    int compression = 1, planar = 1, spp = 1, fillorder = 1;
    int photometric = 0;              // TIFFGetField's, 0 where unset
    uint32_t t4 = 0, t6 = 0;          // fax options
    int64_t rps = 0;                  // libtiff's rows a strip (the image's when absent)
    int64_t tw = 0, th = 0, across = 0, per_plane = 0;
    int64_t row_bytes = 0;            // a strip's or tile's row
    int64_t pred_row = 0;             // the predictor's row (TIFFScanlineSize, packed YCbCr's)
    int64_t seg_size = 0;             // TIFFStripSize / TIFFTileSize
    std::vector<int64_t> offsets, counts;
    std::vector<uint16_t> extra;      // ExtraSamples
    int hs = 1, vs = 1;               // JPEG: YCbCr subsampling
    bool ycc = false;
    // libtiff's RGBA interface (YCbCr but contiguous JPEG): its subsampling,
    // conversion tags and RowsPerStrip as stored
    bool rgba = false;
    int sub_h = 2, sub_v = 2;
    uint32_t rps_tag = 0xFFFFFFFFu;
    std::vector<float> luma, refbw;
    // old-style JPEG (without a StripByteCounts tag its strips cannot be
    // read)
    uint64_t jif = 0, jif_len = 0;
    uint16_t ojpeg_restart = 0;
    std::vector<uint64_t> qtables, dctables, actables;
    bool counts_tag = true;
  };
  Layout L;
  Jpeg jtables{nullptr, 0};
  mrt::FaxState fax;  // libtiff's fax codec's state from strip to strip

  // libtiff's JPEGFixupTagsSubsampling, where the file has no
  // YCbCrSubsampling tag: the luma sampling factors of the first strip's or
  // tile's frame header replace the default 2x2
  void fixup_subsampling() {
    if (L.offsets.empty() || L.counts.empty() || L.counts[0] == 0) return;
    const int64_t off = L.offsets[0];
    if (off < 0 || off >= n) return;
    const uint8_t* p = d + off;
    const int64_t m = std::min<int64_t>(L.counts[0], n - off);
    int64_t i = 0;
    auto byte = [&](uint8_t* v) {
      if (i >= m) return false;
      *v = p[i++];
      return true;
    };
    uint8_t b;
    if (!byte(&b) || b != 0xFF || !byte(&b) || b != 0xD8) return;
    for (;;) {
      do {
        if (!byte(&b)) return;
      } while (b != 0xFF);
      do {
        if (!byte(&b)) return;
      } while (b == 0xFF);
      if (b == 0xD8) continue;
      const bool skip = b == 0xFE || (b >= 0xE0 && b <= 0xEF) || b == 0xDB ||
                        b == 0xDA || b == 0xC4 || b == 0xDD;
      const bool sof = b == 0xC0 || b == 0xC1 || b == 0xC2 || b == 0xC9 || b == 0xCA;
      if (!skip && !sof) return;
      uint8_t hi, lo;
      if (!byte(&hi) || !byte(&lo)) return;
      const int len = (hi << 8) | lo;
      if (skip) {
        if (len < 2) return;
        i += len - 2;
        continue;
      }
      if (len != 8 + L.spp * 3 || i + len - 2 > m) return;
      const uint8_t* f = p + i;
      const int ph = f[7] >> 4, pv = f[7] & 15;
      for (int c = 1; c < L.spp; c++)
        if (f[7 + 3 * c] != 0x11) return;
      if ((ph != 1 && ph != 2 && ph != 4) || (pv != 1 && pv != 2 && pv != 4)) return;
      L.hs = ph;
      L.vs = pv;
      return;
    }
  }

  void libtiff_layout() {
    // TIFFClientOpen's header check
    const uint64_t magic = rd(d + 2, 2);
    if (magic != 42 && magic != 43)
      corrupt("TIFF: not a TIFF file (bad version number " + std::to_string(magic) +
              "), as libtiff reads the header");
    if ((magic == 43) != big) corrupt("TIFF: a big-endian BigTIFF file, which Pillow reads as classic TIFF");
    if (big && (rd(d + 4, 2) != 8 || rd(d + 6, 2) != 0))
      corrupt("TIFF: not a TIFF file (bad BigTIFF offset size), as libtiff reads the header");
    LibtiffDir t(d, n, be, big);
    t.read(big ? rd(d + 8, 8) : rd(d + 4, 4));
    // TiffDecode.c: libtiff's size must be Pillow's
    if (t.width != width || t.height != height)
      corrupt("TIFF: libtiff reads a size of " + std::to_string(t.width) + "x" +
              std::to_string(t.height) + ", Pillow " + std::to_string(width) + "x" +
              std::to_string(height));
    L.compression = t.compression;
    L.planar = t.planar;
    L.spp = t.spp;
    L.fillorder = t.fillorder;
    L.photometric = t.photometric < 0 ? 0 : t.photometric;
    L.t4 = t.t4;
    L.t6 = t.t6;
    L.extra = t.extrasamples;
    L.bits = t.bps;
    L.predictor = t.predictor;
    L.format = t.sampleformat;
    L.tiled = t.tiled;
    tiff_never_decoded(L.compression);
    switch (L.compression) {
      case 1: case 2: case 3: case 4: case 5: case 6: case 7: case 8: case 32771: case 32773:
      case 32809: case 32946: case 34925: case 50000: break;
      default:
        corrupt("TIFF: compression scheme " + std::to_string(L.compression) +
                " is not configured in libtiff");
    }
    // TiffDecode.c reads YCbCr through libtiff's RGBA interface but
    // contiguous JPEG, which libjpeg converts
    L.rgba = L.photometric == 6 && !(L.compression == 7 && L.planar == 1);
    L.sub_h = t.sub_h();
    L.sub_v = t.sub_v();
    L.rps_tag = t.rps;
    L.luma = t.luma;
    L.refbw = t.refbw;
    if (L.compression == 6) {
      if (L.tiled || (L.planar == 2 && L.spp > 1))
        refuse("TIFF: old-style JPEG in tiles or separate planes is not supported");
      L.jif = t.jif;
      L.jif_len = t.jif_len;
      L.ojpeg_restart = t.ojpeg_restart;
      L.qtables = t.qtables;
      L.dctables = t.dctables;
      L.actables = t.actables;
      L.counts_tag = t.counts_tag;
      L.offsets.assign(t.offsets.begin(), t.offsets.end());
      L.counts.assign(t.counts.begin(), t.counts.end());
      ojpeg_subsampling();
      // TIFFScanlineSize of packed YCbCr, at the stream's subsampling
      if (L.photometric == 6 && L.spp == 3) {
        const int hs = L.sub_h, vs = L.sub_v;
        if ((hs != 1 && hs != 2 && hs != 4) || (vs != 1 && vs != 2 && vs != 4))
          corrupt("TIFF: libtiff refuses the directory (Invalid YCbCr subsampling)");
        if ((width + hs - 1) / hs * (hs * vs + 2) * L.bits / 8 / vs == 0)
          corrupt("TIFF: libtiff refuses the directory (a scanline of zero bytes)");
      }
    }
    // ThunderSetupDecode
    if (L.compression == 32809 && L.bits != 4)
      corrupt("TIFF: ThunderScan: Wrong bitspersample value (" + std::to_string(L.bits) +
              "), Thunder decoder only supports 4bits per sample.");
    // Fax3SetupState
    if (tiff_fax(L.compression) && L.bits != 1)
      corrupt("TIFF: Bits/sample must be 1 for Group 3/4 encoding/decoding");
    // JPEGPreDecode: the stream's precision (8 here) must be the samples'
    if (L.compression == 7 && L.bits != 8)
      corrupt("TIFF: Improper JPEG data precision (" + std::to_string(L.bits) +
              "-bit samples, as libtiff's JPEGPreDecode refuses)");
    const int samples = L.planar == 2 ? 1 : L.spp;
    if (L.tiled) {
      L.tw = t.tw;
      L.th = t.th;
      L.across = (width + L.tw - 1) / L.tw;
      L.per_plane = L.across * ((height + L.th - 1) / L.th);
      L.row_bytes = (L.tw * samples * L.bits + 7) / 8;
      L.seg_size = L.row_bytes * L.th;
    } else {
      // TiffDecode.c takes a RowsPerStrip past 2**31 as a negative int
      // and fails to allocate its strip buffer
      if (t.rps >= 0x80000000u && t.rps != 0xFFFFFFFFu)
        corrupt("TIFF: a RowsPerStrip of " + std::to_string(t.rps) +
                ", past Pillow's strip buffer");
      L.rps = t.rps == 0xFFFFFFFFu ? height : t.rps;
      L.per_plane = (height + L.rps - 1) / L.rps;
      L.row_bytes = (width * samples * L.bits + 7) / 8;
      L.seg_size = L.row_bytes * std::min<int64_t>(L.rps, height);
    }
    // the predictor's rows: a strip's packed YCbCr scanline (a row of
    // sampling blocks over the vertical subsampling), else a row
    L.pred_row = L.row_bytes;
    if (!L.tiled && L.photometric == 6 && L.planar == 1 && L.spp == 3 && L.compression != 7)
      L.pred_row = (width + L.sub_h - 1) / L.sub_h * (L.sub_h * L.sub_v + 2) * L.bits / 8 / L.sub_v;
    L.offsets.assign(t.offsets.begin(), t.offsets.end());
    L.counts.clear();
    for (uint64_t c : t.counts) L.counts.push_back(static_cast<int64_t>(std::min<uint64_t>(c, INT64_MAX)));
    L.ycc = L.photometric == 6 && L.planar == 1;
    if (L.compression == 7) {
      if (L.ycc) {
        L.hs = t.ycbcr_sub.size() > 0 ? t.ycbcr_sub[0] : 2;
        L.vs = t.ycbcr_sub.size() > 1 ? t.ycbcr_sub[1] : 2;
        if (L.spp == 3 && t.ycbcr_sub.empty()) fixup_subsampling();
      }
      if (t.jpegtables) {
        const uint8_t* tp = t.jpegtables->field;
        const uint64_t tn = t.jpegtables->count;
        if (tn > (big ? 8u : 4u)) tp = nullptr;
        const uint64_t toff = tn > (big ? 8u : 4u) ? t.rd(t.jpegtables->field, big ? 8 : 4) : 0;
        if (tn <= (big ? 8u : 4u) || (toff <= static_cast<uint64_t>(n) && tn <= static_cast<uint64_t>(n) - toff)) {
          jtables = Jpeg(tp ? tp : d + toff, static_cast<int64_t>(tn));
          jtables.in_tiff = true;
          jtables.run(false, true);
        }
      }
    }
  }

  // One strip or tile (index s): its data decoded into buf[0, size) as
  // libtiff's TIFFReadEncodedStrip / TIFFReadTile leave it: samples of
  // more than 8 bits in the host's (little-endian) order.
  // `filled`: TIFFFillStrip / TIFFFillTile took the strip (a fault after
  // that is the codec's, with its output so far in buf)
  void segment(int64_t s, uint8_t* buf, int64_t size, int64_t seg_w, int64_t seg_h,
               bool last_strip, bool* filled = nullptr) {
    if (filled) *filled = false;
    if (L.compression == 6) {
      ojpeg_segment(s, buf, size, filled);
      return;
    }
    if (s >= static_cast<int64_t>(L.offsets.size())) corrupt("TIFF: strip out of range");
    const int64_t off = L.offsets[s];
    int64_t cnt = L.counts[s];
    if (cnt <= 0) corrupt("TIFF: invalid strip byte count " + std::to_string(cnt));
    // TIFFFillStrip / TIFFFillTile: a count past 1 MiB and ten times the
    // strip's or tile's size is cut to that
    if (cnt > 1024 * 1024 && L.seg_size > 0 && (cnt - 4096) / 10 > L.seg_size)
      cnt = L.seg_size * 10 + 4096;
    if (off < 0 || off > n || cnt > n - off)
      corrupt("TIFF: read error on strip " + std::to_string(s) + " (the file is truncated)");
    if (filled) *filled = true;
    const uint8_t* p = d + off;
    if (tiff_fax(L.compression)) {
      // the fax codec reads the fill order itself (TIFF_NOBITREV)
      mrt::FaxParams fp;
      fp.compression = L.compression;
      fp.options = L.compression == 4 ? L.t6 : L.compression == 3 ? L.t4 : 0;
      fp.msb2lsb = L.fillorder != 2;
      fp.width = seg_w;
      try {
        mrt::tiff_fax(p, cnt, buf, size, seg_h, fp, fax);
      } catch (const Error&) {
        // TIFFReadEncodedTile takes the fax decoder's -1 for success (a
        // tile keeps the rows decoded before the fault); a strip fails
        if (!L.tiled) throw;
      }
      return;
    }
    std::vector<uint8_t> flipped;
    if (L.fillorder == 2 && L.compression != 7) {
      const uint8_t* rev = bitrev();
      flipped.resize(static_cast<size_t>(cnt));
      for (int64_t i = 0; i < cnt; i++) flipped[i] = rev[p[i]];
      p = flipped.data();
    }
    switch (L.compression) {
      case 1:
        // DumpModeDecode
        if (cnt < size)
          corrupt("TIFF: not enough data for a scanline (" + std::to_string(cnt) + " bytes of " +
                  std::to_string(size) + ")");
        std::memcpy(buf, p, static_cast<size_t>(size));
        break;
      case 5: tiff_lzw(p, cnt, buf, size); break;
      case 8: case 32946: Inflater(p, cnt, "TIFF: Deflate data").run(buf, size); break;
      case 32773: tiff_packbits(p, cnt, buf, size); break;
      case 50000: mrt::tiff_zstd(p, cnt, buf, size); break;
      case 34925: mrt::tiff_xz(p, cnt, buf, size); break;
      case 32809:
        tiff_thunder(p, cnt, buf, size, width,
                     (width * (L.planar == 2 ? 1 : L.spp) * L.bits + 7) / 8);
        break;
      case 7: jpeg_segment(p, cnt, buf, size, seg_w, seg_h, last_strip); return;
      default: corrupt("TIFF: compression " + std::to_string(L.compression));
    }
    // LZW, Deflate, ZSTD and LZMA take a predictor; libtiff swaps samples
    // of a big-endian file to the host's order after decoding, but for the
    // floating-point predictor, whose output is the host's already
    const int predictor =
        L.compression == 32773 || L.compression == 1 || L.compression == 32809 ? 1 : L.predictor;
    const int bytes = L.bits / 8;
    if (be && (L.bits == 16 || L.bits == 32) && predictor != 3) {
      for (int64_t i = 0; i + bytes <= size; i += bytes) std::reverse(buf + i, buf + i + bytes);
    }
    if (predictor == 1) return;
    const int stride = L.planar == 2 ? 1 : L.spp;
    const int64_t prow = L.pred_row;
    // PredictorDecodeTile and horAcc*: whole rows of whole pixels
    if (prow <= 0 || size % prow != 0) corrupt("TIFF: Predictor: occ0%rowsize != 0");
    if (prow % (std::max(bytes, 1) * stride) != 0) corrupt("TIFF: Predictor: (cc%stride)!=0");
    if (predictor == 2) {
      if (L.bits != 8 && L.bits != 16 && L.bits != 32 && L.bits != 64)
        corrupt("TIFF: horizontal differencing \"Predictor\" not supported with " +
                std::to_string(L.bits) + "-bit samples");
      for (int64_t r = 0; r + prow <= size; r += prow) {
        uint8_t* row = buf + r;
        const int64_t count = prow / bytes;
        if (bytes == 1) {
          for (int64_t i = stride; i < count; i++) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
          continue;
        }
        for (int64_t i = stride; i < count; i++) {
          uint8_t* a = row + i * bytes;
          const uint8_t* b = a - stride * bytes;
          unsigned carry = 0;
          for (int k = 0; k < bytes; k++) {  // little-endian add
            const unsigned v = a[k] + b[k] + carry;
            a[k] = static_cast<uint8_t>(v);
            carry = v >> 8;
          }
        }
      }
    } else if (predictor == 3) {
      if (L.format != 3)
        corrupt("TIFF: floating point \"Predictor\" not supported with " +
                std::to_string(L.format) + " data format");
      if (L.bits != 16 && L.bits != 24 && L.bits != 32 && L.bits != 64)
        corrupt("TIFF: floating point \"Predictor\" not supported with " +
                std::to_string(L.bits) + "-bit samples");
      std::vector<uint8_t> tmp(static_cast<size_t>(prow));
      const int64_t wc = prow / bytes;
      for (int64_t r = 0; r + prow <= size; r += prow) {
        uint8_t* row = buf + r;
        for (int64_t i = stride; i < prow; i++) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
        std::memcpy(tmp.data(), row, static_cast<size_t>(prow));
        for (int64_t c = 0; c < wc; c++)
          for (int k = 0; k < bytes; k++) row[bytes * c + k] = tmp[(bytes - k - 1) * wc + c];
      }
    } else {
      corrupt("TIFF: \"Predictor\" value " + std::to_string(predictor) + " not supported");
    }
  }

  // libtiff's JPEG codec on one strip or tile: JPEGTables (and the tables
  // of the streams before) in the decompressor, the colour transform
  // chosen by libtiff (YCbCr to RGB for contiguous YCbCr, as Pillow asks
  // with JPEGCOLORMODE_RGB; the components as they are otherwise), never
  // by the stream's JFIF or Adobe marker
  void jpeg_segment(const uint8_t* p, int64_t cnt, uint8_t* buf, int64_t size,
                    int64_t seg_w, int64_t seg_h, bool last_strip) {
    Jpeg head(p, cnt);
    head.in_tiff = true;
    head.take_tables(jtables);
    head.run(true);
    const size_t want = L.planar == 2 ? 1 : static_cast<size_t>(L.spp);
    if (head.comps.size() != want) corrupt("TIFF: improper JPEG component count");
    const int h0 = L.ycc ? L.hs : 1, v0 = L.ycc ? L.vs : 1;
    for (size_t c = 0; c < head.comps.size(); c++) {
      const int eh = c == 0 ? h0 : 1, ev = c == 0 ? v0 : 1;
      if (head.comps[c].h != eh || head.comps[c].v != ev)
        corrupt("TIFF: improper JPEG sampling factors");
    }
    if (head.width > seg_w || (head.height > seg_h && !(last_strip && !L.tiled)))
      corrupt("TIFF: JPEG strip/tile size exceeds expected dimensions");
    if (head.width < seg_w || head.height < seg_h)
      corrupt("TIFF: a JPEG strip or tile smaller than the strip or tile");
    Jpeg j(p, cnt);
    j.in_tiff = true;
    j.take_tables(jtables);
    std::vector<std::vector<uint8_t>> planes = jpeg_planes(j);
    jtables.take_tables(j);
    const Tables& t = tables();
    const int64_t W = j.width;
    const size_t nc = planes.size();
    if (seg_h * seg_w * static_cast<int64_t>(nc) > size)
      corrupt("TIFF: a JPEG strip or tile of more samples than the strip or tile holds");
    for (int64_t r = 0; r < seg_h; r++) {
      uint8_t* o = buf + r * seg_w * static_cast<int64_t>(nc);
      for (int64_t x = 0; x < seg_w; x++, o += nc) {
        const int64_t i = r * W + x;
        if (L.ycc) {
          ycc_to_rgb(t, planes[0][i], planes[1][i], planes[2][i], o);
        } else {
          for (size_t k = 0; k < nc; k++) o[k] = planes[k][i];
        }
      }
    }
  }

  // libtiff's ExtraSamples: the tag's first value (Corel's 999 read as
  // unassociated alpha), or unspecified (0) for samples past the
  // photometric's colour channels; -1 for none
  int libtiff_extra0() const {
    if (!L.extra.empty()) return L.extra[0];
    const int ph = L.photometric;
    const int colour = ph <= 1 || ph == 3 || ph == 4 ? 1
                       : ph == 5 ? 4
                       : ph == 2 || ph == 6 || ph == 8 ? 3 : 0;
    return colour && L.spp > colour ? 0 : -1;
  }

  // TiffDecode.c's _decodeStrip and _decodeTile: each strip or tile through
  // the raw mode's unpacker, edge tiles cropped; separate planes (of more
  // than one sample) one a band of the image, 8-bit or the high byte of
  // 16-bit samples, the colour then un-premultiplied in an RGBA image whose
  // first extra sample is associated or unspecified alpha
  void libtiff_route() {
    libtiff_layout();
    if (L.rgba) {
      rgba_route();
      return;
    }
    // TiffDecode.c _pickUnpackers: a plane a band where libtiff's samples
    // are separate and the mode has bands to spread them over; a mode of
    // one band unpacks the first plane's rows with its raw mode
    const bool separate = L.planar == 2 && bands(pm) > 1;
    const int planes = separate ? bands(pm) : 1;
    Unpack u;
    if (separate) {
      if (L.bits != 8 && L.bits != 16)
        corrupt("TIFF: separate planes of " + std::to_string(L.bits) +
                "-bit samples, which Pillow's decoder does not take");
      if (L.spp != planes && !L.tiled)
        corrupt("TIFF: separate planes of " + std::to_string(L.spp) + " samples for a mode of " +
                std::to_string(planes) + " bands, which Pillow's decoder refuses");
    } else if (!make_unpack(rawmode, pm, u)) {
      corrupt("TIFF: unknown raw mode " + rawmode + " for an image of mode " + mode);
    }
    const bool unpremultiply = separate && pm == PMode::RGBA &&
                               (libtiff_extra0() == 0 || libtiff_extra0() == 1);
    const int sbytes = L.bits / 8;
    const int64_t seg_w = L.tiled ? L.tw : width;
    const int64_t full_rows = L.tiled ? L.th : std::min(L.rps, height);
    const int64_t row_bytes = L.compression == 7 && L.ycc ? seg_w * 3 : L.row_bytes;
    // TiffDecode.c: the unpacker reads no further than libtiff's scanline,
    // and the buffer it asks libtiff to fill (rows a strip of the
    // unpacker's rows) holds a whole strip or tile
    if (!separate) {
      const int64_t unpacker_row = (seg_w * u.bits + 7) / 8;
      if (unpacker_row > row_bytes)
        corrupt("TIFF: raw mode " + rawmode + " takes " + std::to_string(unpacker_row) +
                " bytes a row, libtiff's scanline holds " + std::to_string(row_bytes));
      const int64_t rows = L.tiled ? L.th : L.rps;
      if (unpacker_row < row_bytes && rows * unpacker_row < full_rows * row_bytes)
        corrupt("TIFF: Pillow's strip buffer of " + std::to_string(rows * unpacker_row) +
                " bytes is smaller than libtiff's strip of " + std::to_string(full_rows * row_bytes));
    }
    // Pillow's buffer takes a tile of up to 2**31 - 1 bytes; calloc's pages
    // are touched only where a codec writes, so that a wide tile whose data
    // ends early costs what it decodes
    if (L.tiled && INT32_MAX / std::max<int64_t>(row_bytes, 1) < L.th)
      corrupt("TIFF: a tile of more than 2**31 - 1 bytes, past Pillow's buffer");
    std::vector<ZeroBuffer> bufs(planes);
    for (auto& b : bufs) b.allocate(static_cast<size_t>(row_bytes * full_rows));
    // one row of cw pixels at img row y, column x
    auto put_row = [&](int64_t r, int64_t cw, int64_t y, int64_t x) {
      uint32_t* o = img.data() + y * width + x;
      if (!separate) {
        unpack_row(u, bufs[0].data() + r * row_bytes, cw, o);
        return;
      }
      for (int p = 0; p < planes; p++) {
        const uint8_t* in = bufs[p].data() + r * row_bytes + (sbytes - 1);
        for (int64_t i = 0; i < cw; i++) o[i] = set_band(o[i], p, in[i * sbytes]);
      }
      if (!unpremultiply) return;
      for (int64_t i = 0; i < cw; i++) {
        const uint32_t v = o[i], a = v >> 24;
        if (a == 0) {
          o[i] = 0;
        } else if (a != 255) {
          uint32_t w = a << 24;
          for (int k = 0; k < 3; k++) w |= static_cast<uint32_t>(clip8(static_cast<int>(((v >> (8 * k)) & 255) * 255 / a))) << (8 * k);
          o[i] = w;
        }
      }
    };
    if (L.tiled) {
      for (int64_t y = 0; y < height; y += L.th) {
        for (int64_t x = 0; x < width; x += L.tw) {
          const int64_t tile = (y / L.th) * L.across + x / L.tw;
          for (int p = 0; p < planes; p++)
            segment(tile + p * L.per_plane, bufs[p].data(), row_bytes * L.th, L.tw, L.th, false);
          const int64_t cw = std::min(L.tw, width - x), ch = std::min(L.th, height - y);
          for (int64_t r = 0; r < ch; r++) put_row(r, cw, y + r, x);
        }
      }
      return;
    }
    for (int64_t y = 0; y < height; y += L.rps) {
      const int64_t rows = std::min(L.rps, height - y);
      const int64_t strip = y / L.rps;
      for (int p = 0; p < planes; p++)
        segment(strip + p * L.per_plane, bufs[p].data(), row_bytes * rows, width, rows,
                y + rows == height);
      for (int64_t r = 0; r < rows; r++) put_row(r, width, y + r, 0);
    }
  }

  // ----------------------------------- old-style JPEG: libtiff's tif_ojpeg.c
  // The codec reads its own data (TIFF_NOREADRAW): a stream of the
  // JPEGInterchangeFormat bytes (where the tag points into the file) and
  // then each strip's (a strip at offset 0 or past the file skipped, a
  // byte count of 0 or past the file read to its end). Its header is read
  // from that stream's markers (SOI, APPn and COM skipped, DQT, DHT, DRI,
  // SOF0/1/3 and SOS kept) up to SOS, or, where the stream opens with no
  // marker, from the tables tags. libjpeg then decodes a stream it writes:
  // SOI, the tables by index, DRI, the frame and scan headers it keeps,
  // the entropy data with an RST marker after each strip but the last
  // entry's, and EOI. Packed YCbCr comes out of libjpeg's raw
  // (downsampled) data, or interleaved where the stream's sampling is not
  // one TIFF allows (libjpeg's upsampling, no colour conversion).
  struct OjRegion {
    int64_t at, end;
    int64_t strip;  // -1: the JPEGInterchangeFormat bytes
  };
  struct OjSource {
    std::vector<OjRegion> regs;
    size_t r = 0;
    int64_t p = 0;
    // the next byte, or false at the stream's end
    bool peek(const uint8_t* d, uint8_t& b) {
      while (r < regs.size() && p >= regs[r].end) {
        r++;
        if (r < regs.size()) p = regs[r].at;
      }
      if (r >= regs.size()) return false;
      b = d[p];
      return true;
    }
    bool byte(const uint8_t* d, uint8_t& b) {
      if (!peek(d, b)) return false;
      p++;
      return true;
    }
    bool word(const uint8_t* d, uint32_t& w) {
      uint8_t a, b;
      if (!byte(d, a) || !byte(d, b)) return false;
      w = (a << 8) | b;
      return true;
    }
  };
  struct Ojpeg {
    bool header_done = false, decoded = false, broken = false;
    int hs = 2, vs = 2;
    bool desub = false;
    uint16_t restart = 0;
    bool sof = false;
    int sof_marker = 0xC0;
    uint32_t sof_x = 0, sof_y = 0;
    uint8_t sof_c[3] = {0, 1, 2}, sof_hv[3] = {0x22, 0x11, 0x11}, sof_tq[3] = {0, 1, 2};
    uint8_t sos_cs[3] = {0, 1, 2}, sos_tda[3] = {0, 0x11, 0x22};
    std::vector<uint8_t> qt[4], dc[4], ac[4];  // whole marker segments
    OjSource src;
    std::vector<uint8_t> packed;  // the image's block rows
    int64_t bpl = 0, lps = 0;     // bytes a block row, block rows a strip
    int64_t good_rows = INT64_MAX;  // rows out before libjpeg fails
    bool dead = false;            // libjpeg failed on a strip before
    bool short_ok = false;        // rows past the packed ones are left, not failed
  } oj;

  OjSource oj_source() const {
    OjSource src;
    if (L.jif != 0 && L.jif < static_cast<uint64_t>(n)) {
      uint64_t len = L.jif_len;
      if (len == 0 || L.jif > UINT64_MAX - len || L.jif + len > static_cast<uint64_t>(n))
        len = n - L.jif;
      src.regs.push_back({static_cast<int64_t>(L.jif), static_cast<int64_t>(L.jif + len), -1});
    }
    for (size_t k = 0; L.counts_tag && k < L.offsets.size(); k++) {
      const uint64_t off = static_cast<uint64_t>(L.offsets[k]);
      if (off == 0 || off >= static_cast<uint64_t>(n)) continue;
      uint64_t cnt = static_cast<uint64_t>(L.counts[k]);
      if (cnt == 0 || off + cnt > static_cast<uint64_t>(n)) cnt = n - off;
      src.regs.push_back({static_cast<int64_t>(off), static_cast<int64_t>(off + cnt),
                          static_cast<int64_t>(k)});
    }
    if (!src.regs.empty()) src.p = src.regs[0].at;
    return src;
  }

  // OJPEGReadHeaderInfoSec's marker walk; `correct`: OJPEGSubsamplingCorrect's
  // quiet pass (no tables kept, false ends it quietly). False where the
  // header fails.
  bool oj_markers(OjSource& src, bool correct) {
    const int spp = 3;
    uint8_t m;
    for (;;) {
      if (!src.peek(d, m)) return false;
      if (m != 255) break;
      src.p++;
      do {
        if (!src.byte(d, m)) return false;
      } while (m == 255);
      uint32_t len;
      switch (m) {
        case 0xD8: break;
        case 0xFE: case 0xE0: case 0xE1: case 0xE2: case 0xE3: case 0xE4: case 0xE5: case 0xE6:
        case 0xE7: case 0xE8: case 0xE9: case 0xEA: case 0xEB: case 0xEC: case 0xED: case 0xEE:
        case 0xEF:
          if (!src.word(d, len) || len < 2) return false;
          for (uint32_t k = 2; k < len; k++)
            if (!src.byte(d, m)) return false;
          break;
        case 0xDD:  // DRI
          if (!src.word(d, len) || len != 4) return false;
          if (!src.word(d, len)) return false;
          oj.restart = static_cast<uint16_t>(len);
          break;
        case 0xDB: case 0xC4: {  // DQT, DHT
          const int kind = m;
          if (!src.word(d, len) || len <= 2) return false;
          std::vector<uint8_t> body(len - 2);
          for (auto& b : body)
            if (!src.byte(d, b)) return false;
          if (correct) break;
          if (kind == 0xDB) {
            for (size_t k = 0; k < body.size(); k += 65) {
              if (body.size() - k < 65) return false;
              const int id = body[k] & 15;
              if (id > 3) return false;
              oj.qt[id] = {0xFF, 0xDB, 0, 67};
              oj.qt[id].insert(oj.qt[id].end(), body.begin() + k, body.begin() + k + 65);
            }
          } else {
            const int o = body[0];
            if ((o & 0xF0) != 0 && (o & 0xF0) != 16) return false;
            if ((o & 15) > 3) return false;
            std::vector<uint8_t>& t = (o & 0xF0) ? oj.ac[o & 15] : oj.dc[o & 15];
            t = {0xFF, 0xC4, static_cast<uint8_t>(len >> 8), static_cast<uint8_t>(len)};
            t.insert(t.end(), body.begin(), body.end());
          }
          break;
        }
        case 0xC0: case 0xC1: case 0xC3: {
          if (oj.sof && !correct) return false;
          if (!src.word(d, len) || len < 11 || (len - 8) % 3 != 0) return false;
          if (!correct && (len - 8) / 3 != static_cast<uint32_t>(spp)) return false;
          uint8_t prec;
          uint32_t y, x;
          if (!src.byte(d, prec) || (!correct && prec != 8)) return false;
          if (!src.word(d, y) || !src.word(d, x)) return false;
          if (!correct) {
            if (y < height && y < static_cast<uint32_t>(height)) return false;
            if (x < width) return false;
            if (x > width) return false;
          }
          uint8_t nf;
          if (!src.byte(d, nf) || nf != spp) return false;
          for (int q = 0; q < spp; q++) {
            uint8_t c, hv, tq;
            if (!src.byte(d, c) || !src.byte(d, hv) || !src.byte(d, tq)) return false;
            if (correct) {
              if (q == 0) {
                oj.hs = hv >> 4;
                oj.vs = hv & 15;
                if ((oj.hs != 1 && oj.hs != 2 && oj.hs != 4) || (oj.vs != 1 && oj.vs != 2 && oj.vs != 4))
                  oj.desub = true;
              } else if (hv != 0x11) {
                oj.desub = true;
              }
            } else {
              oj.sof_c[q] = c;
              oj.sof_hv[q] = hv;
              oj.sof_tq[q] = tq;
              if (!oj.desub && hv != (q == 0 ? ((oj.hs << 4) | oj.vs) : 0x11)) return false;
            }
          }
          if (correct) return true;
          oj.sof = true;
          oj.sof_marker = m;
          oj.sof_x = x;
          oj.sof_y = y;
          break;
        }
        case 0xDA: {
          if (correct) return true;
          if (!oj.sof) return false;
          if (!src.word(d, len) || len != static_cast<uint32_t>(6 + spp * 2)) return false;
          uint8_t ns;
          if (!src.byte(d, ns) || ns != spp) return false;
          for (int q = 0; q < spp; q++)
            if (!src.byte(d, oj.sos_cs[q]) || !src.byte(d, oj.sos_tda[q])) return false;
          for (int k = 0; k < 3; k++)
            if (!src.byte(d, m)) break;  // OJPEGReadSkip
          return true;
        }
        default:
          return false;
      }
    }
    return true;
  }

  // OJPEGSubsamplingCorrect: the subsampling the stream's frame header
  // gives (the tag's, 2x2 unset, where it has none), 1x1 where libjpeg
  // must upsample
  void ojpeg_subsampling() {
    if (L.spp != 3 || L.photometric != 6) {
      oj.hs = oj.vs = 1;
    } else {
      oj.hs = L.sub_h;
      oj.vs = L.sub_v;
      OjSource src = oj_source();
      oj_markers(src, true);
      if (oj.desub) oj.hs = oj.vs = 1;
    }
    L.sub_h = oj.hs;
    L.sub_v = oj.vs;
  }

  // The tables tags' segments (OJPEGReadHeaderInfoSecTables*): a table a
  // component, repeated offsets shared with the component before
  bool oj_tables() {
    const int spp = 3;
    auto off = [](const std::vector<uint64_t>& v, int m) { return m < static_cast<int>(v.size()) ? v[m] : 0; };
    if (off(L.qtables, 0) == 0) return false;  // Missing JPEG tables
    for (int m = 0; m < spp; m++) {
      const uint64_t o = off(L.qtables, m);
      if (o != 0 && (m == 0 || o != off(L.qtables, m - 1))) {
        for (int k = 0; k < m - 1; k++)
          if (o == off(L.qtables, k)) return false;
        if (o > static_cast<uint64_t>(n) || n - o < 64) return false;
        oj.qt[m] = {0xFF, 0xDB, 0, 67, static_cast<uint8_t>(m)};
        oj.qt[m].insert(oj.qt[m].end(), d + o, d + o + 64);
        oj.sof_tq[m] = static_cast<uint8_t>(m);
      } else {
        oj.sof_tq[m] = oj.sof_tq[m - 1];
      }
    }
    for (int ac = 0; ac < 2; ac++) {
      const std::vector<uint64_t>& v = ac ? L.actables : L.dctables;
      if (off(v, 0) == 0) return false;
      for (int m = 0; m < spp; m++) {
        const uint64_t o = off(v, m);
        if (o != 0 && (m == 0 || o != off(v, m - 1))) {
          for (int k = 0; k < m - 1; k++)
            if (o == off(v, k)) return false;
          if (o > static_cast<uint64_t>(n) || n - o < 16) return false;
          uint32_t q = 0;
          for (int k = 0; k < 16; k++) q += d[o + k];
          if (static_cast<uint64_t>(n) - o - 16 < q) return false;
          std::vector<uint8_t>& t = ac ? oj.ac[m] : oj.dc[m];
          t = {0xFF, 0xC4, static_cast<uint8_t>((19 + q) >> 8), static_cast<uint8_t>(19 + q),
               static_cast<uint8_t>(ac ? 16 | m : m)};
          t.insert(t.end(), d + o, d + o + 16 + q);
          oj.sos_tda[m] = static_cast<uint8_t>(ac ? (oj.sos_tda[m] & 0xF0) | m : m << 4);
        } else {
          oj.sos_tda[m] = static_cast<uint8_t>(ac ? (oj.sos_tda[m] & 0xF0) | (oj.sos_tda[m - 1] & 0x0F)
                                                  : oj.sos_tda[m - 1]);
        }
      }
    }
    return true;
  }

  // OJPEGReadHeaderInfo and OJPEGWriteHeaderInfo, then the whole stream
  // through the JPEG decoder: false where the header fails (TIFFFillStrip's
  // failure)
  bool ojpeg_start() {
    if (oj.header_done) return !oj.broken;
    oj.header_done = true;
    oj.broken = true;
    const int64_t rps = std::min<int64_t>(L.rps_tag, height);
    oj.restart = L.ojpeg_restart;
    if (rps < height) {
      if ((oj.hs != 1 && oj.hs != 2 && oj.hs != 4) || (oj.vs != 1 && oj.vs != 2 && oj.vs != 4))
        return false;
      if (rps % (oj.vs * 8) != 0) return false;
      oj.restart = static_cast<uint16_t>((width + oj.hs * 8 - 1) / (oj.hs * 8) * (rps / (oj.vs * 8)));
    }
    oj.src = oj_source();
    if (!oj_markers(oj.src, false)) return false;
    if (!oj.sof) {
      if (!oj_tables()) return false;
      oj.sof_marker = 0xC0;
      oj.sof_hv[0] = static_cast<uint8_t>((oj.hs << 4) | oj.vs);
      oj.sof_hv[1] = oj.sof_hv[2] = 0x11;
      for (int m = 0; m < 3; m++) oj.sof_c[m] = oj.sos_cs[m] = static_cast<uint8_t>(m);
      oj.sof_x = static_cast<uint32_t>(width);
      oj.sof_y = static_cast<uint32_t>(height);
    }
    if (oj.sof_marker == 0xC3)
      refuse("TIFF: old-style JPEG of a lossless frame is not supported");
    // the stream libjpeg reads
    std::vector<uint8_t> js = {0xFF, 0xD8};
    for (int k = 0; k < 4; k++) js.insert(js.end(), oj.qt[k].begin(), oj.qt[k].end());
    for (int k = 0; k < 4; k++) js.insert(js.end(), oj.dc[k].begin(), oj.dc[k].end());
    for (int k = 0; k < 4; k++) js.insert(js.end(), oj.ac[k].begin(), oj.ac[k].end());
    if (oj.restart)
      js.insert(js.end(), {0xFF, 0xDD, 0, 4, static_cast<uint8_t>(oj.restart >> 8),
                           static_cast<uint8_t>(oj.restart)});
    js.insert(js.end(), {0xFF, static_cast<uint8_t>(oj.sof_marker), 0, 17, 8,
                         static_cast<uint8_t>(oj.sof_y >> 8), static_cast<uint8_t>(oj.sof_y),
                         static_cast<uint8_t>(oj.sof_x >> 8), static_cast<uint8_t>(oj.sof_x), 3});
    for (int m = 0; m < 3; m++) js.insert(js.end(), {oj.sof_c[m], oj.sof_hv[m], oj.sof_tq[m]});
    js.insert(js.end(), {0xFF, 0xDA, 0, 12, 3});
    for (int m = 0; m < 3; m++) js.insert(js.end(), {oj.sos_cs[m], oj.sos_tda[m]});
    js.insert(js.end(), {0, 63, 0});
    // the entropy data: an RST marker after a strip while entries follow
    int rst = 0;
    OjSource& sr = oj.src;
    uint8_t b;
    while (sr.peek(d, b)) {
      const OjRegion& g = sr.regs[sr.r];
      js.insert(js.end(), d + sr.p, d + g.end);
      sr.p = g.end;
      if (g.strip >= 0 && g.strip + 1 < static_cast<int64_t>(L.offsets.size()) &&
          sr.r + 1 < sr.regs.size()) {
        js.insert(js.end(), {0xFF, static_cast<uint8_t>(0xD0 + rst)});
        rst = (rst + 1) & 7;
      }
    }
    js.insert(js.end(), {0xFF, 0xD9});
    // libjpeg's decode: raw downsampled planes, or interleaved samples
    Jpeg head(js.data(), static_cast<int64_t>(js.size()));
    head.in_tiff = true;
    try {
      head.run(true);
    } catch (const Error&) {
      return false;
    }
    // OJPEGWriteHeaderInfo's checks of what jpeg_start_decompress gives:
    // the frame's width (16 bits in the frame header) the strip's, and in
    // raw mode the luma's sampling the subsampling
    const bool raw = !oj.desub;
    if (head.width != width) return false;
    if (raw && (head.hmax != oj.hs || head.vmax != oj.vs)) return false;
    Jpeg j(js.data(), static_cast<int64_t>(js.size()));
    j.in_tiff = true;
    j.ojpeg = true;
    oj.broken = false;
    const int hs = raw ? oj.hs : 1, vs = raw ? oj.vs : 1;
    oj.bpl = raw ? (width + hs - 1) / hs * (hs * vs + 2) : 3 * width;
    oj.lps = raw ? (rps + vs - 1) / vs : rps;
    const int64_t rows = (static_cast<int64_t>(head.height) + vs - 1) / vs;
    // (what libjpeg refuses before the data, its tables, fails the header)
    try {
      j.run(false);
    } catch (const Error&) {
      oj.broken = true;
      return false;
    }
    try {
      if (raw) {
        // OJPEGDecodeRaw over jpeg_read_raw_data: an iMCU row at a time
        // into one buffer (8 chroma rows, vs * 8 luma rows), each block row
        // of a component past its blocks left as the row before left it,
        // and every read past the frame's last iMCU row leaving the buffer
        // as it is; the image's block rows packed from it
        std::vector<std::vector<uint8_t>> planes;
        std::vector<int> strides = jpeg_raw_planes(j, planes);
        const int64_t need = L.per_plane * oj.lps;
        const int64_t blocks = (width + hs - 1) / hs;
        oj.packed.assign(static_cast<size_t>(need * oj.bpl), 0);
        std::vector<std::vector<uint8_t>> ring(3);
        const int lines[3] = {vs * 8, 8, 8};
        for (int c = 0; c < 3; c++) ring[c].assign(static_cast<size_t>(lines[c]) * strides[c], 0);
        for (int64_t k = 0; k * 8 < need; k++) {
          if (k < j.mcuy) {
            for (int c = 0; c < 3; c++) {
              const int64_t have = (j.comps[c].ch + 7) / 8;  // the component's block rows
              const int per = lines[c] / 8;                    // its block rows an iMCU row
              for (int b = 0; b < per; b++) {
                const int64_t gb = k * per + b;
                if (gb >= have) continue;
                std::memcpy(ring[c].data() + static_cast<int64_t>(b) * 8 * strides[c],
                            planes[c].data() + gb * 8 * strides[c], static_cast<size_t>(8 * strides[c]));
              }
            }
          }
          for (int64_t cl = 0; cl < 8 && k * 8 + cl < need; cl++) {
            uint8_t* o = oj.packed.data() + (k * 8 + cl) * oj.bpl;
            for (int64_t bx = 0; bx < blocks; bx++) {
              for (int r = 0; r < vs; r++)
                for (int c = 0; c < hs; c++) *o++ = ring[0][(cl * vs + r) * strides[0] + bx * hs + c];
              *o++ = ring[1][cl * strides[1] + bx];
              *o++ = ring[2][cl * strides[2] + bx];
            }
          }
        }
      } else {
        // OJPEGDecodeScanlines: past the frame's rows libjpeg gives none
        // and the strip's rows stay as they are (zero)
        std::vector<std::vector<uint8_t>> full = jpeg_planes(j, true);
        oj.packed.assign(static_cast<size_t>(j.height) * oj.bpl, 0);
        oj.short_ok = true;
        const int64_t W = j.width;
        for (int64_t y = 0; y < j.height; y++)
          for (int64_t x = 0; x < width; x++)
            for (int k = 0; k < 3; k++) oj.packed[y * oj.bpl + 3 * x + k] = full[k][y * W + x];
      }
      oj.decoded = true;
    } catch (const Error&) {
      oj.decoded = false;
    }
    // the rows libjpeg gives before its error: those of the iMCU rows
    // before the one it fails in
    oj.good_rows = INT64_MAX;
    if (j.fail_mcu >= 0) {
      const int64_t imcu = j.fail_mcu / std::max(j.mcux, 1);
      oj.good_rows = imcu * (raw ? 8 : 8 * j.vmax);
    }
    return true;
  }

  // One strip: its block rows of the decoded image (OJPEGDecodeRaw /
  // OJPEGDecodeScanlines: a request of a fraction of a row fails)
  void ojpeg_segment(int64_t s, uint8_t* buf, int64_t size, bool* filled) {
    if (!ojpeg_start()) corrupt("TIFF: old-style JPEG: the stream's header is refused (libtiff's tif_ojpeg.c)");
    // (a strip after one libjpeg failed on fails to start: OJPEGPreDecode
    // cannot skip the rows left)
    if (oj.dead) corrupt("TIFF: old-style JPEG: libjpeg failed on an earlier strip");
    if (filled) *filled = true;
    if (oj.bpl <= 0 || size % oj.bpl != 0) corrupt("TIFF: old-style JPEG: Fractional scanline not read");
    if (!oj.decoded) {
      oj.dead = true;
      corrupt("TIFF: old-style JPEG: libjpeg fails on the data");
    }
    const int64_t row0 = s * oj.lps;
    const int64_t rows = size / oj.bpl;
    const int64_t have = std::min<int64_t>(static_cast<int64_t>(oj.packed.size()) / oj.bpl, oj.good_rows);
    const int64_t take = std::max<int64_t>(0, std::min(rows, have - row0));
    if (take > 0)
      std::memcpy(buf, oj.packed.data() + row0 * oj.bpl, static_cast<size_t>(take * oj.bpl));
    if (take < rows && (row0 + rows > oj.good_rows || !oj.short_ok)) {
      oj.dead = true;
      corrupt("TIFF: old-style JPEG: libjpeg fails within the strip");
    }
  }

  // TiffDecode.c _decodeAsRGBA: TIFFRGBAImageGet over blocks of
  // RowsPerStrip (or TileLength) rows, each block's raster of ABGR words
  // unpacked with the raw mode. tif_getimage.c reads the strips or tiles a
  // block holds (gtStripContig, gtTileContig, gtStripSeparate,
  // gtTileSeparate) into a buffer allocated zeroed for the block, and
  // carries on past a strip the codec fails on (Pillow passes stop = 0)
  // with what the buffer holds; a strip or tile it cannot fill ends the
  // decode where it is the block's first read, and is zeroed otherwise.
  // The raster is not turned (Pillow's exif_transpose turns the image).
  void rgba_route() {
    // TIFFRGBAImageOK and TIFFRGBAImageBegin
    if (L.bits != 1 && L.bits != 2 && L.bits != 4 && L.bits != 8 && L.bits != 16)
      corrupt("TIFF: libtiff's RGBA interface: Sorry, can not handle images with " +
              std::to_string(L.bits) + "-bit samples");
    if (L.format == 3)
      corrupt("TIFF: libtiff's RGBA interface: Sorry, can not handle images with IEEE "
              "floating-point samples");
    const bool contig = !(L.planar == 2 && L.spp > 1);
    const int hs = L.sub_h, vs = L.sub_v;
    if (L.bits != 8 || L.spp != 3)
      corrupt("TIFF: libtiff's RGBA interface: Cannot handle format (YCbCr of " +
              std::to_string(L.spp) + " samples of " + std::to_string(L.bits) + " bits)");
    YccToRgb conv;
    conv.init(L.luma, L.refbw);
    const int key = hs << 4 | vs;
    const bool known = contig ? (key == 0x44 || key == 0x42 || key == 0x41 || key == 0x22 ||
                                 key == 0x21 || key == 0x12 || key == 0x11)
                              : key == 0x11;
    if (!known)
      corrupt("TIFF: libtiff's RGBA interface: Cannot handle format (YCbCr subsampling " +
              std::to_string(hs) + "x" + std::to_string(vs) +
              (contig ? std::string() : std::string(" in separate planes")) + ")");
    Unpack u;
    if (!make_unpack(rawmode, pm, u))
      corrupt("TIFF: unknown raw mode " + rawmode + " for an image of mode " + mode);
    // the unpacker reads a raster row's 4 bytes a pixel
    if (u.bits > 32)
      corrupt("TIFF: raw mode " + rawmode + " reads past the RGBA raster's rows");
    // Pillow's block of rows and its buffer
    const int64_t rpb = L.tiled ? L.th : (L.rps_tag == 0xFFFFFFFFu ? height : L.rps_tag);
    if (INT32_MAX / 4 < width) corrupt("TIFF: an RGBA row past Pillow's int");
    if (INT32_MAX / (width * 4) < rpb) corrupt("TIFF: an RGBA block past Pillow's int");
    // libtiff's strips: RowsPerStrip as stored, and its sizes
    const int64_t rps = L.rps_tag;  // 0xFFFFFFFF: one strip
    const int64_t per_image = L.tiled ? 0 : (height + std::min<int64_t>(rps, height) - 1) /
                                                std::min<int64_t>(rps, height);
    const int64_t bsize = contig ? hs * vs + 2 : 1;
    // TIFFScanlineSize / TIFFTileRowSize, TIFFVStripSize / TIFFTileSize
    const int64_t seg_w = L.tiled ? L.tw : width;
    auto seg_bytes = [&](int64_t rows) -> int64_t {
      if (!contig) return rows * seg_w;
      return (seg_w + hs - 1) / hs * bsize * ((rows + vs - 1) / vs);
    };
    const int64_t scanline = contig ? (width + hs - 1) / hs * bsize / vs : width;
    const int planes = contig ? 1 : 3;
    const int64_t seg_max = L.tiled ? seg_bytes(L.th) : seg_bytes(std::min<int64_t>(rps, height));
    std::vector<uint32_t> raster;
    ZeroBuffer buf;
    const uint8_t* bufend = nullptr;
    // one read into plane p's part of the buffer; `first`: the block's
    // first, through the allocating read, which allocates the buffer
    // zeroed once the strip or tile is filled; a tile's there refuses a
    // buffer of more than 10**8 bytes for data of less than the tile over
    // the codec's largest ratio (_TIFFReadEncodedTileAndAllocBuffer)
    auto read = [&](int64_t index, int p, int64_t want, int64_t rows, bool first) {
      if (first) {
        const int64_t ratio = L.compression == 50000 ? 33000 : L.compression == 34925 ? 7000 : 1000;
        if (L.tiled && seg_max * planes > 100000000 && index < static_cast<int64_t>(L.counts.size()) &&
            L.counts[index] < seg_max / ratio)
          corrupt("TIFF: Likely invalid tile byte count (libtiff's allocation check)");
        buf.allocate(static_cast<size_t>(seg_max * planes));
        bufend = buf.data() + seg_max * planes;
      }
      uint8_t* at = buf.data() + p * seg_max;
      bool filled = false;
      try {
        segment(index, at, want, seg_w, rows, false, &filled);
      } catch (const Error&) {
        if (!filled) {
          if (first) throw;
          std::memset(at, 0, static_cast<size_t>(want));
        }
      }
    };
    auto byte = [&](const uint8_t* q) -> int {
      if (!bufend || q < buf.data() || q >= bufend)
        corrupt("TIFF: libtiff's RGBA interface reads past its buffer");
      return *q;
    };
    for (int64_t y = 0; y < height; y += rpb) {
      const int64_t rows = std::min(rpb, height - y);
      raster.assign(static_cast<size_t>(width * rows), 0);
      auto pix = [&](int64_t r, int64_t c, int Y, int Cb, int Cr) {
        raster[r * width + c] = conv.rgb(Y, Cb, Cr);
      };
      // put.contig and put.separate over w columns from tocol, h rows from
      // block row r0, the data from q, `skew` columns past each row
      auto put = [&](const uint8_t* q, int64_t r0, int64_t tocol, int64_t w, int64_t h,
                     int64_t skew) {
        if (!contig) {
          const uint8_t* q1 = q + seg_max;
          const uint8_t* q2 = q1 + seg_max;
          for (int64_t r = 0; r < h; r++) {
            for (int64_t c = 0; c < w; c++) {
              const int64_t k = r * (w + skew) + c;
              pix(r0 + r, tocol + c, byte(q + k), byte(q1 + k), byte(q2 + k));
            }
          }
          return;
        }
        // (putcontig8bitYCbCr44tile skips blocks of 4x2's size)
        const int64_t pskip = (skew / hs) * (key == 0x44 ? 10 : bsize);
        for (int64_t rb = 0; rb < h; rb += vs) {
          for (int64_t x = 0; x < w; x += hs) {
            const int Cb = byte(q + hs * vs), Cr = byte(q + hs * vs + 1);
            for (int r = 0; r < vs && rb + r < h; r++)
              for (int c = 0; c < hs && x + c < w; c++)
                pix(r0 + rb + r, tocol + x + c, byte(q + r * hs + c), Cb, Cr);
            q += bsize;
          }
          q += pskip;
        }
      };
      if (!L.tiled) {
        // gtStripContig / gtStripSeparate
        for (int64_t row = 0; row < rows;) {
          const int64_t in_strip = (row + y) % rps;
          const int64_t nrow = std::min(rows - row, rps - in_strip);
          int64_t nrowsub = nrow;
          if (contig && nrowsub % vs) nrowsub += vs - nrowsub % vs;
          const int64_t strip = (row + y) / rps;
          // TIFFReadEncodedStrip's size: the strip's, at most temp * scanline
          const int64_t rows_in = std::min<int64_t>(std::min<int64_t>(rps, height),
                                                    height - strip * std::min<int64_t>(rps, height));
          const int64_t want = std::min(seg_bytes(rows_in), (in_strip + nrowsub) * scanline);
          for (int p = 0; p < planes; p++)
            read(strip + p * per_image, p, want, rows_in, p == 0 && row == 0);
          put(buf.data() + in_strip * scanline, row, 0, width, nrow, 0);
          row += nrow;
        }
      } else {
        // gtTileContig / gtTileSeparate: a row of tiles
        const int64_t nrow = std::min(rows, L.th - y % L.th);
        for (int64_t tocol = 0; tocol < width; tocol += L.tw) {
          const int64_t tile = (y / L.th) * L.across + tocol / L.tw;
          for (int p = 0; p < planes; p++)
            read(tile + p * L.per_plane, p, seg_max, L.th, p == 0 && tocol == 0);
          const int64_t this_tw = std::min(L.tw, width - tocol);
          put(buf.data(), 0, tocol, this_tw, nrow, L.tw - this_tw);
        }
      }
      for (int64_t r = 0; r < rows; r++)
        unpack_row(u, reinterpret_cast<const uint8_t*>(raster.data() + r * width), width,
                   img.data() + (y + r) * width);
    }
  }

  // Convert.c's conversion of the mode to RGB, with exif_transpose's
  // orientation
  void rgb(uint32_t v, uint8_t* o) const {
    switch (pm) {
      case PMode::One: case PMode::L: case PMode::LA:
        o[0] = o[1] = o[2] = static_cast<uint8_t>(v);
        return;
      case PMode::P: case PMode::PA:
        std::memcpy(o, &palette[3 * (v & 255)], 3);
        return;
      case PMode::I16:
        o[0] = o[1] = o[2] = static_cast<uint8_t>(std::min<uint32_t>(v, 255));
        return;
      case PMode::I: {
        const int32_t s = static_cast<int32_t>(v);
        o[0] = o[1] = o[2] = static_cast<uint8_t>(s <= 0 ? 0 : (s >= 255 ? 255 : s));
        return;
      }
      case PMode::F: {
        float f;
        std::memcpy(&f, &v, 4);
        o[0] = o[1] = o[2] = static_cast<uint8_t>(f > 0 ? (f >= 255 ? 255 : static_cast<int>(f)) : 0);
        return;
      }
      case PMode::Lab: {
        const uint32_t c = lab_to_rgb(v & 255, (v >> 8) & 255, (v >> 16) & 255);
        o[0] = static_cast<uint8_t>(c);
        o[1] = static_cast<uint8_t>(c >> 8);
        o[2] = static_cast<uint8_t>(c >> 16);
        return;
      }
      case PMode::CMYK: {
        const int nk = 255 - static_cast<int>(v >> 24);
        for (int k = 0; k < 3; k++) {
          const int tmp = static_cast<int>((v >> (8 * k)) & 255) * nk + 128;
          o[k] = clamp255(nk - (((tmp >> 8) + tmp) >> 8));
        }
        return;
      }
      default:
        o[0] = static_cast<uint8_t>(v);
        o[1] = static_cast<uint8_t>(v >> 8);
        o[2] = static_cast<uint8_t>(v >> 16);
    }
  }

  void decode(uint8_t* out) {
    img.assign(static_cast<size_t>(width * height), 0);
    if (mapped) {
      map_route(mapped);
    } else if (compression == 1) {
      raw_route();
    } else {
      libtiff_route();
    }
    const int64_t W = width, H = height;
    const bool straight = orientation < 2 || orientation > 8;
    std::vector<uint8_t> line(static_cast<size_t>(straight ? 0 : W * 3));
    for (int64_t r = 0; r < H; r++) {
      uint8_t* o = straight ? out + r * W * 3 : line.data();
      const uint32_t* in = img.data() + r * W;
      if (pm == PMode::RGB || pm == PMode::RGBA) {
        for (int64_t c = 0; c < W; c++, o += 3) {
          o[0] = static_cast<uint8_t>(in[c]);
          o[1] = static_cast<uint8_t>(in[c] >> 8);
          o[2] = static_cast<uint8_t>(in[c] >> 16);
        }
      } else if (pm == PMode::L || pm == PMode::One || pm == PMode::LA) {
        for (int64_t c = 0; c < W; c++, o += 3) o[0] = o[1] = o[2] = static_cast<uint8_t>(in[c]);
      } else {
        for (int64_t c = 0; c < W; c++, o += 3) rgb(in[c], o);
      }
      if (straight) continue;
      // exif_transpose: where pixel (r, c) goes, a step of c at a time
      auto at = [&](int64_t c) {
        int64_t orow = r, ocol = c;
        switch (orientation) {
          case 2: ocol = W - 1 - c; break;
          case 3: orow = H - 1 - r; ocol = W - 1 - c; break;
          case 4: orow = H - 1 - r; break;
          case 5: orow = c; ocol = r; break;
          case 6: orow = c; ocol = H - 1 - r; break;
          case 7: orow = W - 1 - c; ocol = H - 1 - r; break;
          default: orow = W - 1 - c; ocol = r; break;
        }
        return (orow * out_w + ocol) * 3;
      };
      const int64_t base = at(0), step = W > 1 ? at(1) - base : 0;
      for (int64_t c = 0; c < W; c++) std::memcpy(out + base + c * step, &line[c * 3], 3);
    }
  }
};

template <class T>
void size_of(const T& t, int32_t* height, int32_t* width) {
  // the caller's check_size refuses what does not fit
  *height = static_cast<int32_t>(std::min<int64_t>(t.height, INT32_MAX));
  *width = static_cast<int32_t>(std::min<int64_t>(t.width, INT32_MAX));
}

// TIFF's size and decode calls; `path`: Tiff's path route
int tiff_size(const uint8_t* data, int64_t n, bool path, int32_t* height,
              int32_t* width, char* msg, int32_t msg_len) {
  return guarded("TIFF", msg, msg_len, [&] {
    Tiff t(data, n, path);
    *height = static_cast<int32_t>(std::min<int64_t>(t.out_h, INT32_MAX));
    *width = static_cast<int32_t>(std::min<int64_t>(t.out_w, INT32_MAX));
  });
}

int tiff_decode(const uint8_t* data, int64_t n, bool path, uint8_t* out,
                int32_t height, int32_t width, char* msg, int32_t msg_len) {
  return guarded("TIFF", msg, msg_len, [&] {
    Tiff t(data, n, path);
    if (t.out_h != height || t.out_w != width) corrupt("TIFF: the image's size changed");
    t.decode(out);
  });
}

}  // namespace

namespace mrt {

// zlib's CRC-32 (the gzip trailer's)
static uint32_t crc32(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static const bool ready = [] {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)ready;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

void gzip_decompress(const uint8_t* d, int64_t n, const char* what, std::vector<uint8_t>& out) {
  const std::string w(what);
  out.clear();
  int64_t pos = 0;
  for (;;) {
    // gzip._read_gzip_header: no bytes left ends the data
    if (pos >= n) return;
    if (n - pos < 2 || d[pos] != 0x1F || d[pos + 1] != 0x8B) corrupt(w + ": Not a gzipped file");
    pos += 2;
    if (n - pos < 8) corrupt(w + ": Compressed file ended before the end-of-stream marker was reached");
    const int method = d[pos], flag = d[pos + 1];
    pos += 8;
    if (method != 8) corrupt(w + ": Unknown compression method");
    if (flag & 4) {  // FEXTRA
      if (n - pos < 2) corrupt(w + ": Compressed file ended before the end-of-stream marker was reached");
      const int64_t extra = d[pos] | (d[pos + 1] << 8);
      pos += 2;
      if (n - pos < extra) corrupt(w + ": Compressed file ended before the end-of-stream marker was reached");
      pos += extra;
    }
    for (int field = 8; field <= 16; field += 8) {  // FNAME, FCOMMENT
      if (flag & field)
        while (pos < n && d[pos++] != 0) {
        }
    }
    if (flag & 2) {  // FHCRC
      if (n - pos < 2) corrupt(w + ": Compressed file ended before the end-of-stream marker was reached");
      pos += 2;
    }
    std::vector<uint8_t> member;
    const int64_t end = Inflater(d + pos, n - pos, what).run_raw(member);
    pos += end;
    if (n - pos < 8) corrupt(w + ": Compressed file ended before the end-of-stream marker was reached");
    const uint32_t crc = d[pos] | (d[pos + 1] << 8) | (d[pos + 2] << 16) | (uint32_t(d[pos + 3]) << 24);
    const uint32_t size = d[pos + 4] | (d[pos + 5] << 8) | (d[pos + 6] << 16) | (uint32_t(d[pos + 7]) << 24);
    if (crc != crc32(member.data(), member.size())) corrupt(w + ": CRC check failed");
    if (size != static_cast<uint32_t>(member.size())) corrupt(w + ": Incorrect length of data produced");
    out.insert(out.end(), member.begin(), member.end());
    pos += 8;
    while (pos < n && d[pos] == 0) pos++;
  }
}

}  // namespace mrt

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
  return guarded("JPEG", msg, msg_len,
                 [&] { jpeg_entry(data, n, out, height, width, false); });
}

// BLP1's JPEG: mrt_jpeg_decode with jpeg_color_space CMYK where the frame
// has 4 components (Jpeg::force_cmyk)
int mrt_jpeg_decode_cmyk(const uint8_t* data, int64_t n, uint8_t* out, int32_t height,
                         int32_t width, char* msg, int32_t msg_len) {
  return guarded("JPEG", msg, msg_len,
                 [&] { jpeg_entry(data, n, out, height, width, true); });
}

// A PNG's image data (all IDAT chunks, still deflated) to out
// [height, width, 3]. palette: `entries` RGB triples or null.
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
  return guarded("BMP", msg, msg_len, [&] {
    Bmp b(data, n);
    if (b.width != width || b.height != height) corrupt("BMP: the image's size changed");
    decode_bmp(b, data, n, out, b.height);
  });
}

// A DIB header at `at` (no file header), as Pillow reads one: kind 0 a DIB
// file (BmpImagePlugin's DIB plugin); 1 an ICO frame (IcoFile.frame: the
// height halved as int(h / 2), then the frame's AND mask, or for an entry
// of 32 bits a pixel (`bpp32`) its alpha bytes, read as Pillow reads them
// and a ValueError where they are short: `mask_end` the entry's offset
// plus its size); 2 a CUR frame (CurImageFile: the height halved, h // 2).
// The size call gives the image's size, the decode call the pixels.
int mrt_dib_size(const uint8_t* data, int64_t n, int32_t* height,
                 int32_t* width, char* msg, int32_t msg_len, int64_t at,
                 int32_t kind, int64_t mask_end, int32_t bpp32) {
  (void)mask_end;
  (void)bpp32;
  return guarded("DIB", msg, msg_len, [&] {
    Bmp b(data, n, at);
    if (kind != 0) b.height /= 2;
    size_of(b, height, width);
  });
}

int mrt_dib_decode(const uint8_t* data, int64_t n, uint8_t* out,
                   int32_t height, int32_t width, char* msg, int32_t msg_len,
                   int64_t at, int32_t kind, int64_t mask_end, int32_t bpp32) {
  return guarded("DIB", msg, msg_len, [&] {
    Bmp b(data, n, at);
    const int64_t h = kind != 0 ? b.height / 2 : b.height, w = b.width;
    if (w != width || h != height) corrupt("DIB: the image's size changed");
    if (kind == 1) {
      if (bpp32) {
        // the alpha bytes: every 4th of w * h * 4 from the pixel data
        if (b.offset < 0 || b.offset > n || (n - b.offset) / 4 < w * h)
          corrupt("ICO: buffer is not large enough for the alpha mask");
      } else {
        // Pillow reads total bytes and decodes them as "1;I" rows of
        // padded / 8 bytes: the last row needs no padding
        const int64_t padded = (w + 31) / 32 * 32;
        const int64_t total = padded * h / 8;
        const int64_t start = mask_end - total;
        const int64_t need = (h - 1) * (padded / 8) + (w + 7) / 8;
        if (start < 0) corrupt("ICO: negative seek value for the AND mask");
        if (start > n || n - start < need)
          corrupt("ICO: not enough image data in the AND mask");
      }
    }
    decode_bmp(b, data, n, out, h);
  });
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

// TIFF: the first image's size after its orientation, then the whole
// decode into out [height, width, 3] (that size, checked again); `path`
// nonzero reads a file Pillow opens from a path (its memory map where it
// takes one: Tiff::map_stride).
int mrt_tiff_size(const uint8_t* data, int64_t n, int32_t* height,
                  int32_t* width, char* msg, int32_t msg_len, int32_t path) {
  return tiff_size(data, n, path != 0, height, width, msg, msg_len);
}

int mrt_tiff_decode(const uint8_t* data, int64_t n, uint8_t* out,
                    int32_t height, int32_t width, char* msg,
                    int32_t msg_len, int32_t path) {
  return tiff_decode(data, n, path != 0, out, height, width, msg, msg_len);
}

// LittleCMS's LAB -> sRGB table (lab_to_rgb), 33³ nodes of R, G, B
void mrt_lab_clut(const uint16_t* table) {
  std::memcpy(g_lab_clut, table, sizeof(g_lab_clut));
  g_lab_ready = true;
}

// Pillow's LAB -> RGB of n LAB pixels (the image's bytes: L, a + 128,
// b + 128) into n RGB triples
int mrt_lab_rgb(const uint8_t* lab, int64_t n, uint8_t* rgb, char* msg, int32_t msg_len) {
  return guarded("LAB", msg, msg_len, [&] {
    if (!g_lab_ready) refuse("LAB: no LittleCMS table set (mrt_lab_clut)");
    for (int64_t i = 0; i < n; i++, lab += 3, rgb += 3) {
      const uint32_t c = lab_to_rgb(lab[0], lab[1], lab[2]);
      rgb[0] = static_cast<uint8_t>(c);
      rgb[1] = static_cast<uint8_t>(c >> 8);
      rgb[2] = static_cast<uint8_t>(c >> 16);
    }
  });
}

// A whole zlib stream (its end and Adler-32 checked), PNG's and TIFF's
// inflate, into at most cap bytes: *len the bytes it holds.
int mrt_zlib_inflate(const uint8_t* data, int64_t n, uint8_t* out,
                     int64_t cap, int64_t* len, char* msg, int32_t msg_len) {
  return guarded("zlib", msg, msg_len, [&] {
    std::vector<uint8_t> v(static_cast<size_t>(std::max<int64_t>(cap, 1)));
    Inflater(data, n, "zlib").run(v);
    if (static_cast<int64_t>(v.size()) > cap) corrupt("zlib: more data than the output holds");
    std::memcpy(out, v.data(), v.size());
    *len = static_cast<int64_t>(v.size());
  });
}

}  // extern "C"
