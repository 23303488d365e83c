// JPEG 2000 (ISO 15444-1) as Pillow 12.1's Jpeg2KImagePlugin reads it
// over OpenJPEG 2.5.4: JP2 files and raw codestreams, decoded as
// OpenJPEG's tile API decodes them (opj_read_header, then
// opj_read_tile_header / opj_decode_tile_data for each tile and
// opj_end_decompress, single-threaded, in strict mode), each tile then
// unpacked by Pillow's Jpeg2KDecode.c into the mode Jpeg2KImageFile._open
// gave the file, and that image converted to RGB as convert("RGB") does.
//
// What is ported, in OpenJPEG's order of work:
// * the JP2 boxes opj_jp2_read_header_procedure reads (signature, ftyp,
//   jp2h with ihdr, colr, bpcc, pclr, cmap and cdef, jp2c) and the boxes
//   opj_jp2_end_decompress reads past the codestream; the colour space
//   OpenJPEG gives Pillow (colr's enumerated space, or none);
// * the main and tile-part header markers (SIZ, COD, COC, QCD, QCC, RGN,
//   POC, PPM, PPT, TLM, PLM, PLT, CRG, COM, CPF, SOT, SOD, EOC and the
//   unknown-marker scan) with j2k.c's checks and its tile-part
//   bookkeeping over Pillow's stream (which cannot seek);
// * tcd.c's geometry (tiles, offsets, subsampling, resolutions, bands,
//   precincts, code-blocks) and quantisation step sizes;
// * pi.c's packet iterators (LRCP, RLCP, RPCL, PCRL, CPRL and POC
//   changes, packets already read skipped) and t2.c's packet headers
//   (tag trees, pass counts, Lblock, segment lengths with BYPASS and
//   TERMALL, SOP and EPH, headers in PPM or PPT) and bodies;
// * t1.c's EBCOT decoder: the MQ decoder with its 47 states, the
//   significance, refinement and cleanup passes, run-length coding,
//   raw (BYPASS) passes, RESET, VSC, SEGSYM, RGN max-shift, the half-bit
//   reconstruction and the division by 2 of reversible coefficients;
// * HTJ2K (ISO 15444-15) code-blocks, code-block style 0x40: t2.c's HT
//   segments (the cleanup pass alone in the first segment, every later
//   pass of a packet in the next, over OpenJPEG's Part-1 segment limits)
//   and ht_dec.c's block decoder (jpeg2000_ht.cpp);
// * dwt.c's 5/3 (integer) and 9/7 (float: its lifting constants and
//   order of operations) inverse transforms, mct.c's RCT and ICT, the DC
//   level shift, lrintf and the clamp to each component's precision;
// * Pillow's unpackers (its shifts and offsets, its subsampled-component
//   indexing, its YCbCr -> RGB for sYCC) and convert("RGB").
// Built without floating-point contraction (-ffp-contract=off): the 9/7
// path must round each product and sum as OpenJPEG's SSE code does.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "image_codec.h"

namespace {

using mrt::corrupt;
using mrt::guarded;

[[noreturn]] void fail(const std::string& m) { corrupt("JPEG2000: " + m); }

inline uint32_t be16(const uint8_t* p) { return (uint32_t(p[0]) << 8) | p[1]; }
inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}
inline uint32_t be_n(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; i++) v = (v << 8) | p[i];
  return v;
}

// ------------------------------------------------------------------ stream
// opj_stream over the whole file (Pillow's stream: its length is the file's)
struct Stream {
  const uint8_t* d;
  uint64_t n;
  uint64_t pos = 0;
  uint64_t left() const { return n - pos; }
  uint64_t read(uint8_t* out, uint64_t k) {
    const uint64_t m = std::min(k, left());
    if (out && m) std::memcpy(out, d + pos, m);
    pos += m;
    return m;
  }
  // opj_stream_skip: the bytes skipped, -1 where none could be
  int64_t skip(uint64_t k) {
    if (k > left()) {
      const uint64_t m = left();
      pos = n;
      return m ? int64_t(m) : -1;
    }
    pos += k;
    return int64_t(k);
  }
};

// ---------------------------------------------------------------- JP2 boxes
constexpr uint32_t kBoxJp = 0x6a502020, kBoxFtyp = 0x66747970, kBoxJp2h = 0x6a703268,
                   kBoxJp2c = 0x6a703263, kBoxIhdr = 0x69686472, kBoxColr = 0x636f6c72,
                   kBoxBpcc = 0x62706363, kBoxPclr = 0x70636c72, kBoxCmap = 0x636d6170,
                   kBoxCdef = 0x63646566;
constexpr uint32_t kJp2Signature = 1, kJp2FileType = 2, kJp2Header = 4, kJp2Codestream = 8;

bool img_box(uint32_t t) {
  return t == kBoxIhdr || t == kBoxColr || t == kBoxBpcc || t == kBoxPclr || t == kBoxCmap ||
         t == kBoxCdef;
}

// opj_jp2_t's header state
struct Jp2 {
  uint32_t state = 0;
  bool has_jp2h = false, has_ihdr = false, comps = false;
  uint32_t w = 0, h = 0, numcomps = 0;
  bool has_colr = false;
  uint32_t meth = 0, enumcs = 0;
  bool pclr = false, cmap = false, cdef = false;
  uint32_t pclr_channels = 0;

  void ihdr(const uint8_t* p, uint32_t n) {
    if (comps) return;  // "Ignoring ihdr box. First ihdr box already read"
    if (n != 14) fail("bad image header box (bad size)");
    h = be32(p);
    w = be32(p + 4);
    numcomps = be16(p + 8);
    if (h < 1 || w < 1 || numcomps < 1) fail("wrong values in the ihdr box");
    if (numcomps - 1 >= 16384) fail("invalid number of components (ihdr)");
    comps = true;
    has_ihdr = true;
  }

  void colr(const uint8_t* p, uint32_t n) {
    if (n < 3) fail("bad COLR header box (bad size)");
    if (has_colr) return;  // the first colour box counts
    const uint32_t m = p[0];
    if (m == 1) {
      if (n < 7) fail("bad COLR header box (bad size)");
      meth = 1;
      enumcs = be32(p + 3);
      has_colr = true;
    } else if (m == 2) {
      meth = 2;  // an ICC profile: no enumerated space
      has_colr = true;
    }
  }

  void bpcc(uint32_t n) {
    if (n != numcomps) fail("bad BPCC header box (bad size)");
  }

  void read_pclr(const uint8_t* p, uint32_t n) {
    if (pclr) fail("a second pclr box");
    if (n < 3) fail("a pclr box too short");
    const uint32_t entries = be16(p), channels = p[2];
    if (entries == 0 || entries > 1024) fail("invalid PCLR box entries");
    if (channels == 0) fail("invalid PCLR box: 0 palette columns");
    if (n < 3 + channels) fail("a pclr box too short");
    uint64_t at = 3 + channels;
    for (uint32_t j = 0; j < entries; j++) {
      for (uint32_t i = 0; i < channels; i++) {
        uint32_t bytes = ((p[3 + i] & 0x7f) + 1 + 7) >> 3;
        bytes = std::min<uint32_t>(bytes, 4);
        if (n < at + bytes) fail("a pclr box too short");
        at += bytes;
      }
    }
    pclr = true;
    pclr_channels = channels;
  }

  void read_cmap(uint32_t n) {
    if (!pclr) fail("need to read a PCLR box before the CMAP box");
    if (cmap) fail("only one CMAP box is allowed");
    if (n < pclr_channels * 4) fail("insufficient data for CMAP box");
    cmap = true;
  }

  void read_cdef(const uint8_t* p, uint32_t n) {
    if (cdef) fail("a second cdef box");
    if (n < 2) fail("insufficient data for CDEF box");
    const uint32_t k = be16(p);
    if (k == 0) fail("no channel description in the CDEF box");
    if (n < 2 + k * 6) fail("insufficient data for CDEF box");
    cdef = true;
  }

  void img(uint32_t type, const uint8_t* p, uint32_t n) {
    switch (type) {
      case kBoxIhdr: ihdr(p, n); break;
      case kBoxColr: colr(p, n); break;
      case kBoxBpcc: bpcc(n); break;
      case kBoxPclr: read_pclr(p, n); break;
      case kBoxCmap: read_cmap(n); break;
      default: read_cdef(p, n); break;
    }
  }

  // opj_jp2_read_jp2h
  void jp2h(const uint8_t* p, uint32_t n) {
    if ((state & kJp2FileType) != kJp2FileType) fail("the jp2h box is misplaced");
    bool seen_ihdr = false;
    while (n > 0) {
      if (n < 8) fail("cannot handle box of less than 8 bytes");
      uint32_t length = be32(p), type = be32(p + 4), head = 8;
      if (length == 1) {
        if (n < 16) fail("cannot handle XL box of less than 16 bytes");
        if (be32(p + 8) != 0) fail("cannot handle box sizes higher than 2^32");
        length = be32(p + 12);
        head = 16;
        if (length == 0) fail("cannot handle box of undefined sizes");
      } else if (length == 0) {
        fail("cannot handle box of undefined sizes");
      }
      if (length < head) fail("box length is inconsistent");
      if (length > n) fail("JP2 header box: box length is inconsistent");
      if (img_box(type)) img(type, p + head, length - head);
      if (type == kBoxIhdr) seen_ihdr = true;
      p += length;
      n -= length;
    }
    if (!seen_ihdr) fail("JP2 header box: no ihdr box");
    state |= kJp2Header;
    has_jp2h = true;
  }

  void top(uint32_t type, const uint8_t* p, uint32_t n) {
    if (type == kBoxJp) {
      if (state != 0) fail("the signature box must be the first box in the file");
      if (n != 4) fail("error with JP signature box size");
      if (be32(p) != 0x0d0a870a) fail("bad JP2 signature");
      state |= kJp2Signature;
    } else if (type == kBoxFtyp) {
      if (state != kJp2Signature) fail("the ftyp box must be the second box in the file");
      if (n < 8 || ((n - 8) & 3)) fail("error with FTYP box size");
      state |= kJp2FileType;
    } else if (type == kBoxJp2h) {
      jp2h(p, n);
    } else {
      img(type, p, n);
    }
  }

  // opj_jp2_read_header_procedure: true where it stops at the codestream
  // box (the stream then at the codestream), else at the stream's end
  bool boxes(Stream& s) {
    for (;;) {
      uint8_t hd[8];
      uint64_t got = s.read(hd, 8);
      if (got != 8) return false;
      uint64_t length = be32(hd);
      const uint32_t type = be32(hd + 4);
      if (length == 0) {
        if (s.left() > 0xFFFFFFFFull - 8) fail("cannot handle box sizes higher than 2^32");
        length = s.left() + 8;
      } else if (length == 1) {
        const uint64_t more = s.read(hd, 8);
        if (more != 8) return false;
        got = 16;
        if (be32(hd) != 0) fail("cannot handle box sizes higher than 2^32");
        length = be32(hd + 4);
      }
      if (type == kBoxJp2c) {
        if (!(state & kJp2Header)) fail("bad placed JPEG 2000 codestream");
        state |= kJp2Codestream;
        return true;
      }
      if (length == 0) fail("cannot handle box of undefined sizes");
      if (length < got) fail("invalid box size");
      const uint64_t size = length - got;
      const bool top_handler = type == kBoxJp || type == kBoxFtyp || type == kBoxJp2h;
      if (top_handler || img_box(type)) {
        if (!top_handler && !(state & kJp2Header)) {
          // an image box before jp2h: skipped
          if (s.skip(size) != int64_t(size)) fail("problem with skipping a JPEG 2000 box");
          continue;
        }
        if (size > s.left()) fail("invalid box size");
        const uint8_t* body = s.d + s.pos;
        s.pos += size;
        top(type, body, uint32_t(size));
      } else {
        if (!(state & kJp2Signature)) fail("first box must be the JPEG 2000 signature box");
        if (!(state & kJp2FileType)) fail("second box must be the file type box");
        if (s.skip(size) != int64_t(size)) {
          if (state & kJp2Codestream) return false;
          fail("problem with skipping a JPEG 2000 box");
        }
      }
    }
  }

  // OpenJPEG's colour space from the colr box: 1 sRGB, 2 gray, 3 sYCC,
  // 4 e-YCC, 5 CMYK, 0 unspecified (no enumerated space, or another one)
  int color_space() const {
    switch (enumcs) {
      case 16: return 1;
      case 17: return 2;
      case 18: return 3;
      case 24: return 4;
      case 12: return 5;
      default: return 0;
    }
  }
};

// -------------------------------------------------------------- codestream
constexpr uint32_t kSOT = 0xFF90, kSOD = 0xFF93, kEOC = 0xFFD9, kSIZ = 0xFF51, kCOD = 0xFF52,
                   kCOC = 0xFF53, kRGN = 0xFF5E, kQCD = 0xFF5C, kQCC = 0xFF5D, kPOC = 0xFF5F,
                   kTLM = 0xFF55, kPLM = 0xFF57, kPLT = 0xFF58, kPPM = 0xFF60, kPPT = 0xFF61,
                   kSOP = 0xFF91, kCRG = 0xFF63, kCOM = 0xFF64, kCBD = 0xFF78, kMCT = 0xFF74,
                   kMCC = 0xFF75, kMCO = 0xFF77, kCAP = 0xFF50, kCPF = 0xFF59;
// j2k.c's decoder states
constexpr uint32_t kMHSIZ = 0x2, kMH = 0x4, kTPHSOT = 0x8, kTPH = 0x10, kNEOC = 0x40,
                   kDATA = 0x80, kStateEOC = 0x100;
constexpr uint32_t kUnknown = 0;  // the handler of every other marker

// j2k_memory_marker_handler_tab: the states a marker may be read in (the
// unknown handler's for every marker not listed)
uint32_t marker_states(uint32_t m, uint32_t* id) {
  *id = m;
  switch (m) {
    case kSOT: return kMH | kTPHSOT;
    case kCOD: case kCOC: case kRGN: case kQCD: case kQCC: case kPOC: case kCOM: case kMCT:
    case kMCC: case kMCO: return kMH | kTPH;
    case kSIZ: return kMHSIZ;
    case kTLM: case kPLM: case kPPM: case kCRG: case kCBD: case kCAP: case kCPF: return kMH;
    case kPLT: case kPPT: return kTPH;
    case kSOP: return 0;
    default: *id = kUnknown; return kMH | kTPH;
  }
}

struct Step {
  int32_t expn = 0, mant = 0;
};

struct Tccp {
  uint32_t csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
  uint32_t qntsty = 0, numgbits = 0, roishift = 0;
  int32_t dc_shift = 0;
  Step steps[97];
  uint32_t prcw[33] = {}, prch[33] = {};
};

struct Poc {
  uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0, prg = 0;
};

// the bytes of numbered PPM or PPT marker segments (Zppm, Zppt)
struct Ppx {
  std::vector<std::vector<uint8_t>> data;
  std::vector<bool> present;
  void add(uint32_t z, const uint8_t* p, uint32_t n, const char* what) {
    if (present.size() <= z) {
      present.resize(z + 1, false);
      data.resize(z + 1);
    }
    if (present[z]) fail(std::string(what) + " index already read");
    present[z] = true;
    data[z].assign(p, p + n);
  }
};

// Part-2 multi-component transform records (opj_mct_data_t and
// opj_simple_mcc_decorrelation_data_t; an MCC's arrays by their place
// among the MCT records, -1 for none)
struct MctRecord {
  uint32_t index = 0, array_type = 0, element_type = 0;
  std::vector<uint8_t> data;
};
struct MccRecord {
  uint32_t index = 0, nb_comps = 0;
  int32_t deco = -1, offset = -1;
};

struct Tcp {
  uint32_t csty = 0, numlayers = 0, mct = 0;
  std::vector<MctRecord> mct_records;
  // OpenJPEG's array of MCC records: the first nb_mcc are read, the slot
  // after them keeps what a collection read in part left there
  std::vector<MccRecord> mcc_records;
  uint32_t nb_mcc = 0;
  int32_t prg = 0;
  bool cod = false, poc = false;
  uint32_t numpocs = 0;
  Poc pocs[32];
  std::vector<Tccp> tccps;
  bool ppt = false;
  Ppx ppt_markers;
  std::vector<uint8_t> ppt_data;
  uint64_t ppt_pos = 0;
  std::vector<uint8_t> data;
  bool has_data = false;
  int32_t part = -1;
  uint32_t nb_parts = 0;
};

struct Comp {
  uint32_t dx = 1, dy = 1, prec = 8, sgnd = 0;
  uint32_t resno_decoded = 0;
};

// The codestream's headers as j2k.c reads them, and its tile-part walk.
struct Codestream {
  Stream& s;
  explicit Codestream(Stream& st) : s(st) {}
  uint32_t state = 0;
  // SIZ
  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;
  uint32_t tw = 0, th = 0, numcomps = 0;
  std::vector<Comp> comps;
  uint32_t ihdr_w = 0, ihdr_h = 0;
  Tcp deflt;
  std::vector<std::unique_ptr<Tcp>> tcps;
  bool ppm = false;
  Ppx ppm_markers;
  std::vector<uint8_t> ppm_data;
  uint64_t ppm_pos = 0;
  // the tile-part walk
  uint32_t tile = 0;
  uint64_t sot_length = 0;
  bool last_tile_part = false, can_decode = false;

  uint32_t nb_tiles() const { return tw * th; }
  Tcp& tcp_of(uint32_t t) {
    if (!tcps[t]) {
      tcps[t].reset(new Tcp(deflt));
      tcps[t]->cod = false;
      tcps[t]->ppt = false;
      tcps[t]->part = -1;
    }
    return *tcps[t];
  }
  Tcp& cur() { return state == kTPH ? tcp_of(tile) : deflt; }

  uint32_t read16() {
    uint8_t b[2];
    if (s.read(b, 2) != 2) fail("stream too short");
    return be16(b);
  }

  // ---------------------------------------------------------------- SIZ
  void siz(const uint8_t* p, uint32_t n) {
    if (n < 36 || (n - 36) % 3) fail("error with SIZ marker size");
    const uint32_t nb = (n - 36) / 3;
    x1 = be32(p + 2);
    y1 = be32(p + 6);
    x0 = be32(p + 10);
    y0 = be32(p + 14);
    tdx = be32(p + 18);
    tdy = be32(p + 22);
    tx0 = be32(p + 26);
    ty0 = be32(p + 30);
    const uint32_t csiz = be16(p + 34);
    if (csiz >= 16385) fail("SIZ: illegal number of components");
    if (csiz != nb) fail("SIZ: number of components does not match its length");
    if (x0 >= x1 || y0 >= y1) fail("SIZ: negative or zero image size");
    if (tdx == 0 || tdy == 0) fail("SIZ: invalid tile size");
    const uint64_t tx1 = std::min<uint64_t>(uint64_t(tx0) + tdx, 0xFFFFFFFFu);
    const uint64_t ty1 = std::min<uint64_t>(uint64_t(ty0) + tdy, 0xFFFFFFFFu);
    if (tx0 > x0 || ty0 > y0 || tx1 <= x0 || ty1 <= y0) fail("SIZ: illegal tile offset");
    if (ihdr_w > 0 && ihdr_h > 0 && (ihdr_w != x1 - x0 || ihdr_h != y1 - y0))
      fail("SIZ: the image size differs from the ihdr box's");
    // Pillow takes at most 4 components; OpenJPEG's own allocations for
    // more are not modelled (Pillow fails on them either way)
    if (csiz > 4) fail("more than 4 components");
    numcomps = csiz;
    comps.resize(csiz);
    for (uint32_t i = 0; i < csiz; i++) {
      const uint8_t* c = p + 36 + 3 * i;
      comps[i].prec = (c[0] & 0x7f) + 1;
      comps[i].sgnd = c[0] >> 7;
      comps[i].dx = c[1];
      comps[i].dy = c[2];
      if (c[1] < 1 || c[2] < 1) fail("SIZ: invalid component subsampling");
      if (comps[i].prec > 31) fail("SIZ: precision above 31 bits");
    }
    tw = uint32_t((uint64_t(x1) - tx0 + tdx - 1) / tdx);
    th = uint32_t((uint64_t(y1) - ty0 + tdy - 1) / tdy);
    if (tw == 0 || th == 0 || tw > 65535 / th) fail("invalid number of tiles");
    deflt.tccps.assign(csiz, Tccp());
    for (uint32_t i = 0; i < csiz; i++)
      if (!comps[i].sgnd) deflt.tccps[i].dc_shift = int32_t(1u << (comps[i].prec - 1));
    tcps.clear();
    tcps.resize(size_t(tw) * th);
    state = kMH;
  }

  // ------------------------------------------------------------ COD, COC
  void spcod(uint32_t compno, const uint8_t* p, uint32_t& n) {
    Tcp& t = cur();
    if (compno >= numcomps) fail("bad component in COD/COC");
    Tccp& c = t.tccps[compno];
    if (n < 5) fail("error reading SPCod SPCoc element");
    c.numres = p[0] + 1u;
    if (c.numres > 33) fail("invalid number of resolutions");
    c.cblkw = p[1] + 2u;
    c.cblkh = p[2] + 2u;
    if (c.cblkw > 10 || c.cblkh > 10 || c.cblkw + c.cblkh > 12)
      fail("invalid code-block width and height");
    c.cblksty = p[3];
    if (c.cblksty & 0x80) fail("unsupported mixed HT code-block style");
    c.qmfbid = p[4];
    if (c.qmfbid > 1) fail("invalid wavelet transformation");
    n -= 5;
    if (c.csty & 1) {
      if (n < c.numres) fail("error reading SPCod SPCoc element");
      for (uint32_t i = 0; i < c.numres; i++) {
        const uint32_t v = p[5 + i];
        if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) fail("invalid precinct size");
        c.prcw[i] = v & 0xf;
        c.prch[i] = v >> 4;
      }
      n -= c.numres;
    } else {
      for (uint32_t i = 0; i < c.numres; i++) c.prcw[i] = c.prch[i] = 15;
    }
  }

  void cod(const uint8_t* p, uint32_t n) {
    Tcp& t = cur();
    if (t.cod) return;  // the first COD of a tile counts
    t.cod = true;
    if (n < 5) fail("error reading COD marker");
    t.csty = p[0];
    if (t.csty & ~7u) fail("unknown Scod value in COD marker");
    t.prg = p[1];
    if (t.prg > 4) t.prg = -1;
    t.numlayers = be16(p + 2);
    if (t.numlayers < 1) fail("invalid number of layers in COD marker");
    t.mct = p[4];
    if (t.mct > 1) fail("invalid multiple component transformation");
    n -= 5;
    for (auto& c : t.tccps) c.csty = t.csty & 1;
    spcod(0, p + 5, n);
    if (n != 0) fail("error reading COD marker");
    // opj_j2k_copy_tile_component_parameters
    const Tccp& a = t.tccps[0];
    for (uint32_t i = 1; i < numcomps; i++) {
      Tccp& c = t.tccps[i];
      c.numres = a.numres;
      c.cblkw = a.cblkw;
      c.cblkh = a.cblkh;
      c.cblksty = a.cblksty;
      c.qmfbid = a.qmfbid;
      std::memcpy(c.prcw, a.prcw, sizeof(c.prcw));
      std::memcpy(c.prch, a.prch, sizeof(c.prch));
    }
  }

  uint32_t comp_room() const { return numcomps <= 256 ? 1 : 2; }

  void coc(const uint8_t* p, uint32_t n) {
    Tcp& t = cur();
    const uint32_t room = comp_room();
    if (n < room + 1) fail("error reading COC marker");
    n -= room + 1;
    const uint32_t compno = be_n(p, int(room));
    if (compno >= numcomps) fail("error reading COC marker (bad number of components)");
    t.tccps[compno].csty = p[room];
    spcod(compno, p + room + 1, n);
    if (n != 0) fail("error reading COC marker");
  }

  // ------------------------------------------------------------ QCD, QCC
  void sqcd(uint32_t compno, const uint8_t* p, uint32_t& n) {
    Tcp& t = cur();
    if (compno >= numcomps) fail("bad component in QCD/QCC");
    Tccp& c = t.tccps[compno];
    if (n < 1) fail("error reading SQcd or SQcc element");
    n -= 1;
    c.qntsty = p[0] & 0x1f;
    c.numgbits = p[0] >> 5;
    ++p;
    uint32_t bands;
    if (c.qntsty == 1) {
      bands = 1;
    } else {
      bands = c.qntsty == 0 ? n : n / 2;
    }
    if (c.qntsty == 0) {
      for (uint32_t b = 0; b < bands; b++)
        if (b < 97) c.steps[b] = Step{int32_t(p[b] >> 3), 0};
      if (n < bands) fail("error reading SQcd or SQcc element");
      n -= bands;
    } else {
      if (n < 2 * bands) fail("error reading SQcd or SQcc element");
      for (uint32_t b = 0; b < bands; b++) {
        const uint32_t v = be16(p + 2 * b);
        if (b < 97) c.steps[b] = Step{int32_t(v >> 11), int32_t(v & 0x7ff)};
      }
      n -= 2 * bands;
    }
    if (c.qntsty == 1) {
      for (uint32_t b = 1; b < 97; b++) {
        const int32_t e = c.steps[0].expn - int32_t((b - 1) / 3);
        c.steps[b] = Step{e > 0 ? e : 0, c.steps[0].mant};
      }
    }
  }

  void qcd(const uint8_t* p, uint32_t n) {
    sqcd(0, p, n);
    if (n != 0) fail("error reading QCD marker");
    Tcp& t = cur();
    const Tccp& a = t.tccps[0];
    for (uint32_t i = 1; i < numcomps; i++) {
      Tccp& c = t.tccps[i];
      c.qntsty = a.qntsty;
      c.numgbits = a.numgbits;
      std::memcpy(c.steps, a.steps, sizeof(c.steps));
    }
  }

  void qcc(const uint8_t* p, uint32_t n) {
    const uint32_t room = comp_room();
    if (n < room) fail("error reading QCC marker");
    const uint32_t compno = be_n(p, int(room));
    n -= room;
    if (compno >= numcomps) fail("invalid component number in QCC");
    sqcd(compno, p + room, n);
    if (n != 0) fail("error reading QCC marker");
  }

  // ------------------------------------------------------ RGN, POC, ...
  void rgn(const uint8_t* p, uint32_t n) {
    const uint32_t room = comp_room();
    if (n != 2 + room) fail("error reading RGN marker");
    Tcp& t = cur();
    const uint32_t compno = be_n(p, int(room));
    if (compno >= numcomps) fail("bad component number in RGN");
    t.tccps[compno].roishift = p[room + 1];
  }

  void poc(const uint8_t* p, uint32_t n) {
    const uint32_t room = comp_room();
    const uint32_t chunk = 5 + 2 * room;
    uint32_t count = n / chunk;
    if (count == 0 || n % chunk) fail("error reading POC marker");
    Tcp& t = cur();
    const uint32_t old = t.poc ? t.numpocs + 1 : 0;
    count += old;
    if (count >= 32) fail("too many POCs");
    t.poc = true;
    for (uint32_t i = old; i < count; i++) {
      Poc& c = t.pocs[i];
      c.resno0 = p[0];
      c.compno0 = be_n(p + 1, int(room));
      c.layno1 = std::min(be16(p + 1 + room), t.numlayers);
      c.resno1 = p[3 + room];
      c.compno1 = std::min(be_n(p + 4 + room, int(room)), numcomps);
      c.prg = p[4 + 2 * room];
      p += chunk;
    }
    t.numpocs = count - 1;
  }

  void tlm(const uint8_t* p, uint32_t n) {
    if (n < 2) fail("error reading TLM marker");
    n -= 2;
    const uint32_t st = (p[1] >> 4) & 3, sp = (p[1] >> 6) & 1;
    if (st == 3) fail("TLM: ST = 3 is invalid");
    if (n % ((sp + 1) * 2 + st)) fail("error reading TLM marker");
  }

  void plt(const uint8_t* p, uint32_t n) {
    if (n < 1) fail("error reading PLT marker");
    uint32_t len = 0;
    for (uint32_t i = 1; i < n; i++) {
      len |= p[i] & 0x7f;
      if (p[i] & 0x80) {
        len <<= 7;
      } else {
        len = 0;
      }
    }
    if (len != 0) fail("error reading PLT marker");
  }

  void ppm_marker(const uint8_t* p, uint32_t n) {
    if (n < 2) fail("error reading PPM marker");
    ppm = true;
    ppm_markers.add(p[0], p + 1, n - 1, "Zppm");
  }

  void ppt_marker(const uint8_t* p, uint32_t n) {
    if (n < 2) fail("error reading PPT marker");
    if (ppm) fail("PPT marker after a PPM marker");
    Tcp& t = tcp_of(tile);
    t.ppt = true;
    t.ppt_markers.add(p[0], p + 1, n - 1, "Zppt");
  }

  // opj_j2k_merge_ppm: the Nppm fields taken out, every marker's headers
  // in one stream
  void merge_ppm() {
    if (!ppm) return;
    uint64_t total = 0, remaining = 0;
    for (int pass = 0; pass < 2; pass++) {
      remaining = 0;
      for (size_t i = 0; i < ppm_markers.present.size(); i++) {
        if (!ppm_markers.present[i]) continue;
        const std::vector<uint8_t>& m = ppm_markers.data[i];
        const uint8_t* d = m.data();
        uint64_t size = m.size();
        if (remaining >= size) {
          if (pass) ppm_data.insert(ppm_data.end(), d, d + size);
          remaining -= size;
          size = 0;
        } else {
          if (pass) ppm_data.insert(ppm_data.end(), d, d + remaining);
          d += remaining;
          size -= remaining;
          remaining = 0;
        }
        while (size > 0) {
          if (size < 4) fail("not enough bytes to read Nppm");
          const uint32_t nppm = be32(d);
          d += 4;
          size -= 4;
          if (!pass) {
            if (total > 0xFFFFFFFFull - nppm) fail("too large value for Nppm");
            total += nppm;
          }
          if (size >= nppm) {
            if (pass) ppm_data.insert(ppm_data.end(), d, d + nppm);
            size -= nppm;
            d += nppm;
          } else {
            if (pass) ppm_data.insert(ppm_data.end(), d, d + size);
            remaining = nppm - size;
            size = 0;
          }
        }
      }
      if (!pass) {
        if (remaining != 0) fail("corrupted PPM markers");
        ppm_data.reserve(total);
      }
    }
  }

  void merge_ppt(Tcp& t) {
    if (!t.ppt) return;
    t.ppt_data.clear();
    for (size_t i = 0; i < t.ppt_markers.present.size(); i++)
      if (t.ppt_markers.present[i])
        t.ppt_data.insert(t.ppt_data.end(), t.ppt_markers.data[i].begin(),
                          t.ppt_markers.data[i].end());
    t.ppt_markers = Ppx();
    t.ppt_pos = 0;
  }

  void sot(const uint8_t* p, uint32_t n) {
    if (n != 8) fail("error reading SOT marker");
    tile = be16(p);
    const uint32_t tot_len = be32(p + 2), part = p[6];
    uint32_t num_parts = p[7];
    if (tile >= nb_tiles()) fail("invalid tile number");
    Tcp& t = tcp_of(tile);
    if (t.part + 1 != int32_t(part)) fail("invalid tile part index");
    t.part = int32_t(part);
    // Psot is 0 (to the end), 12 (an empty tile-part: a warning) or >= 14
    if (tot_len != 0 && tot_len < 14 && tot_len != 12)
      fail("Psot value is not correct regards to the JPEG2000 norm");
    if (!tot_len) last_tile_part = true;
    if (t.nb_parts != 0 && part >= t.nb_parts) {
      last_tile_part = true;
      fail("TPsot is not valid regarding the number of tile-parts");
    }
    if (num_parts != 0) {
      if (t.nb_parts && part >= t.nb_parts) fail("TPsot is not valid");
      if (part >= num_parts) {
        last_tile_part = true;
        fail("TPsot is not valid regarding TNsot");
      }
      t.nb_parts = num_parts;
    }
    if (t.nb_parts && t.nb_parts == part + 1) can_decode = true;
    sot_length = last_tile_part ? 0 : uint32_t(tot_len - 12);
    state = kTPH;
  }

  // opj_j2k_read_cbd: each component's depth and signedness anew (the DC
  // level shift stays SIZ's)
  void cbd(const uint8_t* p, uint32_t n) {
    if (n != numcomps + 2 || be16(p) != numcomps) fail("Crror reading CBD marker");
    for (uint32_t i = 0; i < numcomps; i++) {
      comps[i].sgnd = p[2 + i] >> 7;
      comps[i].prec = (p[2 + i] & 0x7f) + 1u;
      if (comps[i].prec > 31) fail("CBD: precision above 31 bits");
    }
  }

  // opj_j2k_read_mct: one array of a Part-2 transform (a record of its
  // index, array and element types and data; a second part, Zmct or
  // Ymct, is skipped with a warning)
  void mct_marker(const uint8_t* p, uint32_t n) {
    Tcp& t = cur();
    if (n < 2) fail("Error reading MCT marker");
    if (be16(p) != 0) return;  // "mct data within multiple MCT records"
    if (n <= 6) fail("Error reading MCT marker");
    const uint32_t imct = be16(p + 2), index = imct & 0xff;
    size_t k = 0;
    while (k < t.mct_records.size() && t.mct_records[k].index != index) k++;
    if (k == t.mct_records.size()) t.mct_records.emplace_back();
    MctRecord& r = t.mct_records[k];
    r.data.clear();
    r.index = index;
    r.array_type = (imct >> 8) & 3;
    r.element_type = (imct >> 10) & 3;
    if (be16(p + 4) != 0) return;  // "multiple MCT markers": the record kept empty
    r.data.assign(p + 6, p + n);
  }

  // opj_j2k_read_mcc: one array-based decorrelation collection (a single
  // collection of components 0..n-1 in order; anything else is skipped
  // with a warning, what the fields read so far left in place)
  void mcc_marker(const uint8_t* p, uint32_t n) {
    Tcp& t = cur();
    if (n < 2) fail("Error reading MCC marker");
    if (be16(p) != 0) return;  // "multiple data spanning"
    if (n < 7) fail("Error reading MCC marker");
    const uint32_t index = p[2];
    uint32_t k = 0;
    while (k < t.nb_mcc && t.mcc_records[k].index != index) k++;
    const bool fresh = k == t.nb_mcc;
    if (t.mcc_records.size() <= k) t.mcc_records.resize(k + 1);
    MccRecord& r = t.mcc_records[k];
    r.index = index;
    if (be16(p + 3) != 0) return;  // "multiple data spanning"
    const uint32_t collections = be16(p + 5);
    if (collections > 1) return;   // "multiple collections"
    uint32_t left = n - 7;
    p += 7;
    for (uint32_t c = 0; c < collections; c++) {
      if (left < 3) fail("Error reading MCC marker");
      if (p[0] != 1) return;  // "collections other than array decorrelation"
      uint32_t nc = be16(p + 1);
      p += 3;
      left -= 3;
      uint32_t width = 1 + (nc >> 15);
      r.nb_comps = nc & 0x7fff;
      if (left < width * r.nb_comps + 2) fail("Error reading MCC marker");
      left -= width * r.nb_comps + 2;
      for (uint32_t j = 0; j < r.nb_comps; j++, p += width)
        if (be_n(p, int(width)) != j) return;  // "indix shuffle"
      nc = be16(p);
      p += 2;
      width = 1 + (nc >> 15);
      if ((nc & 0x7fff) != r.nb_comps) return;  // "without same number of indixes"
      if (left < width * r.nb_comps + 3) fail("Error reading MCC marker");
      left -= width * r.nb_comps + 3;
      for (uint32_t j = 0; j < r.nb_comps; j++, p += width)
        if (be_n(p, int(width)) != j) return;
      const uint32_t tmcc = be_n(p, 3);
      p += 3;
      r.deco = r.offset = -1;
      auto find = [&](uint32_t idx) {
        for (size_t m = 0; m < t.mct_records.size(); m++)
          if (t.mct_records[m].index == idx) return int32_t(m);
        fail("Error reading MCC marker");
      };
      if (tmcc & 0xff) r.deco = find(tmcc & 0xff);
      if ((tmcc >> 8) & 0xff) r.offset = find((tmcc >> 8) & 0xff);
    }
    if (left != 0) fail("Error reading MCC marker");
    if (fresh) t.nb_mcc++;
  }

  // opj_j2k_read_mco and opj_j2k_add_mct: the transform's one stage. Every
  // DC level shift of the tile (or the default) becomes 0, then the stage's
  // collection (with as many components as the image) gives its offsets
  // as the shifts; its decorrelation matrix is held to its size. OpenJPEG
  // decodes no transform of its own (COD's byte 2 fails), so the shifts
  // are what an MCO changes.
  void mco_marker(const uint8_t* p, uint32_t n) {
    Tcp& t = cur();
    if (n < 1) fail("Error reading MCO marker");
    const uint32_t stages = p[0];
    if (stages > 1) return;  // "Cannot take in charge multiple transformation stages"
    if (n != stages + 1) fail("Error reading MCO marker");
    for (Tccp& c : t.tccps) c.dc_shift = 0;
    for (uint32_t i = 0; i < stages; i++) {
      const uint32_t index = p[1 + i];
      const MccRecord* r = nullptr;
      for (uint32_t m = 0; m < t.nb_mcc && !r; m++)
        if (t.mcc_records[m].index == index) r = &t.mcc_records[m];
      if (!r || r->nb_comps != numcomps) continue;
      static const uint32_t kSize[4] = {2, 4, 4, 8};
      if (r->deco >= 0) {
        const MctRecord& a = t.mct_records[size_t(r->deco)];
        if (a.data.size() != size_t(kSize[a.element_type]) * numcomps * numcomps)
          fail("MCO: the decorrelation array's size");
      }
      if (r->offset >= 0) {
        const MctRecord& a = t.mct_records[size_t(r->offset)];
        if (a.data.size() != size_t(kSize[a.element_type]) * numcomps)
          fail("MCO: the offset array's size");
        for (uint32_t c = 0; c < numcomps; c++)
          t.tccps[c].dc_shift = mct_int32(a.data.data() + c * kSize[a.element_type],
                                          a.element_type);
      }
    }
  }

  // j2k_mct_read_functions_to_int32: an element as int32 (int16 read as
  // its unsigned 16 bits, floats truncated; x86's conversion gives
  // INT32_MIN for NaN or what no int32 holds)
  static int32_t mct_int32(const uint8_t* e, uint32_t type) {
    auto from = [](double v) {
      return (v >= -2147483648.0 && v < 2147483648.0) ? int32_t(v) : INT32_MIN;
    };
    if (type == 0) return int32_t(be16(e));
    if (type == 1) return int32_t(be32(e));
    if (type == 2) {
      const uint32_t u = be32(e);
      float f;
      std::memcpy(&f, &u, 4);
      return from(double(f));
    }
    const uint64_t u = (uint64_t(be32(e)) << 32) | be32(e + 4);
    double d;
    std::memcpy(&d, &u, 8);
    return from(d);
  }

  // one marker segment's body through its handler
  void handle(uint32_t id, const uint8_t* p, uint32_t n) {
    switch (id) {
      case kSIZ: siz(p, n); break;
      case kCOD: cod(p, n); break;
      case kCOC: coc(p, n); break;
      case kQCD: qcd(p, n); break;
      case kQCC: qcc(p, n); break;
      case kRGN: rgn(p, n); break;
      case kPOC: poc(p, n); break;
      case kTLM: tlm(p, n); break;
      case kPLM: if (n < 1) fail("error reading PLM marker"); break;
      case kPLT: plt(p, n); break;
      case kPPM: ppm_marker(p, n); break;
      case kPPT: ppt_marker(p, n); break;
      case kCRG: if (n != numcomps * 4) fail("error reading CRG marker"); break;
      case kCOM: case kCPF: break;
      // opj_j2k_read_cap reads nothing (Part 15's capabilities: the
      // code-block style says HT)
      case kCAP: break;
      case kCBD: cbd(p, n); break;
      case kMCT: mct_marker(p, n); break;
      case kMCC: mcc_marker(p, n); break;
      case kMCO: mco_marker(p, n); break;
      case kSOT: sot(p, n); break;
      default: fail("not sure how that happened");
    }
  }

  // opj_j2k_read_unk: 2-byte steps to the next marker known where it stands
  uint32_t read_unknown() {
    for (;;) {
      const uint32_t m = read16();
      if (m >= 0xff00) {
        uint32_t id;
        const uint32_t states = marker_states(m, &id);
        if (!(state & states)) fail("marker is not compliant with its position");
        if (id != kUnknown) return id;
      }
    }
  }

  // opj_j2k_read_header_procedure
  void main_header() {
    if (read16() != 0xFF4F) fail("expected a SOC marker");
    state = kMHSIZ;
    uint32_t marker = read16();
    bool has_siz = false, has_cod = false, has_qcd = false;
    while (marker != kSOT) {
      if (marker < 0xff00) fail("a marker ID was expected");
      uint32_t id;
      uint32_t states = marker_states(marker, &id);
      if (id == kUnknown) {
        marker = read_unknown();
        if (marker == kSOT) break;
        states = marker_states(marker, &id);
      }
      if (id == kSIZ) has_siz = true;
      if (id == kCOD) has_cod = true;
      if (id == kQCD) has_qcd = true;
      if (!(state & states)) fail("marker is not compliant with its position");
      uint32_t size = read16();
      if (size < 2) fail("invalid marker size");
      size -= 2;
      if (s.left() < size) {
        s.pos = s.n;
        fail("stream too short");
      }
      const uint8_t* body = s.d + s.pos;
      s.pos += size;
      handle(id, body, size);
      marker = read16();
    }
    if (!has_siz) fail("required SIZ marker not found in main header");
    if (!has_cod) fail("required COD marker not found in main header");
    if (!has_qcd) fail("required QCD marker not found in main header");
    merge_ppm();
    state = kTPHSOT;
  }

  // opj_j2k_read_sod
  void read_sod() {
    Tcp& t = tcp_of(tile);
    if (last_tile_part) {
      sot_length = uint32_t(s.left() - 2);
    } else if (sot_length >= 2) {
      sot_length -= 2;
    }
    uint64_t got = 0;
    if (sot_length) {
      if (sot_length > s.left()) fail("tile part length size inconsistent with stream length");
      if (sot_length > 0xFFFFFFFFull - 2) fail("tile part too long");
      got = s.read(nullptr, sot_length);
      t.data.insert(t.data.end(), s.d + s.pos - got, s.d + s.pos);
      t.has_data = true;
    }
    state = got != sot_length ? kNEOC : kTPHSOT;
  }

  // opj_j2k_read_tile_header: false where no tile is left
  bool tile_header() {
    uint32_t marker = kSOT;
    if (state == kStateEOC) {
      marker = kEOC;
    } else if (state != kTPHSOT) {
      fail("a tile-part header expected");
    }
    while (!can_decode && marker != kEOC) {
      while (marker != kSOD) {
        if (s.left() == 0) {
          state = kNEOC;
          break;
        }
        uint32_t size = read16();
        if (size < 2) fail("inconsistent marker size");
        if (marker == 0x8080 && s.left() == 0) {
          state = kNEOC;
          break;
        }
        if ((state & kTPH) && sot_length != 0) {
          if (sot_length < uint64_t(size) + 2) fail("SOT length is less than marker size");
          sot_length -= size + 2;
        }
        size -= 2;
        uint32_t id;
        const uint32_t states = marker_states(marker, &id);
        if (!(state & states)) fail("marker is not compliant with its position");
        if (s.left() < size) {
          if (size > 0) fail("marker size inconsistent with stream length");
        }
        const uint8_t* body = s.d + s.pos;
        s.pos += size;
        if (id == kUnknown) fail("not sure how that happened");
        handle(id, body, size);
        marker = read16();
      }
      if (s.left() == 0 && state == kNEOC) break;
      read_sod();
      // (OpenJPEG's look-ahead for streams whose TPsot equals TNsot needs a
      // stream that seeks; Pillow's does not, so it never runs)
      if (!can_decode) {
        uint8_t b[2];
        if (s.read(b, 2) != 2) {
          // SPOT6-like streams: a tile of one part with TPsot == TNsot
          // == 0 and no EOC
          bool found = false;
          if (tile + 1 == nb_tiles()) {
            for (uint32_t k = 0; k < nb_tiles(); k++) {
              if (tcps[k] && tcps[k]->part == 0 && tcps[k]->nb_parts == 0) {
                tile = k;
                marker = kEOC;
                state = kStateEOC;
                found = true;
                break;
              }
            }
          }
          if (!found) fail("stream too short");
          break;
        }
        marker = be16(b);
      }
    }
    if (marker == kEOC && state != kStateEOC) {
      tile = 0;
      state = kStateEOC;
    }
    if (!can_decode) {
      while (tile < nb_tiles() && !(tcps[tile] && tcps[tile]->has_data)) ++tile;
      if (tile == nb_tiles()) return false;
    }
    merge_ppt(tcp_of(tile));
    state |= kDATA;
    return true;
  }

  // the end of opj_j2k_decode_tile: the next marker after a decoded tile
  void after_tile() {
    can_decode = false;
    state &= ~kDATA;
    if (s.left() == 0 && state == kNEOC) return;
    if (state != kStateEOC) {
      uint8_t b[2];
      if (s.read(b, 2) != 2) fail("stream too short");
      const uint32_t m = be16(b);
      if (m == kEOC) {
        tile = 0;
        state = kStateEOC;
      } else if (m != kSOT) {
        if (s.left() == 0) {
          state = kNEOC;
          return;
        }
        fail("stream too short");
      }
    }
  }
};

// ------------------------------------------------------------- tile model
inline int32_t ceildiv(int64_t a, int64_t b) { return int32_t((a + b - 1) / b); }
inline int32_t ceildivpow2(int64_t a, uint32_t b) { return int32_t((a + (int64_t(1) << b) - 1) >> b); }
inline int32_t floordivpow2(int64_t a, uint32_t b) { return int32_t(a >> b); }

// tgt.c's tag tree: a node's value 999 until decoded
struct TagTree {
  struct Node {
    int32_t parent, value, low;
  };
  std::vector<Node> nodes;
  void create(uint32_t w, uint32_t h) {
    nodes.clear();
    if (uint64_t(w) * h == 0) return;
    std::vector<uint32_t> lw{w}, lh{h}, start{0};
    uint64_t total = 0;
    for (;;) {
      const uint64_t n = uint64_t(lw.back()) * lh.back();
      total += n;
      if (n <= 1) break;
      start.push_back(uint32_t(total));
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    }
    nodes.resize(total);
    for (size_t l = 0; l < lw.size(); l++) {
      for (uint32_t j = 0; j < lh[l]; j++) {
        for (uint32_t i = 0; i < lw[l]; i++) {
          Node& nd = nodes[start[l] + j * lw[l] + i];
          nd.parent = l + 1 < lw.size() ? int32_t(start[l + 1] + (j / 2) * lw[l + 1] + i / 2) : -1;
        }
      }
    }
    reset();
  }
  void reset() {
    for (auto& nd : nodes) {
      nd.value = 999;
      nd.low = 0;
    }
  }
};

struct Seg {
  uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0, numnewpasses = 0,
           newlen = 0;
};

struct Cblk {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0, real_num_segs = 0;
  uint32_t mb = 0;  // the band's magnitude bit-planes at the first inclusion
  std::vector<Seg> segs;
  std::vector<uint8_t> data;  // the code-block's chunks, in order
  uint32_t nchunks = 0;       // and their number
  uint64_t chunk0 = 0;        // the first one's offset in the tile's data
};

struct Precinct {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t bandno = 0;
  int32_t numbps = 0;
  float stepsize = 0;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Resolution {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t pw = 0, ph = 0, numbands = 0;
  uint32_t pdx = 15, pdy = 15;
  Band bands[3];
};

// a coefficient or sample as OpenJPEG keeps it: an int32 or, on the 9/7
// path, a float in the same word
union Sample {
  int32_t i;
  float f;
};

struct TileComp {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t numres = 0, minres = 0;
  std::vector<Resolution> res;
  std::vector<Sample> data;
  uint32_t w() const { return uint32_t(res[minres - 1].x1 - res[minres - 1].x0); }
};

struct Tile {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  std::vector<TileComp> comps;
};

// opj_tcd_init_tile for decoding
void init_tile(Codestream& cs, uint32_t tileno, Tile& tile) {
  Tcp& tcp = cs.tcp_of(tileno);
  const uint32_t p = tileno % cs.tw, q = tileno / cs.tw;
  const uint64_t tx0 = uint64_t(cs.tx0) + uint64_t(p) * cs.tdx;
  const uint64_t ty0 = uint64_t(cs.ty0) + uint64_t(q) * cs.tdy;
  tile.x0 = int32_t(uint32_t(std::max<uint64_t>(tx0, cs.x0)));
  tile.x1 = int32_t(uint32_t(std::min<uint64_t>(std::min<uint64_t>(tx0 + cs.tdx, 0xFFFFFFFFu), cs.x1)));
  if (tile.x0 < 0 || tile.x1 <= tile.x0) fail("tile X coordinates are not supported");
  tile.y0 = int32_t(uint32_t(std::max<uint64_t>(ty0, cs.y0)));
  tile.y1 = int32_t(uint32_t(std::min<uint64_t>(std::min<uint64_t>(ty0 + cs.tdy, 0xFFFFFFFFu), cs.y1)));
  if (tile.y0 < 0 || tile.y1 <= tile.y0) fail("tile Y coordinates are not supported");
  tile.comps.assign(cs.numcomps, TileComp());
  for (uint32_t c = 0; c < cs.numcomps; c++) {
    const Tccp& tccp = tcp.tccps[c];
    const Comp& comp = cs.comps[c];
    TileComp& tc = tile.comps[c];
    tc.x0 = ceildiv(tile.x0, comp.dx);
    tc.y0 = ceildiv(tile.y0, comp.dy);
    tc.x1 = ceildiv(tile.x1, comp.dx);
    tc.y1 = ceildiv(tile.y1, comp.dy);
    tc.numres = tccp.numres;
    tc.minres = tccp.numres;
    tc.res.assign(tc.numres, Resolution());
    // the tile's coefficients are held to Pillow's size limit by the
    // caller's size check; a tile-component is never larger than the image
    for (uint32_t r = 0; r < tc.numres; r++) {
      Resolution& res = tc.res[r];
      const uint32_t level = tc.numres - 1 - r;
      res.x0 = ceildivpow2(tc.x0, level);
      res.y0 = ceildivpow2(tc.y0, level);
      res.x1 = ceildivpow2(tc.x1, level);
      res.y1 = ceildivpow2(tc.y1, level);
      const uint32_t pdx = tccp.prcw[r], pdy = tccp.prch[r];
      res.pdx = pdx;
      res.pdy = pdy;
      const int64_t tlx = int64_t(floordivpow2(res.x0, pdx)) << pdx;
      const int64_t tly = int64_t(floordivpow2(res.y0, pdy)) << pdy;
      const uint64_t brx = uint64_t(uint32_t(ceildivpow2(res.x1, pdx))) << pdx;
      const uint64_t bry = uint64_t(uint32_t(ceildivpow2(res.y1, pdy))) << pdy;
      if (brx > 0x7FFFFFFFu || bry > 0x7FFFFFFFu) fail("integer overflow");
      res.pw = res.x0 == res.x1 ? 0 : uint32_t((int64_t(brx) - tlx) >> pdx);
      res.ph = res.y0 == res.y1 ? 0 : uint32_t((int64_t(bry) - tly) >> pdy);
      if (res.pw != 0 && 0xFFFFFFFFu / res.pw < res.ph) fail("size of tile data exceeds system limits");
      const uint64_t nprec = uint64_t(res.pw) * res.ph;
      int64_t tlcbgx, tlcbgy;
      uint32_t cbgw, cbgh;
      if (r == 0) {
        tlcbgx = tlx;
        tlcbgy = tly;
        cbgw = pdx;
        cbgh = pdy;
        res.numbands = 1;
      } else {
        tlcbgx = ceildivpow2(tlx, 1);
        tlcbgy = ceildivpow2(tly, 1);
        cbgw = pdx - 1;
        cbgh = pdy - 1;
        res.numbands = 3;
      }
      const uint32_t cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
      for (uint32_t b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        const uint32_t lvl = level;
        if (r == 0) {
          band.bandno = 0;
          band.x0 = ceildivpow2(tc.x0, lvl);
          band.y0 = ceildivpow2(tc.y0, lvl);
          band.x1 = ceildivpow2(tc.x1, lvl);
          band.y1 = ceildivpow2(tc.y1, lvl);
        } else {
          band.bandno = b + 1;
          const int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
          band.x0 = ceildivpow2(int64_t(tc.x0) - (xob << lvl), lvl + 1);
          band.y0 = ceildivpow2(int64_t(tc.y0) - (yob << lvl), lvl + 1);
          band.x1 = ceildivpow2(int64_t(tc.x1) - (xob << lvl), lvl + 1);
          band.y1 = ceildivpow2(int64_t(tc.y1) - (yob << lvl), lvl + 1);
        }
        const Step& st = tccp.steps[r == 0 ? 0 : 3 * (r - 1) + b + 1];
        // BUG_WEIRD_TWO_INVK: the decoder's 9/7 gain is 0 for every band
        const int32_t gain = tccp.qmfbid == 0 ? 0 : (band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1);
        const int32_t rb = int32_t(comp.prec) + gain;
        band.stepsize = float((1.0 + st.mant / 2048.0) * std::pow(2.0, double(rb - st.expn)));
        band.numbps = st.expn + int32_t(tccp.numgbits) - 1;
        if (nprec == 0) continue;
        if (nprec > (uint64_t(1) << 26)) fail("too many precincts");
        band.precincts.assign(size_t(nprec), Precinct());
        for (uint64_t k = 0; k < nprec; k++) {
          Precinct& pr = band.precincts[k];
          const int64_t sx = tlcbgx + int64_t(k % res.pw) * (int64_t(1) << cbgw);
          const int64_t sy = tlcbgy + int64_t(k / res.pw) * (int64_t(1) << cbgh);
          pr.x0 = int32_t(std::max<int64_t>(sx, band.x0));
          pr.y0 = int32_t(std::max<int64_t>(sy, band.y0));
          pr.x1 = int32_t(std::min<int64_t>(sx + (int64_t(1) << cbgw), band.x1));
          pr.y1 = int32_t(std::min<int64_t>(sy + (int64_t(1) << cbgh), band.y1));
          const int64_t tlbx = int64_t(floordivpow2(pr.x0, cbw)) << cbw;
          const int64_t tlby = int64_t(floordivpow2(pr.y0, cbh)) << cbh;
          const int64_t brbx = int64_t(ceildivpow2(pr.x1, cbw)) << cbw;
          const int64_t brby = int64_t(ceildivpow2(pr.y1, cbh)) << cbh;
          pr.cw = brbx > tlbx ? uint32_t((brbx - tlbx) >> cbw) : 0;
          pr.ch = brby > tlby ? uint32_t((brby - tlby) >> cbh) : 0;
          const uint64_t ncb = uint64_t(pr.cw) * pr.ch;
          if (ncb > (uint64_t(1) << 26)) fail("too many code-blocks");
          pr.cblks.assign(size_t(ncb), Cblk());
          for (uint64_t j = 0; j < ncb; j++) {
            Cblk& cb = pr.cblks[j];
            const int64_t cx = tlbx + int64_t(j % pr.cw) * (int64_t(1) << cbw);
            const int64_t cy = tlby + int64_t(j / pr.cw) * (int64_t(1) << cbh);
            cb.x0 = int32_t(std::max<int64_t>(cx, pr.x0));
            cb.y0 = int32_t(std::max<int64_t>(cy, pr.y0));
            cb.x1 = int32_t(std::min<int64_t>(cx + (int64_t(1) << cbw), pr.x1));
            cb.y1 = int32_t(std::min<int64_t>(cy + (int64_t(1) << cbh), pr.y1));
          }
          pr.incl.create(pr.cw, pr.ch);
          pr.imsb.create(pr.cw, pr.ch);
        }
      }
    }
  }
}

// ------------------------------------------------------- packet iterator
// pi.c's decoder iterators over one tile; packets already read are skipped
// through `include`, shared by every progression of the tile
struct PiComp {
  uint32_t dx = 1, dy = 1, numres = 0;
  struct Res {
    uint32_t pdx, pdy, pw, ph;
  };
  std::vector<Res> res;
};

struct PacketIterator {
  std::vector<PiComp> comps;
  uint32_t numcomps = 0;
  int32_t tx0 = 0, ty0 = 0, tx1 = 0, ty1 = 0;
  uint32_t step_l = 0, step_r = 0, step_c = 0, step_p = 1;
  std::vector<uint8_t>* include = nullptr;
  // the progression: layers [0, layno1), resolutions [resno0, resno1),
  // components [compno0, compno1), precincts [0, precno1)
  int32_t prg = 0;
  uint32_t resno0 = 0, resno1 = 0, compno0 = 0, compno1 = 0, layno1 = 0, precno1 = 0;
  // the position
  uint32_t layno = 0, resno = 0, compno = 0, precno = 0;
  bool first = true;
  uint32_t dx = 0, dy = 0;
  uint64_t x = 0, y = 0;
  uint32_t prec_end = 0;

  bool take() {
    const uint64_t index = uint64_t(layno) * step_l + uint64_t(resno) * step_r +
                           uint64_t(compno) * step_c + uint64_t(precno) * step_p;
    if (index >= include->size()) fail("invalid access to pi->include");
    if (!(*include)[index]) {
      (*include)[index] = 1;
      return true;
    }
    return false;
  }

  void min_steps(bool one_comp) {
    dx = dy = 0;
    for (uint32_t c = (one_comp ? compno : 0); c < (one_comp ? compno + 1 : numcomps); c++) {
      const PiComp& comp = comps[c];
      for (uint32_t r = 0; r < comp.numres; r++) {
        const PiComp::Res& rs = comp.res[r];
        const uint32_t e = rs.pdx + comp.numres - 1 - r;
        if (e < 32 && comp.dx <= 0xFFFFFFFFu / (1u << e)) {
          const uint32_t v = comp.dx * (1u << e);
          dx = !dx ? v : std::min(dx, v);
        }
        const uint32_t f = rs.pdy + comp.numres - 1 - r;
        if (f < 32 && comp.dy <= 0xFFFFFFFFu / (1u << f)) {
          const uint32_t v = comp.dy * (1u << f);
          dy = !dy ? v : std::min(dy, v);
        }
      }
    }
  }

  // the precinct of (x, y) at (compno, resno) for the position orders;
  // false where the position holds no packet of it
  bool position_precinct() {
    const PiComp& comp = comps[compno];
    if (resno >= comp.numres) return false;
    const PiComp::Res& rs = comp.res[resno];
    const uint32_t levelno = comp.numres - 1 - resno;
    if (levelno >= 32 || ((comp.dx << levelno) >> levelno) != comp.dx ||
        ((comp.dy << levelno) >> levelno) != comp.dy)
      return false;
    if (uint64_t(comp.dx) << levelno > 0x7FFFFFFF || uint64_t(comp.dy) << levelno > 0x7FFFFFFF)
      return false;
    const uint64_t ddx = uint64_t(comp.dx) << levelno, ddy = uint64_t(comp.dy) << levelno;
    const uint64_t trx0 = (uint64_t(uint32_t(tx0)) + ddx - 1) / ddx;
    const uint64_t try0 = (uint64_t(uint32_t(ty0)) + ddy - 1) / ddy;
    const uint64_t trx1 = (uint64_t(uint32_t(tx1)) + ddx - 1) / ddx;
    const uint64_t try1 = (uint64_t(uint32_t(ty1)) + ddy - 1) / ddy;
    const uint32_t rpx = rs.pdx + levelno, rpy = rs.pdy + levelno;
    if (rpx >= 31 || ((comp.dx << rpx) >> rpx) != comp.dx || rpy >= 31 ||
        ((comp.dy << rpy) >> rpy) != comp.dy)
      return false;
    if (!((y % (uint64_t(comp.dy) << rpy) == 0) ||
          ((y == uint64_t(uint32_t(ty0))) && ((try0 << levelno) % (uint64_t(1) << rpy)))))
      return false;
    if (!((x % (uint64_t(comp.dx) << rpx) == 0) ||
          ((x == uint64_t(uint32_t(tx0))) && ((trx0 << levelno) % (uint64_t(1) << rpx)))))
      return false;
    if (rs.pw == 0 || rs.ph == 0) return false;
    if (trx0 == trx1 || try0 == try1) return false;
    const uint32_t prci = uint32_t(((x + ddx - 1) / ddx) >> rs.pdx) - uint32_t(trx0 >> rs.pdx);
    const uint32_t prcj = uint32_t(((y + ddy - 1) / ddy) >> rs.pdy) - uint32_t(try0 >> rs.pdy);
    precno = prci + prcj * rs.pw;
    return true;
  }

  // opj_pi_next_<order>: the next packet not yet read, false at the end
  bool next() {
    if (compno0 >= numcomps || compno1 >= numcomps + 1) return false;  // an error message only
    switch (prg) {
      case 0: return next_lrcp(false);
      case 1: return next_lrcp(true);
      case 2: return next_pos(2);
      case 3: return next_pos(3);
      case 4: return next_pos(4);
      default: return false;
    }
  }

  // LRCP (rl false) and RLCP (rl true), as generators over their loops
  bool next_lrcp(bool rl) {
    if (first) {
      first = false;
      if (rl) {
        resno = resno0;
        layno = 0;
      } else {
        layno = 0;
        resno = resno0;
      }
      compno = compno0;
    } else {
      goto skip;
    }
    for (;;) {
      // the loops' conditions, outermost first
      if (rl) {
        if (resno >= resno1) return false;
        if (layno >= layno1) {
          ++resno;
          layno = 0;
          compno = compno0;
          continue;
        }
      } else {
        if (layno >= layno1) return false;
        if (resno >= resno1) {
          ++layno;
          resno = resno0;
          compno = compno0;
          continue;
        }
      }
      if (compno >= compno1) {
        if (rl) {
          ++layno;
        } else {
          ++resno;
        }
        compno = compno0;
        continue;
      }
      {
        const PiComp& comp = comps[compno];
        if (resno >= comp.numres) {
          ++compno;
          continue;
        }
        const PiComp::Res& rs = comp.res[resno];
        prec_end = rs.pw * rs.ph;
        precno = 0;
      }
      while (precno < prec_end) {
        if (take()) return true;
      skip:
        ++precno;
      }
      ++compno;
    }
  }

  // RPCL (2), PCRL (3), CPRL (4): the position loops, then layers
  bool next_pos(int order) {
    if (first) {
      first = false;
      if (order != 4) {
        min_steps(false);
        if (dx == 0 || dy == 0) return false;
      }
    } else if (order == 2) {
      goto skip;
    } else if (order == 3) {
      goto skip3;
    } else {
      goto skip4;
    }
    if (order == 2) {
      for (resno = resno0; resno < resno1; resno++) {
        for (y = uint32_t(ty0); y < uint64_t(uint32_t(ty1)); y += dy - (y % dy)) {
          for (x = uint32_t(tx0); x < uint64_t(uint32_t(tx1)); x += dx - (x % dx)) {
            for (compno = compno0; compno < compno1; compno++) {
              if (!position_precinct()) continue;
              for (layno = 0; layno < layno1; layno++) {
                if (take()) return true;
              skip:;
              }
            }
          }
        }
      }
      return false;
    } else if (order == 3) {
      for (y = uint32_t(ty0); y < uint64_t(uint32_t(ty1)); y += dy - (y % dy)) {
        for (x = uint32_t(tx0); x < uint64_t(uint32_t(tx1)); x += dx - (x % dx)) {
          for (compno = compno0; compno < compno1; compno++) {
            for (resno = resno0; resno < std::min(resno1, comps[compno].numres); resno++) {
              if (!position_precinct()) continue;
              for (layno = 0; layno < layno1; layno++) {
                if (take()) return true;
              skip3:;
              }
            }
          }
        }
      }
      return false;
    } else {
      for (compno = compno0; compno < compno1; compno++) {
        min_steps(true);
        if (dx == 0 || dy == 0) return false;
        for (y = uint32_t(ty0); y < uint64_t(uint32_t(ty1)); y += dy - (y % dy)) {
          for (x = uint32_t(tx0); x < uint64_t(uint32_t(tx1)); x += dx - (x % dx)) {
            for (resno = resno0; resno < std::min(resno1, comps[compno].numres); resno++) {
              if (!position_precinct()) continue;
              for (layno = 0; layno < layno1; layno++) {
                if (take()) return true;
              skip4:;
              }
            }
          }
        }
      }
      return false;
    }
  }
};

// ------------------------------------------------------------------- tier 2
// bio.c: packet-header bits, a 0 bit stuffed after each 0xFF byte, zeros
// past the end
struct Bio {
  const uint8_t* start;
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t* p, uint64_t n) : start(p), bp(p), end(p + n) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n - 1; i < n; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  uint64_t numbytes() const { return uint64_t(bp - start); }
};

// opj_tgt_decode: whether the leaf's value is below `threshold`
uint32_t tgt_decode(Bio& bio, TagTree& tree, uint32_t leaf, int32_t threshold) {
  int32_t stack[32];
  int depth = 0;
  int32_t node = int32_t(leaf);
  while (tree.nodes[node].parent >= 0) {
    stack[depth++] = node;
    node = tree.nodes[node].parent;
  }
  int32_t low = 0;
  for (;;) {
    TagTree::Node& nd = tree.nodes[node];
    if (low > nd.low) {
      nd.low = low;
    } else {
      low = nd.low;
    }
    while (low < threshold && low < nd.value) {
      if (bio.read(1)) {
        nd.value = low;
      } else {
        ++low;
      }
    }
    nd.low = low;
    if (depth == 0) break;
    node = stack[--depth];
  }
  return tree.nodes[node].value < threshold ? 1 : 0;
}

uint32_t getnumpasses(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

uint32_t floorlog2(uint32_t a) {
  uint32_t l = 0;
  while (a >>= 1) l++;
  return l;
}

// opj_t2_init_seg
void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
  if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
  Seg& seg = cb.segs[index];
  seg = Seg();
  if (cblksty & 4) {  // TERMALL
    seg.maxpasses = 1;
  } else if (cblksty & 1) {  // BYPASS
    if (first) {
      seg.maxpasses = 10;
    } else {
      const uint32_t prev = cb.segs[index - 1].maxpasses;
      seg.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    seg.maxpasses = 109;
  }
}

// The packet headers of a tile: the tile's own data, or PPM's or PPT's
// stream
struct HeaderSource {
  const uint8_t* data;
  uint64_t* pos;  // into data
  uint64_t size;
};

// opj_t2_read_packet_header then opj_t2_read_packet_data (or its skip),
// for the packet at the iterator; `p`, `left`: the tile's data there.
// Returns the bytes of tile data it read.
uint64_t decode_packet(Tile& tile, Tcp& tcp, PacketIterator& pi, const uint8_t* p,
                       uint64_t left, HeaderSource* ppx) {
  TileComp& tc = tile.comps[pi.compno];
  Resolution& res = tc.res[pi.resno];
  const uint32_t cblksty = tcp.tccps[pi.compno].cblksty;
  if (pi.layno == 0) {
    for (uint32_t b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      if (pi.precno >= band.precincts.size()) fail("invalid precinct");
      Precinct& pr = band.precincts[pi.precno];
      pr.incl.reset();
      pr.imsb.reset();
      for (Cblk& cb : pr.cblks) {
        cb.numsegs = 0;
        cb.real_num_segs = 0;
      }
    }
  }
  const uint8_t* cur = p;
  if (tcp.csty & 2) {  // SOP
    if (left >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
  }
  const uint8_t* hstart;
  uint64_t hlen;
  if (ppx) {
    hstart = ppx->data + *ppx->pos;
    hlen = ppx->size - *ppx->pos;
  } else {
    hstart = cur;
    hlen = uint64_t(p + left - cur);
  }
  Bio bio(hstart, hlen);
  const uint32_t present = bio.read(1);
  bool data_present = false;
  if (present) {
    for (uint32_t b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      if (pi.precno >= band.precincts.size()) fail("invalid precinct");
      Precinct& pr = band.precincts[pi.precno];
      const uint32_t ncb = pr.cw * pr.ch;
      for (uint32_t k = 0; k < ncb; k++) {
        Cblk& cb = pr.cblks[k];
        uint32_t included;
        if (!cb.numsegs) {
          included = tgt_decode(bio, pr.incl, k, int32_t(pi.layno + 1));
        } else {
          included = bio.read(1);
        }
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (!cb.numsegs) {
          uint32_t i = 0;
          while (!tgt_decode(bio, pr.imsb, k, int32_t(i))) ++i;
          cb.mb = uint32_t(band.numbps);
          cb.numbps = uint32_t(band.numbps) + 1 - i;
          cb.numlenbits = 3;
        }
        cb.numnewpasses = getnumpasses(bio);
        uint32_t increment = 0;
        while (bio.read(1)) ++increment;
        cb.numlenbits += increment;
        uint32_t segno = 0;
        if (!cb.numsegs) {
          init_seg(cb, 0, cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            init_seg(cb, segno, cblksty, false);
          }
        }
        int32_t n = int32_t(cb.numnewpasses);
        do {
          Seg& seg = cb.segs[segno];
          // HT: the first segment takes one pass (the cleanup), a later one
          // every pass left, whatever the segment's limit
          if (cblksty & 0x40) {
            seg.numnewpasses = segno == 0 ? 1 : uint32_t(n);
          } else {
            seg.numnewpasses = uint32_t(std::min<int64_t>(int64_t(seg.maxpasses) - seg.numpasses, n));
          }
          const uint32_t bits = cb.numlenbits + floorlog2(seg.numnewpasses);
          if (bits > 32) fail("invalid bit number in a packet header");
          seg.newlen = bits ? bio.read(bits) : 0;
          n -= int32_t(seg.numnewpasses);
          if (n > 0) {
            ++segno;
            init_seg(cb, segno, cblksty, false);
          }
        } while (n > 0);
      }
    }
    bio.inalign();
    data_present = true;
  } else {
    bio.inalign();
  }
  const uint8_t* h = hstart + bio.numbytes();
  if (tcp.csty & 4) {  // EPH: required where COD announces it
    const uint64_t used = uint64_t(h - hstart);
    if (hlen - used < 2) fail("not enough space for required EPH marker");
    if (h[0] != 0xff || h[1] != 0x92) fail("expected EPH marker");
    h += 2;
  }
  const uint64_t header_length = uint64_t(h - hstart);
  if (ppx) {
    *ppx->pos += header_length;
  } else {
    cur += header_length;
  }
  if (!data_present) return uint64_t(cur - p);
  // the packet's body: each code-block's new segments
  const uint8_t* end = p + left;
  for (uint32_t b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Precinct& pr = band.precincts[pi.precno];
    for (Cblk& cb : pr.cblks) {
      if (!cb.numnewpasses) continue;
      Seg* seg;
      uint32_t segidx;
      if (!cb.numsegs) {
        segidx = 0;
        ++cb.numsegs;
      } else {
        segidx = cb.numsegs - 1;
        if (cb.segs[segidx].numpasses == cb.segs[segidx].maxpasses) {
          ++segidx;
          ++cb.numsegs;
        }
      }
      do {
        if (segidx >= cb.segs.size()) fail("a segment past the header's");
        seg = &cb.segs[segidx];
        if (uint64_t(end - cur) < seg->newlen)
          fail("read: segment too long for codeblock");
        cb.data.insert(cb.data.end(), cur, cur + seg->newlen);
        if (cb.nchunks++ == 0) cb.chunk0 = uint64_t(cur - tcp.data.data());
        cur += seg->newlen;
        seg->len += seg->newlen;
        seg->numpasses += seg->numnewpasses;
        cb.numnewpasses -= seg->numnewpasses;
        seg->real_num_passes = seg->numpasses;
        if (cb.numnewpasses > 0) {
          ++segidx;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
      cb.real_num_segs = cb.numsegs;
    }
  }
  return uint64_t(cur - p);
}

// opj_tcd_is_subband_area_of_interest for a whole-tile decode: whether a
// precinct or code-block (band coordinates) meets the tile-component's
// area in band `bandno`, widened by the filter's margin
bool area_of_interest(const Tile& tile, const Tcp& tcp, uint32_t compno, uint32_t resno,
                      uint32_t bandno, int32_t bx0, int32_t by0, int32_t bx1, int32_t by1) {
  const TileComp& tc = tile.comps[compno];
  const uint64_t margin = tcp.tccps[compno].qmfbid == 1 ? 2 : 3;
  const uint32_t nb = resno == 0 ? tc.numres - 1 : tc.numres - resno;
  auto map = [&](uint32_t v, uint32_t ob) -> uint64_t {
    if (nb == 0) return v;
    const uint64_t off = (uint64_t(1) << (nb - 1)) * ob;
    return v <= off ? 0 : ((v - off) + (uint64_t(1) << nb) - 1) >> nb;
  };
  uint64_t tbx0 = map(uint32_t(tc.x0), bandno & 1), tby0 = map(uint32_t(tc.y0), bandno >> 1);
  uint64_t tbx1 = map(uint32_t(tc.x1), bandno & 1), tby1 = map(uint32_t(tc.y1), bandno >> 1);
  tbx0 = tbx0 < margin ? 0 : tbx0 - margin;
  tby0 = tby0 < margin ? 0 : tby0 - margin;
  tbx1 = std::min<uint64_t>(tbx1 + margin, 0xFFFFFFFFu);
  tby1 = std::min<uint64_t>(tby1 + margin, 0xFFFFFFFFu);
  return uint32_t(bx0) < tbx1 && uint32_t(by0) < tby1 && uint32_t(bx1) > tbx0 &&
         uint32_t(by1) > tby0;
}

// opj_t2_decode_packets over the tile's data
void t2_decode(Codestream& cs, Tile& tile, Tcp& tcp) {
  // opj_pi_create_decode
  uint32_t max_res = 0;
  uint64_t max_prec = 0;
  std::vector<PiComp> pcs(cs.numcomps);
  for (uint32_t c = 0; c < cs.numcomps; c++) {
    const TileComp& tc = tile.comps[c];
    PiComp& pc = pcs[c];
    pc.dx = cs.comps[c].dx;
    pc.dy = cs.comps[c].dy;
    pc.numres = tc.numres;
    max_res = std::max(max_res, tc.numres);
    pc.res.resize(tc.numres);
    for (uint32_t r = 0; r < tc.numres; r++) {
      const Resolution& rs = tc.res[r];
      pc.res[r] = PiComp::Res{rs.pdx, rs.pdy, rs.pw, rs.ph};
      max_prec = std::max<uint64_t>(max_prec, uint64_t(rs.pw) * rs.ph);
    }
  }
  const uint64_t step_p = 1, step_c = max_prec * step_p, step_r = cs.numcomps * step_c,
                 step_l = max_res * step_r;
  const uint64_t include_size = (uint64_t(tcp.numlayers) + 1) * step_l;
  if (include_size > (uint64_t(1) << 31) || step_l > 0xFFFFFFFFu)
    fail("packet iterator too large");
  std::vector<uint8_t> include(include_size, 0);
  const uint32_t bound = tcp.numpocs + 1;
  std::vector<PacketIterator> pis(bound);
  for (uint32_t k = 0; k < bound; k++) {
    PacketIterator& pi = pis[k];
    pi.comps = pcs;
    pi.numcomps = cs.numcomps;
    pi.tx0 = tile.x0;
    pi.ty0 = tile.y0;
    pi.tx1 = tile.x1;
    pi.ty1 = tile.y1;
    pi.step_p = uint32_t(step_p);
    pi.step_c = uint32_t(step_c);
    pi.step_r = uint32_t(step_r);
    pi.step_l = uint32_t(step_l);
    pi.include = &include;
    if (tcp.poc) {
      const Poc& poc = tcp.pocs[k];
      pi.prg = int32_t(poc.prg);
      pi.resno0 = poc.resno0;
      pi.compno0 = poc.compno0;
      pi.resno1 = poc.resno1;
      pi.compno1 = poc.compno1;
      pi.layno1 = std::min(poc.layno1, tcp.numlayers);
    } else {
      pi.prg = tcp.prg;
      pi.resno0 = 0;
      pi.compno0 = 0;
      pi.resno1 = max_res;
      pi.compno1 = cs.numcomps;
      pi.layno1 = tcp.numlayers;
    }
  }
  HeaderSource src{nullptr, nullptr, 0};
  HeaderSource* ppx = nullptr;
  if (cs.ppm) {
    src = HeaderSource{cs.ppm_data.data(), &cs.ppm_pos, cs.ppm_data.size()};
    ppx = &src;
  } else if (tcp.ppt) {
    src = HeaderSource{tcp.ppt_data.data(), &tcp.ppt_pos, tcp.ppt_data.size()};
    ppx = &src;
  }
  const uint8_t* data = tcp.data.data();
  uint64_t left = tcp.data.size();
  for (uint32_t k = 0; k < bound; k++) {
    PacketIterator& pi = pis[k];
    if (pi.prg == -1) fail("unknown progression order");
    std::vector<bool> first_pass_failed(cs.numcomps, true);
    while (pi.next()) {
      // every packet of a whole-tile decode is read; one whose bands'
      // precincts are all empty is skipped (its header read all the same)
      const TileComp& tc = tile.comps[pi.compno];
      const Resolution& rs = tc.res[pi.resno];
      bool skip = true;
      for (uint32_t b = 0; b < rs.numbands; b++) {
        const Band& band = rs.bands[b];
        if (pi.precno >= band.precincts.size()) fail("invalid precinct");
        const Precinct& pr = band.precincts[pi.precno];
        if (area_of_interest(tile, tcp, pi.compno, pi.resno, band.bandno, pr.x0, pr.y0, pr.x1,
                             pr.y1)) {
          skip = false;
          break;
        }
      }
      const uint64_t read = decode_packet(tile, tcp, pi, data, left, ppx);
      if (!skip) {
        first_pass_failed[pi.compno] = false;
        cs.comps[pi.compno].resno_decoded = std::max(pi.resno, cs.comps[pi.compno].resno_decoded);
      }
      if (first_pass_failed[pi.compno] && cs.comps[pi.compno].resno_decoded == 0)
        cs.comps[pi.compno].resno_decoded = tc.minres - 1;
      data += read;
      left -= read;
    }
  }
}

// ------------------------------------------------------------------- tier 1
// ISO 15444-1 Table C.2: Qe, the next state after an MPS and after an
// LPS, and whether an LPS switches the MPS
constexpr uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401,
    0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
constexpr uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                               17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                               33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
constexpr uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                               15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                               30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
constexpr uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// the 19 contexts: zero coding 0-8, sign 9-13, magnitude 14-16,
// run-length 17, uniform 18
constexpr int kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18;

// mqc.c's decoder (mqc_inl.h), over a segment followed by 0xFF 0xFF
struct Mq {
  const uint8_t* bp = nullptr;
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t state[19], mps[19];

  void reset_states() {
    std::memset(state, 0, sizeof(state));
    std::memset(mps, 0, sizeof(mps));
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[0] = 4;
  }
  void bytein() {
    const uint32_t next = bp[1];
    if (bp[0] == 0xff) {
      if (next > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += next << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += next << 8;
      ct = 8;
    }
  }
  // `seg`: the segment's bytes with 0xFF 0xFF after them
  void init(const uint8_t* seg, uint32_t len) {
    bp = seg;
    c = len == 0 ? 0xffu << 16 : uint32_t(seg[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  __attribute__((always_inline)) inline uint32_t decode(int cx) {
    const uint32_t qe = kQe[state[cx]];
    uint32_t d;
    a -= qe;
    if ((c >> 16) < qe) {
      // lpsexchange
      if (a < qe) {
        a = qe;
        d = mps[cx];
        state[cx] = kNmps[state[cx]];
      } else {
        a = qe;
        d = !mps[cx];
        if (kSwitch[state[cx]]) mps[cx] ^= 1;
        state[cx] = kNlps[state[cx]];
      }
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        // mpsexchange
        if (a < qe) {
          d = !mps[cx];
          if (kSwitch[state[cx]]) mps[cx] ^= 1;
          state[cx] = kNlps[state[cx]];
        } else {
          d = mps[cx];
          state[cx] = kNmps[state[cx]];
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // the raw (BYPASS) decoder
  void raw_init(const uint8_t* seg) {
    bp = seg;
    c = 0;
    ct = 0;
  }
  uint32_t raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp;
          bp++;
          ct = 7;
        }
      } else {
        c = *bp;
        bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

// a coefficient's flags: its 8 neighbours' significance, its 4 direct
// neighbours' signs, and its own state
constexpr uint32_t kNW = 1, kN = 2, kNE = 4, kW = 8, kE = 16, kSW = 32, kS = 64, kSE = 128,
                   kNeighbours = 0xff, kSgnN = 1 << 8, kSgnS = 1 << 9, kSgnW = 1 << 10,
                   kSgnE = 1 << 11, kSig = 1 << 12, kVisit = 1 << 13, kRefined = 1 << 14;

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc[256];   // context
  uint8_t spb[256];  // sign prediction bit
  Luts() {
    for (int orient = 0; orient < 4; orient++) {
      for (int f = 0; f < 256; f++) {
        int h = !!(f & kW) + !!(f & kE);
        int v = !!(f & kN) + !!(f & kS);
        const int d = !!(f & kNW) + !!(f & kNE) + !!(f & kSW) + !!(f & kSE);
        int n;
        // band 1 (HL) swaps the horizontal and vertical counts
        if (orient == 1) std::swap(h, v);
        if (orient != 3) {
          if (!h) {
            n = !v ? (!d ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
          } else if (h == 1) {
            n = !v ? (!d ? 5 : 6) : 7;
          } else {
            n = 8;
          }
        } else {
          const int hv = h + v;
          if (!d) {
            n = !hv ? 0 : hv == 1 ? 1 : 2;
          } else if (d == 1) {
            n = !hv ? 3 : hv == 1 ? 4 : 5;
          } else if (d == 2) {
            n = !hv ? 6 : 7;
          } else {
            n = 8;
          }
        }
        zc[orient][f] = uint8_t(n);
      }
    }
    // index bits: W sig, W neg, E sig, E neg, N sig, N neg, S sig, S neg
    for (int i = 0; i < 256; i++) {
      auto contrib = [&](int sig, int neg) { return sig ? (neg ? -1 : 1) : 0; };
      int hc = contrib(i & 1, i & 2) + contrib(i & 4, i & 8);
      int vc = contrib(i & 16, i & 32) + contrib(i & 64, i & 128);
      hc = std::max(-1, std::min(1, hc));
      vc = std::max(-1, std::min(1, vc));
      int ctx, x;
      if (hc == 0 && vc == 0) {
        ctx = 0;
        x = 0;
      } else {
        int hh = hc, vv = vc;
        x = 0;
        if (hh < 0 || (hh == 0 && vv < 0)) {
          hh = -hh;
          vv = -vv;
          x = 1;
        }
        ctx = hh == 0 ? 1 : (vv == 1 ? 4 : vv == 0 ? 3 : 2);
      }
      sc[i] = uint8_t(kCtxSc + ctx);
      spb[i] = uint8_t(x);
    }
  }
};
const Luts kLuts;
inline const Luts& luts() { return kLuts; }

// t1.c's decoder over one code-block
struct T1 {
  uint32_t w = 0, h = 0;
  std::vector<int32_t> data;
  std::vector<uint32_t> flags;  // (w + 2) x (h + 2), a border around
  Mq mq;
  uint32_t orient = 0;
  bool vsc = false;

  uint32_t& fl(uint32_t x, uint32_t y) { return flags[(y + 1) * (w + 2) + x + 1]; }

  uint32_t sc_index(uint32_t f) const {
    uint32_t i = 0;
    if (f & kW) i |= 1 | ((f & kSgnW) ? 2 : 0);
    if (f & kE) i |= 4 | ((f & kSgnE) ? 8 : 0);
    if (f & kN) i |= 16 | ((f & kSgnN) ? 32 : 0);
    if (f & kS) i |= 64 | ((f & kSgnS) ? 128 : 0);
    return i;
  }

  // a coefficient becomes significant: its neighbours learn it (under VSC
  // the stripe above does not see the first row of a stripe)
  void significant(uint32_t x, uint32_t y, uint32_t neg) {
    const uint32_t stride = w + 2;
    uint32_t* f = &flags[(y + 1) * stride + x + 1];
    *f |= kSig;
    f[-1] |= kE | (neg ? kSgnE : 0);
    f[1] |= kW | (neg ? kSgnW : 0);
    if (!(vsc && (y & 3) == 0)) {
      uint32_t* up = f - stride;
      up[0] |= kS | (neg ? kSgnS : 0);
      up[-1] |= kSE;
      up[1] |= kSW;
    }
    uint32_t* dn = f + stride;
    dn[0] |= kN | (neg ? kSgnN : 0);
    dn[-1] |= kNE;
    dn[1] |= kNW;
  }

  void decode_sign(uint32_t x, uint32_t y, int32_t oneplushalf, bool raw) {
    uint32_t v;
    if (raw) {
      v = mq.raw();
    } else {
      const uint32_t i = sc_index(fl(x, y));
      v = mq.decode(luts().sc[i]) ^ luts().spb[i];
    }
    data[y * w + x] = v ? -oneplushalf : oneplushalf;
    significant(x, y, v);
  }

  void sigpass(int32_t bpno, bool raw) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (uint32_t k = 0; k < h; k += 4) {
      for (uint32_t x = 0; x < w; x++) {
        for (uint32_t y = k; y < std::min(k + 4, h); y++) {
          uint32_t& f = fl(x, y);
          if ((f & (kSig | kVisit)) || !(f & kNeighbours)) continue;
          const uint32_t bit = raw ? mq.raw() : mq.decode(luts().zc[orient][f & kNeighbours]);
          if (bit) decode_sign(x, y, oneplushalf, raw);
          fl(x, y) |= kVisit;
        }
      }
    }
  }

  void refpass(int32_t bpno, bool raw) {
    const int32_t poshalf = (1 << bpno) >> 1;
    for (uint32_t k = 0; k < h; k += 4) {
      for (uint32_t x = 0; x < w; x++) {
        for (uint32_t y = k; y < std::min(k + 4, h); y++) {
          uint32_t& f = fl(x, y);
          if ((f & (kSig | kVisit)) != kSig) continue;
          uint32_t v;
          if (raw) {
            v = mq.raw();
          } else {
            const int ctx = (f & kRefined) ? kCtxMag + 2 : (f & kNeighbours) ? kCtxMag + 1 : kCtxMag;
            v = mq.decode(ctx);
          }
          int32_t& d = data[y * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          f |= kRefined;
        }
      }
    }
  }

  void clnpass(int32_t bpno, bool segsym) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (uint32_t k = 0; k < h; k += 4) {
      for (uint32_t x = 0; x < w; x++) {
        uint32_t y = k;
        const uint32_t end = std::min(k + 4, h);
        if (end - k == 4) {
          bool run = true;
          for (uint32_t j = k; j < end; j++)
            if (fl(x, j) & (kSig | kVisit | kNeighbours)) run = false;
          if (run) {
            if (!mq.decode(kCtxAgg)) continue;
            uint32_t runlen = mq.decode(kCtxUni);
            runlen = (runlen << 1) | mq.decode(kCtxUni);
            y = k + runlen;
            decode_sign(x, y, oneplushalf, false);
            ++y;
          }
        }
        for (; y < end; y++) {
          uint32_t f = fl(x, y);
          if (!(f & (kSig | kVisit))) {
            if (mq.decode(luts().zc[orient][f & kNeighbours])) decode_sign(x, y, oneplushalf, false);
          }
        }
      }
    }
    for (uint32_t y = 0; y < h; y++)
      for (uint32_t x = 0; x < w; x++) fl(x, y) &= ~kVisit;
    if (segsym) {
      uint32_t v = mq.decode(kCtxUni);
      v = (v << 1) | mq.decode(kCtxUni);
      v = (v << 1) | mq.decode(kCtxUni);
      v = (v << 1) | mq.decode(kCtxUni);
      (void)v;  // a bad segmentation symbol is a warning only
    }
  }

  // opj_t1_decode_cblk
  void decode(const Cblk& cb, uint32_t bandno, uint32_t roishift, uint32_t cblksty) {
    w = uint32_t(cb.x1 - cb.x0);
    h = uint32_t(cb.y1 - cb.y0);
    data.assign(size_t(w) * h, 0);
    flags.assign(size_t(w + 2) * (h + 2), 0);
    orient = bandno;
    vsc = cblksty & 8;
    const int32_t bpno_plus_one0 = int32_t(roishift + cb.numbps);
    if (bpno_plus_one0 >= 31) fail("unsupported bpno_plus_one >= 31");
    int32_t bpno_plus_one = bpno_plus_one0;
    int passtype = 2;
    mq.reset_states();
    std::vector<uint8_t> seg_bytes;
    uint64_t index = 0;
    for (uint32_t segno = 0; segno < cb.real_num_segs; segno++) {
      const Seg& seg = cb.segs[segno];
      const bool raw = bpno_plus_one <= int32_t(cb.numbps) - 4 && passtype < 2 && (cblksty & 1);
      if (index + seg.len > cb.data.size()) fail("code-block data too short");
      seg_bytes.assign(cb.data.begin() + index, cb.data.begin() + index + seg.len);
      seg_bytes.push_back(0xff);
      seg_bytes.push_back(0xff);
      index += seg.len;
      if (raw) {
        mq.raw_init(seg_bytes.data());
      } else {
        mq.init(seg_bytes.data(), seg.len);
      }
      for (uint32_t passno = 0; passno < seg.real_num_passes && bpno_plus_one >= 1; passno++) {
        switch (passtype) {
          case 0: sigpass(bpno_plus_one, raw); break;
          case 1: refpass(bpno_plus_one, raw); break;
          default: clnpass(bpno_plus_one, cblksty & 32); break;
        }
        if ((cblksty & 2) && !raw) mq.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          bpno_plus_one--;
        }
      }
    }
  }
};

// opj_t1_decode_cblks over one tile-component: every code-block decoded,
// its ROI shift undone and its coefficients put in the tile (reversible:
// halved; irreversible: times half the band's step size)
void t1_decode(Tile& tile, Tcp& tcp, uint32_t compno) {
  TileComp& tc = tile.comps[compno];
  const Tccp& tccp = tcp.tccps[compno];
  const uint32_t tw = tc.w();
  T1 t1;
  for (uint32_t r = 0; r < tc.minres; r++) {
    Resolution& res = tc.res[r];
    for (uint32_t b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      for (Precinct& pr : band.precincts) {
        for (Cblk& cb : pr.cblks) {
          if (!area_of_interest(tile, tcp, compno, r, band.bandno, cb.x0, cb.y0, cb.x1, cb.y1))
            continue;
          if (tccp.cblksty & 0x40) {
            t1.w = uint32_t(cb.x1 - cb.x0);
            t1.h = uint32_t(cb.y1 - cb.y0);
            // OpenJPEG decodes one chunk where it lies in the tile's data
            // (malloc'd), several from a buffer of their own (malloc'd)
            mrt::HtBlock hb{cb.data.data(), uint32_t(cb.data.size()), cb.nchunks, cb.numsegs,
                            {0, 0}, {0, 0}, t1.w, t1.h, cb.numbps, cb.mb, tccp.roishift,
                            (tccp.cblksty & 8) != 0,
                            cb.nchunks == 1 ? uint32_t(cb.chunk0 & 3) : 0u};
            for (uint32_t k = 0; k < 2 && k < cb.numsegs; k++) {
              hb.seg_len[k] = cb.segs[k].len;
              hb.seg_passes[k] = cb.segs[k].real_num_passes;
            }
            mrt::jpeg2000_ht_block(hb, t1.data);
          } else {
            t1.decode(cb, band.bandno, tccp.roishift, tccp.cblksty);
          }
          if (t1.w == 0 || t1.h == 0) continue;
          uint32_t x = uint32_t(cb.x0 - band.x0), y = uint32_t(cb.y0 - band.y0);
          if (band.bandno & 1) x += uint32_t(tc.res[r - 1].x1 - tc.res[r - 1].x0);
          if (band.bandno & 2) y += uint32_t(tc.res[r - 1].y1 - tc.res[r - 1].y0);
          const uint32_t cw = t1.w, ch = t1.h;
          if (tccp.roishift) {
            if (tccp.roishift >= 31) {
              std::fill(t1.data.begin(), t1.data.end(), 0);
            } else {
              const int32_t thresh = 1 << tccp.roishift;
              for (int32_t& v : t1.data) {
                int32_t mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                  mag >>= tccp.roishift;
                  v = v < 0 ? -mag : mag;
                }
              }
            }
          }
          for (uint32_t j = 0; j < ch; j++) {
            Sample* row = &tc.data[size_t(y + j) * tw + x];
            const int32_t* src = &t1.data[size_t(j) * cw];
            if (tccp.qmfbid == 1) {
              for (uint32_t i = 0; i < cw; i++) row[i].i = src[i] / 2;
            } else {
              const float step = 0.5f * band.stepsize;
              for (uint32_t i = 0; i < cw; i++) row[i].f = float(src[i]) * step;
            }
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------- DWT
inline int32_t wadd(int32_t a, int32_t b) { return int32_t(uint32_t(a) + uint32_t(b)); }
inline int32_t wsub(int32_t a, int32_t b) { return int32_t(uint32_t(a) - uint32_t(b)); }

// the inverse 5/3 of one line: `sn` low then `dn` high coefficients in,
// samples out; `cas`: the parity of the line's first coordinate
void idwt53(int32_t* line, int32_t* tmp, int32_t sn, int32_t dn, int32_t cas) {
  const int32_t len = sn + dn;
  if (cas == 0) {
    if (len <= 1) return;
  } else if (len == 1) {
    line[0] /= 2;
    return;
  }
  // interleave: the low coefficients at the even coordinates
  for (int32_t i = 0; i < sn; i++) tmp[2 * i + cas] = line[i];
  for (int32_t i = 0; i < dn; i++) tmp[2 * i + 1 - cas] = line[sn + i];
  auto at = [&](int32_t i) { return tmp[i < 0 ? -i : i >= len ? 2 * (len - 1) - i : i]; };
  // the even coordinates: x -= (left + right + 2) >> 2
  for (int32_t i = cas; i < len; i += 2)
    tmp[i] = wsub(tmp[i], wadd(wadd(at(i - 1), at(i + 1)), 2) >> 2);
  // the odd ones: x += (left + right) >> 1
  for (int32_t i = 1 - cas; i < len; i += 2)
    tmp[i] = wadd(tmp[i], wadd(at(i - 1), at(i + 1)) >> 1);
  std::memcpy(line, tmp, size_t(len) * sizeof(int32_t));
}

// dwt.c's opj_v8dwt_decode on one line (`w`: interleaved, low at `cas`)
constexpr float kDwtAlpha = -1.586134342f, kDwtBeta = -0.052980118f, kDwtGamma = 0.882911075f,
                kDwtDelta = 0.443506852f, kDwtK = 1.230174105f, kTwoInvK = 1.625732422f;

void v8_step2(float* wv, int32_t l, int32_t wi, uint32_t end, uint32_t m, float c) {
  const uint32_t imax = std::min(end, m);
  uint32_t i = 0;
  int32_t vl = l, vw = wi;
  for (; i < imax; ++i) {
    wv[vw - 1] = wv[vw - 1] + ((wv[vl] + wv[vw]) * c);
    vl = vw;
    vw += 2;
  }
  if (m < end) wv[vw - 1] = wv[vw - 1] + ((c + c) * wv[vl]);
}

void idwt97(float* wv, int32_t sn, int32_t dn, int32_t cas) {
  int32_t a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int32_t i = 0; i < sn; i++) wv[a + 2 * i] = wv[a + 2 * i] * kDwtK;
  for (int32_t i = 0; i < dn; i++) wv[b + 2 * i] = wv[b + 2 * i] * kTwoInvK;
  v8_step2(wv, b, a + 1, uint32_t(sn), uint32_t(std::min(sn, dn - a)), -kDwtDelta);
  v8_step2(wv, a, b + 1, uint32_t(dn), uint32_t(std::min(dn, sn - b)), -kDwtGamma);
  v8_step2(wv, b, a + 1, uint32_t(sn), uint32_t(std::min(sn, dn - a)), -kDwtBeta);
  v8_step2(wv, a, b + 1, uint32_t(dn), uint32_t(std::min(dn, sn - b)), -kDwtAlpha);
}

// opj_dwt_decode (5/3) or opj_dwt_decode_real (9/7) over `numres`
// resolutions of a tile-component
void dwt_decode(TileComp& tc, uint32_t numres, bool real) {
  if (numres <= 1 || tc.data.empty()) return;
  const uint32_t w = tc.w();
  uint32_t maxlen = 0;
  for (uint32_t r = 0; r < numres; r++)
    maxlen = std::max({maxlen, uint32_t(tc.res[r].x1 - tc.res[r].x0),
                       uint32_t(tc.res[r].y1 - tc.res[r].y0)});
  std::vector<int32_t> line(maxlen + 2), tmp(maxlen + 2);
  std::vector<float> fline(maxlen + 2);
  uint32_t rw = uint32_t(tc.res[0].x1 - tc.res[0].x0), rh = uint32_t(tc.res[0].y1 - tc.res[0].y0);
  for (uint32_t r = 1; r < numres; r++) {
    const int32_t hsn = int32_t(rw), vsn = int32_t(rh);
    const Resolution& res = tc.res[r];
    rw = uint32_t(res.x1 - res.x0);
    rh = uint32_t(res.y1 - res.y0);
    const int32_t hdn = int32_t(rw) - hsn, vdn = int32_t(rh) - vsn;
    const int32_t hcas = res.x0 % 2, vcas = res.y0 % 2;
    for (uint32_t j = 0; j < rh; j++) {
      Sample* row = &tc.data[size_t(j) * w];
      if (real) {
        // interleave (opj_v8dwt_interleave_h): low at 2i + cas
        std::fill(fline.begin(), fline.end(), 0.f);
        for (int32_t i = 0; i < hsn; i++) fline[2 * i + hcas] = row[i].f;
        for (int32_t i = 0; i < hdn; i++) fline[2 * i + 1 - hcas] = row[hsn + i].f;
        idwt97(fline.data(), hsn, hdn, hcas);
        for (uint32_t i = 0; i < rw; i++) row[i].f = fline[i];
      } else {
        for (uint32_t i = 0; i < rw; i++) line[i] = row[i].i;
        idwt53(line.data(), tmp.data(), hsn, hdn, hcas);
        for (uint32_t i = 0; i < rw; i++) row[i].i = line[i];
      }
    }
    for (uint32_t i = 0; i < rw; i++) {
      Sample* col = &tc.data[i];
      if (real) {
        std::fill(fline.begin(), fline.end(), 0.f);
        for (int32_t k = 0; k < vsn; k++) fline[2 * k + vcas] = col[size_t(k) * w].f;
        for (int32_t k = 0; k < vdn; k++) fline[2 * k + 1 - vcas] = col[size_t(vsn + k) * w].f;
        idwt97(fline.data(), vsn, vdn, vcas);
        for (uint32_t k = 0; k < rh; k++) col[size_t(k) * w].f = fline[k];
      } else {
        for (uint32_t k = 0; k < rh; k++) line[k] = col[size_t(k) * w].i;
        idwt53(line.data(), tmp.data(), vsn, vdn, vcas);
        for (uint32_t k = 0; k < rh; k++) col[size_t(k) * w].i = line[k];
      }
    }
  }
}

// ------------------------------------------------ MCT, DC shift and output
// opj_tcd_mct_decode: the inverse RCT or ICT of components 0-2
void mct_decode(Tile& tile, Tcp& tcp, uint32_t numcomps) {
  if (!tcp.mct) return;
  if (numcomps < 3) return;  // "inconsistent with a MCT": a message only
  TileComp& c0 = tile.comps[0];
  TileComp& c1 = tile.comps[1];
  TileComp& c2 = tile.comps[2];
  if (c0.minres != c1.minres || c0.minres != c2.minres)
    fail("tiles don't all have the same dimension: the MCT is not applied");
  const Resolution& r0 = c0.res[c0.minres - 1];
  const Resolution& r1 = c1.res[c1.minres - 1];
  const Resolution& r2 = c2.res[c2.minres - 1];
  const uint64_t n = uint64_t(r0.x1 - r0.x0) * uint64_t(r0.y1 - r0.y0);
  if (uint64_t(r1.x1 - r1.x0) * uint64_t(r1.y1 - r1.y0) != n ||
      uint64_t(r2.x1 - r2.x0) * uint64_t(r2.y1 - r2.y0) != n)
    fail("tiles don't all have the same dimension: the MCT is not applied");
  Sample* a = c0.data.data();
  Sample* b = c1.data.data();
  Sample* c = c2.data.data();
  if (tcp.tccps[0].qmfbid == 1) {
    for (uint64_t i = 0; i < n; i++) {
      const int32_t y = a[i].i, u = b[i].i, v = c[i].i;
      const int32_t g = wsub(y, wadd(u, v) >> 2);
      a[i].i = wadd(v, g);
      b[i].i = g;
      c[i].i = wadd(u, g);
    }
  } else {
    for (uint64_t i = 0; i < n; i++) {
      const float y = a[i].f, u = b[i].f, v = c[i].f;
      const float r = y + (v * 1.402f);
      const float g = y - (u * 0.34413f) - (v * 0.71414f);
      const float bb = y + (u * 1.772f);
      a[i].f = r;
      b[i].f = g;
      c[i].f = bb;
    }
  }
}

// opj_tcd_dc_level_shift_decode over the decoded resolution's area
void dc_shift(TileComp& tc, const Tccp& tccp, const Comp& comp) {
  if (tc.data.empty()) return;
  const Resolution& res = tc.res[comp.resno_decoded];
  const uint32_t w = uint32_t(res.x1 - res.x0), h = uint32_t(res.y1 - res.y0), stride = tc.w();
  int32_t lo, hi;
  if (comp.sgnd) {
    lo = -(1 << (comp.prec - 1));
    hi = (1 << (comp.prec - 1)) - 1;
  } else {
    lo = 0;
    hi = int32_t((1u << comp.prec) - 1);
  }
  for (uint32_t j = 0; j < h; j++) {
    Sample* row = &tc.data[size_t(j) * stride];
    for (uint32_t i = 0; i < w; i++) {
      if (tccp.qmfbid == 1) {
        row[i].i = std::max(lo, std::min(hi, wadd(row[i].i, tccp.dc_shift)));
      } else {
        const float v = row[i].f;
        if (v > float(INT32_MAX)) {
          row[i].i = hi;
        } else if (v < float(INT32_MIN)) {
          row[i].i = lo;
        } else {
          const int64_t r = int64_t(std::lrintf(v)) + tccp.dc_shift;
          row[i].i = int32_t(std::max<int64_t>(lo, std::min<int64_t>(hi, r)));
        }
      }
    }
  }
}

// ------------------------------------------------------------- Pillow
// Pillow's modes of Jpeg2KImageFile (the probe's), by code
enum Mode { kL = 0, kI16 = 1, kLA = 2, kRGB = 3, kRGBA = 4, kCMYK = 5, kP = 6, kPA = 7 };

// ConvertYCbCr.c's tables, SCALE 6: R and B as their shifted values,
// G's two tables summed and shifted per pixel
constexpr int16_t kRCr[256] = {
    -180, -179, -177, -176, -174, -173, -172, -170, -169, -167, -166, -165, -163, -162, -160, -159,
    -158, -156, -155, -153, -152, -150, -149, -148, -146, -145, -143, -142, -141, -139, -138, -136,
    -135, -134, -132, -131, -129, -128, -127, -125, -124, -122, -121, -120, -118, -117, -115, -114,
    -113, -111, -110, -108, -107, -106, -104, -103, -101, -100, -99, -97, -96, -94, -93, -92,
    -90, -89, -87, -86, -85, -83, -82, -80, -79, -78, -76, -75, -73, -72, -71, -69,
    -68, -66, -65, -64, -62, -61, -59, -58, -57, -55, -54, -52, -51, -50, -48, -47,
    -45, -44, -43, -41, -40, -38, -37, -36, -34, -33, -31, -30, -29, -27, -26, -24,
    -23, -22, -20, -19, -17, -16, -14, -13, -12, -10, -9, -7, -6, -5, -3, -2,
    0, 1, 2, 4, 5, 7, 8, 9, 11, 12, 14, 15, 16, 18, 19, 21,
    22, 23, 25, 26, 28, 29, 30, 32, 33, 35, 36, 37, 39, 40, 42, 43,
    44, 46, 47, 49, 50, 51, 53, 54, 56, 57, 58, 60, 61, 63, 64, 65,
    67, 68, 70, 71, 72, 74, 75, 77, 78, 79, 81, 82, 84, 85, 86, 88,
    89, 91, 92, 93, 95, 96, 98, 99, 100, 102, 103, 105, 106, 107, 109, 110,
    112, 113, 114, 116, 117, 119, 120, 121, 123, 124, 126, 127, 128, 130, 131, 133,
    134, 136, 137, 138, 140, 141, 143, 144, 145, 147, 148, 150, 151, 152, 154, 155,
    157, 158, 159, 161, 162, 164, 165, 166, 168, 169, 171, 172, 173, 175, 176, 178};
constexpr int16_t kBCb[256] = {
    -227, -226, -224, -222, -220, -218, -217, -215, -213, -211, -210, -208, -206, -204, -202, -201,
    -199, -197, -195, -194, -192, -190, -188, -187, -185, -183, -181, -179, -178, -176, -174, -172,
    -171, -169, -167, -165, -164, -162, -160, -158, -156, -155, -153, -151, -149, -148, -146, -144,
    -142, -140, -139, -137, -135, -133, -132, -130, -128, -126, -125, -123, -121, -119, -117, -116,
    -114, -112, -110, -109, -107, -105, -103, -101, -100, -98, -96, -94, -93, -91, -89, -87,
    -86, -84, -82, -80, -78, -77, -75, -73, -71, -70, -68, -66, -64, -62, -61, -59,
    -57, -55, -54, -52, -50, -48, -47, -45, -43, -41, -39, -38, -36, -34, -32, -31,
    -29, -27, -25, -24, -22, -20, -18, -16, -15, -13, -11, -9, -8, -6, -4, -2,
    0, 1, 3, 5, 7, 8, 10, 12, 14, 15, 17, 19, 21, 23, 24, 26,
    28, 30, 31, 33, 35, 37, 38, 40, 42, 44, 46, 47, 49, 51, 53, 54,
    56, 58, 60, 62, 63, 65, 67, 69, 70, 72, 74, 76, 77, 79, 81, 83,
    85, 86, 88, 90, 92, 93, 95, 97, 99, 101, 102, 104, 106, 108, 109, 111,
    113, 115, 116, 118, 120, 122, 124, 125, 127, 129, 131, 132, 134, 136, 138, 139,
    141, 143, 145, 147, 148, 150, 152, 154, 155, 157, 159, 161, 163, 164, 166, 168,
    170, 171, 173, 175, 177, 178, 180, 182, 184, 186, 187, 189, 191, 193, 194, 196,
    198, 200, 202, 203, 205, 207, 209, 210, 212, 214, 216, 217, 219, 221, 223, 225};
constexpr int16_t kGCb[256] = {
    2817, 2807, 2761, 2753, 2707, 2697, 2687, 2643, 2633, 2621, 2579, 2567, 2557, 2514, 2501, 2493,
    2448, 2437, 2428, 2382, 2373, 2362, 2318, 2308, 2297, 2254, 2242, 2233, 2187, 2177, 2168, 2121,
    2113, 2102, 2057, 2048, 2003, 1993, 1982, 1939, 1928, 1917, 1875, 1862, 1853, 1809, 1797, 1789,
    1743, 1733, 1723, 1678, 1669, 1657, 1614, 1603, 1593, 1549, 1537, 1529, 1483, 1473, 1464, 1417,
    1409, 1398, 1353, 1344, 1299, 1289, 1277, 1235, 1223, 1213, 1170, 1157, 1149, 1104, 1093, 1084,
    1038, 1029, 1018, 974, 964, 953, 910, 898, 889, 844, 833, 825, 778, 769, 759, 713,
    705, 659, 649, 639, 595, 585, 573, 531, 519, 509, 466, 453, 445, 399, 389, 379,
    334, 325, 313, 270, 259, 249, 205, 193, 185, 139, 129, 120, 73, 65, 54, 9,
    0, -45, -55, -65, -109, -119, -131, -173, -185, -195, -238, -251, -259, -304, -315, -324,
    -370, -379, -390, -434, -444, -455, -499, -511, -519, -565, -575, -584, -631, -639, -650, -695,
    -704, -749, -759, -770, -813, -824, -835, -877, -890, -899, -943, -955, -963, -1009, -1019, -1029,
    -1074, -1083, -1095, -1138, -1149, -1159, -1203, -1215, -1223, -1269, -1279, -1288, -1335, -1343, -1389, -1399,
    -1409, -1453, -1463, -1475, -1517, -1529, -1539, -1582, -1595, -1603, -1648, -1659, -1668, -1714, -1723, -1734,
    -1778, -1788, -1799, -1842, -1854, -1863, -1908, -1919, -1927, -1974, -1983, -1993, -2039, -2047, -2093, -2103,
    -2113, -2157, -2167, -2179, -2221, -2234, -2243, -2287, -2299, -2307, -2353, -2363, -2373, -2418, -2427, -2439,
    -2482, -2493, -2503, -2547, -2559, -2567, -2613, -2623, -2632, -2679, -2687, -2698, -2743, -2752, -2797, -2807};
constexpr int16_t kGCr[256] = {
    5869, 5815, 5759, 5703, 5682, 5627, 5571, 5549, 5495, 5439, 5383, 5362, 5307, 5251, 5229, 5175,
    5119, 5063, 5043, 4987, 4931, 4909, 4855, 4799, 4743, 4723, 4667, 4611, 4589, 4535, 4479, 4423,
    4403, 4347, 4291, 4270, 4215, 4159, 4103, 4083, 4027, 3971, 3950, 3895, 3839, 3784, 3763, 3707,
    3651, 3630, 3575, 3519, 3464, 3443, 3387, 3331, 3310, 3255, 3199, 3144, 3123, 3067, 3012, 2990,
    2935, 2879, 2824, 2803, 2747, 2692, 2670, 2615, 2559, 2504, 2483, 2427, 2372, 2350, 2295, 2240,
    2184, 2163, 2107, 2052, 2030, 1975, 1920, 1864, 1843, 1787, 1732, 1710, 1655, 1600, 1544, 1523,
    1468, 1412, 1390, 1335, 1280, 1224, 1203, 1148, 1092, 1070, 1016, 960, 904, 883, 828, 772,
    750, 696, 640, 584, 563, 508, 452, 430, 376, 320, 264, 244, 188, 132, 110, 56,
    0, -55, -75, -131, -187, -209, -263, -319, -375, -395, -451, -507, -528, -583, -639, -695,
    -715, -771, -827, -848, -903, -959, -1015, -1035, -1091, -1147, -1168, -1223, -1279, -1334, -1355, -1411,
    -1467, -1488, -1543, -1599, -1654, -1675, -1731, -1786, -1808, -1863, -1919, -1974, -1995, -2051, -2106, -2128,
    -2183, -2239, -2294, -2315, -2371, -2426, -2448, -2503, -2558, -2614, -2635, -2691, -2746, -2768, -2823, -2878,
    -2934, -2955, -3011, -3066, -3088, -3143, -3198, -3254, -3275, -3330, -3386, -3408, -3463, -3518, -3574, -3595,
    -3650, -3706, -3728, -3783, -3838, -3894, -3915, -3970, -4026, -4048, -4102, -4158, -4214, -4235, -4290, -4346,
    -4368, -4422, -4478, -4534, -4554, -4610, -4666, -4688, -4742, -4798, -4854, -4874, -4930, -4986, -5008, -5062,
    -5118, -5174, -5194, -5250, -5306, -5327, -5382, -5438, -5494, -5514, -5570, -5626, -5647, -5702, -5758, -5780};

void ycbcr_rgb(uint8_t* px, uint32_t n) {
  for (uint32_t x = 0; x < n; x++, px += 4) {
    const int y = px[0], cb = px[1], cr = px[2];
    const int r = y + kRCr[cr];
    const int g = y + ((kGCb[cb] + kGCr[cr]) >> 6);
    const int b = y + kBCb[cb];
    px[0] = uint8_t(r <= 0 ? 0 : r >= 255 ? 255 : r);
    px[1] = uint8_t(g <= 0 ? 0 : g >= 255 ? 255 : g);
    px[2] = uint8_t(b <= 0 ? 0 : b >= 255 ? 255 : b);
  }
}

// Jpeg2KDecode.c's unpackers, by name
enum Unpacker { kNone, kGrayL, kGrayI, kGrayRGB, kGrayALA, kSrgbRGB, kSyccRGB, kSrgbaRGBA, kSyccaRGBA };

// the j2k_unpackers table: (mode, colour space, components, subsampling)
Unpacker find_unpacker(int mode, int space, uint32_t numcomps, bool comp0_full) {
  struct Row {
    int mode, space;
    uint32_t comps;
    bool subsampling;
    Unpacker u;
  };
  static const Row rows[] = {
      {kL, 2, 1, false, kGrayL},        {kP, 1, 1, false, kGrayL},
      {kPA, 1, 2, false, kGrayALA},     {kI16, 2, 1, false, kGrayI},
      {kLA, 2, 2, false, kGrayALA},     {kRGB, 2, 1, false, kGrayRGB},
      {kRGB, 2, 2, false, kGrayRGB},    {kRGB, 1, 3, true, kSrgbRGB},
      {kRGB, 3, 3, true, kSyccRGB},     {kRGB, 1, 4, true, kSrgbRGB},
      {kRGB, 3, 4, true, kSyccRGB},     {kRGBA, 2, 1, false, kGrayRGB},
      {kRGBA, 2, 2, false, kGrayALA},   {kRGBA, 1, 3, true, kSrgbRGB},
      {kRGBA, 3, 3, true, kSyccRGB},    {kRGBA, 1, 4, true, kSrgbaRGBA},
      {kRGBA, 3, 4, true, kSyccaRGBA},  {kRGBA, 2, 4, true, kSrgbaRGBA},
      {kCMYK, 5, 4, true, kSrgbaRGBA},
  };
  for (const Row& r : rows)
    if (r.space == space && r.comps == numcomps && (r.subsampling || comp0_full) && r.mode == mode)
      return r.u;
  return kNone;
}

// Pillow's image being decoded: 1 byte a pixel (L, P), 2 (I;16) or 4
struct PilImage {
  int mode;
  uint32_t w, h, bpp;
  std::vector<uint8_t> px;
  PilImage(int m, uint32_t width, uint32_t height) : mode(m), w(width), h(height) {
    bpp = (m == kL || m == kP) ? 1 : m == kI16 ? 2 : 4;
    px.assign(size_t(w) * h * bpp, 0);
  }
  uint8_t* row(uint32_t y) { return px.data() + size_t(y) * w * bpp; }
};

struct CompInfo {
  int shift, offset, csiz;
  uint32_t dx, dy;
};

CompInfo comp_info(const Comp& c, int depth) {
  CompInfo ci;
  ci.shift = depth - int(c.prec);
  ci.offset = c.sgnd ? 1 << (c.prec - 1) : 0;
  ci.csiz = int((c.prec + 7) >> 3);
  if (ci.csiz == 3) ci.csiz = 4;
  if (ci.shift < 0) ci.offset += 1 << (-ci.shift - 1);
  ci.dx = c.dx;
  ci.dy = c.dy;
  return ci;
}

inline uint32_t word_at(const uint8_t* p, int csiz, size_t i) {
  switch (csiz) {
    case 1: return p[i];
    case 2: {
      uint16_t v;
      std::memcpy(&v, p + 2 * i, 2);
      return v;
    }
    default: {
      uint32_t v;
      std::memcpy(&v, p + 4 * i, 4);
      return v;
    }
  }
}

inline uint32_t pshift(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

// one tile's unpack into Pillow's image (`td`: the tile's components as
// opj_decode_tile_data gives them, `x0`..`y1` the tile's image area)
void unpack(Unpacker u, const std::vector<Comp>& comps, const uint8_t* td, uint32_t ix0,
            uint32_t iy0, uint32_t w, uint32_t h, PilImage& im) {
  switch (u) {
    case kGrayL:
    case kGrayI:
    case kGrayRGB: {
      const CompInfo c = comp_info(comps[0], u == kGrayI ? 16 : 8);
      for (uint32_t y = 0; y < h; y++) {
        const uint8_t* data = td + size_t(c.csiz) * y * w;
        uint8_t* row = im.row(iy0 + y);
        for (uint32_t x = 0; x < w; x++) {
          const uint32_t v = pshift(uint32_t(c.offset) + word_at(data, c.csiz, x), c.shift);
          if (u == kGrayL) {
            row[ix0 + x] = uint8_t(v);
          } else if (u == kGrayI) {
            const uint16_t s = uint16_t(v);
            std::memcpy(row + 2 * (ix0 + x), &s, 2);
          } else {
            uint8_t* p = row + 4 * (ix0 + x);
            p[0] = p[1] = p[2] = uint8_t(v);
            p[3] = 0xff;
          }
        }
      }
      break;
    }
    case kGrayALA: {
      const CompInfo c = comp_info(comps[0], 8), a = comp_info(comps[1], 8);
      const uint8_t* at = td + size_t(c.csiz) * w * h;
      for (uint32_t y = 0; y < h; y++) {
        const uint8_t* data = td + size_t(c.csiz) * y * w;
        const uint8_t* adata = at + size_t(a.csiz) * y * w;
        uint8_t* row = im.row(iy0 + y) + 4 * size_t(ix0);
        for (uint32_t x = 0; x < w; x++) {
          const uint8_t v = uint8_t(pshift(uint32_t(c.offset) + word_at(data, c.csiz, x), c.shift));
          row[4 * x] = row[4 * x + 1] = row[4 * x + 2] = v;
          row[4 * x + 3] = uint8_t(pshift(uint32_t(a.offset) + word_at(adata, a.csiz, x), a.shift));
        }
      }
      break;
    }
    default: {
      const int n_in = (u == kSrgbaRGBA || u == kSyccaRGBA) ? 4 : 3;
      CompInfo c[4];
      const uint8_t* cdata[4];
      const uint8_t* p = td;
      for (int n = 0; n < n_in; n++) {
        c[n] = comp_info(comps[n], 8);
        cdata[n] = p;
        p += size_t(c[n].csiz) * (w / c[n].dx) * (h / c[n].dy);
      }
      for (uint32_t y = 0; y < h; y++) {
        uint8_t* row = im.row(iy0 + y) + 4 * size_t(ix0);
        const uint8_t* data[4];
        for (int n = 0; n < n_in; n++)
          data[n] = cdata[n] + size_t(c[n].csiz) * (y / c[n].dy) * (w / c[n].dx);
        for (uint32_t x = 0; x < w; x++) {
          for (int n = 0; n < n_in; n++)
            row[4 * x + n] = uint8_t(
                pshift(uint32_t(c[n].offset) + word_at(data[n], c[n].csiz, x / c[n].dx), c[n].shift));
          if (n_in == 3) row[4 * x + 3] = 0xff;
        }
        if (u == kSyccRGB || u == kSyccaRGBA) ycbcr_rgb(row, w);
      }
      break;
    }
  }
}


// convert("RGB") of Pillow's image (`palette`: 256 RGB entries for P, PA)
void to_rgb(PilImage& im, const uint8_t* palette, uint8_t* out) {
  const size_t n = size_t(im.w) * im.h;
  const uint8_t* p = im.px.data();
  for (size_t i = 0; i < n; i++, out += 3) {
    switch (im.mode) {
      case kL: out[0] = out[1] = out[2] = p[i]; break;
      case kP: std::memcpy(out, palette + 3 * p[i], 3); break;
      case kI16: {
        uint16_t v;
        std::memcpy(&v, p + 2 * i, 2);
        out[0] = out[1] = out[2] = uint8_t(v > 255 ? 255 : v);
        break;
      }
      case kLA: out[0] = out[1] = out[2] = p[4 * i]; break;
      case kPA: std::memcpy(out, palette + 3 * p[4 * i], 3); break;
      case kCMYK: mrt::cmyk_rgb(p + 4 * i, out); break;
      default: std::memcpy(out, p + 4 * i, 3); break;
    }
  }
}

// -------------------------------------------------------------- the decode
struct Decoder {
  Stream s;
  Jp2 jp2;
  bool is_jp2;
  Codestream cs;
  int space = 0;  // OpenJPEG's colour space: 0 unspecified, else Jp2::color_space
  Decoder(const uint8_t* d, int64_t n) : s{d, uint64_t(n)}, cs(s) {
    is_jp2 = n >= 4 && !(d[0] == 0xff && d[1] == 0x4f && d[2] == 0xff && d[3] == 0x51);
  }

  // opj_read_header
  void header() {
    if (is_jp2) {
      jp2.boxes(s);
      if (!jp2.has_jp2h) fail("JP2H box missing");
      if (!jp2.has_ihdr) fail("IHDR box missing");
      cs.ihdr_w = jp2.w;
      cs.ihdr_h = jp2.h;
    }
    cs.main_header();
    space = is_jp2 ? jp2.color_space() : 0;
  }

  // one tile: T2, T1, the inverse DWT, MCT and DC shift, then its bytes as
  // opj_decode_tile_data gives them
  std::vector<uint8_t> tile(uint32_t tileno, Tile& t) {
    Tcp& tcp = cs.tcp_of(tileno);
    init_tile(cs, tileno, t);
    if (!tcp.has_data) fail("a tile without data");
    uint64_t size = 0;
    for (uint32_t c = 0; c < cs.numcomps; c++) {
      const TileComp& tc = t.comps[c];
      const uint64_t w = uint32_t(tc.x1 - tc.x0), h = uint32_t(tc.y1 - tc.y0);
      int csiz = int((cs.comps[c].prec + 7) >> 3);
      if (csiz == 3) csiz = 4;
      size += w * h * uint64_t(csiz);
    }
    if (size > 0xFFFFFFFFull) fail("tile data too large");
    for (TileComp& tc : t.comps)
      tc.data.assign(size_t(uint32_t(tc.x1 - tc.x0)) * uint32_t(tc.y1 - tc.y0), Sample{0});
    t2_decode(cs, t, tcp);
    for (uint32_t c = 0; c < cs.numcomps; c++) t1_decode(t, tcp, c);
    for (uint32_t c = 0; c < cs.numcomps; c++)
      dwt_decode(t.comps[c], cs.comps[c].resno_decoded + 1, tcp.tccps[c].qmfbid == 0);
    mct_decode(t, tcp, cs.numcomps);
    for (uint32_t c = 0; c < cs.numcomps; c++) dc_shift(t.comps[c], tcp.tccps[c], cs.comps[c]);
    std::vector<uint8_t> out(static_cast<size_t>(size));
    uint8_t* o = out.data();
    for (uint32_t c = 0; c < cs.numcomps; c++) {
      const TileComp& tc = t.comps[c];
      const Comp& comp = cs.comps[c];
      const Resolution& res = tc.res[comp.resno_decoded];
      const uint32_t w = uint32_t(res.x1 - res.x0), h = uint32_t(res.y1 - res.y0);
      int csiz = int((comp.prec + 7) >> 3);
      if (csiz == 3) csiz = 4;
      for (uint32_t j = 0; j < h && w > 0; j++) {
        const Sample* row = &tc.data[size_t(j) * tc.w()];
        for (uint32_t i = 0; i < w; i++) {
          const uint32_t v = uint32_t(row[i].i);
          for (int k = 0; k < csiz; k++) *o++ = uint8_t(v >> (8 * k));
        }
      }
    }
    out.resize(size_t(o - out.data()));
    return out;
  }

  void decode(int mode, const uint8_t* palette, uint8_t* rgb, uint32_t width, uint32_t height) {
    header();
    if (cs.numcomps < 1 || cs.numcomps > 4)
      fail("broken data stream: a colour space or component count Pillow does not take");
    // Pillow's colour space where OpenJPEG gives none: gray for 1 or 2
    // components; for 3 or 4, sYCC where component 0 is full-size and
    // component 1 or 2 subsampled, else sRGB
    int sp = space;
    if (sp == 0) {
      auto full = [&](uint32_t c) { return cs.comps[c].dx == 1 && cs.comps[c].dy == 1; };
      if (cs.numcomps <= 2) {
        sp = 2;
      } else {
        sp = full(0) && !(full(1) && full(2)) ? 3 : 1;
      }
    }
    const bool comp0_full = cs.comps[0].dx == 1 && cs.comps[0].dy == 1;
    const Unpacker u = find_unpacker(mode, sp, cs.numcomps, comp0_full);
    if (u == kNone) fail("broken data stream: no unpacker of Pillow's for this mode");
    if (width != cs.x1 - cs.x0 || height != cs.y1 - cs.y0) fail("the image's size changed");
    PilImage im(mode, width, height);
    // Pillow's tile buffer, kept from tile to tile and grown to the larger
    // of OpenJPEG's tile size and the tile's area in every component: a
    // component smaller than Pillow's indexing assumes reads on into what
    // an earlier tile left there (zeros where no tile wrote)
    std::vector<uint8_t> buffer;
    uint64_t comp_width = 0;
    for (const Comp& c : cs.comps) {
      uint64_t k = (c.prec + 7) >> 3;
      comp_width += k == 3 ? 4 : k;
    }
    for (;;) {
      if (!cs.tile_header()) break;
      Tile t;
      const uint32_t tileno = cs.tile;
      std::vector<uint8_t> td = tile(tileno, t);
      // the tile's bytes are OpenJPEG's; a tile-component without data
      // there (a tile of one part decoded) is released
      cs.tcps[tileno]->data.clear();
      cs.tcps[tileno]->data.shrink_to_fit();
      cs.tcps[tileno]->has_data = false;
      // Pillow's tile checks, then its unpack
      if (t.x0 >= t.x1 || t.y0 >= t.y1 || uint32_t(t.x0) < cs.x0 || uint32_t(t.y0) < cs.y0 ||
          int64_t(uint32_t(t.x1) - cs.x0) > int64_t(width) ||
          int64_t(uint32_t(t.y1) - cs.y0) > int64_t(height))
        fail("broken data stream: a tile outside the image");
      const uint32_t tw = uint32_t(t.x1 - t.x0), th = uint32_t(t.y1 - t.y0);
      uint64_t opj_size = 0;
      for (uint32_t c = 0; c < cs.numcomps; c++) {
        const TileComp& tc = t.comps[c];
        uint64_t k = (cs.comps[c].prec + 7) >> 3;
        opj_size += uint64_t(uint32_t(tc.x1 - tc.x0)) * uint32_t(tc.y1 - tc.y0) * (k == 3 ? 4 : k);
      }
      const uint64_t need = std::max<uint64_t>(opj_size, uint64_t(tw) * th * comp_width);
      if (buffer.size() < need) buffer.resize(size_t(need), 0);
      std::memcpy(buffer.data(), td.data(), td.size());
      unpack(u, cs.comps, buffer.data(), uint32_t(t.x0) - cs.x0, uint32_t(t.y0) - cs.y0, tw, th, im);
      cs.after_tile();
    }
    if (is_jp2) jp2.boxes(s);  // opj_jp2_end_decompress reads on
    to_rgb(im, palette, rgb);
  }
};

}  // namespace

extern "C" {

// The image size of a JPEG 2000 file's codestream (SIZ), its headers read
// as OpenJPEG reads them (`mode` and `palette` as the decode's, unused).
int mrt_jpeg2000_size(const uint8_t* data, int64_t n, int32_t* height, int32_t* width, char* msg,
                      int32_t msg_len, int32_t mode, const uint8_t* palette) {
  (void)mode;
  (void)palette;
  return guarded("JPEG2000", msg, msg_len, [&] {
    Decoder d(data, n);
    d.header();
    *height = int32_t(std::min<uint32_t>(d.cs.y1 - d.cs.y0, INT32_MAX));
    *width = int32_t(std::min<uint32_t>(d.cs.x1 - d.cs.x0, INT32_MAX));
  });
}

// The whole decode into out [height, width, 3]: `mode` Pillow's mode of the
// file (data/image_probe.py: 0 L, 1 I;16, 2 LA, 3 RGB, 4 RGBA, 5 CMYK, 6 P,
// 7 PA), `palette` 256 RGB entries as Pillow's P image holds them.
int mrt_jpeg2000_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t height,
                        int32_t width, char* msg, int32_t msg_len, int32_t mode,
                        const uint8_t* palette) {
  return guarded("JPEG2000", msg, msg_len, [&] {
    Decoder d(data, n);
    d.decode(mode, palette, out, uint32_t(width), uint32_t(height));
  });
}

// ISO 15444-1 Table C.2 as the decoder holds it (for the tests)
void mrt_jpeg2000_mq_table(uint16_t* qe, uint8_t* nmps, uint8_t* nlps, uint8_t* sw) {
  for (int i = 0; i < 47; i++) {
    qe[i] = kQe[i];
    nmps[i] = kNmps[i];
    nlps[i] = kNlps[i];
    sw[i] = kSwitch[i];
  }
}

}  // extern "C"
