// TIFF's CCITT compressions: modified Huffman (2), RLEW (32771), T.4 /
// Group 3 (3, 1D or 2D by T4Options bit 0) and T.6 / Group 4 (4), one
// strip or tile as libtiff 4.7's tif_fax3.c decodes it for Pillow 12.1.
//
// The decoder is tif_fax3.h's, macro for macro: bits taken LSB first
// through the fill order's bit table (libtiff's fax codec reads FillOrder
// itself and turns off the generic bit reversal), the code tables
// mkg3states builds (7-bit 2D modes, 12-bit white and 13-bit black runs,
// EOL as 11 zeros), zeros padded past the data's end, SYNC_EOL before
// each T.4 row (trash skipped up to 11 zeros, then the EOL's 1), the
// reference line's runs, CLEANUP_RUNS' repair of a row whose runs do not
// add up, and _TIFFFax3fillruns (white 0, black 1, MSB first). An
// unexpected code ends its row, which is filled as far as it got (libtiff
// only reports it); running out of data fails the strip, but for T.6,
// which keeps the rows before; a run array overflow fails it. T4Options'
// fill bits (bit 2) need nothing, and its uncompressed mode (bit 1) is not
// read by libtiff: the extension code that starts it ends the row.

#include <algorithm>
#include <cstring>
#include <vector>

#include "image_codec.h"

namespace mrt {
namespace {

enum State {
  S_Null = 0, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
  uint8_t state = S_Null, width = 0;
  int32_t param = 0;
};

struct Code {
  const char* bits;  // in stream order
  int param;
};

// T.4's terminating and make-up codes
const Code kWhiteTerm[] = {
    {"00110101", 0},  {"000111", 1},   {"0111", 2},     {"1000", 3},     {"1011", 4},
    {"1100", 5},      {"1110", 6},     {"1111", 7},     {"10011", 8},    {"10100", 9},
    {"00111", 10},    {"01000", 11},   {"001000", 12},  {"000011", 13},  {"110100", 14},
    {"110101", 15},   {"101010", 16},  {"101011", 17},  {"0100111", 18}, {"0001100", 19},
    {"0001000", 20},  {"0010111", 21}, {"0000011", 22}, {"0000100", 23}, {"0101000", 24},
    {"0101011", 25},  {"0010011", 26}, {"0100100", 27}, {"0011000", 28}, {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33}, {"00010011", 34},
    {"00010100", 35}, {"00010101", 36}, {"00010110", 37}, {"00010111", 38}, {"00101000", 39},
    {"00101001", 40}, {"00101010", 41}, {"00101011", 42}, {"00101100", 43}, {"00101101", 44},
    {"00000100", 45}, {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49},
    {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53}, {"00100101", 54},
    {"01011000", 55}, {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59},
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63}};
const Code kWhiteMakeUp[] = {
    {"11011", 64},       {"10010", 128},      {"010111", 192},     {"0110111", 256},
    {"00110110", 320},   {"00110111", 384},   {"01100100", 448},   {"01100101", 512},
    {"01101000", 576},   {"01100111", 640},   {"011001100", 704},  {"011001101", 768},
    {"011010010", 832},  {"011010011", 896},  {"011010100", 960},  {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664},    {"010011011", 1728}};
const Code kBlackTerm[] = {
    {"0000110111", 0},    {"010", 1},           {"11", 2},            {"10", 3},
    {"011", 4},           {"0011", 5},          {"0010", 6},          {"00011", 7},
    {"000101", 8},        {"000100", 9},        {"0000100", 10},      {"0000101", 11},
    {"0000111", 12},      {"00000100", 13},     {"00000111", 14},     {"000011000", 15},
    {"0000010111", 16},   {"0000011000", 17},   {"0000001000", 18},   {"00001100111", 19},
    {"00001101000", 20},  {"00001101100", 21},  {"00000110111", 22},  {"00000101000", 23},
    {"00000010111", 24},  {"00000011000", 25},  {"000011001010", 26}, {"000011001011", 27},
    {"000011001100", 28}, {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51},
    {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63}};
const Code kBlackMakeUp[] = {
    {"0000001111", 64},     {"000011001000", 128},  {"000011001001", 192},
    {"000001011011", 256},  {"000000110011", 320},  {"000000110100", 384},
    {"000000110101", 448},  {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088}, {"0000001110110", 1152},
    {"0000001110111", 1216}, {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728}};
// the extended make-up codes both colours share
const Code kMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
const Code kEOLH[] = {{"00000000000", 0}};
const Code kPass[] = {{"0001", 0}};
const Code kHoriz[] = {{"001", 0}};
const Code kV0[] = {{"1", 0}};
const Code kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}};
const Code kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}};
const Code kExt[] = {{"0000001", 0}};
const Code kEOLV[] = {{"0000000", 0}};

struct Tables {
  TabEnt main[128], white[4096], black[8192];
  template <size_t N>
  static void fill(TabEnt* t, int size, const Code (&codes)[N], State state) {
    for (const Code& c : codes) {
      const int width = static_cast<int>(std::strlen(c.bits));
      int code = 0;
      for (int i = 0; i < width; i++) code |= (c.bits[i] == '1') << i;  // LSB first
      for (int k = code; k < (1 << size); k += 1 << width) {
        t[k].state = static_cast<uint8_t>(state);
        t[k].width = static_cast<uint8_t>(width);
        t[k].param = c.param;
      }
    }
  }
  Tables() {
    fill(main, 7, kPass, S_Pass);
    fill(main, 7, kHoriz, S_Horiz);
    fill(main, 7, kV0, S_V0);
    fill(main, 7, kVR, S_VR);
    fill(main, 7, kVL, S_VL);
    fill(main, 7, kExt, S_Ext);
    fill(main, 7, kEOLV, S_EOL);
    fill(white, 12, kWhiteMakeUp, S_MakeUpW);
    fill(white, 12, kMakeUp, S_MakeUp);
    fill(white, 12, kWhiteTerm, S_TermW);
    fill(white, 12, kEOLH, S_EOL);
    fill(black, 13, kBlackMakeUp, S_MakeUpB);
    fill(black, 13, kMakeUp, S_MakeUp);
    fill(black, 13, kBlackTerm, S_TermB);
    fill(black, 13, kEOLH, S_EOL);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const uint8_t masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0, 0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; colour++) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      const uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {
          if (colour) *cp++ |= static_cast<uint8_t>(0xff >> bx);
          else *cp++ &= static_cast<uint8_t>(0xff << (8 - bx));
          run -= 8 - bx;
        }
        const uint32_t n = run >> 3;
        std::memset(cp, colour ? 0xff : 0, n);
        cp += n;
        if (run & 7) {
          if (colour) *cp |= static_cast<uint8_t>(0xff00 >> (run & 7));
          else *cp &= static_cast<uint8_t>(0xff >> (run & 7));
        }
      } else if (colour) {
        cp[0] |= static_cast<uint8_t>(masks[run] >> bx);
      } else {
        cp[0] &= static_cast<uint8_t>(~(masks[run] >> bx));
      }
      x += runs[colour];
    }
  }
}

// libtiff's return -1 from the decoder: the strip fails
struct Fail {
  const char* why;
};
// NeedBits' goto eoflab: the data ended with no bit left
struct Eof {};

struct Fax {
  const FaxParams& p;
  const Tables& T = tables();
  uint8_t bitmap[256];
  const uint8_t* cp;
  const uint8_t* start;
  const uint8_t* ep;
  uint32_t BitAcc = 0;
  int BitsAvail = 0;
  int EOLcnt = 0;
  int32_t lastx;
  uint32_t nruns;
  uint32_t* curruns;
  uint32_t* refruns = nullptr;
  // the row being decoded
  int32_t a0 = 0, RunLength = 0, b1 = 0;
  uint32_t* pa = nullptr;
  uint32_t* thisrun = nullptr;
  uint32_t* pb = nullptr;
  const TabEnt* ent = nullptr;

  Fax(const uint8_t* d, int64_t n, const FaxParams& params, bool two_d, FaxState& state)
      : p(params) {
    for (int i = 0; i < 256; i++) {
      int r = 0;
      for (int k = 0; k < 8; k++) r |= ((i >> k) & 1) << (7 - k);
      bitmap[i] = static_cast<uint8_t>(p.msb2lsb ? r : i);
    }
    cp = start = d;
    ep = d + n;
    lastx = static_cast<int32_t>(p.width);
    // Fax3SetupState's run arrays, made once an image; Fax3PreDecode's
    // reference line of one white run
    nruns = static_cast<uint32_t>(((p.width + 1 + 31) / 32) * 32);
    if (two_d) nruns *= 2;
    if (state.runs.size() != static_cast<size_t>(nruns) * 2) state.runs.assign(static_cast<size_t>(nruns) * 2, 0);
    curruns = state.runs.data();
    if (two_d) {
      refruns = state.runs.data() + nruns;
      refruns[0] = static_cast<uint32_t>(p.width);
      refruns[1] = 0;
    }
  }

  bool eod() const { return cp >= ep; }
  void need8(int n) {
    if (BitsAvail < n) {
      if (eod()) {
        if (BitsAvail == 0) throw Eof{};
        BitsAvail = n;
      } else {
        BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;
        BitsAvail += 8;
      }
    }
  }
  void need16(int n) {
    if (BitsAvail < n) {
      if (eod()) {
        if (BitsAvail == 0) throw Eof{};
        BitsAvail = n;
      } else {
        BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;
        if ((BitsAvail += 8) < n) {
          if (eod()) {
            BitsAvail = n;
          } else {
            BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;
            BitsAvail += 8;
          }
        }
      }
    }
  }
  uint32_t get(int n) const { return BitAcc & ((1u << n) - 1); }
  void clr(int n) {
    BitsAvail -= n;
    BitAcc >>= n;
  }
  void lookup8(int wid, const TabEnt* tab) {
    need8(wid);
    ent = tab + get(wid);
    clr(ent->width);
  }
  void lookup16(int wid, const TabEnt* tab) {
    need16(wid);
    ent = tab + get(wid);
    clr(ent->width);
  }

  void setvalue(int32_t x) {
    if (pa >= thisrun + nruns) throw Fail{"a run array overflow"};
    *pa++ = static_cast<uint32_t>(RunLength + x);
    a0 += x;
    RunLength = 0;
  }

  void sync_eol() {
    if (EOLcnt == 0) {
      for (;;) {
        need16(11);
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      need8(8);
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    EOLcnt = 0;
  }

  void cleanup_runs() {
    if (RunLength) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= static_cast<int32_t>(*--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }

  // one colour's run: its make-up codes, then its terminating code; false
  // for another code (the row ends)
  bool run(bool black) {
    for (;;) {
      if (black) {
        lookup16(13, T.black);
      } else {
        lookup16(12, T.white);
      }
      switch (ent->state) {
        case S_TermW:
          if (black) return false;
          setvalue(ent->param);
          return true;
        case S_TermB:
          if (!black) return false;
          setvalue(ent->param);
          return true;
        case S_MakeUpW:
          if (black) return false;
          a0 += ent->param;
          RunLength += ent->param;
          break;
        case S_MakeUpB:
          if (!black) return false;
          a0 += ent->param;
          RunLength += ent->param;
          break;
        case S_MakeUp:
          a0 += ent->param;
          RunLength += ent->param;
          break;
        default:
          return false;
      }
    }
  }

  // EXPAND1D; an Eof is cleaned up here and passed on
  void expand1d() {
    try {
      for (;;) {
        // white, then black: an EOL or another code ends the row
        for (;;) {
          lookup16(12, T.white);
          if (ent->state == S_EOL) {
            EOLcnt = 1;
            cleanup_runs();
            return;
          }
          if (ent->state == S_TermW) {
            setvalue(ent->param);
            break;
          }
          if (ent->state == S_MakeUpW || ent->state == S_MakeUp) {
            a0 += ent->param;
            RunLength += ent->param;
            continue;
          }
          cleanup_runs();
          return;
        }
        if (a0 >= lastx) break;
        for (;;) {
          lookup16(13, T.black);
          if (ent->state == S_EOL) {
            EOLcnt = 1;
            cleanup_runs();
            return;
          }
          if (ent->state == S_TermB) {
            setvalue(ent->param);
            break;
          }
          if (ent->state == S_MakeUpB || ent->state == S_MakeUp) {
            a0 += ent->param;
            RunLength += ent->param;
            continue;
          }
          cleanup_runs();
          return;
        }
        if (a0 >= lastx) break;
        if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
      }
    } catch (const Eof&) {
      cleanup_runs();
      throw;
    }
    cleanup_runs();
  }

  void check_b1() {
    if (pa != thisrun) {
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) throw Fail{"a run array overflow"};
        b1 += static_cast<int32_t>(pb[0] + pb[1]);
        pb += 2;
      }
    }
  }

  // EXPAND2D; an Eof is cleaned up here and passed on
  void expand2d() {
    try {
      while (a0 < lastx) {
        if (pa >= thisrun + nruns) throw Fail{"a run array overflow"};
        lookup8(7, T.main);
        switch (ent->state) {
          case S_Pass:
            check_b1();
            if (pb + 1 >= refruns + nruns) throw Fail{"a run array overflow"};
            b1 += static_cast<int32_t>(*pb++);
            RunLength += b1 - a0;
            a0 = b1;
            b1 += static_cast<int32_t>(*pb++);
            break;
          case S_Horiz: {
            const bool black_first = (pa - thisrun) & 1;
            if (!run(black_first) || !run(!black_first)) {
              cleanup_runs();
              return;
            }
            check_b1();
            break;
          }
          case S_V0:
            check_b1();
            setvalue(b1 - a0);
            if (pb >= refruns + nruns) throw Fail{"a run array overflow"};
            b1 += static_cast<int32_t>(*pb++);
            break;
          case S_VR:
            check_b1();
            setvalue(b1 - a0 + ent->param);
            if (pb >= refruns + nruns) throw Fail{"a run array overflow"};
            b1 += static_cast<int32_t>(*pb++);
            break;
          case S_VL:
            check_b1();
            if (b1 < a0 + ent->param) {
              cleanup_runs();
              return;
            }
            setvalue(b1 - a0 - ent->param);
            b1 -= static_cast<int32_t>(*--pb);
            break;
          case S_Ext:
            *pa++ = static_cast<uint32_t>(lastx - a0);
            cleanup_runs();
            return;
          case S_EOL:
            *pa++ = static_cast<uint32_t>(lastx - a0);
            need8(4);
            clr(4);
            EOLcnt = 1;
            cleanup_runs();
            return;
          default:
            cleanup_runs();
            return;
        }
      }
      if (RunLength) {
        if (RunLength + a0 < lastx) {
          need8(1);
          if (!get(1)) {
            cleanup_runs();
            return;
          }
          clr(1);
        }
        setvalue(0);
      }
    } catch (const Eof&) {
      cleanup_runs();
      throw;
    }
    cleanup_runs();
  }

  // libtiff 4.7's retry of T.4 data whose EOL is not found: the strip's
  // data read again from its start, rows without EOLs from here on
  void rewind() {
    cp = start;
    BitAcc = 0;
    BitsAvail = 0;
    EOLcnt = 0;
  }

  void start_row() {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
  }
};

}  // namespace

void tiff_fax(const uint8_t* d, int64_t n, uint8_t* out, int64_t cap, int64_t rows,
              const FaxParams& p, FaxState& state) {
  const int64_t rowbytes = (p.width + 7) / 8;
  const bool g4 = p.compression == 4;
  const bool two_d = g4 || (p.compression == 3 && (p.options & 1));
  Fax f(d, n, p, two_d, state);
  bool& noeol = state.noeol;
  int64_t line = 0;
  uint8_t* buf = out;
  if (rows * rowbytes > cap) corrupt("TIFF: CCITT data: more rows than the strip holds");
  try {
    for (; line < rows; line++, buf += rowbytes) {
      f.start_row();
      if (p.compression == 2 || p.compression == 32771) {
        try {
          f.expand1d();
        } catch (const Eof&) {
          fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(f.lastx));
          throw;
        }
        fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(f.lastx));
        // the row's end: to a byte, or to a 16-bit word of the data
        if (p.compression == 2) {
          f.clr(f.BitsAvail - (f.BitsAvail & ~7));
        } else {
          f.clr(f.BitsAvail - (f.BitsAvail & ~15));
          if (f.BitsAvail == 0 && ((f.cp - f.start) & 1)) f.cp++;
        }
        continue;
      }
      if (p.compression == 3) {
        if (!noeol) {
          try {
            f.sync_eol();
          } catch (const Eof&) {
            noeol = true;
            f.rewind();
          }
        }
        bool is1d = true;
        if (two_d) {
          try {
            f.need8(1);
          } catch (const Eof&) {
            f.cleanup_runs();
            fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(f.lastx));
            throw Fail{"premature end of data"};
          }
          is1d = f.get(1);
          f.clr(1);
          f.pb = f.refruns;
          f.b1 = static_cast<int32_t>(*f.pb++);
        }
        try {
          if (is1d) {
            f.expand1d();
          } else {
            f.expand2d();
          }
        } catch (const Eof&) {
          // Fax3Decode1D ends the row where the data does and goes on;
          // Fax3Decode2D fills the row and fails the strip
          if (two_d) {
            fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(f.lastx));
            throw Fail{"premature end of data"};
          }
        }
        fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(f.lastx));
        if (two_d) {
          if (f.pa < f.thisrun + f.nruns) f.setvalue(0);
          std::swap(f.curruns, f.refruns);
        }
        continue;
      }
      // T.6: an EOL, or the data's end after a row was decoded, ends the
      // strip with the rows before
      f.pb = f.refruns;
      f.b1 = static_cast<int32_t>(*f.pb++);
      bool eofb = false;
      try {
        f.expand2d();
        eofb = f.EOLcnt != 0;
      } catch (const Eof&) {
        eofb = true;
      }
      if (eofb) {
        fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(f.lastx));
        if (line == 0) throw Fail{"no row before the data's end"};
        return;
      }
      fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(f.lastx));
      f.setvalue(0);
      std::swap(f.curruns, f.refruns);
    }
  } catch (const Eof&) {
    corrupt("TIFF: CCITT data: premature end of data at row " + std::to_string(line));
  } catch (const Fail& e) {
    corrupt(std::string("TIFF: CCITT data: ") + e.why + " at row " + std::to_string(line));
  }
}

}  // namespace mrt
