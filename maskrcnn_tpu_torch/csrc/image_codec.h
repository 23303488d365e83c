// What the sources of the host image decoder library share: its error
// type, and the TIFF codecs that live in sources of their own
// (tiff_zstd.cpp, tiff_xz.cpp, tiff_fax.cpp) beside image_decode.cpp.
// All of them are compiled together into one library
// (maskrcnn_tpu_torch/data/native_image.py).

#pragma once

#include <cstdint>
#include <cstdio>
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

}  // namespace mrt
