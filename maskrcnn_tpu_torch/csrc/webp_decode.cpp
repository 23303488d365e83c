// Host WebP decoder of the port: the first frame of a WebP file to RGB
// uint8, the pixels np.asarray(PIL.Image.open(f).convert("RGB")) gives
// with Pillow 12.1 over libwebp 1.6.
//
// Host C++17, no CUDA: maskrcnn_tpu_torch/data/native_image.py compiles it
// with g++ on first use and calls it through ctypes, which releases the
// GIL for the whole call.
//
// Pillow opens every WebP file through libwebp's WebPAnimDecoder in
// non-premultiplied RGBA and drops the alpha, so the RGB never depends on
// it: this decoder reads the RIFF container (a plain "VP8 " or "VP8L"
// file, or "VP8X" with or without an animation), skips the metadata
// chunks, and places the first frame at its offset on a canvas cleared to
// transparent black, as WebPAnimDecoder does for a key frame. A lossy
// frame's ALPH chunk is decoded as libwebp decodes it (its values unused)
// so that a file whose alpha libwebp refuses is refused here too.
//
// VP8L (lossless) follows vp8l_dec.c: simple and normal prefix codes with
// their code-length codes, two-level lookup tables of 8 root bits, meta
// prefix codes (the entropy image), the colour cache, LZ77 with the
// 120-entry distance map, and the inverse transforms (the predictor's 14
// modes, cross-colour, subtract-green, colour indexing with pixel
// bundling), then ARGB to RGB.
//
// VP8 (lossy) follows vp8_dec.c, tree_dec.c, quant_dec.c and frame_dec.c:
// the frame header (the scaling bits ignored, as libwebp does), the
// boolean decoder, segments with their quantizers and filter strengths,
// loop-filter deltas, 1 to 8 token partitions, the 16x16, 4x4 and chroma
// intra modes, coefficient tokens under the default and the updated
// probabilities, dequantization, the inverse WHT and DCT, the simple and
// normal loop filters (dsp/dec.c), then libwebp's fancy 4:2:0 upsampler
// (dsp/upsampling.c) and its 14-bit YUV -> RGB (dsp/yuv.h). Its constant
// tables (coefficient probabilities and their update probabilities, the
// 4x4 mode probabilities, the quantizer steps) are RFC 6386's, in
// libwebp's order of the 4x4 modes.
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

int report(const Error& e, char* msg, int32_t msg_len) {
  if (msg && msg_len > 0) {
    std::snprintf(msg, static_cast<size_t>(msg_len), "%s", e.msg.c_str());
  }
  return e.code;
}

uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
uint32_t le32(const uint8_t* p) {
  return le24(p) | (static_cast<uint32_t>(p[3]) << 24);
}

// ------------------------------------------------------------ VP8 tables

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// the 4x4 modes in libwebp's order (kBModesProba's indices)
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED };
// the 16x16 and chroma modes share the first four numbers; the DC mode
// at an edge of the frame gets one of these
enum { DC_NOTOP = 4, DC_NOLEFT, DC_NOTOPLEFT };

// the 4x4 mode tree: kYModesIntra4 (a negative entry is a leaf)
const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// --------------------------------------------------------- VP8 bit reader

// libwebp's VP8BitReader: the boolean decoder over one partition, zeros
// past its end (eof set at the first byte that is not there).
struct BoolReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // range - 1
  bool eof = false;

  BoolReader() = default;
  BoolReader(const uint8_t* start, size_t size) : p(start), end(start + size) {
    load();
  }

  void load() {
    if (end - p >= 8) {
      uint64_t v = 0;
      for (int i = 0; i < 7; i++) v = (v << 8) | p[i];
      p += 7;
      value = (value << 56) | v;
      bits += 56;
    } else if (p < end) {
      value = (value << 8) | *p++;
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }

  int get_bit(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> bits);
    int bit;
    if (v > split) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << bits;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }

  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(get_bit(0x80)) << n;
    return v;
  }
  int32_t get_signed_value(int n) {
    const int32_t v = static_cast<int32_t>(get_value(n));
    return get_bit(0x80) ? -v : v;
  }
  int get_signed(int v) { return get_bit(0x80) ? -v : v; }
};

// ------------------------------------------------------------ VP8 decoder

constexpr int BPS = 32;  // the work buffer's stride (dsp.h)

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// ---- the inverse transforms (dsp/dec.c)

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- intra prediction (dsp/dec.c), in the work buffer at dst

inline uint8_t avg3(int a, int b, int c) {
  return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

// 16x16 luma (size 16) and 8x8 chroma (size 8)
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 5 : 4;
  switch (mode) {
    case B_DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case B_TM_PRED: true_motion(dst, size); break;
    case B_VE_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case B_HE_PRED:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> (shift - 1));
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> (shift - 1));
      break;
    }
    default: fill(dst, size, 0x80);
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = dst[-1 - BPS], I = dst[-1], J = dst[-1 + BPS],
            K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, static_cast<int>(dc >> 3));
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                               avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          static_cast<uint8_t>(L);
      break;
    default:  // B_HD_PRED
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
  }
}

#undef DST

// ---- the loop filters (dsp/dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * std::abs(p0 - q0) + std::abs(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * std::abs(p0 - q0) + std::abs(p1 - q1)) > t) return 0;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// hstride: across the edge; vstride: along it
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * vstride, hstride, thresh2))
      do_filter2(p + i * vstride, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (edge) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct FilterInfo {
  int limit = 0;   // f_limit_: 0 for no filtering
  int ilevel = 0;
  int inner = 0;
  int hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  bool is_i4x4 = false;
  uint8_t imodes[16];
  uint8_t uvmode = 0;
  uint8_t segment = 0;
  bool skip = false;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct BandProbas {
  uint8_t probas[3][11];
};

inline int clip_q(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

struct Vp8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  std::vector<BoolReader> parts;
  int num_parts_minus_one = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int8_t quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segments[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  QuantMatrix dqm[4];
  BandProbas bands[4][8];
  int use_skip_proba = 0, skip_p = 0;
  FilterInfo fstrengths[4][2];

  Vp8(const uint8_t* buf, size_t size) {
    if (size < 10) corrupt("VP8: truncated frame header");
    const uint32_t bits = le24(buf);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (!key_frame) corrupt("VP8: not a key frame");
    if (profile > 3) corrupt("VP8: incorrect keyframe parameters");
    if (!show) corrupt("VP8: frame not displayable");
    buf += 3;
    size -= 3;
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
      corrupt("VP8: bad code word");
    width = ((buf[4] << 8) | buf[3]) & 0x3fff;   // the scaling bits: ignored
    height = ((buf[6] << 8) | buf[5]) & 0x3fff;
    buf += 7;
    size -= 7;
    if (width == 0 || height == 0) corrupt("VP8: empty frame");
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    if (partition_length > size) corrupt("VP8: bad partition length");
    br = BoolReader(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br.get_value(1);  // colour space
    br.get_value(1);  // clamping type
    parse_segment_header();
    parse_filter_header();
    parse_partitions(buf, size);
    parse_quant();
    br.get_value(1);  // update_proba: ignored
    parse_proba();
  }

  void parse_segment_header() {
    use_segment = br.get_value(1);
    if (use_segment) {
      update_map = br.get_value(1);
      if (br.get_value(1)) {
        absolute_delta = br.get_value(1);
        for (int s = 0; s < 4; ++s)
          quantizer[s] = static_cast<int8_t>(br.get_value(1) ? br.get_signed_value(7) : 0);
        for (int s = 0; s < 4; ++s)
          filter_strength[s] = static_cast<int8_t>(br.get_value(1) ? br.get_signed_value(6) : 0);
      }
      if (update_map)
        for (int s = 0; s < 3; ++s)
          segments[s] = static_cast<uint8_t>(br.get_value(1) ? br.get_value(8) : 255u);
    } else {
      update_map = false;
    }
    if (br.eof) corrupt("VP8: cannot parse segment header");
  }

  void parse_filter_header() {
    simple = br.get_value(1);
    level = br.get_value(6);
    sharpness = br.get_value(3);
    use_lf_delta = br.get_value(1);
    if (use_lf_delta && br.get_value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) corrupt("VP8: cannot parse filter header");
  }

  void parse_partitions(const uint8_t* buf, size_t size) {
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + size;
    num_parts_minus_one = (1 << br.get_value(2)) - 1;
    const size_t last_part = num_parts_minus_one;
    if (size < 3 * last_part) corrupt("VP8: cannot parse partitions");
    const uint8_t* part_start = buf + last_part * 3;
    size_t size_left = size - last_part * 3;
    parts.resize(last_part + 1);
    for (size_t p = 0; p < last_part; ++p) {
      size_t psize = le24(sz);
      if (psize > size_left) psize = size_left;
      parts[p] = BoolReader(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last_part] = BoolReader(part_start, size_left);
    if (part_start >= buf_end) corrupt("VP8: cannot parse partitions");
  }

  void parse_quant() {
    const int base_q0 = br.get_value(7);
    const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
    const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          dqm[i] = dqm[0];
          continue;
        }
        q = base_q0;
      }
      QuantMatrix& m = dqm[i];
      m.y1[0] = kDcTable[clip_q(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip_q(q + 0, 127)];
      m.y2[0] = kDcTable[clip_q(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip_q(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip_q(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip_q(q + dquv_ac, 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            bands[t][b].probas[c][p] = static_cast<uint8_t>(
                br.get_bit(kCoeffsUpdateProba[t][b][c][p])
                    ? br.get_value(8)
                    : kCoeffsProba0[t][b][c][p]);
    use_skip_proba = br.get_value(1);
    if (use_skip_proba) skip_p = br.get_value(8);
  }

  void precompute_filter_strengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += level;
      } else {
        base_level = level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths[s][i4x4];
        int lvl = base_level;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            if (sharpness > 4) {
              ilevel >>= 2;
            } else {
              ilevel >>= 1;
            }
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  // tree_dec.c's ParseIntraMode
  void parse_intra_mode(MBData& block, uint8_t* top, uint8_t* left) {
    if (update_map) {
      block.segment = static_cast<uint8_t>(
          !br.get_bit(segments[0]) ? br.get_bit(segments[1])
                                   : br.get_bit(segments[2]) + 2);
    } else {
      block.segment = 0;
    }
    block.skip = use_skip_proba ? br.get_bit(skip_p) : 0;
    block.is_i4x4 = !br.get_bit(145);
    if (!block.is_i4x4) {
      const int ymode = br.get_bit(156) ? (br.get_bit(128) ? B_TM_PRED : B_HE_PRED)
                                        : (br.get_bit(163) ? B_VE_PRED : B_DC_PRED);
      block.imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* const prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br.get_bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.get_bit(prob[i])];
          ymode = -i;
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    block.uvmode = static_cast<uint8_t>(
        !br.get_bit(142) ? B_DC_PRED
        : !br.get_bit(114) ? B_VE_PRED
        : br.get_bit(183) ? B_TM_PRED
                          : B_HE_PRED);
  }

  static int get_large_value(BoolReader& r, const uint8_t* p) {
    int v;
    if (!r.get_bit(p[3])) {
      if (!r.get_bit(p[4])) {
        v = 2;
      } else {
        v = 3 + r.get_bit(p[5]);
      }
    } else {
      if (!r.get_bit(p[6])) {
        if (!r.get_bit(p[7])) {
          v = 5 + r.get_bit(159);
        } else {
          v = 7 + 2 * r.get_bit(165);
          v += r.get_bit(145);
        }
      } else {
        const int bit1 = r.get_bit(p[8]);
        const int bit0 = r.get_bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + r.get_bit(*tab);
        v += 3 + (8 << cat);
      }
    }
    return v;
  }

  // GetCoeffs: the tokens of one 4x4 block from position n; returns the
  // position after the last coefficient read
  int get_coeffs(BoolReader& r, int type, int ctx, const int* dq, int n,
                 int16_t* out) {
    const uint8_t* p = bands[type][kBands[n]].probas[ctx];
    for (; n < 16; ++n) {
      if (!r.get_bit(p[0])) return n;
      while (!r.get_bit(p[1])) {
        p = bands[type][kBands[++n]].probas[0];
        if (n == 16) return 16;
      }
      int v;
      if (!r.get_bit(p[2])) {
        v = 1;
        p = bands[type][kBands[n + 1]].probas[1];
      } else {
        v = get_large_value(r, p);
        p = bands[type][kBands[n + 1]].probas[2];
      }
      out[kZigzag[n]] = static_cast<int16_t>(r.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // ParseResiduals; mb_nz / left_nz: the top and left non-zero flags
  // (bits 0-3 luma, 4-5 u, 6-7 v), and the WHT's
  bool parse_residuals(BoolReader& r, MBData& block, uint8_t& mb_nz,
                       uint8_t& mb_nz_dc, uint8_t& left_nz,
                       uint8_t& left_nz_dc) {
    const QuantMatrix& q = dqm[block.segment];
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, 384 * sizeof(*dst));
    int first, ac_type;
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb_nz_dc + left_nz_dc;
      const int nz = get_coeffs(r, 1, ctx, q.y2, 0, dc);
      mb_nz_dc = left_nz_dc = (nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    uint8_t tnz = mb_nz & 0x0f;
    uint8_t lnz = left_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(r, ac_type, ctx, q.y1, first, dst);
        l = (nz > first);
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = static_cast<uint8_t>(mb_nz >> (4 + ch));
      lnz = static_cast<uint8_t>(left_nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(r, 2, ctx, q.uv, 0, dst);
          l = (nz > 0);
          tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    mb_nz = static_cast<uint8_t>(out_t_nz);
    left_nz = static_cast<uint8_t>(out_l_nz);
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  static void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    if (bits >> 30) transform_one(src, dst);  // DC-only and AC3 give the same
  }
  static void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    if (bits & 0xff)
      for (int i = 0; i < 4; ++i)
        transform_one(src + 16 * i, dst + (i & 1) * 4 + (i >> 1) * 4 * BPS);
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
      if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mb_y == 0 ? static_cast<int>(DC_NOTOP) : static_cast<int>(B_DC_PRED);
    }
    return mode;
  }

  // The whole frame into planes y [mb_h*16][mb_w*16], u and v
  // [mb_h*8][mb_w*8], loop-filtered.
  void decode(std::vector<uint8_t>& yp, std::vector<uint8_t>& up,
              std::vector<uint8_t>& vp) {
    precompute_filter_strengths();
    const int ys = mb_w * 16, uvs = mb_w * 8;
    yp.assign(static_cast<size_t>(ys) * mb_h * 16, 0);
    up.assign(static_cast<size_t>(uvs) * mb_h * 8, 0);
    vp.assign(static_cast<size_t>(uvs) * mb_h * 8, 0);
    std::vector<MBData> mb_data(mb_w);
    std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
    uint8_t intra_l[4];
    std::vector<uint8_t> nz(mb_w, 0), nz_dc(mb_w, 0);
    std::vector<FilterInfo> finfo(static_cast<size_t>(mb_w) * mb_h);
    std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
    // the work buffer: a row of border above each plane's block
    uint8_t yuv_b[BPS * 17 + BPS * 9];
    uint8_t* const y_dst = yuv_b + BPS + 8;
    uint8_t* const u_dst = yuv_b + BPS * 17 + BPS + 8;
    uint8_t* const v_dst = u_dst + 16;
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      BoolReader& token_br = parts[mb_y & num_parts_minus_one];
      std::memset(intra_l, B_DC_PRED, 4);
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        parse_intra_mode(mb_data[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br.eof) corrupt("VP8: premature end of partition 0");
      uint8_t left_nz = 0, left_nz_dc = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& block = mb_data[mb_x];
        bool skip = use_skip_proba ? block.skip : false;
        if (!skip) {
          skip = parse_residuals(token_br, block, nz[mb_x], nz_dc[mb_x],
                                 left_nz, left_nz_dc);
        } else {
          left_nz = nz[mb_x] = 0;
          if (!block.is_i4x4) left_nz_dc = nz_dc[mb_x] = 0;
          block.non_zero_y = 0;
          block.non_zero_uv = 0;
        }
        if (filter_type > 0) {
          FilterInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
          f = fstrengths[block.segment][block.is_i4x4];
          f.inner |= !skip;
        }
        if (token_br.eof) corrupt("VP8: premature end of a token partition");
      }
      // ReconstructRow
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) {
        u_dst[j * BPS - 1] = 129;
        v_dst[j * BPS - 1] = 129;
      }
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const MBData& block = mb_data[mb_x];
        if (mb_x > 0) {
          for (int j = -1; j < 16; ++j)
            std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
          for (int j = -1; j < 8; ++j) {
            std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
            std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
          }
        }
        const int16_t* coeffs = block.coeffs;
        uint32_t bits = block.non_zero_y;
        if (mb_y > 0) {
          std::memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
          std::memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
          std::memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
        }
        if (block.is_i4x4) {
          uint8_t* const top_right = y_dst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w - 1) {
              std::memset(top_right, top_y[16 * mb_x + 15], 4);
            } else {
              std::memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
            }
          }
          for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
          for (int n = 0; n < 16; ++n, bits <<= 2) {
            uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            predict4(dst, block.imodes[n]);
            do_transform(bits, coeffs + n * 16, dst);
          }
        } else {
          predict_block(y_dst, 16, check_mode(mb_x, mb_y, block.imodes[0]));
          if (bits != 0)
            for (int n = 0; n < 16; ++n, bits <<= 2)
              do_transform(bits, coeffs + n * 16,
                           y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
        const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
        predict_block(u_dst, 8, uvmode);
        predict_block(v_dst, 8, uvmode);
        do_uv_transform(block.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
        do_uv_transform(block.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
        if (mb_y < mb_h - 1) {
          std::memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
          std::memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
          std::memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j)
          std::memcpy(&yp[static_cast<size_t>(mb_y * 16 + j) * ys + mb_x * 16],
                      y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
          std::memcpy(&up[static_cast<size_t>(mb_y * 8 + j) * uvs + mb_x * 8],
                      u_dst + j * BPS, 8);
          std::memcpy(&vp[static_cast<size_t>(mb_y * 8 + j) * uvs + mb_x * 8],
                      v_dst + j * BPS, 8);
        }
      }
    }
    if (filter_type == 0) return;
    // the loop filter, macroblock by macroblock in raster order
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FilterInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        const int ilevel = f.ilevel;
        uint8_t* yd = &yp[static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) simple_filter(yd, 1, ys, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k, 1, ys, limit);
          if (mb_y > 0) simple_filter(yd, ys, 1, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k * ys, ys, 1, limit);
          continue;
        }
        uint8_t* ud = &up[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
        uint8_t* vd = &vp[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
        const int hev_t = f.hev_thresh;
        if (mb_x > 0) {
          filter_loop(yd, 1, ys, 16, limit + 4, ilevel, hev_t, true);
          filter_loop(ud, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
          filter_loop(vd, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k)
            filter_loop(yd + 4 * k, 1, ys, 16, limit, ilevel, hev_t, false);
          filter_loop(ud + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
          filter_loop(vd + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
        }
        if (mb_y > 0) {
          filter_loop(yd, ys, 1, 16, limit + 4, ilevel, hev_t, true);
          filter_loop(ud, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
          filter_loop(vd, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k)
            filter_loop(yd + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t, false);
          filter_loop(ud + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
          filter_loop(vd + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
        }
      }
    }
  }
};

// ---- YUV -> RGB (dsp/yuv.h) and the fancy upsampler (dsp/upsampling.c)

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return static_cast<uint8_t>((v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UPSAMPLE_FUNC for one pair of rows (bottom_y may be null), every channel
// as its packed u | v << 16 arithmetic gives it.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
               bottom_dst);
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + (2 * x - 1) * 3);
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1,
               top_dst + 2 * x * 3);
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1,
                 bottom_dst + 2 * x * 3);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + (len - 1) * 3);
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2,
                 (3 * l_v + tl_v + 2) >> 2, bottom_dst + (len - 1) * 3);
  }
}

// A VP8 frame to RGB at out (row stride out_stride bytes).
void decode_vp8(const uint8_t* data, size_t size, int width, int height,
                uint8_t* out, size_t out_stride) {
  Vp8 dec(data, size);
  if (dec.width != width || dec.height != height)
    corrupt("VP8: the frame's size differs from the container's");
  std::vector<uint8_t> yp, up, vp;
  dec.decode(yp, up, vp);
  const int ys = dec.mb_w * 16, uvs = dec.mb_w * 8;
  // EmitFancyRGB over the whole frame
  upsample_pair(&yp[0], nullptr, &up[0], &vp[0], &up[0], &vp[0], out, nullptr, width);
  int y = 0;
  for (; y + 2 < height; y += 2) {
    const int k = y / 2;
    upsample_pair(&yp[static_cast<size_t>(y + 1) * ys], &yp[static_cast<size_t>(y + 2) * ys],
                  &up[static_cast<size_t>(k) * uvs], &vp[static_cast<size_t>(k) * uvs],
                  &up[static_cast<size_t>(k + 1) * uvs], &vp[static_cast<size_t>(k + 1) * uvs],
                  out + (y + 1) * out_stride, out + (y + 2) * out_stride, width);
  }
  if (!(height & 1)) {
    const int k = y / 2;
    upsample_pair(&yp[static_cast<size_t>(y + 1) * ys], nullptr,
                  &up[static_cast<size_t>(k) * uvs], &vp[static_cast<size_t>(k) * uvs],
                  &up[static_cast<size_t>(k) * uvs], &vp[static_cast<size_t>(k) * uvs],
                  out + (y + 1) * out_stride, nullptr, width);
  }
}

// ----------------------------------------------------------------- VP8L

// libwebp's VP8LBitReader: bits LSB first; reading past the end counts
// as an error where vp8l_dec.c checks eos_
struct LBits {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;       // next byte to load
  uint64_t val = 0;
  int nbits = 0;        // bits loaded into val
  uint64_t consumed = 0;

  LBits(const uint8_t* d, size_t n) : data(d), len(n) {}

  void fill() {
    while (nbits <= 56) {
      val |= static_cast<uint64_t>(pos < len ? data[pos] : 0) << nbits;
      pos++;
      nbits += 8;
    }
  }
  uint32_t peek() {
    if (nbits < 32) fill();
    return static_cast<uint32_t>(val);
  }
  void skip(int n) {
    val >>= n;
    nbits -= n;
    consumed += n;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    const uint32_t v = static_cast<uint32_t>(val) & ((1u << n) - 1);
    skip(n);
    return v;
  }
  bool eos() const { return consumed > 8 * static_cast<uint64_t>(len); }
};

struct HCode {
  uint8_t bits;
  uint16_t value;
};

constexpr int kRootBits = 8;
constexpr int kMaxCodeLength = 15;

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// huffman_utils.c's BuildHuffmanTable: the table's size, 0 for an invalid
// code; root == null only sizes it.
int build_table(HCode* root, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = static_cast<uint16_t>(s);
  int total_size = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {  // one symbol: zero bits
    if (root) replicate(root, 1, total_size, HCode{0, sorted[0]});
    return total_size;
  }
  HCode* table = root;
  uint32_t low = 0xffffffffu, mask = total_size - 1, key = 0;
  int num_nodes = 1, num_open = 1, table_bits = root_bits;
  int table_size = 1 << table_bits, symbol = 0, len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (!root) continue;
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size,
                HCode{static_cast<uint8_t>(len), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root) table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total_size += table_size;
        low = key & mask;
        if (root) {
          root[low].bits = static_cast<uint8_t>(table_bits + root_bits);
          root[low].value = static_cast<uint16_t>((table - root) - low);
        }
      }
      if (root) {
        replicate(&table[key >> root_bits], step, table_size,
                  HCode{static_cast<uint8_t>(len - root_bits), sorted[symbol++]});
      }
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
  return total_size;
}

struct Tree {
  std::vector<HCode> table;

  bool build(int root_bits, const int* lengths, int n) {
    const int size = build_table(nullptr, root_bits, lengths, n);
    if (size == 0) return false;
    table.assign(size, HCode{0, 0});
    return build_table(table.data(), root_bits, lengths, n) == size;
  }

  int read(LBits& br) const {
    uint32_t val = br.peek();
    const HCode* t = &table[val & ((1u << kRootBits) - 1)];
    const int nbits = t->bits - kRootBits;
    if (nbits > 0) {
      br.skip(kRootBits);
      val = br.peek();
      t += t->value;
      t += val & ((1u << nbits) - 1);
    }
    br.skip(t->bits);
    return t->value;
  }
};

enum { GREEN = 0, RED, BLUE, ALPHA, DIST };
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7, 8, 9, 10, 11, 12, 13, 14, 15};

struct HGroup {
  Tree trees[5];
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Vp8l {
  LBits br;
  std::vector<Transform> transforms;
  unsigned seen = 0;

  Vp8l(const uint8_t* d, size_t n) : br(d, n) {}

  void check() {
    if (br.eos()) corrupt("VP8L: the bitstream ends early");
  }

  void read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
    Tree t;
    if (!t.build(kRootBits, cl_lengths, 19)) corrupt("VP8L: bad code-length code");
    int max_symbol;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(length_nbits);
      if (max_symbol > num_symbols) corrupt("VP8L: bad code lengths");
    } else {
      max_symbol = num_symbols;
    }
    int prev = 8, symbol = 0;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      const int code_len = t.read(br);
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len != 0) prev = code_len;
      } else {
        static const uint8_t extra[3] = {2, 3, 7}, offsets[3] = {3, 3, 11};
        const int slot = code_len - 16;
        int repeat = br.read(extra[slot]) + offsets[slot];
        if (symbol + repeat > num_symbols) corrupt("VP8L: bad code lengths");
        const int length = code_len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = length;
      }
    }
  }

  void read_code(int alphabet_size, Tree& tree) {
    std::vector<int> lengths(std::max(alphabet_size, 256), 0);
    if (br.read(1)) {  // simple code
      const int num_symbols = br.read(1) + 1;
      const int first_len = br.read(1);
      lengths[br.read(first_len == 0 ? 1 : 8)] = 1;
      if (num_symbols == 2) lengths[br.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
      read_code_lengths(cl_lengths, alphabet_size, lengths.data());
    }
    check();
    if (!tree.build(kRootBits, lengths.data(), alphabet_size))
      corrupt("VP8L: bad prefix code");
  }

  // DecodeImageStream: a level-0 stream reads the transforms and may have
  // meta prefix codes; the others are sub-images
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    int tx = xsize;
    if (level0) {
      while (br.read(1)) read_transform(tx, ysize);
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) corrupt("VP8L: bad colour cache size");
    }
    // ReadHuffmanCodes
    int huffman_bits = 0, huffman_xsize = 0;
    std::vector<uint32_t> huffman_image;
    int num_groups = 1;
    if (level0 && br.read(1)) {
      huffman_bits = 2 + br.read(3);
      huffman_xsize = subsample(tx, huffman_bits);
      huffman_image = decode_stream(huffman_xsize, subsample(ysize, huffman_bits), false);
      for (uint32_t& g : huffman_image) {
        g = (g >> 8) & 0xffff;
        num_groups = std::max<int>(num_groups, g + 1);
      }
    }
    check();
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<HGroup> groups(num_groups);
    for (HGroup& g : groups)
      for (int j = 0; j < 5; ++j)
        read_code(kAlphabetSize[j] + (j == 0 ? cache_size : 0), g.trees[j]);
    std::vector<uint32_t> data(static_cast<size_t>(tx) * ysize);
    decode_pixels(data, tx, groups, huffman_image, huffman_bits,
                  huffman_xsize, cache_bits);
    if (level0) {
      for (int i = static_cast<int>(transforms.size()) - 1; i >= 0; --i)
        data = inverse_transform(transforms[i], data);
    }
    return data;
  }

  void read_transform(int& xsize, int ysize) {
    Transform t;
    t.type = br.read(2);
    if (seen & (1u << t.type)) corrupt("VP8L: a transform used twice");
    seen |= 1u << t.type;
    t.xsize = xsize;
    t.ysize = ysize;
    if (t.type == 0 || t.type == 1) {  // predictor, cross-colour
      t.bits = br.read(3) + 2;
      t.data = decode_stream(subsample(t.xsize, t.bits), subsample(ysize, t.bits), false);
    } else if (t.type == 3) {          // colour indexing
      const int num_colors = br.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      const int final_num = 1 << (8 >> t.bits);
      t.data.assign(final_num, 0);
      uint8_t* nd = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* od = reinterpret_cast<const uint8_t*>(pal.data());
      for (int i = 0; i < 4; ++i) nd[i] = od[i];
      for (int i = 4; i < 4 * num_colors; ++i) nd[i] = static_cast<uint8_t>(od[i] + nd[i - 4]);
    }
    transforms.push_back(std::move(t));
  }

  void decode_pixels(std::vector<uint32_t>& data, int width,
                     const std::vector<HGroup>& groups,
                     const std::vector<uint32_t>& himage, int hbits,
                     int hxsize, int cache_bits) {
    std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0);
    const int cache_shift = 32 - cache_bits;
    const size_t total = data.size();
    size_t src = 0, last_cached = 0;
    int col = 0, row = 0;
    auto group_at = [&](int x, int y) -> const HGroup& {
      if (himage.empty()) return groups[0];
      return groups[himage[static_cast<size_t>(y >> hbits) * hxsize + (x >> hbits)]];
    };
    auto insert = [&]() {
      while (last_cached < src) {
        const uint32_t argb = data[last_cached++];
        cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
      }
    };
    while (src < total) {
      const HGroup& g = group_at(col, row);
      const int code = g.trees[GREEN].read(br);
      if (code < 256) {
        const int red = g.trees[RED].read(br);
        const int blue = g.trees[BLUE].read(br);
        const int alpha = g.trees[ALPHA].read(br);
        data[src++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) |
                      (code << 8) | blue;
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256);
        const int dist_symbol = g.trees[DIST].read(br);
        const int dist_code = copy_value(dist_symbol);
        const size_t dist = plane_code_to_distance(width, dist_code);
        if (src < dist || total - src < static_cast<size_t>(length))
          corrupt("VP8L: bad backward reference");
        for (int i = 0; i < length; ++i, ++src) data[src] = data[src - dist];
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
      } else if (code < 256 + 24 + static_cast<int>(cache.size())) {
        insert();
        data[src++] = cache[code - 256 - 24];
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else {
        corrupt("VP8L: bad symbol");
      }
      if (cache_bits) insert();
      if (br.eos()) corrupt("VP8L: the bitstream ends early");
    }
  }

  int copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra_bits = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra_bits;
    return offset + br.read(extra_bits) + 1;
  }

  static size_t plane_code_to_distance(int xsize, int plane_code) {
    if (plane_code > 120) return plane_code - 120;
    const int dist_code = kCodeToPlane[plane_code - 1];
    const int yoffset = dist_code >> 4;
    const int xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
  }

  // ---- the inverse transforms (lossless.c)

  static uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
  static int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
    int pa_minus_pb = 0;
    for (int s = 0; s < 32; s += 8)
      pa_minus_pb += sub3((a >> s) & 0xff, (b >> s) & 0xff, (c >> s) & 0xff);
    return pa_minus_pb <= 0 ? a : b;
  }
  static uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
      out |= static_cast<uint32_t>(clip255(static_cast<int>((c0 >> s) & 0xff) +
                                           static_cast<int>((c1 >> s) & 0xff) -
                                           static_cast<int>((c2 >> s) & 0xff)))
             << s;
    return out;
  }
  static uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = average2(c0, c1);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
      out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
    }
    return out;
  }
  static uint32_t predict(int mode, const uint32_t* out, const uint32_t* top) {
    const uint32_t L = out[-1];
    switch (mode) {
      case 1: return L;
      case 2: return top[0];
      case 3: return top[1];
      case 4: return top[-1];
      case 5: return average2(average2(L, top[1]), top[0]);
      case 6: return average2(L, top[-1]);
      case 7: return average2(L, top[0]);
      case 8: return average2(top[-1], top[0]);
      case 9: return average2(top[0], top[1]);
      case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
      case 11: return select(top[0], L, top[-1]);
      case 12: return clamped_full(L, top[0], top[-1]);
      case 13: return clamped_half(L, top[0], top[-1]);
      default: return 0xff000000u;
    }
  }

  static std::vector<uint32_t> inverse_transform(const Transform& t,
                                                 std::vector<uint32_t>& in) {
    const int width = t.xsize, height = t.ysize;
    if (t.type == 0) {  // predictor
      std::vector<uint32_t> out(in.size());
      const int tiles_per_row = subsample(width, t.bits);
      out[0] = add_pixels(in[0], 0xff000000u);
      for (int x = 1; x < width; ++x) out[x] = add_pixels(in[x], out[x - 1]);
      for (int y = 1; y < height; ++y) {
        uint32_t* o = &out[static_cast<size_t>(y) * width];
        const uint32_t* i = &in[static_cast<size_t>(y) * width];
        const uint32_t* top = o - width;
        const uint32_t* modes = &t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row];
        o[0] = add_pixels(i[0], top[0]);
        for (int x = 1; x < width; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          o[x] = add_pixels(i[x], predict(mode, o + x, top + x));
        }
      }
      return out;
    }
    if (t.type == 1) {  // cross-colour
      const int tiles_per_row = subsample(width, t.bits);
      for (int y = 0; y < height; ++y) {
        uint32_t* p = &in[static_cast<size_t>(y) * width];
        const uint32_t* m = &t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row];
        for (int x = 0; x < width; ++x) {
          const uint32_t code = m[x >> t.bits];
          const int8_t g2r = static_cast<int8_t>(code & 0xff);
          const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
          const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
          const uint32_t argb = p[x];
          const int8_t green = static_cast<int8_t>(argb >> 8);
          int new_red = (argb >> 16) & 0xff;
          int new_blue = argb & 0xff;
          new_red += (g2r * green) >> 5;
          new_red &= 0xff;
          new_blue += (g2b * green) >> 5;
          new_blue += (r2b * static_cast<int8_t>(new_red)) >> 5;
          new_blue &= 0xff;
          p[x] = (argb & 0xff00ff00u) | (new_red << 16) | new_blue;
        }
      }
      return std::move(in);
    }
    if (t.type == 2) {  // subtract green
      for (uint32_t& argb : in) {
        const uint32_t green = (argb >> 8) & 0xff;
        uint32_t rb = argb & 0x00ff00ffu;
        rb += (green << 16) | green;
        rb &= 0x00ff00ffu;
        argb = (argb & 0xff00ff00u) | rb;
      }
      return std::move(in);
    }
    // colour indexing
    std::vector<uint32_t> out(static_cast<size_t>(width) * height);
    const int packed_width = subsample(width, t.bits);
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    for (int y = 0; y < height; ++y) {
      const uint32_t* src = &in[static_cast<size_t>(y) * packed_width];
      uint32_t* dst = &out[static_cast<size_t>(y) * width];
      uint32_t packed = 0;
      for (int x = 0; x < width; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
    return out;
  }
};

// A VP8L bitstream to RGB at out (row stride out_stride bytes).
void decode_vp8l(const uint8_t* data, size_t size, int width, int height,
                 uint8_t* out, size_t out_stride) {
  if (size < 5 || data[0] != 0x2f) corrupt("VP8L: bad signature");
  Vp8l dec(data, size);
  dec.br.read(8);
  const int w = dec.br.read(14) + 1, h = dec.br.read(14) + 1;
  dec.br.read(1);  // alpha_is_used
  if (dec.br.read(3) != 0) corrupt("VP8L: unknown version");
  if (w != width || h != height)
    corrupt("VP8L: the image's size differs from the container's");
  std::vector<uint32_t> argb = dec.decode_stream(w, h, true);
  for (int y = 0; y < h; ++y) {
    uint8_t* o = out + y * out_stride;
    const uint32_t* p = &argb[static_cast<size_t>(y) * w];
    for (int x = 0; x < w; ++x) {
      o[3 * x] = static_cast<uint8_t>(p[x] >> 16);
      o[3 * x + 1] = static_cast<uint8_t>(p[x] >> 8);
      o[3 * x + 2] = static_cast<uint8_t>(p[x]);
    }
  }
}

// ------------------------------------------------------------ alpha

// libwebp's ALPHInit and ALPHDecode (alpha_dec.c) on a lossy frame's ALPH
// chunk: the header byte (compression method 0 or 1, a filter in its two
// bits, pre-processing 0 or 1, the reserved bits 0), then raw alpha of at
// least width x height bytes, or a headerless VP8L stream (transforms,
// colour cache, meta prefix codes) whose green channel holds the alpha,
// and the filter undone (filters.c). Pillow's RGB never depends on the
// alpha, but libwebp's decode, and so Pillow, fails where it does not
// decode: so does this.
void decode_alpha(const uint8_t* data, size_t size, int width, int height) {
  if (size <= 1) corrupt("WebP: could not decode alpha data (an empty ALPH chunk)");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre_processing = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || pre_processing > 1 || reserved != 0)
    corrupt("WebP: could not decode alpha data (a bad ALPH header)");
  const uint8_t* p = data + 1;
  const size_t n = size - 1;
  const size_t npix = static_cast<size_t>(width) * height;
  std::vector<uint8_t> alpha(npix);
  if (method == 0) {
    if (n < npix) corrupt("WebP: could not decode alpha data (raw alpha shorter than the frame)");
    std::memcpy(alpha.data(), p, npix);
  } else {
    Vp8l dec(p, n);
    const std::vector<uint32_t> argb = dec.decode_stream(width, height, true);
    for (size_t i = 0; i < npix; i++) alpha[i] = static_cast<uint8_t>(argb[i] >> 8);
  }
  // WebPUnfilters: horizontal, vertical, gradient (none: 0), in place
  for (int y = 0; filter && y < height; y++) {
    uint8_t* row = &alpha[static_cast<size_t>(y) * width];
    const uint8_t* prev = y ? row - width : nullptr;
    if (!prev || filter == 1) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; x++) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < width; x++) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < width; x++) {
        top = prev[x];
        const int g = left + top - top_left;
        left = static_cast<uint8_t>(row[x] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        row[x] = left;
      }
    }
  }
}

// ------------------------------------------------------------ container

// The first frame of a WebP file, as WebPDemux lays it out for
// WebPAnimDecoder.
struct WebP {
  int64_t width = 0, height = 0;  // the canvas
  int64_t x = 0, y = 0, fw = 0, fh = 0;
  const uint8_t* bitstream = nullptr;
  size_t size = 0;
  bool lossless = false;
  const uint8_t* alpha = nullptr;  // the frame's ALPH chunk, if any
  size_t alpha_size = 0;

  // the frame's bitstream among chunks [p, end), and the first ALPH chunk
  // before it (WebPDemux refuses one before a VP8L bitstream); metadata
  // chunks are skipped
  void find_bitstream(const uint8_t* p, const uint8_t* end) {
    while (end - p >= 8) {
      const uint32_t n = le32(p + 4);
      if (static_cast<uint64_t>(end - p - 8) < n) corrupt("WebP: truncated chunk");
      if (!std::memcmp(p, "VP8 ", 4) || !std::memcmp(p, "VP8L", 4)) {
        lossless = p[3] == 'L';
        if (lossless && alpha) corrupt("WebP: an ALPH chunk before a VP8L bitstream");
        bitstream = p + 8;
        size = n;
        return;
      }
      if (!std::memcmp(p, "ALPH", 4) && !alpha) {
        alpha = p + 8;
        alpha_size = n;
      }
      p += 8 + n + (n & 1);
    }
    corrupt("WebP: no VP8 or VP8L bitstream");
  }

  // the bitstream's own size
  void bitstream_size(int64_t* w, int64_t* h) const {
    if (lossless) {
      if (size < 5 || bitstream[0] != 0x2f) corrupt("VP8L: bad signature");
      const uint32_t bits = le32(bitstream + 1);
      *w = (bits & 0x3fff) + 1;
      *h = ((bits >> 14) & 0x3fff) + 1;
    } else {
      if (size < 10) corrupt("VP8: truncated frame header");
      if (bitstream[3] != 0x9d || bitstream[4] != 0x01 || bitstream[5] != 0x2a)
        corrupt("VP8: bad code word");
      *w = (bitstream[6] | (bitstream[7] << 8)) & 0x3fff;
      *h = (bitstream[8] | (bitstream[9] << 8)) & 0x3fff;
    }
  }

  WebP(const uint8_t* d, int64_t n) {
    if (n < 20 || std::memcmp(d, "RIFF", 4) || std::memcmp(d + 8, "WEBP", 4))
      corrupt("not a WebP file");
    const uint64_t riff = le32(d + 4);
    if (riff < 12 || riff + 8 > static_cast<uint64_t>(n))
      corrupt("WebP: truncated file");
    const uint8_t* end = d + 8 + riff;
    const uint8_t* p = d + 12;
    if (!std::memcmp(p, "VP8X", 4)) {
      const uint32_t cn = le32(p + 4);
      if (cn < 10 || end - p - 8 < static_cast<int64_t>(cn)) corrupt("WebP: bad VP8X chunk");
      const uint8_t flags = p[8];
      width = static_cast<int64_t>(le24(p + 12)) + 1;
      height = static_cast<int64_t>(le24(p + 15)) + 1;
      p += 8 + cn + (cn & 1);
      if (flags & 0x02) {  // animation: the first ANMF
        while (end - p >= 8) {
          const uint32_t len = le32(p + 4);
          if (static_cast<uint64_t>(end - p - 8) < len) corrupt("WebP: truncated chunk");
          if (!std::memcmp(p, "ANMF", 4)) {
            if (len < 16) corrupt("WebP: bad ANMF chunk");
            x = 2 * static_cast<int64_t>(le24(p + 8));
            y = 2 * static_cast<int64_t>(le24(p + 11));
            fw = static_cast<int64_t>(le24(p + 14)) + 1;
            fh = static_cast<int64_t>(le24(p + 17)) + 1;
            find_bitstream(p + 24, p + 8 + len);
            break;
          }
          p += 8 + len + (len & 1);
        }
        if (!bitstream) corrupt("WebP: an animation without frames");
        if (x + fw > width || y + fh > height)
          corrupt("WebP: a frame outside the canvas");
      } else {
        find_bitstream(p, end);
        fw = width;
        fh = height;
      }
      int64_t bw, bh;
      bitstream_size(&bw, &bh);
      if (bw != fw || bh != fh)
        corrupt("WebP: the bitstream's size differs from the frame's");
      return;
    }
    find_bitstream(p, end);
    if (bitstream != p + 8) corrupt("WebP: the bitstream is not the first chunk");
    bitstream_size(&width, &height);
    fw = width;
    fh = height;
  }
};

// into out [height, width, 3]: the size mrt_webp_size gave
void decode_webp(const uint8_t* d, int64_t n, uint8_t* out, int64_t height,
                 int64_t width) {
  WebP w(d, n);
  if (w.width != width || w.height != height)
    corrupt("WebP: the canvas's size changed");
  // the canvas is cleared to transparent black; the frame goes at its
  // offset
  std::memset(out, 0, static_cast<size_t>(w.width * w.height * 3));
  uint8_t* at = out + (w.y * w.width + w.x) * 3;
  const size_t stride = static_cast<size_t>(w.width) * 3;
  if (w.lossless) {
    decode_vp8l(w.bitstream, w.size, static_cast<int>(w.fw),
                static_cast<int>(w.fh), at, stride);
  } else {
    decode_vp8(w.bitstream, w.size, static_cast<int>(w.fw),
               static_cast<int>(w.fh), at, stride);
    if (w.alpha)
      decode_alpha(w.alpha, w.alpha_size, static_cast<int>(w.fw), static_cast<int>(w.fh));
  }
}

template <class F>
int guarded(char* msg, int32_t msg_len, F f) {
  try {
    f();
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(Error{1, "WebP: out of memory"}, msg, msg_len);
  }
}

}  // namespace

extern "C" {

// The canvas's size: 0 and *height, *width, or an error code and message.
int mrt_webp_size(const uint8_t* data, int64_t n, int32_t* height,
                  int32_t* width, char* msg, int32_t msg_len) {
  return guarded(msg, msg_len, [&] {
    WebP w(data, n);
    *height = static_cast<int32_t>(std::min<int64_t>(w.height, INT32_MAX));
    *width = static_cast<int32_t>(std::min<int64_t>(w.width, INT32_MAX));
  });
}

// The whole decode into out [height, width, 3] (mrt_webp_size's size,
// checked again).
int mrt_webp_decode(const uint8_t* data, int64_t n, uint8_t* out,
                    int32_t height, int32_t width, char* msg,
                    int32_t msg_len) {
  return guarded(msg, msg_len,
                 [&] { decode_webp(data, n, out, height, width); });
}

}  // extern "C"
