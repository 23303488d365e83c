// Block-compressed texels and the planes of DDS, BLP and PSD files,
// decoded natively to RGB uint8: the pixels
// np.asarray(PIL.Image.open(f).convert("RGB")) gives with Pillow 12.1.
//
// * mrt_bcn: Pillow's C "bcn" decoder (DdsImagePlugin's tile, n = 1-7):
//   BC1 (4 colours, or 3 and a transparent black where c0 <= c1), BC2,
//   BC3, BC4, BC5 (unsigned, or signed "BC5S" with its bytes offset by
//   128), BC6H (unsigned or signed: the 14 modes' endpoint layouts,
//   deltas, unquantization, half floats made 8-bit as Pillow clamps
//   them) and BC7 (8 modes, partitions, anchors, p-bits, rotation, index
//   selection); blocks row by row, the right and bottom edge blocks
//   cropped; an error where the data runs out (Pillow's truncated file).
//   The BC6H/BC7 partition and anchor tables are in bcn_tables.h, read
//   off Pillow's decoder (tests/image_corpus.py --bcn-tables).
// * mrt_dds_masks: DdsImagePlugin's Python DdsRgbDecoder (bitcount // 8
//   bytes a pixel, little-endian, each mask's bits scaled by
//   int(v / total * 255) in doubles; a short read is zeros).
// * mrt_blp_dxt: BlpImagePlugin's own Python decode_dxt1/3/5 (its 565
//   expansion by shifts alone and its floor divisions, not bcn.c's), the
//   rows of 4-pixel blocks laid out as that plugin lays them, then read
//   back by the image's width as set_as_raw reads them.
// * mrt_psd_planes: PsdImagePlugin's merged image: one plane a channel,
//   raw or PackBits (Pillow's PackDecode.c: packets run on from row to
//   row, a packet past a row's end is cut there, the stream runs on past
//   its channel's byte counts), then Convert.c to RGB ("1", L, P through
//   its RGB;L palette, RGB(A), CMYK from "C;I" planes through cmyk2rgb,
//   LAB through image_decode.cpp's LittleCMS table).
//
// Host C++17, compiled into the image library with image_decode.cpp
// (maskrcnn_tpu_torch/data/native_image.py), which reads the headers
// in Python and calls these once a decode, outside the GIL. Entry points
// return 0, 1 (a corrupt file: ValueError) or 2 (NotImplementedError),
// with a message.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "bcn_tables.h"
#include "image_codec.h"

extern "C" int mrt_lab_rgb(const uint8_t* lab, int64_t n, uint8_t* rgb, char* msg,
                           int32_t msg_len);

namespace {

using mrt::corrupt;
using mrt::guarded;

struct Rgba {
  uint8_t r, g, b, a;
};

// ---------------------------------------------------------- BC1 - BC5

Rgba decode_565(uint16_t v) {
  int r = (v & 0xf800) >> 8;
  r |= r >> 5;
  int g = (v & 0x07e0) >> 3;
  g |= g >> 6;
  int b = (v & 0x001f) << 3;
  b |= b >> 5;
  return Rgba{uint8_t(r), uint8_t(g), uint8_t(b), 0xff};
}

inline uint16_t load16(const uint8_t* p) { return uint16_t(p[0] | (p[1] << 8)); }
inline uint32_t load32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// BC1's colour block; BC2 and BC3 always take the 4-colour branch
void bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  const uint16_t c0 = load16(src), c1 = load16(src + 2);
  const uint32_t lut = load32(src + 4);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  const int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = Rgba{uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3),
                uint8_t((2 * b0 + b1) / 3), 0xff};
    p[3] = Rgba{uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3),
                uint8_t((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = Rgba{uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2),
                0xff};
    p[3] = Rgba{0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) dst[n] = p[3 & (lut >> (2 * n))];
}

// BC3's alpha block (BC4's and BC5's channels): 8 bytes into channel o
// of 16 texels of `stride` bytes; signed: BC5S's int8 endpoints + 128
void bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
  int a0, a1;
  if (sign) {
    a0 = int8_t(src[0]) + 128;
    a1 = int8_t(src[1]) + 128;
  } else {
    a0 = src[0];
    a1 = src[1];
  }
  const int lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  const int lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  uint8_t a[8];
  a[0] = uint8_t(a0);
  a[1] = uint8_t(a1);
  if (a0 > a1) {
    for (int k = 1; k < 7; k++) a[k + 1] = uint8_t(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; k++) a[k + 1] = uint8_t(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  for (int n = 0; n < 8; n++) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; n++) dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

// ------------------------------------------------------------- BC7

// the bits [bit, bit + count) of a 16-byte block, LSB first
inline uint32_t get_bits(const uint8_t* src, int bit, int count) {
  uint32_t v = 0;
  for (int i = 0; i < count; i++, bit++) v |= uint32_t((src[bit >> 3] >> (bit & 7)) & 1) << i;
  return v;
}

struct Bc7Mode {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
constexpr Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

constexpr uint8_t kWeights2[4] = {0, 21, 43, 64};
constexpr uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
constexpr uint8_t kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

inline int subset_of(int ns, int partition, int n) {
  if (ns == 2) return 1 & (mrt::kBcPartition2[partition] >> n);
  if (ns == 3) return 3 & (mrt::kBcPartition3[partition] >> (2 * n));
  return 0;
}

inline uint8_t expand_quantized(uint8_t v, int bits) {
  v = uint8_t(v << (8 - bits));
  return uint8_t(v | (v >> bits));
}

void bc7_lerp(Rgba* dst, const Rgba* e, int s0, int s1) {
  const int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = uint8_t((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = uint8_t((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = uint8_t((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = uint8_t((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (!src[0]) {  // no mode bit: opaque black
    for (int i = 0; i < 16; i++) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  int bit = 0;
  while (!(src[0] & (1 << bit))) bit++;
  const Bc7Mode& info = kBc7Modes[bit];
  bit++;
  int cb = info.cb, ab = info.ab;
  const uint8_t* cw = weights(info.ib);
  const uint8_t* aw = weights((ab && info.ib2) ? info.ib2 : info.ib);
  auto load = [&](int n) {
    const uint32_t v = get_bits(src, bit, n);
    bit += n;
    return uint8_t(v);
  };
  const int partition = load(info.pb);
  const int rotation = load(info.rb);
  const int index_sel = load(info.isb);
  const int numep = info.ns << 1;
  Rgba ep[6];
  for (int i = 0; i < numep; i++) ep[i].r = load(cb);
  for (int i = 0; i < numep; i++) ep[i].g = load(cb);
  for (int i = 0; i < numep; i++) ep[i].b = load(cb);
  for (int i = 0; i < numep; i++) ep[i].a = ab ? load(ab) : 255;
  auto with_p = [&](Rgba& e, uint8_t p, bool alpha) {
    e.r = uint8_t((e.r << 1) | p);
    e.g = uint8_t((e.g << 1) | p);
    e.b = uint8_t((e.b << 1) | p);
    if (alpha) e.a = uint8_t((e.a << 1) | p);
  };
  if (info.epb) {  // a p-bit an endpoint
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i++) with_p(ep[i], load(1), ab != 0);
  }
  if (info.spb) {  // a p-bit a subset
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i += 2) {
      const uint8_t p = load(1);
      with_p(ep[i], p, ab != 0);
      with_p(ep[i + 1], p, ab != 0);
    }
  }
  for (int i = 0; i < numep; i++) {
    ep[i].r = expand_quantized(ep[i].r, cb);
    ep[i].g = expand_quantized(ep[i].g, cb);
    ep[i].b = expand_quantized(ep[i].b, cb);
    if (ab) ep[i].a = expand_quantized(ep[i].a, ab);
  }
  int cibit = bit;
  int aibit = cibit + 16 * info.ib - info.ns;
  for (int i = 0; i < 16; i++) {
    const int s = subset_of(info.ns, partition, i) << 1;
    int ib = info.ib;
    if (i == 0) {
      ib--;
    } else if (info.ns == 2) {
      if (i == mrt::kBcAnchor2[partition]) ib--;
    } else if (info.ns == 3) {
      if ((s == 2 && i == mrt::kBcAnchor3a[partition]) ||
          (s == 4 && i == mrt::kBcAnchor3b[partition]))
        ib--;
    }
    const int i0 = int(get_bits(src, cibit, ib));
    cibit += ib;
    if (ab && info.ib2) {
      int ib2 = info.ib2;
      if (i == 0) ib2--;
      const int i1 = int(get_bits(src, aibit, ib2));
      aibit += ib2;
      if (index_sel)
        bc7_lerp(&col[i], &ep[s], aw[i1], cw[i0]);
      else
        bc7_lerp(&col[i], &ep[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &ep[s], cw[i0], cw[i0]);
    }
    uint8_t* c = &col[i].r;
    if (rotation >= 1 && rotation <= 3) std::swap(c[rotation - 1], col[i].a);
  }
}

// ------------------------------------------------------------- BC6H

struct Bc6Mode {
  uint8_t ns, tr, pb, epb, rb, gb, bb;
};
constexpr Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// The endpoint bits of each mode after its mode bits, in stream order
// (the BC6H format's layout table): fields of endpoint e (r0 g0 b0 r1 g1
// b1 r2 g2 b2 r3 g3 b3 = 0-11; w, x, y, z of the format's naming), bits
// lo..hi in that order (hi < lo: the high bits stored reversed).
struct Field {
  uint8_t e, lo, hi;
};
enum : uint8_t { R0, G0, B0, R1, G1, B1, R2, G2, B2, R3, G3, B3 };
#define F(e, lo, hi) Field{e, lo, hi}
const std::vector<Field> kBc6Layouts[14] = {
    {F(G2, 4, 4), F(B2, 4, 4), F(B3, 4, 4), F(R0, 0, 9), F(G0, 0, 9), F(B0, 0, 9), F(R1, 0, 4),
     F(G3, 4, 4), F(G2, 0, 3), F(G1, 0, 4), F(B3, 0, 0), F(G3, 0, 3), F(B1, 0, 4), F(B3, 1, 1),
     F(B2, 0, 3), F(R2, 0, 4), F(B3, 2, 2), F(R3, 0, 4), F(B3, 3, 3)},
    {F(G2, 5, 5), F(G3, 4, 5), F(R0, 0, 6), F(B3, 0, 1), F(B2, 4, 4), F(G0, 0, 6), F(B2, 5, 5),
     F(B3, 2, 2), F(G2, 4, 4), F(B0, 0, 6), F(B3, 3, 3), F(B3, 5, 5), F(B3, 4, 4), F(R1, 0, 5),
     F(G2, 0, 3), F(G1, 0, 5), F(G3, 0, 3), F(B1, 0, 5), F(B2, 0, 3), F(R2, 0, 5), F(R3, 0, 5)},
    {F(R0, 0, 9), F(G0, 0, 9), F(B0, 0, 9), F(R1, 0, 4), F(R0, 10, 10), F(G2, 0, 3), F(G1, 0, 3),
     F(G0, 10, 10), F(B3, 0, 0), F(G3, 0, 3), F(B1, 0, 3), F(B0, 10, 10), F(B3, 1, 1),
     F(B2, 0, 3), F(R2, 0, 4), F(B3, 2, 2), F(R3, 0, 4), F(B3, 3, 3)},
    {F(R0, 0, 9), F(G0, 0, 9), F(B0, 0, 9), F(R1, 0, 3), F(R0, 10, 10), F(G3, 4, 4), F(G2, 0, 3),
     F(G1, 0, 4), F(G0, 10, 10), F(G3, 0, 3), F(B1, 0, 3), F(B0, 10, 10), F(B3, 1, 1),
     F(B2, 0, 3), F(R2, 0, 3), F(B3, 0, 0), F(B3, 2, 2), F(R3, 0, 3), F(G2, 4, 4), F(B3, 3, 3)},
    {F(R0, 0, 9), F(G0, 0, 9), F(B0, 0, 9), F(R1, 0, 3), F(R0, 10, 10), F(B2, 4, 4), F(G2, 0, 3),
     F(G1, 0, 3), F(G0, 10, 10), F(B3, 0, 0), F(G3, 0, 3), F(B1, 0, 4), F(B0, 10, 10),
     F(B2, 0, 3), F(R2, 0, 3), F(B3, 1, 2), F(R3, 0, 3), F(B3, 4, 4), F(B3, 3, 3)},
    {F(R0, 0, 8), F(B2, 4, 4), F(G0, 0, 8), F(G2, 4, 4), F(B0, 0, 8), F(B3, 4, 4), F(R1, 0, 4),
     F(G3, 4, 4), F(G2, 0, 3), F(G1, 0, 4), F(B3, 0, 0), F(G3, 0, 3), F(B1, 0, 4), F(B3, 1, 1),
     F(B2, 0, 3), F(R2, 0, 4), F(B3, 2, 2), F(R3, 0, 4), F(B3, 3, 3)},
    {F(R0, 0, 7), F(G3, 4, 4), F(B2, 4, 4), F(G0, 0, 7), F(B3, 2, 2), F(G2, 4, 4), F(B0, 0, 7),
     F(B3, 3, 4), F(R1, 0, 5), F(G2, 0, 3), F(G1, 0, 4), F(B3, 0, 0), F(G3, 0, 3), F(B1, 0, 4),
     F(B3, 1, 1), F(B2, 0, 3), F(R2, 0, 5), F(R3, 0, 5)},
    {F(R0, 0, 7), F(B3, 0, 0), F(B2, 4, 4), F(G0, 0, 7), F(G2, 5, 5), F(G2, 4, 4), F(B0, 0, 7),
     F(G3, 5, 5), F(B3, 4, 4), F(R1, 0, 4), F(G3, 4, 4), F(G2, 0, 3), F(G1, 0, 5), F(G3, 0, 3),
     F(B1, 0, 4), F(B3, 1, 1), F(B2, 0, 3), F(R2, 0, 4), F(B3, 2, 2), F(R3, 0, 4), F(B3, 3, 3)},
    {F(R0, 0, 7), F(B3, 1, 1), F(B2, 4, 4), F(G0, 0, 7), F(B2, 5, 5), F(G2, 4, 4), F(B0, 0, 7),
     F(B3, 5, 5), F(B3, 4, 4), F(R1, 0, 4), F(G3, 4, 4), F(G2, 0, 3), F(G1, 0, 4), F(B3, 0, 0),
     F(G3, 0, 3), F(B1, 0, 5), F(B2, 0, 3), F(R2, 0, 4), F(B3, 2, 2), F(R3, 0, 4), F(B3, 3, 3)},
    {F(R0, 0, 5), F(G3, 4, 4), F(B3, 0, 1), F(B2, 4, 4), F(G0, 0, 5), F(G2, 5, 5), F(B2, 5, 5),
     F(B3, 2, 2), F(G2, 4, 4), F(B0, 0, 5), F(G3, 5, 5), F(B3, 3, 3), F(B3, 5, 5), F(B3, 4, 4),
     F(R1, 0, 5), F(G2, 0, 3), F(G1, 0, 5), F(G3, 0, 3), F(B1, 0, 5), F(B2, 0, 3), F(R2, 0, 5),
     F(R3, 0, 5)},
    {F(R0, 0, 9), F(G0, 0, 9), F(B0, 0, 9), F(R1, 0, 9), F(G1, 0, 9), F(B1, 0, 9)},
    {F(R0, 0, 9), F(G0, 0, 9), F(B0, 0, 9), F(R1, 0, 8), F(R0, 10, 10), F(G1, 0, 8),
     F(G0, 10, 10), F(B1, 0, 8), F(B0, 10, 10)},
    {F(R0, 0, 9), F(G0, 0, 9), F(B0, 0, 9), F(R1, 0, 7), F(R0, 11, 10), F(G1, 0, 7),
     F(G0, 11, 10), F(B1, 0, 7), F(B0, 11, 10)},
    {F(R0, 0, 9), F(G0, 0, 9), F(B0, 0, 9), F(R1, 0, 3), F(R0, 15, 10), F(G1, 0, 3),
     F(G0, 15, 10), F(B1, 0, 3), F(B0, 15, 10)},
};
#undef F

inline void sign_extend(uint16_t& v, int prec) {
  int x = v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  v = uint16_t(x);
}

int bc6_unquantize(uint16_t v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xffff;
    return ((int(v) << 16) + 0x8000) >> bits;
  }
  int x = int16_t(v);
  if (bits >= 16) return x;
  bool s = false;
  if (x < 0) {
    s = true;
    x = -x;
  }
  if (x != 0) {
    if (x >= (1 << (bits - 1)) - 1)
      x = 0x7fff;
    else
      x = ((x << 15) + 0x4000) >> (bits - 1);
  }
  return s ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000u;
  o.u = uint32_t(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000u;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= uint32_t(h & 0x8000) << 16;
  return o.f;
}

float bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float(uint16_t(0x8000 | (((-v) * 31) / 32)));
    return half_to_float(uint16_t((v * 31) / 32));
  }
  return half_to_float(uint16_t((v * 31) / 64));
}

inline uint8_t bc6_clamp(float v) {
  if (v < 0.0f) return 0;
  if (v > 1.0f) return 255;
  return uint8_t(v * 255.0f);
}

void bc6_lerp(Rgba* col, const int* e0, const int* e1, int s, bool sign) {
  const int t = 64 - s;
  col->r = bc6_clamp(bc6_finalize((e0[0] * t + e1[0] * s) >> 6, sign));
  col->g = bc6_clamp(bc6_finalize((e0[1] * t + e1[1] * s) >> 6, sign));
  col->b = bc6_clamp(bc6_finalize((e0[2] * t + e1[2] * s) >> 6, sign));
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 0x1f, bit = 5, ib = 3;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
  } else {
    mode = 10 + (mode >> 2);
    ib = 4;
  }
  if (mode >= 14) {  // a reserved mode: black
    std::memset(col, 0, 16 * sizeof(Rgba));
    return;
  }
  const Bc6Mode& info = kBc6Modes[mode];
  const uint8_t* cw = weights(ib);
  const int numep = info.ns == 2 ? 12 : 6;
  uint16_t ep[12] = {0};
  for (const Field& f : kBc6Layouts[mode]) {
    const int step = f.hi >= f.lo ? 1 : -1;
    for (int b = f.lo;; b += step) {
      ep[f.e] = uint16_t(ep[f.e] | (get_bits(src, bit++, 1) << b));
      if (b == f.hi) break;
    }
  }
  const int partition = int(get_bits(src, bit, info.pb));
  bit += info.pb;
  const int mask = (1 << info.epb) - 1;
  if (sign)
    for (int i = 0; i < 3; i++) sign_extend(ep[i], info.epb);
  if (sign || info.tr)
    for (int i = 3; i < numep; i += 3) {
      sign_extend(ep[i], info.rb);
      sign_extend(ep[i + 1], info.gb);
      sign_extend(ep[i + 2], info.bb);
    }
  // the deltas added and masked to the endpoint's bits, where Pillow
  // leaves a signed block's sums unextended
  if (info.tr)
    for (int i = 3; i < numep; i++) ep[i] = uint16_t((ep[i] + ep[i % 3]) & mask);
  int ueps[12];
  for (int i = 0; i < numep; i++) ueps[i] = bc6_unquantize(ep[i], info.epb, sign);
  for (int i = 0; i < 16; i++) {
    const int s = subset_of(info.ns, partition, i) * 6;
    int ib2 = ib;
    if (i == 0 || (info.ns == 2 && i == mrt::kBcAnchor2[partition])) ib2--;
    const int i0 = int(get_bits(src, bit, ib2));
    bit += ib2;
    bc6_lerp(&col[i], &ueps[s], &ueps[s + 3], cw[i0], sign);
  }
}

// One block of BCn (n = 1-7) as RGBA texels (BC4: its value in r, g, b)
void bcn_block(Rgba* col, const uint8_t* src, int n, bool sign) {
  std::memset(col, 0, 16 * sizeof(Rgba));
  switch (n) {
    case 1:
      bc1_color(col, src, false);
      break;
    case 2:
      bc1_color(col, src + 8, true);
      for (int i = 0; i < 16; i++) {
        const int av = 0xf & (src[(i * 4) >> 3] >> ((i * 4) & 7));
        col[i].a = uint8_t((av << 4) | av);
      }
      break;
    case 3:
      bc1_color(col, src + 8, true);
      bc3_alpha(&col[0].r, src, 4, 3, false);
      break;
    case 4: {
      uint8_t l[16];
      bc3_alpha(l, src, 1, 0, false);
      for (int i = 0; i < 16; i++) col[i] = Rgba{l[i], l[i], l[i], 255};
      break;
    }
    case 5:
      bc3_alpha(&col[0].r, src, 4, 0, sign);
      bc3_alpha(&col[0].r, src + 8, 4, 1, sign);
      if (sign)  // BC5S: blue at the signed range's zero
        for (int i = 0; i < 16; i++) col[i].b = 128;
      break;
    case 6:
      bc6_block(col, src, sign);
      break;
    default:
      bc7_block(col, src);
  }
}

void decode_bcn(const uint8_t* d, int64_t n, int64_t pos, int bcn, bool sign, uint8_t* out,
                int height, int width) {
  const int size = (bcn == 1 || bcn == 4) ? 8 : 16;
  const int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
  if (pos > n || (n - pos) / size < bw * bh) corrupt("DDS: image file is truncated");
  Rgba col[16];
  const uint8_t* p = d + pos;
  for (int64_t by = 0; by < bh; by++)
    for (int64_t bx = 0; bx < bw; bx++, p += size) {
      bcn_block(col, p, bcn, sign);
      for (int j = 0; j < 4; j++) {
        const int64_t y = by * 4 + j;
        if (y >= height) break;
        for (int i = 0; i < 4; i++) {
          const int64_t x = bx * 4 + i;
          if (x >= width) break;
          uint8_t* o = out + (y * width + x) * 3;
          o[0] = col[j * 4 + i].r;
          o[1] = col[j * 4 + i].g;
          o[2] = col[j * 4 + i].b;
        }
      }
    }
}

// ------------------------------------------------------- DDS's masks

void dds_masks(const uint8_t* d, int64_t n, int64_t pos, int64_t bitcount, const uint32_t* masks,
               int count, uint8_t* out, int height, int width) {
  int offset[4] = {0, 0, 0, 0};
  uint32_t total[4] = {0, 0, 0, 0};
  for (int c = 0; c < count; c++) {
    uint32_t m = masks[c];
    if (m) {
      while (!(m & 1)) {
        m >>= 1;
        offset[c]++;
      }
    }
    total[c] = m;
  }
  const int64_t bytes = bitcount / 8, npix = int64_t(width) * height;
  for (int64_t i = 0; i < npix; i++) {
    uint32_t v = 0;
    if (pos < n) {
      const int64_t k = std::min<int64_t>(std::min<int64_t>(bytes, 4), n - pos);
      for (int64_t b = 0; b < k; b++) v |= uint32_t(d[pos + b]) << (8 * b);
      pos += std::min(bytes, n - pos);
    }
    for (int c = 0; c < 3; c++)
      out[i * 3 + c] = total[c] ? uint8_t(int(double((v & masks[c]) >> offset[c]) /
                                               double(total[c]) * 255.0))
                                : 0;
  }
}

// ------------------------------------------------------- BLP's DXT

// BlpImagePlugin.unpack_565
inline void unpack_565(int v, int* c) {
  c[0] = ((v >> 11) & 0x1f) << 3;
  c[1] = ((v >> 5) & 0x3f) << 2;
  c[2] = (v & 0x1f) << 3;
}

// decode_dxt1/3/5 of one block: 16 texels of RGBA
void blp_block(const uint8_t* b, int kind, int* px) {
  int c0[3], c1[3];
  const int color0 = load16(b + (kind == 0 ? 0 : 8)), color1 = load16(b + (kind == 0 ? 2 : 10));
  uint32_t code = load32(b + (kind == 0 ? 4 : 12));
  unpack_565(color0, c0);
  unpack_565(color1, c1);
  const int a0 = b[0], a1 = b[1];
  const uint32_t acode2 = b[2] | (b[3] << 8);
  const uint32_t acode1 = b[4] | (b[5] << 8) | (b[6] << 16) | (uint32_t(b[7]) << 24);
  for (int t = 0; t < 16; t++) {
    const int cc = (code >> (2 * t)) & 3;
    int* o = px + 4 * t;
    o[3] = 255;
    for (int k = 0; k < 3; k++) {
      if (cc == 0) o[k] = c0[k];
      else if (cc == 1) o[k] = c1[k];
      else if (kind == 0 && color0 <= color1)
        o[k] = cc == 2 ? (c0[k] + c1[k]) / 2 : 0;
      else
        o[k] = cc == 2 ? (2 * c0[k] + c1[k]) / 3 : (2 * c1[k] + c0[k]) / 3;
    }
    if (kind == 0) {
      if (cc == 3 && color0 <= color1) o[3] = 0;
    } else if (kind == 1) {
      const int a = b[t / 2];
      o[3] = ((t & 1) ? a >> 4 : a & 0xf) * 17;
    } else {
      const int ai = 3 * t;
      int ac;
      if (ai <= 12) ac = (acode2 >> ai) & 7;
      else if (ai == 15) ac = (acode2 >> 15) | ((acode1 << 1) & 6);
      else ac = (acode1 >> (ai - 16)) & 7;
      int a;
      if (ac == 0) a = a0;
      else if (ac == 1) a = a1;
      else if (a0 > a1) a = ((8 - ac) * a0 + (ac - 1) * a1) / 7;
      else if (ac == 6) a = 0;
      else if (ac == 7) a = 255;
      else a = ((6 - ac) * a0 + (ac - 1) * a1) / 5;
      o[3] = a;
    }
  }
}

// BLP2's DXT (kind 0, 1, 2: alpha encodings 0, 1 and 7): every row of
// blocks read whole (ImageFile._safe_read: a short one is Pillow's
// "Truncated File Read"), its 4 rows of the padded width laid out one
// after another, 4 bytes a pixel (3 for DXT1 without alpha); then that
// stream read as `width` pixels a row of the image's mode (4 bytes where
// `alpha`, else 3), as set_as_raw reads it.
void blp_dxt(const uint8_t* d, int64_t n, int64_t pos, int kind, bool alpha, uint8_t* out,
             int height, int width) {
  const int64_t bw = (int64_t(width) + 3) / 4, bh = (int64_t(height) + 3) / 4;
  const int size = kind == 0 ? 8 : 16;
  const int per = (kind == 0 && !alpha) ? 3 : 4;  // bytes a pixel decode_dxt* gives
  const int step = alpha ? 4 : 3;                 // bytes a pixel of the image's mode
  const int64_t line = bw * size;
  if (pos > n || (n - pos) / line < bh) corrupt("BLP: Truncated File Read");
  const int64_t row_px = bw * 4;
  int px[64];
  for (int64_t by = 0; by < bh; by++)
    for (int64_t bx = 0; bx < bw; bx++) {
      blp_block(d + pos + by * line + bx * size, kind, px);
      for (int j = 0; j < 4; j++)
        for (int i = 0; i < 4; i++) {
          // the texel's place in the stream, then in the image
          const int64_t at = ((by * 4 + j) * row_px + bx * 4 + i) * per;
          for (int k = 0; k < per; k++) {
            const int64_t b = at + k, pixel = b / step, c = b % step;
            if (c < 3 && pixel < int64_t(width) * height)
              out[pixel * 3 + c] = uint8_t(px[4 * (j * 4 + i) + k]);
          }
        }
    }
}

// -------------------------------------------------------------- PSD

// Pillow's PackDecode.c over data[pos, n) into `rows` rows of `stride`
// bytes; an error where the data ends first
void packbits(const uint8_t* d, int64_t n, int64_t pos, int64_t stride, int64_t rows,
              uint8_t* dst) {
  int64_t x = 0, y = 0;
  for (;;) {
    if (pos >= n) corrupt("PSD: image file is truncated");
    const uint8_t c = d[pos];
    if (c & 0x80) {
      if (c == 0x80) {
        pos++;
        continue;
      }
      if (n - pos < 2) corrupt("PSD: image file is truncated");
      for (int k = 257 - c; k > 0 && x < stride; k--) dst[y * stride + x++] = d[pos + 1];
      pos += 2;
    } else {
      const int64_t len = c + 2;
      if (n - pos < len) corrupt("PSD: image file is truncated");
      for (int64_t i = 1; i < len && x < stride; i++) dst[y * stride + x++] = d[pos + i];
      pos += len;
    }
    if (x >= stride) {
      x = 0;
      if (++y >= rows) return;
    }
  }
}

// PSD modes as native_image.PSD_MODES numbers them
enum PsdMode { kOne, kL, kP, kRGB, kRGBA, kCMYK, kLAB };

void psd_planes(const uint8_t* d, int64_t n, int64_t pos, int compression, int mode,
                int channels, const uint8_t* palette, uint8_t* out, int height, int width) {
  const int64_t npix = int64_t(width) * height;
  const int64_t stride = mode == kOne ? (int64_t(width) + 7) / 8 : width;
  std::vector<uint8_t> planes(size_t(stride * height * channels));
  if (compression == 0) {
    for (int c = 0; c < channels; c++) {
      const int64_t at = pos + int64_t(c) * npix;
      if (at > n || n - at < stride * height) corrupt("PSD: image file is truncated");
      std::memcpy(&planes[size_t(c * stride * height)], d + at, size_t(stride * height));
    }
  } else if (compression == 1) {
    const int64_t table = pos;
    pos += int64_t(channels) * height * 2;
    if (pos > n) corrupt("PSD: the byte-count table runs past the file");
    for (int c = 0; c < channels; c++) {
      packbits(d, n, pos, stride, height, &planes[size_t(c * stride * height)]);
      for (int64_t y = 0; y < height; y++) {
        const int64_t at = table + (int64_t(c) * height + y) * 2;
        pos += (d[at] << 8) | d[at + 1];
      }
    }
  } else {
    corrupt("PSD: cannot load this image (compression " + std::to_string(compression) + ")");
  }
  const uint8_t* p = planes.data();
  const int64_t ps = stride * height;
  if (mode == kOne) {
    for (int64_t y = 0; y < height; y++)
      for (int64_t x = 0; x < width; x++) {
        const uint8_t v = (p[y * stride + x / 8] >> (7 - x % 8)) & 1 ? 255 : 0;
        std::memset(out + (y * width + x) * 3, v, 3);
      }
  } else if (mode == kL) {
    for (int64_t i = 0; i < npix; i++) std::memset(out + i * 3, p[i], 3);
  } else if (mode == kP) {
    for (int64_t i = 0; i < npix; i++)
      for (int k = 0; k < 3; k++) out[i * 3 + k] = palette[p[i] * 3 + k];
  } else if (mode == kRGB || mode == kRGBA) {
    for (int64_t i = 0; i < npix; i++)
      for (int k = 0; k < 3; k++) out[i * 3 + k] = p[k * ps + i];
  } else if (mode == kCMYK) {
    for (int64_t i = 0; i < npix; i++) {
      const uint8_t c[4] = {uint8_t(255 - p[i]), uint8_t(255 - p[ps + i]),
                            uint8_t(255 - p[2 * ps + i]), uint8_t(255 - p[3 * ps + i])};
      mrt::cmyk_rgb(c, out + i * 3);
    }
  } else {
    std::vector<uint8_t> lab(size_t(npix * 3));
    for (int64_t i = 0; i < npix; i++)
      for (int k = 0; k < 3; k++) lab[size_t(i * 3 + k)] = p[k * ps + i];
    char msg[256];
    if (mrt_lab_rgb(lab.data(), npix, out, msg, sizeof(msg))) corrupt(msg);
  }
}

}  // namespace

extern "C" {

// BCn blocks (bcn = 1-7; sign: BC5S, BC6HS) from data[pos, n) into out
// [height, width, 3], as convert("RGB") of Pillow's decode gives them
int mrt_bcn(const uint8_t* data, int64_t n, int64_t pos, int32_t bcn, int32_t sign, uint8_t* out,
            int32_t height, int32_t width, char* msg, int32_t msg_len) {
  return guarded("DDS", msg, msg_len,
                 [&] { decode_bcn(data, n, pos, bcn, sign != 0, out, height, width); });
}

// DDS's uncompressed RGB(A) of `count` masks from data[pos, n)
int mrt_dds_masks(const uint8_t* data, int64_t n, int64_t pos, int64_t bitcount,
                  const uint32_t* masks, int32_t count, uint8_t* out, int32_t height,
                  int32_t width, char* msg, int32_t msg_len) {
  return guarded("DDS", msg, msg_len, [&] {
    dds_masks(data, n, pos, bitcount, masks, count, out, height, width);
  });
}

// BLP2's DXT1/3/5 (kind 0, 1, 2) from data[pos, n); alpha: the image is
// RGBA
int mrt_blp_dxt(const uint8_t* data, int64_t n, int64_t pos, int32_t kind, int32_t alpha,
                uint8_t* out, int32_t height, int32_t width, char* msg, int32_t msg_len) {
  return guarded("BLP", msg, msg_len,
                 [&] { blp_dxt(data, n, pos, kind, alpha != 0, out, height, width); });
}

// PSD's merged image: `channels` planes from data[pos, n) (pos: after
// the compression word), mode a PsdMode, palette 768 bytes (RGB
// triples) for P
int mrt_psd_planes(const uint8_t* data, int64_t n, int64_t pos, int32_t compression,
                   int32_t mode, int32_t channels, const uint8_t* palette, uint8_t* out,
                   int32_t height, int32_t width, char* msg, int32_t msg_len) {
  return guarded("PSD", msg, msg_len, [&] {
    psd_planes(data, n, pos, compression, mode, channels, palette, out, height, width);
  });
}

}  // extern "C"
