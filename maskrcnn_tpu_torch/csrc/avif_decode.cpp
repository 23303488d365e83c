// Host AVIF decoder of the port: an AVIF file's AV1 item (and its alpha
// item) to RGB or RGBA uint8, the pixels Pillow 12.1's AvifImageFile gives
// over libavif 1.3, which decodes with dav1d and converts with
// avifImageYUVToRGB into an avifRGBImage of 8 bits (RGB, or RGBA where
// the image has alpha) at its defaults (automatic chroma upsampling).
//
// The container is read in Python (data/image_probe.py's model of
// libavif's parse, which hands this library the items' bytes and the
// properties); here: the AV1 frames (av1_decode.cpp), then
// avifImageYUVToRGB's routes for 8-bit data:
// * libyuv's (reformat_libyuv.c) where libyuv takes the matrix: BT.601
//   (and BT.470BG, and unspecified), BT.709 and BT.2020 NCL, each in full
//   or limited range, and the chromaticity-derived NCL matrix of those
//   primaries (unspecified primaries taken as BT.709's): YuvPixel's 6-bit fixed point (row_common.c's constants),
//   with 4:2:0 and 4:2:2 chroma upsampled by ScaleRowUp2_Bilinear and
//   ScaleRowUp2_Linear (its "Any" edges) as the MatrixFilter routes do;
// * libavif's own (reformat.c) where it does not: identity (4:4:4),
//   YCgCo (full range), the other matrices of its coefficient table and
//   the chromaticity-derived matrix of other primaries, 4:0:0 in limited
//   range: float unorm tables, the bilinear 9/3/3/1 chroma upsampling of
//   avifImageYUVAnyToRGBAnySlow, and (uint8_t)(0.5f + v * 255).
// The matrices libavif does not convert (BT.2020 CL, SMPTE 2085, CL,
// ICtCp, reserved values, YCgCo in limited range, identity with
// subsampled chroma) fail as Pillow fails ("Conversion from YUV failed").
// An alpha plane in limited range is widened as avifLimitedToFullY does;
// premultiplied alpha is undone as avifRGBImageUnpremultiplyAlpha does
// (with libyuv's ARGBUnattenuate).
//
// Host C++17: compiled with av1_decode.cpp into the AVIF library
// (maskrcnn_tpu_torch/data/native_image.py), called through ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "av1_decode.h"
#include "image_codec.h"

namespace mrt {
namespace {

using av1::Frame;

// libyuv's YuvConstants: YG, YB, UB, UG, VG, VR
struct LibyuvConstants {
  int yg, yb, ub, ug, vg, vr;
};
const LibyuvConstants kI601 = {18997, -1160, 128, 25, 52, 102};
const LibyuvConstants kJpeg = {16320, 32, 113, 22, 46, 90};
const LibyuvConstants kH709 = {18997, -1160, 128, 14, 34, 115};
const LibyuvConstants kF709 = {16320, 32, 119, 12, 30, 101};
const LibyuvConstants k2020 = {19003, -1160, 128, 12, 42, 107};
const LibyuvConstants kV2020 = {16320, 32, 120, 11, 37, 94};

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

inline void yuv_pixel(int y, int u, int v, const LibyuvConstants& c, uint8_t* rgb) {
  const int bb = c.ub * 128 - c.yb, bg = c.ug * 128 + c.vg * 128 + c.yb, br = c.vr * 128 - c.yb;
  const int y1 = static_cast<int>((static_cast<uint32_t>(y) * 0x0101u * static_cast<uint32_t>(c.yg)) >> 16);
  const int b = y1 + u * c.ub - bb;
  const int g = y1 + bg - (u * c.ug + v * c.vg);
  const int r = y1 + v * c.vr - br;
  rgb[0] = clamp255(r >> 6);
  rgb[1] = clamp255(g >> 6);
  rgb[2] = clamp255(b >> 6);
}

// ScaleRowUp2_Linear_Any_C
void up_linear(const uint8_t* s, int w, uint8_t* d) {
  const int work = (w - 1) & ~1;
  d[0] = s[0];
  for (int x = 0; x < work / 2; x++) {
    d[1 + 2 * x] = static_cast<uint8_t>((s[x] * 3 + s[x + 1] + 2) >> 2);
    d[2 + 2 * x] = static_cast<uint8_t>((s[x] + s[x + 1] * 3 + 2) >> 2);
  }
  d[w - 1] = s[(w - 1) / 2];
}

// ScaleRowUp2_Bilinear_Any_C: two output rows from chroma rows s and t
void up_bilinear(const uint8_t* s, const uint8_t* t, int w, uint8_t* d, uint8_t* e) {
  const int work = (w - 1) & ~1;
  d[0] = static_cast<uint8_t>((3 * s[0] + t[0] + 2) >> 2);
  e[0] = static_cast<uint8_t>((s[0] + 3 * t[0] + 2) >> 2);
  for (int x = 0; x < work / 2; x++) {
    d[1 + 2 * x] = static_cast<uint8_t>((s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4);
    d[2 + 2 * x] = static_cast<uint8_t>((s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4);
    e[1 + 2 * x] = static_cast<uint8_t>((s[x] * 3 + s[x + 1] + t[x] * 9 + t[x + 1] * 3 + 8) >> 4);
    e[2 + 2 * x] = static_cast<uint8_t>((s[x] + s[x + 1] * 3 + t[x] * 3 + t[x + 1] * 9 + 8) >> 4);
  }
  const int k = (w - 1) / 2;
  d[w - 1] = static_cast<uint8_t>((3 * s[k] + t[k] + 2) >> 2);
  e[w - 1] = static_cast<uint8_t>((s[k] + 3 * t[k] + 2) >> 2);
}

// The planes of a frame: pointers, strides, subsampling.
struct Planes {
  const uint8_t* p[3];
  int stride[3];
  int w, h, ss_x, ss_y, mono;
};

void libyuv_route(const Planes& pl, const LibyuvConstants& c, uint8_t* out, int channels) {
  const int w = pl.w, h = pl.h;
  std::vector<uint8_t> u0(w), v0(w), u1(w), v1(w);
  auto row = [&](int y, const uint8_t* u, const uint8_t* v) {
    const uint8_t* yr = pl.p[0] + size_t(y) * pl.stride[0];
    uint8_t* o = out + size_t(y) * w * channels;
    for (int x = 0; x < w; x++) yuv_pixel(yr[x], u[x], v[x], c, o + x * channels);
  };
  if (!pl.ss_x && !pl.ss_y) {
    for (int y = 0; y < h; y++)
      row(y, pl.p[1] + size_t(y) * pl.stride[1], pl.p[2] + size_t(y) * pl.stride[2]);
    return;
  }
  if (pl.ss_x && !pl.ss_y) {
    for (int y = 0; y < h; y++) {
      up_linear(pl.p[1] + size_t(y) * pl.stride[1], w, u0.data());
      up_linear(pl.p[2] + size_t(y) * pl.stride[2], w, v0.data());
      row(y, u0.data(), v0.data());
    }
    return;
  }
  // 4:2:0 (I420ToRGB24MatrixBilinear's order of rows)
  const uint8_t* su = pl.p[1];
  const uint8_t* sv = pl.p[2];
  up_linear(su, w, u0.data());
  up_linear(sv, w, v0.data());
  row(0, u0.data(), v0.data());
  int y = 1;
  for (; y < h - 1; y += 2) {
    up_bilinear(su, su + pl.stride[1], w, u0.data(), u1.data());
    up_bilinear(sv, sv + pl.stride[2], w, v0.data(), v1.data());
    row(y, u0.data(), v0.data());
    row(y + 1, u1.data(), v1.data());
    su += pl.stride[1];
    sv += pl.stride[2];
  }
  if (!(h & 1)) {
    up_linear(su, w, u0.data());
    up_linear(sv, w, v0.data());
    row(h - 1, u0.data(), v0.data());
  }
}

// libavif's colour primaries (rX, rY, gX, gY, bX, bY, wX, wY), BT.709's for
// values it does not know
void primaries_of(int cp, float* v) {
  static const struct {
    int cp;
    float v[8];
  } kTable[] = {
      {1, {0.64f, 0.33f, 0.30f, 0.60f, 0.15f, 0.06f, 0.3127f, 0.3290f}},
      {4, {0.67f, 0.33f, 0.21f, 0.71f, 0.14f, 0.08f, 0.310f, 0.316f}},
      {5, {0.64f, 0.33f, 0.29f, 0.60f, 0.15f, 0.06f, 0.3127f, 0.3290f}},
      {6, {0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f, 0.3290f}},
      {7, {0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f, 0.3290f}},
      {8, {0.681f, 0.319f, 0.243f, 0.692f, 0.145f, 0.049f, 0.310f, 0.316f}},
      {9, {0.708f, 0.292f, 0.170f, 0.797f, 0.131f, 0.046f, 0.3127f, 0.3290f}},
      {10, {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.3333f, 0.3333f}},
      {11, {0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.314f, 0.351f}},
      {12, {0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.3127f, 0.3290f}},
      {22, {0.630f, 0.340f, 0.295f, 0.605f, 0.155f, 0.077f, 0.3127f, 0.3290f}},
  };
  for (const auto& e : kTable)
    if (e.cp == cp) {
      std::memcpy(v, e.v, sizeof(e.v));
      return;
    }
  std::memcpy(v, kTable[0].v, sizeof(kTable[0].v));
}

// avifCalcYUVCoefficients: kr, kg, kb
void yuv_coefficients(int mc, int cp, float* kr, float* kg, float* kb) {
  float r = 0.299f, b = 0.114f;  // BT.601, libavif's default
  if (mc == 12) {
    float p[8];
    primaries_of(cp, p);
    const float rX = p[0], rY = p[1], gX = p[2], gY = p[3], bX = p[4], bY = p[5], wX = p[6], wY = p[7];
    const float rZ = 1.0f - (rX + rY), gZ = 1.0f - (gX + gY), bZ = 1.0f - (bX + bY), wZ = 1.0f - (wX + wY);
    r = (rY * (wX * (gY * bZ - bY * gZ) + wY * (bX * gZ - gX * bZ) + wZ * (gX * bY - bX * gY))) /
        (wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) + bX * (rY * gZ - gY * rZ)));
    b = (bY * (wX * (rY * gZ - gY * rZ) + wY * (gX * rZ - rX * gZ) + wZ * (rX * gY - gX * rY))) /
        (wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) + bX * (rY * gZ - gY * rZ)));
  } else {
    switch (mc) {
      case 1: r = 0.2126f; b = 0.0722f; break;
      case 4: r = 0.30f; b = 0.11f; break;
      case 5: case 6: r = 0.299f; b = 0.114f; break;
      case 7: r = 0.212f; b = 0.087f; break;
      case 9: r = 0.2627f; b = 0.0593f; break;
      default: break;
    }
  }
  *kr = r;
  *kb = b;
  *kg = 1.0f - r - b;
}

enum Mode { MODE_COEFFICIENTS, MODE_IDENTITY, MODE_YCGCO };

void libavif_route(const Planes& pl, int mc, int cp, int full, uint8_t* out, int channels) {
  const int w = pl.w, h = pl.h;
  const Mode mode = mc == 0 ? MODE_IDENTITY : mc == 8 ? MODE_YCGCO : MODE_COEFFICIENTS;
  float kr = 0.0f, kg = 0.0f, kb = 0.0f;
  if (mode == MODE_COEFFICIENTS) yuv_coefficients(mc, cp, &kr, &kg, &kb);
  const float bias_y = full ? 0.0f : 16.0f;
  const float bias_uv = 128.0f;
  const float range_y = full ? 255.0f : 219.0f;
  const float range_uv = full ? 255.0f : 224.0f;
  float table_y[256], table_uv[256];
  for (int i = 0; i < 256; i++) {
    table_y[i] = (static_cast<float>(i) - bias_y) / range_y;
    table_uv[i] = (static_cast<float>(i) - bias_uv) / range_uv;
  }
  const float* tuv = mode == MODE_IDENTITY ? table_y : table_uv;
  const float max_f = 255.0f;
  for (int j = 0; j < h; j++) {
    const uint8_t* yr = pl.p[0] + size_t(j) * pl.stride[0];
    uint8_t* o = out + size_t(j) * w * channels;
    const int uv_j = j >> pl.ss_y;
    for (int i = 0; i < w; i++) {
      const float Y = table_y[yr[i]];
      float Cb = 0.5f, Cr = 0.5f;
      float R, G, B;
      if (!pl.mono) {
        const int uv_i = i >> pl.ss_x;
        const uint8_t* pu = pl.p[1] + size_t(uv_j) * pl.stride[1] + uv_i;
        const uint8_t* pv = pl.p[2] + size_t(uv_j) * pl.stride[2] + uv_i;
        if (!pl.ss_x && !pl.ss_y) {
          Cb = tuv[*pu];
          Cr = tuv[*pv];
        } else {
          int adj_col, adj_row;
          if (i == 0 || (i == w - 1 && (i % 2) != 0) || !pl.ss_x) adj_col = 0;
          else adj_col = (i % 2) != 0 ? 1 : -1;
          if (j == 0 || (j == h - 1 && (j % 2) != 0) || !pl.ss_y) adj_row = 0;
          else adj_row = (j % 2) != 0 ? pl.stride[1] : -pl.stride[1];
          const int adj_row_v = adj_row == 0 ? 0 : (adj_row > 0 ? pl.stride[2] : -pl.stride[2]);
          Cb = (tuv[pu[0]] * (9.0f / 16.0f)) + (tuv[pu[adj_col]] * (3.0f / 16.0f)) +
               (tuv[pu[adj_row]] * (3.0f / 16.0f)) + (tuv[pu[adj_col + adj_row]] * (1.0f / 16.0f));
          Cr = (tuv[pv[0]] * (9.0f / 16.0f)) + (tuv[pv[adj_col]] * (3.0f / 16.0f)) +
               (tuv[pv[adj_row_v]] * (3.0f / 16.0f)) + (tuv[pv[adj_col + adj_row_v]] * (1.0f / 16.0f));
        }
        if (mode == MODE_IDENTITY) {
          G = Y;
          B = Cb;
          R = Cr;
        } else if (mode == MODE_YCGCO) {
          const float t = Y - Cb;
          G = Y + Cb;
          B = t - Cr;
          R = t + Cr;
        } else {
          R = Y + (2 * (1 - kr)) * Cr;
          B = Y + (2 * (1 - kb)) * Cb;
          G = Y - ((2 * ((kr * (1 - kr) * Cr) + (kb * (1 - kb) * Cb))) / kg);
        }
      } else {
        R = G = B = Y;
      }
      const float rc = std::min(std::max(R, 0.0f), 1.0f);
      const float gc = std::min(std::max(G, 0.0f), 1.0f);
      const float bc = std::min(std::max(B, 0.0f), 1.0f);
      o[i * channels + 0] = static_cast<uint8_t>(0.5f + (rc * max_f));
      o[i * channels + 1] = static_cast<uint8_t>(0.5f + (gc * max_f));
      o[i * channels + 2] = static_cast<uint8_t>(0.5f + (bc * max_f));
    }
  }
}

// avifImageYUVToRGB for 8-bit planes into RGB (channels 3) or RGBA
// (channels 4, alpha filled by the caller); mc, cp: the CICP matrix and
// primaries, full: the YUV range.
void yuv_to_rgb(const Planes& pl, int mc, int cp, int full, uint8_t* out, int channels) {
  if (mc == 3 || mc == 10 || mc == 11 || mc == 13 || mc == 14 || mc == 16 || mc == 17 || mc >= 18)
    corrupt("AVIF: Conversion from YUV failed: Reformat failed (the matrix libavif does not convert)");
  if (mc == 0 && !pl.mono && (pl.ss_x || pl.ss_y))
    corrupt("AVIF: Conversion from YUV failed: Reformat failed (identity with subsampled chroma)");
  if (mc == 8 && !full) corrupt("AVIF: Conversion from YUV failed: Reformat failed (limited-range YCgCo)");
  if (!pl.mono) {
    const LibyuvConstants* c = nullptr;
    int m = mc;
    if (m == 12) m = (cp == 1 || cp == 2) ? 1 : (cp == 5 || cp == 6) ? 6 : cp == 9 ? 9 : -1;
    switch (m) {
      case 1: c = full ? &kF709 : &kH709; break;
      case 2: case 5: case 6: c = full ? &kJpeg : &kI601; break;
      case 9: c = full ? &kV2020 : &k2020; break;
      default: break;
    }
    if (c) {
      libyuv_route(pl, *c, out, channels);
      return;
    }
  }
  libavif_route(pl, mc, cp, full, out, channels);
}

// avifRGBImageUnpremultiplyAlpha of 8-bit RGBA: libyuv's ARGBUnattenuate
// (its 16-bit reciprocals fixed_invtbl8, the channel widened to 16 bits,
// the product in 32-bit int), opaque pixels kept
void unpremultiply(uint8_t* px, size_t n) {
  for (size_t k = 0; k < n; k++) {
    uint8_t* p = px + k * 4;
    const int a = p[3];
    if (a == 255) continue;
    const uint32_t ia = a == 0 ? 0u : a == 1 ? 0xFFFFu : 0x10000u / static_cast<uint32_t>(a);
    for (int i = 0; i < 3; i++) {
      const int32_t v = static_cast<int32_t>((static_cast<uint32_t>(p[i]) * 257u) * ia) >> 16;
      p[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

Planes planes_of(const Frame& f) {
  Planes pl;
  for (int i = 0; i < 3; i++) {
    pl.p[i] = f.plane[i].empty() ? nullptr : f.plane[i].data();
    pl.stride[i] = f.stride[i];
  }
  pl.w = f.width;
  pl.h = f.height;
  pl.mono = f.color.mono;
  pl.ss_x = f.color.ss_x;
  pl.ss_y = f.color.ss_y;
  return pl;
}

void decode_avif(const uint8_t* color, int64_t nc, const uint8_t* alpha, int64_t na, uint8_t* out,
                 int height, int width, int channels, int mc, int cp, int full, int prem) {
  Frame f;
  av1::decode(color, nc, f);
  // libavif gives the image its ispe size: the frame's top-left part
  // where the frame is larger (where it is smaller libavif reads past
  // dav1d's picture, memory the codec never wrote, which no decoder can
  // repeat)
  if (f.width < width || f.height < height)
    refuse("AVIF: an AV1 frame smaller than the image's ispe size (libavif reads past "
           "the decoded picture), which the port does not read");
  if (mc < 0) {  // no colr nclx box: the sequence header's colour config
    mc = f.color.matrix;
    cp = f.color.primaries;
    full = f.color.full_range;
  }
  Planes pl = planes_of(f);
  pl.w = width;
  pl.h = height;
  yuv_to_rgb(pl, mc, cp, full, out, channels);
  if (channels == 4) {
    const size_t n = size_t(width) * height;
    if (alpha) {
      Frame a;
      av1::decode(alpha, na, a);
      if (a.width < width || a.height < height)
        refuse("AVIF: an alpha item's AV1 frame smaller than the image's ispe size (libavif "
               "reads past the decoded picture), which the port does not read");
      for (int y = 0; y < height; y++)
        for (int x = 0; x < width; x++) {
          int v = a.plane[0][size_t(y) * a.stride[0] + x];
          if (!a.color.full_range) v = ((v - 16) * 255 + 109) / 219;  // avifLimitedToFullY
          out[(size_t(y) * width + x) * 4 + 3] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
        }
      if (prem) unpremultiply(out, n);
    } else {
      for (size_t k = 0; k < n; k++) out[k * 4 + 3] = 255;
    }
  }
}

}  // namespace
}  // namespace mrt

extern "C" {

// The whole decode into out [height, width, channels]: the colour item's
// AV1 data, the alpha item's (na 0: none), the CICP matrix and primaries
// and the range of the image's colr nclx box (matrix -1: none, the
// sequence header's colour config then), whether the alpha is
// premultiplied. Returns 0, or an error code and message (1: a corrupt
// file, 2: a mode not read).
int mrt_avif_decode(const uint8_t* color, int64_t nc, const uint8_t* alpha, int64_t na,
                    uint8_t* out, int32_t height, int32_t width, int32_t channels, int32_t matrix,
                    int32_t primaries, int32_t full_range, int32_t premultiplied, char* msg,
                    int32_t msg_len) {
  return mrt::guarded("AVIF", msg, msg_len, [&] {
    mrt::decode_avif(color, nc, na ? alpha : nullptr, na, out, height, width, channels, matrix,
                     primaries, full_range, premultiplied);
  });
}

// The AV1 frame's planes (tests): info [width, height, chroma width,
// chroma height, mono, ss_x, ss_y, full range, primaries, transfer,
// matrix]; planes copied into y, u, v where given.
int mrt_av1_planes(const uint8_t* data, int64_t n, int32_t* info, uint8_t* y, uint8_t* u,
                   uint8_t* v, char* msg, int32_t msg_len) {
  return mrt::guarded("AVIF", msg, msg_len, [&] {
    mrt::av1::Frame f;
    if (y) mrt::av1::decode(data, n, f);
    else mrt::av1::probe(data, n, f);
    const auto& c = f.color;
    const int32_t cw = c.mono ? 0 : (f.width + c.ss_x) >> c.ss_x;
    const int32_t ch = c.mono ? 0 : (f.height + c.ss_y) >> c.ss_y;
    const int32_t values[11] = {f.width, f.height, cw, ch, c.mono, c.ss_x, c.ss_y,
                                c.full_range, c.primaries, c.transfer, c.matrix};
    std::memcpy(info, values, sizeof(values));
    uint8_t* dst[3] = {y, u, v};
    for (int p = 0; p < 3; p++)
      if (dst[p] && !f.plane[p].empty()) std::memcpy(dst[p], f.plane[p].data(), f.plane[p].size());
  });
}

// avifImageYUVToRGB of given 8-bit planes (tests): the chroma planes at
// the subsampling given (mono: Y only), into out [h, w, channels].
int mrt_avif_yuv_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int32_t w, int32_t h,
                        int32_t ss_x, int32_t ss_y, int32_t mono, int32_t matrix, int32_t primaries,
                        int32_t full_range, uint8_t* out, int32_t channels, char* msg,
                        int32_t msg_len) {
  return mrt::guarded("AVIF", msg, msg_len, [&] {
    mrt::Planes pl;
    pl.p[0] = y;
    pl.p[1] = u;
    pl.p[2] = v;
    pl.stride[0] = w;
    pl.stride[1] = pl.stride[2] = (w + ss_x) >> ss_x;
    pl.w = w;
    pl.h = h;
    pl.ss_x = ss_x;
    pl.ss_y = ss_y;
    pl.mono = mono;
    mrt::yuv_to_rgb(pl, matrix, primaries, full_range, out, channels);
  });
}

}  // extern "C"
