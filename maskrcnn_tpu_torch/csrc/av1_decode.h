// What the AVIF library's sources share: the decoded AV1 frame
// (av1_decode.cpp) that avif_decode.cpp converts to RGB.

#pragma once

#include <cstdint>
#include <vector>

#include "image_codec.h"

namespace mrt {
namespace av1 {

// The colour configuration of an AV1 sequence header (spec 5.5.2).
struct ColorConfig {
  int bit_depth = 8;
  int mono = 0;
  int ss_x = 1, ss_y = 1;
  int primaries = 2, transfer = 2, matrix = 2;  // 2: unspecified
  int full_range = 0;
  int chroma_sample_position = 0;
};

// A decoded frame: the planes cropped to the frame's size, 8-bit samples.
struct Frame {
  int width = 0, height = 0;
  ColorConfig color;
  std::vector<uint8_t> plane[3];  // Y, then U and V (empty for 4:0:0)
  int stride[3] = {0, 0, 0};
  int plane_w[3] = {0, 0, 0}, plane_h[3] = {0, 0, 0};
};

// The size and colour configuration of the first frame of the OBUs in
// data[0, n) (its sequence and frame headers), without decoding it.
void probe(const uint8_t* data, int64_t n, Frame& out);

// Decodes the first shown frame of the OBUs in data[0, n) (a key frame
// or an intra-only frame with its sequence header before it).
void decode(const uint8_t* data, int64_t n, Frame& out);

}  // namespace av1
}  // namespace mrt
