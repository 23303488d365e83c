// Multilevel RoIAlign forward (tf.crop_and_resize semantics) for sm_90a.
//
// Replaces the Pallas TPU kernel maskrcnn_tpu/ops/roi_align_pallas.py:58
// `_kernel` (entry point batched_multilevel_roi_align_pallas). The
// semantics are maskrcnn_tpu/ops/roi_align.py `_crop_core`: one bilinear
// sample per output cell, the 2x2 footprint clamped as there, samples
// outside the level zeroed.
//
// Inputs. The four pyramid levels P2..P5 as separate NHWC tensors
// [B, H_l, W_l, C] (float32 or bfloat16). The Pallas kernel stacks them
// into one width-padded table only to give Mosaic one DMA source; here
// each level is read where it lies. Per box (B*N of them): the level
// index, and the sample coordinates in_y/in_x [P] computed by the port's
// plain roi_levels/sample_points, so the rounding-sensitive coordinate
// math exists once and both paths share it.
//
// What bounds it on the H100: memory traffic. Each output cell reads four
// C-vectors and writes one; arithmetic is 7 flops per channel. The
// footprints of neighbouring cells overlap, so most reads hit L2.
//
// Design: one CTA per (box, pool row). The row's y taps are the same for
// the whole CTA; threads walk (pool column, 16-byte channel vector) pairs,
// so a warp reads contiguous runs of a pixel's channels (C=256 bf16 is 32
// vectors, one per lane) and writes the output row contiguously. The
// blend runs in float32 and rounds to the output type once. The order of
// the blend is fixed, ((p00*w00 + p01*w01) + p10*w10) + p11*w11 with
// w_yx = wy*wx, and the build passes -fmad=false, so the plain PyTorch
// version (ops/roi_align.multilevel_roi_align) computes the same bits.
// Level sizes are arbitrary; nothing assumes the Pallas patch window.
//
// int8-table mode (Config.QUANT_INT8_ROI; the Pallas kernel's
// `level_scales`): the levels are int8 maps quantized with the RPN's
// per-level activation scales. A 16-byte load carries 16 channels, so the
// kernel reads half the bytes of the bf16 mode. The blend runs in the
// same order over float32 of the int8 taps, is multiplied by the box's
// level scale (four host floats passed by value in `Levels`: no device
// read, no sync), and rounds once to the output type (float32 or bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kThreads = 256;

struct Levels {
  const void* ptr[kLevels];
  int height[kLevels];
  int width[kLevels];
  float scale[kLevels];  // dequantization scales of int8 levels
};

// 16-byte loads of a table type to float, and stores of an output type
template <typename T>
struct Vec;

template <>
struct Vec<int8_t> {
  static constexpr int kWidth = 16;
  __device__ static void load(const int8_t* p, float* v) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = static_cast<float>(b[i]);
  }
};

template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

// Clamp rules of _crop_core for one axis: start index, weight of the
// start+1 tap, and whether the sample lies outside [0, extent-1].
struct Taps {
  int start;
  float frac;
  bool outside;
};

__device__ __forceinline__ Taps axis_taps(float coord, float extent_max) {
  Taps t;
  const float start = fminf(fmaxf(floorf(coord), 0.0f), fmaxf(extent_max - 1.0f, 0.0f));
  t.frac = fminf(fmaxf(coord, 0.0f), extent_max) - start;
  t.outside = (coord < 0.0f) || (coord > extent_max);
  t.start = static_cast<int>(start);
  return t;
}

// A table vector of V channels as V / kWidth stores of the output type.
template <typename TOut, int V>
__device__ __forceinline__ void store_all(TOut* p, const float* v) {
  constexpr int W = Vec<TOut>::kWidth;
  static_assert(V % W == 0, "table vector must be whole output stores");
#pragma unroll
  for (int j = 0; j < V; j += W) Vec<TOut>::store(p + j, v + j);
}

// TIn: the table type; TOut: the output type; kScaled: int8 tables,
// whose blend is multiplied by the level's scale.
template <typename TIn, typename TOut, bool kScaled>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Levels levels, const int32_t* __restrict__ box_level,
                 const float* __restrict__ in_y, const float* __restrict__ in_x,
                 TOut* __restrict__ out, int boxes_per_image, int pool, int channels) {
  using T = TIn;
  constexpr int V = Vec<T>::kWidth;
  const int box = blockIdx.x;
  const int py = blockIdx.y;
  // clamped so a bad level can never index past the four levels
  const int lvl = min(max(box_level[box], 0), kLevels - 1);
  const int img = box / boxes_per_image;
  const int height = levels.height[lvl];
  const int width = levels.width[lvl];
  const Taps ty = axis_taps(in_y[box * pool + py], static_cast<float>(height - 1));
  const int y1 = min(ty.start + 1, height - 1);
  const float wy0 = 1.0f - ty.frac;
  const float wy1 = ty.frac;

  const T* base = static_cast<const T*>(levels.ptr[lvl]) +
                  static_cast<size_t>(img) * height * width * channels;
  const T* row0 = base + static_cast<size_t>(ty.start) * width * channels;
  const T* row1 = base + static_cast<size_t>(y1) * width * channels;
  TOut* out_row = out + (static_cast<size_t>(box) * pool + py) * pool * channels;
  const float scale = levels.scale[lvl];

  const int vecs = channels / V;
  for (int i = threadIdx.x; i < pool * vecs; i += blockDim.x) {
    const int px = i / vecs;
    const int c = (i - px * vecs) * V;
    float res[V];
    const Taps tx = axis_taps(in_x[box * pool + px], static_cast<float>(width - 1));
    if (ty.outside || tx.outside) {
#pragma unroll
      for (int k = 0; k < V; ++k) res[k] = 0.0f;
    } else {
      const int x1 = min(tx.start + 1, width - 1);
      const float wx0 = 1.0f - tx.frac;
      const float wx1 = tx.frac;
      const float w00 = wy0 * wx0, w01 = wy0 * wx1;
      const float w10 = wy1 * wx0, w11 = wy1 * wx1;
      float p00[V], p01[V], p10[V], p11[V];
      Vec<T>::load(row0 + static_cast<size_t>(tx.start) * channels + c, p00);
      Vec<T>::load(row0 + static_cast<size_t>(x1) * channels + c, p01);
      Vec<T>::load(row1 + static_cast<size_t>(tx.start) * channels + c, p10);
      Vec<T>::load(row1 + static_cast<size_t>(x1) * channels + c, p11);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        res[k] = ((p00[k] * w00 + p01[k] * w01) + p10[k] * w10) + p11[k] * w11;
        if (kScaled) res[k] = res[k] * scale;
      }
    }
    store_all<TOut, V>(out_row + static_cast<size_t>(px) * channels + c, res);
  }
}

template <typename TIn, typename TOut, bool kScaled>
void launch(const Levels& levels, const int32_t* box_level, const float* in_y,
            const float* in_x, void* out, int num_boxes, int boxes_per_image,
            int pool, int channels, cudaStream_t s) {
  const dim3 grid(num_boxes, pool);
  roi_align_kernel<TIn, TOut, kScaled><<<grid, kThreads, 0, s>>>(
      levels, box_level, in_y, in_x, static_cast<TOut*>(out), boxes_per_image,
      pool, channels);
}

}  // namespace

extern "C" {

// Types: 0 = float32, 1 = bfloat16, 2 = int8 (tables only). Float tables
// write their own type and take no scales; int8 tables write float32 or
// bfloat16 and take `scales`, a host array of kLevels floats. Pointers are
// device pointers except level_ptrs/heights/widths/scales (host arrays of
// kLevels entries). Returns the CUDA error of the launch (0 on success).
int mrt_roi_align(const void* const* level_ptrs, const int* heights,
                  const int* widths, const float* scales,
                  const int32_t* box_level, const float* in_y, const float* in_x,
                  void* out, int num_boxes, int boxes_per_image, int pool,
                  int channels, int in_dtype, int out_dtype, void* stream) {
  Levels levels;
  for (int l = 0; l < kLevels; ++l) {
    levels.ptr[l] = level_ptrs[l];
    levels.height[l] = heights[l];
    levels.width[l] = widths[l];
    levels.scale[l] = scales ? scales[l] : 1.0f;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool int8_tables = in_dtype == 2;
  if (int8_tables != (scales != nullptr) ||
      (!int8_tables && in_dtype != out_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (in_dtype == 0 && out_dtype == 0) {
    launch<float, float, false>(levels, box_level, in_y, in_x, out, num_boxes,
                                boxes_per_image, pool, channels, s);
  } else if (in_dtype == 1 && out_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16, false>(
        levels, box_level, in_y, in_x, out, num_boxes, boxes_per_image, pool,
        channels, s);
  } else if (in_dtype == 2 && out_dtype == 0) {
    launch<int8_t, float, true>(levels, box_level, in_y, in_x, out, num_boxes,
                                boxes_per_image, pool, channels, s);
  } else if (in_dtype == 2 && out_dtype == 1) {
    launch<int8_t, __nv_bfloat16, true>(levels, box_level, in_y, in_x, out,
                                        num_boxes, boxes_per_image, pool,
                                        channels, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
