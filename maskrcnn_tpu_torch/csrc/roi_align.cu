// Multilevel RoIAlign forward (tf.crop_and_resize semantics) for sm_90a,
// version 2: the coordinate prologue runs inside the kernel.
//
// Replaces the Pallas TPU kernel maskrcnn_tpu/ops/roi_align_pallas.py:58
// `_kernel` (entry point batched_multilevel_roi_align_pallas). The
// semantics are maskrcnn_tpu/ops/roi_align.py `_crop_core`: one bilinear
// sample per output cell, the 2x2 footprint clamped as there, samples
// outside the level zeroed. The plain PyTorch version is
// ops/roi_align.multilevel_roi_align: its prologue (roi_levels,
// sample_points) and its blend (roi_align_levels).
//
// Inputs. The four pyramid levels P2..P5 as separate NHWC tensors
// [B, H_l, W_l, C] (float32, bfloat16, or int8 with four level scales),
// each read where it lies, and the boxes [B*N, 4] float32 normalized
// (y1, x1, y2, x2), image-major.
//
// What bounds it on the H100: bytes. Each distinct table row that a
// sample reads, read once, the output written once, the boxes (16 B
// each); 7 flops a channel. At B=8, N=500, P=7, C=256 in bf16 that is
// about 63 us at 3.35 TB/s, two thirds of it the output.
//
// Version 1 took the level and the sample coordinates from about a dozen
// small PyTorch ops (0.34 ms a call, more than the kernel), ran one CTA
// per (box, pool row) with one work item a thread (at P=7 12.5% of the
// threads idle, in int8 mode 56%), and each thread walked a chain of
// dependent loads (level, then y, then x, then its four taps), so it had
// four loads in flight. It reached 25% of its bound.
//
// Version 2:
// * The prologue is fused in. A CTA takes one box, or a band of a box's
//   pool rows when P is large (P=14: four bands, so 400 boxes still give
//   1,600 CTAs for 132 SMs). Its first threads compute the box's level
//   (4 + log2(sqrt(h*w) / divisor), rounded half to even, clamped to
//   [2, 5]) and, per output cell of the band, the sample coordinates
//   (y1*(H-1)) + r*(((y2-y1)*(H-1)) / (P-1)), the clamped taps, the
//   offsets of the 2x2 footprint and its four weights, into shared memory.
//   The divisor and P-1 are float arguments: division by them is an IEEE
//   division, as PyTorch's division by a tensor, and the build's
//   -fmad=false keeps every product and sum rounded as PyTorch's separate
//   elementwise ops round them; log2f, sqrtf and rintf are the functions
//   PyTorch's CUDA ops use. So the kernel computes the plain version's
//   bits.
// * All threads of the CTA stream (cell, 16-byte channel vector) items of
//   the band, neighbouring threads on neighbouring vectors (C=256 bf16: a
//   warp a cell), each thread kUnroll items at a time: 4 * kUnroll
//   independent 16-byte loads in flight, issued before any is used.
// * The output of a band is contiguous, and item i writes its vector at
//   i * V, so a warp's stores are contiguous 16-byte stores.
// The blend runs in float32, in the order
// ((p00*w00 + p01*w01) + p10*w10) + p11*w11 with w_yx = wy*wx, and rounds
// to the output type once. int8 tables (Config.QUANT_INT8_ROI; the Pallas
// kernel's `level_scales`) blend their int8 taps the same way and multiply
// by the level's scale (four host floats passed by value). Level sizes and
// C (a multiple of the 16-byte vector) are arbitrary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kThreads = 256;
constexpr int kUnroll = 2;
// a band holds at least this many cells where the box has them: P=7 is
// one band of 49 cells, P=14 four bands of 4 rows
constexpr int kBandCells = 64;

struct Levels {
  const void* ptr[kLevels];
  int height[kLevels];
  int width[kLevels];
  float scale[kLevels];  // dequantization scales of int8 levels
};

// 16-byte table vectors to float, and stores of an output type
template <typename T>
struct Vec;

template <>
struct Vec<int8_t> {
  static constexpr int kWidth = 16;
  __device__ static void convert(const uint4& r, float* v) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = static_cast<float>(b[i]);
  }
};

template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
  __device__ static void convert(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ static void convert(const uint4& r, float* v) {
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

// A table vector of V channels as V / kWidth stores of the output type.
template <typename TOut, int V>
__device__ __forceinline__ void store_all(TOut* p, const float* v) {
  constexpr int W = Vec<TOut>::kWidth;
  static_assert(V % W == 0, "table vector must be whole output stores");
#pragma unroll
  for (int j = 0; j < V; j += W) Vec<TOut>::store(p + j, v + j);
}

// Clamp rules of _crop_core for one axis (ops/roi_align._axis_taps): start
// index, weight of the start+1 tap, and whether the sample lies outside
// [0, extent_max].
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

// a[l] for a level index l, by selects: an indexed kernel parameter array
// would be copied to local memory
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kLevels], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// ops/roi_align.roi_levels: 0-based FPN level of a box. A NaN level (a box
// with a negative area) goes to P2, as PyTorch's float-to-int conversion of
// NaN on the card.
__device__ __forceinline__ int box_level(float y1, float x1, float y2, float x2,
                                         float divisor) {
  const float h = y2 - y1;
  const float w = x2 - x1;
  const float lvl = 4.0f + log2f(sqrtf(h * w) / divisor);
  return static_cast<int>(fminf(fmaxf(rintf(lvl), 2.0f), 5.0f) - 2.0f);
}

// One output cell of a band: the element offset of its top-left tap in the
// image's level (-1 when the sample lies outside the level, and the cell is
// zero), the steps to the x+1 and y+1 taps, and the four weights.
struct __align__(16) Cell {
  int off, dx, dy, pad;
  float w00, w01, w10, w11;
};

// CTAs an SM holds: 4 (64 registers a thread) where an item writes at
// most 32 bytes; int8 tables to float32 (64 bytes an item) need more
// registers, and 3 CTAs.
template <typename TIn, typename TOut>
constexpr int min_blocks() {
  return Vec<TIn>::kWidth * sizeof(TOut) > 32 ? 3 : 4;
}

// TIn: the table type; TOut: the output type; kScaled: int8 tables,
// whose blend is multiplied by the level's scale.
template <typename TIn, typename TOut, bool kScaled>
__global__ void __launch_bounds__(kThreads, (min_blocks<TIn, TOut>()))
roi_align_kernel(Levels levels, const float* __restrict__ boxes, TOut* __restrict__ out,
                 float divisor, float pool_m1, int boxes_per_image, int pool,
                 int channels, int band_rows, int bands) {
  using T = TIn;
  constexpr int V = Vec<T>::kWidth;
  extern __shared__ Cell cells[];
  __shared__ int s_level;
  const int box = blockIdx.x / bands;
  const int row0 = (blockIdx.x - box * bands) * band_rows;
  const int ncells = min(band_rows, pool - row0) * pool;
  const int tid = threadIdx.x;

  // prologue: the level and the band's cells
  if (tid < ncells) {
    const float* b = boxes + 4 * static_cast<size_t>(box);
    const float y1 = b[0], x1 = b[1], y2 = b[2], x2 = b[3];
    const int lvl = box_level(y1, x1, y2, x2, divisor);
    if (tid == 0) s_level = lvl;
    const int height = pick(levels.height, lvl);
    const int width = pick(levels.width, lvl);
    const float h_max = static_cast<float>(height - 1);
    const float w_max = static_cast<float>(width - 1);
    const float hs = ((y2 - y1) * h_max) / pool_m1;
    const float ws = ((x2 - x1) * w_max) / pool_m1;
    const float y_base = y1 * h_max;
    const float x_base = x1 * w_max;
    for (int c = tid; c < ncells; c += kThreads) {
      const int r = row0 + c / pool;
      const int col = c - (c / pool) * pool;
      const Taps ty = axis_taps(y_base + static_cast<float>(r) * hs, h_max);
      const Taps tx = axis_taps(x_base + static_cast<float>(col) * ws, w_max);
      Cell e;
      if (ty.outside || tx.outside) {
        e.off = -1;
        e.dx = e.dy = 0;
        e.w00 = e.w01 = e.w10 = e.w11 = 0.0f;
      } else {
        const int y_next = min(ty.start + 1, height - 1);
        const int x_next = min(tx.start + 1, width - 1);
        e.off = (ty.start * width + tx.start) * channels;
        e.dx = (x_next - tx.start) * channels;
        e.dy = (y_next - ty.start) * width * channels;
        const float wy0 = 1.0f - ty.frac, wy1 = ty.frac;
        const float wx0 = 1.0f - tx.frac, wx1 = tx.frac;
        e.w00 = wy0 * wx0;
        e.w01 = wy0 * wx1;
        e.w10 = wy1 * wx0;
        e.w11 = wy1 * wx1;
      }
      e.pad = 0;
      cells[c] = e;
    }
  }
  __syncthreads();

  const int lvl = s_level;
  const int height = pick(levels.height, lvl);
  const int width = pick(levels.width, lvl);
  const int img = box / boxes_per_image;
  const T* base = static_cast<const T*>(pick(levels.ptr, lvl)) +
                  static_cast<size_t>(img) * height * width * channels;
  const float scale = pick(levels.scale, lvl);
  TOut* out_band = out + (static_cast<size_t>(box) * pool + row0) * pool * channels;

  // item i = (cell, vector) = divmod(i, vecs); thread tid takes items
  // tid, tid + kThreads, ..., stepping (cell, vector) by divmod(kThreads, vecs)
  const int vecs = channels / V;
  const int nitems = ncells * vecs;
  const int dc = kThreads / vecs;
  const int dv = kThreads - dc * vecs;
  int cell = tid / vecs;
  int vec = tid - cell * vecs;
  for (int i = tid; i < nitems; i += kUnroll * kThreads) {
    int item_cell[kUnroll], item_vec[kUnroll];
    uint4 raw[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      item_cell[u] = cell;
      item_vec[u] = vec;
      vec += dv;
      cell += dc;
      if (vec >= vecs) {
        vec -= vecs;
        ++cell;
      }
    }
    // every load first, then the blends
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = i + u * kThreads < nitems;
      const Cell e = cells[live ? item_cell[u] : 0];
      if (live && e.off >= 0) {
        const T* p00 = base + e.off + item_vec[u] * V;
        raw[u][0] = __ldg(reinterpret_cast<const uint4*>(p00));
        raw[u][1] = __ldg(reinterpret_cast<const uint4*>(p00 + e.dx));
        raw[u][2] = __ldg(reinterpret_cast<const uint4*>(p00 + e.dy));
        raw[u][3] = __ldg(reinterpret_cast<const uint4*>(p00 + e.dy + e.dx));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int item = i + u * kThreads;
      if (item >= nitems) break;
      const Cell e = cells[item_cell[u]];
      float res[V];
      if (e.off < 0) {
#pragma unroll
        for (int k = 0; k < V; ++k) res[k] = 0.0f;
      } else {
        float p[V];
        Vec<T>::convert(raw[u][0], p);
#pragma unroll
        for (int k = 0; k < V; ++k) res[k] = p[k] * e.w00;
        Vec<T>::convert(raw[u][1], p);
#pragma unroll
        for (int k = 0; k < V; ++k) res[k] = res[k] + p[k] * e.w01;
        Vec<T>::convert(raw[u][2], p);
#pragma unroll
        for (int k = 0; k < V; ++k) res[k] = res[k] + p[k] * e.w10;
        Vec<T>::convert(raw[u][3], p);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          res[k] = res[k] + p[k] * e.w11;
          if (kScaled) res[k] = res[k] * scale;
        }
      }
      store_all<TOut, V>(out_band + static_cast<size_t>(item) * V, res);
    }
  }
}

template <typename TIn, typename TOut, bool kScaled>
cudaError_t launch(const Levels& levels, const float* boxes, void* out, float divisor,
                   float pool_m1, int num_boxes, int boxes_per_image, int pool,
                   int channels, cudaStream_t s) {
  // bands of whole pool rows, at least kBandCells cells each where the box
  // has them, split evenly
  const int rows = min(pool, max(1, kBandCells / pool));
  const int bands = (pool + rows - 1) / rows;
  const int band_rows = (pool + bands - 1) / bands;
  const size_t smem = static_cast<size_t>(band_rows) * pool * sizeof(Cell);
  auto kernel = roi_align_kernel<TIn, TOut, kScaled>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(num_boxes) * bands, kThreads, smem, s>>>(
      levels, boxes, static_cast<TOut*>(out), divisor, pool_m1, boxes_per_image,
      pool, channels, band_rows, bands);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Types: 0 = float32, 1 = bfloat16, 2 = int8 (tables only). Float tables
// write their own type and take no scales; int8 tables write float32 or
// bfloat16 and take `scales`, a host array of kLevels floats. level_ptrs,
// heights, widths and scales are host arrays of kLevels entries; boxes
// ([num_boxes, 4] float32) and out ([num_boxes, pool, pool, channels]) are
// device pointers. divisor: 224 / sqrt(image area) as a float32; pool_m1:
// pool - 1. Returns the CUDA error of the launch (0 on success).
int mrt_roi_align(const void* const* level_ptrs, const int* heights,
                  const int* widths, const float* scales, const float* boxes,
                  void* out, int num_boxes, int boxes_per_image, int pool,
                  int channels, int in_dtype, int out_dtype, float divisor,
                  float pool_m1, void* stream) {
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
      (!int8_tables && in_dtype != out_dtype) || pool < 1 || num_boxes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_boxes == 0) return 0;
  cudaError_t err;
  if (in_dtype == 0 && out_dtype == 0) {
    err = launch<float, float, false>(levels, boxes, out, divisor, pool_m1,
                                      num_boxes, boxes_per_image, pool, channels, s);
  } else if (in_dtype == 1 && out_dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16, false>(
        levels, boxes, out, divisor, pool_m1, num_boxes, boxes_per_image, pool,
        channels, s);
  } else if (in_dtype == 2 && out_dtype == 0) {
    err = launch<int8_t, float, true>(levels, boxes, out, divisor, pool_m1,
                                      num_boxes, boxes_per_image, pool, channels, s);
  } else if (in_dtype == 2 && out_dtype == 1) {
    err = launch<int8_t, __nv_bfloat16, true>(levels, boxes, out, divisor, pool_m1,
                                              num_boxes, boxes_per_image, pool,
                                              channels, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
