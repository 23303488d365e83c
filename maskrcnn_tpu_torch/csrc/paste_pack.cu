// Fused mask paste + threshold + validity + bit-pack, for sm_90a,
// version 2.
//
// Replaces the Pallas TPU kernel benchmarks/gates/paste_pack_kernel.py:60
// `_kernel` (entry point paste_masks_packed_pallas). Semantics are those of
// the port's plain version, ops/mask_paste.paste_masks_packed_plain:
// q = floor(clamp(mask * 255, 0, 255)) (the reference's uint8
// convert('L')), the one-hot bilinear operators of `_interp_operator`
// (size clamped to >= 1, ratio m / size as a true division, half-pixel
// centres, clamp to [0, m-1], i1 = min(i0 + 1, m - 1), zero outside
// [start, start + size)), rows blended first, then columns, `> 127.5`,
// AND valid, packed MSB-first (np.unpackbits order), ceil(W/8) bytes a
// row with zero padding bits. Any H and W.
//
// What bounds it on the H100: writes. At B=8 on the 1024^2 canvas the
// output is 400 x 1024 x 128 B = 52 MB, about 16 us at 3.35 TB/s; the
// arithmetic is a handful of flops for each pixel inside a box.
//
// Version 1 ran one CTA per (detection, 16 rows), 25,600 CTAs at N=400:
// each reloaded and requantised the whole 28x28 float mask (3.1 KB) to
// write 2 KB, every thread stored one byte (32 B a warp store), and rows
// and bytes outside the box went through the full per-pixel path. It
// reached 8% of its bound.
//
// Version 2: one CTA per (detection, band of kRows rows), 6,400 CTAs at
// N=400 on 1024^2. A band of the packed output is one contiguous byte
// range of the detection's plane, written in 16-byte chunks, neighbouring
// threads on neighbouring chunks, each with one 16-byte store (bytes one
// by one only in the band's first and last chunk when the range is not
// 16-byte aligned: a ragged width makes the row pitch and the plane offset
// any number of bytes).
// * An invalid detection, or a band that misses the box's rows, writes its
//   range as zeros and reads nothing else: the CUDA form of the Pallas
//   kernel's tile skip.
// * Otherwise the CTA stages q once for the band, blends the band's rows
//   of q with their y taps (rows[y][j], the plain version's wy @ q; kept
//   as (j, j+1) pairs, both x taps of a pixel in one 8-byte load), and
//   computes the x taps (i0 or outside, frac) once per column of the bytes
//   that cover the box, stored [bit][byte] so that neighbouring threads
//   read neighbouring words. It makes the box's bytes in the rows inside
//   the box, a byte (8 pixels) a thread, branch-free, into the band's bytes
//   in shared memory (zero elsewhere), laid out so that each output chunk
//   is an aligned 16-byte word there, and then stores the band.
// The operators are one-hot, so a blend is two products: only the two taps
// of each axis are read, in the operator's order, and the build's
// -fmad=false keeps every product rounded as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;
// mask values a thread loads ahead (28x28 masks: all of them)
constexpr int kMaskLoads = 4;

// One axis of _interp_operator at output coordinate `pos`: the two taps,
// their weights, and whether pos lies inside [start, start + size).
struct Taps {
  int i0, i1;
  float w0, w1;
  bool inside;
};

__device__ __forceinline__ Taps axis_taps(float pos, float start, float size,
                                          float ratio, int m) {
  Taps t;
  t.inside = pos >= start && pos < start + size;
  float mp = (pos - start + 0.5f) * ratio - 0.5f;
  mp = fminf(fmaxf(mp, 0.0f), static_cast<float>(m - 1));
  const float f0 = floorf(mp);
  const float frac = mp - f0;
  t.i0 = static_cast<int>(f0);
  t.i1 = min(t.i0 + 1, m - 1);
  // the operator row: (tap == i0) * (1 - frac) + (tap == i1) * frac; at
  // the last tap i0 == i1 and frac == 0, so the weight is exactly 1
  t.w0 = 1.0f - frac;
  t.w1 = frac;
  return t;
}

// rows[y, j] or full[y, x]: the one-hot blend of two taps.
__device__ __forceinline__ float blend(int i0, int i1, float w0, float w1, float v0,
                                       float v1) {
  if (i0 == i1) return v0;
  return w0 * v0 + w1 * v1;
}

__global__ void __launch_bounds__(kThreads)
paste_pack_kernel(const float* __restrict__ masks, const float* __restrict__ boxes,
                  const bool* __restrict__ valid, uint8_t* __restrict__ out, int m,
                  int height, int width, int wbytes, int bands) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool row_in[kRows];
  const int n = blockIdx.x / bands;
  const int y_begin = (blockIdx.x - n * bands) * kRows;
  const int y_end = min(y_begin + kRows, height);
  const size_t plane = static_cast<size_t>(n) * height * wbytes;
  const size_t begin = plane + static_cast<size_t>(y_begin) * wbytes;
  const size_t end = plane + static_cast<size_t>(y_end) * wbytes;

  const float y1 = boxes[n * 4 + 0];
  const float x1 = boxes[n * 4 + 1];
  const float bh = fmaxf(boxes[n * 4 + 2] - y1, 1.0f);
  const float bw = fmaxf(boxes[n * 4 + 3] - x1, 1.0f);
  // rows and columns that may lie inside [start, start + size): a superset
  // (NaN widens it to the canvas); the exact test is axis_taps'
  const int row_lo = static_cast<int>(fmaxf(floorf(y1), 0.0f));
  const int row_hi = static_cast<int>(fminf(ceilf(y1 + bh), static_cast<float>(height - 1)));
  const int col_lo = static_cast<int>(fmaxf(floorf(x1), 0.0f));
  const int col_hi = static_cast<int>(fminf(ceilf(x1 + bw), static_cast<float>(width - 1)));
  const bool zero = !valid[n] || row_lo > y_end - 1 || row_hi < y_begin ||
                    row_lo > row_hi || col_lo > col_hi;

  const size_t first = begin / 16, last = (end - 1) / 16;
  if (zero) {
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (size_t c = first + threadIdx.x; c <= last; c += kThreads) {
      const size_t lo = c * 16, hi = lo + 16;
      if (lo >= begin && hi <= end) {
        *reinterpret_cast<uint4*>(out + lo) = z;
      } else {
        for (size_t o = lo < begin ? begin : lo; o < (hi < end ? hi : end); ++o) out[o] = 0;
      }
    }
    return;
  }

  // the bytes that cover the box's columns: their columns' x taps, stored
  // [bit k][byte], so that neighbouring threads (neighbouring bytes) read
  // neighbouring words; the band's rows of q blended with their y taps, as
  // (rows[y][j], rows[y][j + 1]) pairs, one 8-byte load for both taps of a
  // pixel; and the band's packed bytes, staged so that 16-byte chunks of the
  // output are 16-byte aligned words here too
  const int byte_lo = col_lo / 8;
  const int nbytes = col_hi / 8 - byte_lo + 1;
  const int nrows = y_end - y_begin;
  const int shift = static_cast<int>(begin - first * 16);
  float2* pairs = reinterpret_cast<float2*>(smem);        // [kRows, m]
  float2* taps = pairs + kRows * m;                       // [8, nbytes]: (i0 or -1, frac)
  float* q = reinterpret_cast<float*>(taps + 8 * wbytes);  // [m, m]
  uint4* staged = reinterpret_cast<uint4*>(q + ((m * m + 3) & ~3));
  uint8_t* packed = reinterpret_cast<uint8_t*>(staged) + shift;
  const float ry = static_cast<float>(m) / bh;
  const float rx = static_cast<float>(m) / bw;

  // the mask's first kThreads * kMaskLoads values are loaded before the x
  // taps are computed, so that their latency (the mask is usually read
  // from device memory here, behind the writes of every CTA) overlaps the
  // taps' arithmetic
  const float* mask = masks + static_cast<size_t>(n) * m * m;
  float head[kMaskLoads];
#pragma unroll
  for (int k = 0; k < kMaskLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    head[k] = i < m * m ? __ldg(mask + i) : 0.0f;
  }
  for (int e = threadIdx.x; e < 8 * nbytes; e += kThreads) {
    const int k = e / nbytes;
    const int x = (byte_lo + e - k * nbytes) * 8 + k;
    const Taps tx = axis_taps(static_cast<float>(x), x1, bw, rx, m);
    // w0 = 1 - frac, w1 = frac: the same floats as axis_taps', from frac
    taps[e] = make_float2(__int_as_float(tx.inside && x < width ? tx.i0 : -1), tx.w1);
  }
  const int words = (shift + nrows * wbytes + 15) / 16;
  for (int i = threadIdx.x; i < words; i += kThreads) staged[i] = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < kMaskLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < m * m) q[i] = floorf(fminf(fmaxf(head[k] * 255.0f, 0.0f), 255.0f));
  }
  for (int i = threadIdx.x + kMaskLoads * kThreads; i < m * m; i += kThreads)
    q[i] = floorf(fminf(fmaxf(mask[i] * 255.0f, 0.0f), 255.0f));
  __syncthreads();
  // only the band's rows that may lie inside the box
  const int r_first = max(row_lo, y_begin) - y_begin;
  const int r_count = min(row_hi, y_end - 1) - y_begin - r_first + 1;
  for (int e = threadIdx.x; e < r_count * m; e += kThreads) {
    const int r = r_first + e / m;
    const int j = e - (r - r_first) * m;
    const int j1 = min(j + 1, m - 1);
    const Taps ty = axis_taps(static_cast<float>(y_begin + r), y1, bh, ry, m);
    pairs[r * m + j] = make_float2(
        blend(ty.i0, ty.i1, ty.w0, ty.w1, q[ty.i0 * m + j], q[ty.i1 * m + j]),
        blend(ty.i0, ty.i1, ty.w0, ty.w1, q[ty.i0 * m + j1], q[ty.i1 * m + j1]));
    if (j == 0) row_in[r] = ty.inside;
  }
  __syncthreads();

  // the box's bytes in those rows, a byte a thread: item e is (row, byte) =
  // divmod(e, nbytes), stepped without a division. A pixel is blend(i0,
  // i1 = min(i0 + 1, m - 1)) of its row's pair at i0; the taps of all 8
  // pixels are loaded first, with no branch, and a pixel outside the box
  // (i0 = -1) is masked at the end.
  const int items = r_count * nbytes;
  const int dr = kThreads / nbytes, db = kThreads - dr * nbytes;
  int r = r_first + threadIdx.x / nbytes;
  int bb = threadIdx.x % nbytes;
  for (int e = threadIdx.x; e < items; e += kThreads) {
    if (row_in[r]) {
      const float2* row = pairs + r * m;
      float2 t[8], v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = taps[k * nbytes + bb];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = row[max(__float_as_int(t[k].x), 0)];
      uint32_t bits = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i0 = __float_as_int(t[k].x);
        const int i = max(i0, 0);
        const float val = blend(i, min(i + 1, m - 1), 1.0f - t[k].y, t[k].y, v[k].x, v[k].y);
        if (i0 >= 0 && val > 127.5f) bits |= 0x80u >> k;
      }
      packed[r * wbytes + byte_lo + bb] = static_cast<uint8_t>(bits);
    }
    bb += db;
    r += dr;
    if (bb >= nbytes) {
      bb -= nbytes;
      ++r;
    }
  }
  __syncthreads();

  for (size_t c = first + threadIdx.x; c <= last; c += kThreads) {
    const size_t lo = c * 16, hi = lo + 16;
    if (lo >= begin && hi <= end) {
      *reinterpret_cast<uint4*>(out + lo) = staged[c - first];
    } else {
      for (size_t o = lo < begin ? begin : lo; o < (hi < end ? hi : end); ++o)
        out[o] = packed[o - begin];
    }
  }
}

}  // namespace

extern "C" {

// masks [N, m, m] float32, boxes [N, 4] float32 (y1, x1, y2, x2 pixels),
// valid [N] bool, out [N, height, ceil(width/8)] uint8, 16-byte aligned;
// all device pointers. Returns the CUDA error of the launch (0 on
// success).
int mrt_paste_pack(const float* masks, const float* boxes, const bool* valid,
                   uint8_t* out, int n, int m, int height, int width,
                   void* stream) {
  if (n == 0) return 0;
  const int wbytes = (width + 7) / 8;
  const int bands = (height + kRows - 1) / kRows;
  // the band's row pairs, the [8, W/8] x taps, q (padded to 16 bytes), and
  // the band's bytes with up to 16 bytes of shift
  const size_t smem = sizeof(float2) * (static_cast<size_t>(kRows) * m + 8 * wbytes) +
                      sizeof(float) * ((static_cast<size_t>(m) * m + 3) & ~3ull) +
                      ((static_cast<size_t>(kRows) * wbytes + 31) & ~15ull);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paste_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paste_pack_kernel<<<static_cast<unsigned>(n) * bands, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      masks, boxes, valid, out, m, height, width, wbytes, bands);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
