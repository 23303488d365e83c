// Fused mask paste + threshold + validity + bit-pack, for sm_90a.
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
// row with zero padding bits.
//
// What bounds it on the H100: writes. At B=8 on the 1024^2 canvas the
// output is 400 x 1024 x 128 B = 52 MB, about 16 us at 3.35 TB/s; the
// arithmetic is a handful of flops a pixel. The plain version's bmm
// canvas is float32, 32x the packed bytes, read back for the pack.
//
// Design: one CTA per (detection, block of 16 rows); each thread makes one
// output byte (8 pixels), neighbouring threads neighbouring bytes, so the
// stores of a row are coalesced. q (m x m float32) sits in shared memory.
// The operators are one-hot, so a blend is two products: only the two
// taps of each axis are read, in the operator's order, and the build's
// -fmad=false keeps every product rounded as in the plain version. Rows
// and columns outside the box, and invalid detections, are written as
// zeros. Any H and W (the Pallas kernel needs W % 128 == 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;

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

// rows[y, j] or full[y, x]: the one-hot blend of two taps of `v`.
__device__ __forceinline__ float blend(const Taps& t, float v0, float v1) {
  if (t.i0 == t.i1) return v0;
  return t.w0 * v0 + t.w1 * v1;
}

__global__ void __launch_bounds__(kThreads)
paste_pack_kernel(const float* __restrict__ masks, const float* __restrict__ boxes,
                  const bool* __restrict__ valid, uint8_t* __restrict__ out, int m,
                  int height, int width, int wbytes) {
  extern __shared__ float q[];
  const int n = blockIdx.x;
  const int y_begin = blockIdx.y * kRows;
  const int y_end = min(y_begin + kRows, height);
  uint8_t* out_n = out + static_cast<size_t>(n) * height * wbytes;
  const bool keep = valid[n];

  const float* mask = masks + static_cast<size_t>(n) * m * m;
  for (int i = threadIdx.x; i < m * m; i += kThreads)
    q[i] = floorf(fminf(fmaxf(mask[i] * 255.0f, 0.0f), 255.0f));
  __syncthreads();

  const float y1 = boxes[n * 4 + 0];
  const float x1 = boxes[n * 4 + 1];
  const float bh = fmaxf(boxes[n * 4 + 2] - y1, 1.0f);
  const float bw = fmaxf(boxes[n * 4 + 3] - x1, 1.0f);
  const float ry = static_cast<float>(m) / bh;
  const float rx = static_cast<float>(m) / bw;

  const int count = (y_end - y_begin) * wbytes;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int y = y_begin + i / wbytes;
    const int byte = i % wbytes;
    uint32_t bits = 0;
    const Taps ty = axis_taps(static_cast<float>(y), y1, bh, ry, m);
    if (keep && ty.inside) {
      const float* q0 = q + ty.i0 * m;
      const float* q1 = q + ty.i1 * m;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int x = byte * 8 + k;
        if (x >= width) break;
        const Taps tx = axis_taps(static_cast<float>(x), x1, bw, rx, m);
        if (!tx.inside) continue;
        const float r0 = blend(ty, q0[tx.i0], q1[tx.i0]);
        const float r1 = blend(ty, q0[tx.i1], q1[tx.i1]);
        if (blend(tx, r0, r1) > 127.5f) bits |= 0x80u >> k;
      }
    }
    out_n[static_cast<size_t>(y) * wbytes + byte] = static_cast<uint8_t>(bits);
  }
}

}  // namespace

extern "C" {

// masks [N, m, m] float32, boxes [N, 4] float32 (y1, x1, y2, x2 integral
// pixels), valid [N] bool, out [N, height, ceil(width/8)] uint8; all
// device pointers. Returns the CUDA error of the launch (0 on success).
int mrt_paste_pack(const float* masks, const float* boxes, const bool* valid,
                   uint8_t* out, int n, int m, int height, int width,
                   void* stream) {
  if (n == 0) return 0;
  const int wbytes = (width + 7) / 8;
  const dim3 grid(n, (height + kRows - 1) / kRows);
  paste_pack_kernel<<<grid, kThreads, m * m * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      masks, boxes, valid, out, m, height, width, wbytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
