// Greedy NMS keep mask over score-sorted boxes, batched over images, for
// sm_90a.
//
// Replaces the Pallas TPU kernel maskrcnn_tpu/ops/nms_pallas.py:35
// `_nms_kernel` (entry point nms_mask_pallas). Semantics of
// maskrcnn_tpu/ops/nms.py nms_mask: the +1 pixel-area IoU, suppression at
// iou >= thr, invalid rows neither survive nor suppress.
//
// What bounds it on the H100: the greedy order. Which box survives
// depends on every earlier decision, a chain of N steps; the IoU work
// (N^2/2 pairs, 250 KB of bits at N=500) is small and parallel.
//
// Design, in two launches on the caller's stream and with no copy to the
// host (the reference's nms_cuda.cu:107-131 copied its bitmask to the
// host for the scan, a sync per call):
//  1. nms_mask_kernel, grid (column block, row block, image), 64 threads:
//     each thread owns one row and builds a 64-bit word of the later
//     columns in the block that the row suppresses. The IoU follows the
//     op order of _iou_plus_one and the build passes -fmad=false, so the
//     plain PyTorch version computes the same IoU bits.
//  2. nms_scan_kernel, one CTA per image: the image's bitmask is staged
//     in shared memory, then one warp walks the rows in order, keeping
//     the removed-words bitmap (ceil(N/64) words, 8 at N=500) in shared
//     memory, so the sequential chain runs at shared-memory latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr int kScanThreads = 256;
constexpr int kMaxWords = 32;  // one warp lane per removed word

__device__ __forceinline__ bool suppresses(const float* a, const float* b, float thr) {
  // op order of maskrcnn_tpu.ops.nms._iou_plus_one with a the earlier row
  const float area_a = (a[3] - a[1] + 1.0f) * (a[2] - a[0] + 1.0f);
  const float area_b = (b[3] - b[1] + 1.0f) * (b[2] - b[0] + 1.0f);
  const float yy1 = fmaxf(a[0], b[0]);
  const float xx1 = fmaxf(a[1], b[1]);
  const float yy2 = fminf(a[2], b[2]);
  const float xx2 = fminf(a[3], b[3]);
  const float w = fmaxf(xx2 - xx1 + 1.0f, 0.0f);
  const float h = fmaxf(yy2 - yy1 + 1.0f, 0.0f);
  const float inter = w * h;
  const float uni = area_a + area_b - inter;
  return inter / uni >= thr;
}

__global__ void __launch_bounds__(kBlock)
nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                int n, float thr, unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  const int img = blockIdx.z;
  const int words = gridDim.x;
  const int row_start = row_block * kBlock;
  const int col_start = col_block * kBlock;
  const int rows = min(n - row_start, kBlock);
  const int cols = min(n - col_start, kBlock);
  const float* img_boxes = boxes + static_cast<size_t>(img) * n * 4;

  __shared__ float col_boxes[kBlock * 4];
  if (threadIdx.x < cols) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      col_boxes[threadIdx.x * 4 + k] = img_boxes[(col_start + threadIdx.x) * 4 + k];
  }
  __syncthreads();
  if (threadIdx.x >= rows) return;

  const int i = row_start + threadIdx.x;
  unsigned long long bits = 0;
  // only later columns, and only from valid rows
  if (col_block >= row_block && valid[static_cast<size_t>(img) * n + i]) {
    float row[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) row[k] = img_boxes[i * 4 + k];
    const int first = (col_block == row_block) ? threadIdx.x + 1 : 0;
    for (int j = first; j < cols; ++j)
      if (suppresses(row, &col_boxes[j * 4], thr)) bits |= 1ull << j;
  }
  mask[(static_cast<size_t>(img) * n + i) * words + col_block] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const uint8_t* __restrict__ valid, int n, int words,
                uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* rows = smem;                                // [n, words]
  __shared__ unsigned long long removed[kMaxWords];
  const int img = blockIdx.x;
  const unsigned long long* img_mask = mask + static_cast<size_t>(img) * n * words;
  for (int k = threadIdx.x; k < n * words; k += blockDim.x) rows[k] = img_mask[k];
  if (threadIdx.x < words) removed[threadIdx.x] = 0ull;
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const uint8_t* img_valid = valid + static_cast<size_t>(img) * n;
  uint8_t* img_keep = keep + static_cast<size_t>(img) * n;
  for (int i = 0; i < n; ++i) {
    const int w = i >> 6;
    const bool alive = img_valid[i] && !((removed[w] >> (i & 63)) & 1ull);
    __syncwarp();  // every lane has read removed[w] before it changes
    if (alive && lane >= w && lane < words) removed[lane] |= rows[i * words + lane];
    if (lane == 0) img_keep[i] = alive ? 1 : 0;
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// boxes [B, N, 4] float32, valid [B, N] bool (one byte), mask scratch
// [B, N, ceil(N/64)] 64-bit words, keep [B, N] bool; all device pointers.
// Returns the first CUDA error of the two launches (0 on success).
int mrt_nms(const float* boxes, const uint8_t* valid, int batch, int n, float thr,
            unsigned long long* mask, uint8_t* keep, void* stream) {
  const int words = (n + kBlock - 1) / kBlock;
  if (words > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(boxes, valid, n, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n) * words * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<batch, kScanThreads, smem, s>>>(mask, valid, n, words, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
