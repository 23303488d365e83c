// Grouped (K=4) RoIAlign compute skeleton, float32, for sm_90a.
//
// Replaces the Pallas TPU gate benchmarks/gates/group_roi_gate.py:29
// `kernel3d` and :65 `kernel` (one pallas_call, :106): a cost study on no
// serving path. For each group i of n, with dense weights built per group
//
//     Wy [28, 128]  0.25 at base, 0.75 at base+1,
//                   base = (r / 7) * 32 + (r % 7) * 2 + i % 3
//     Wx [28, 40]   0.5 at xb and xb+1, xb = (q % 7) * 2 + i % 5
//     T  = Wy @ P                    P = patches [128, 40, 256]
//     out[k, a, b, c] = sum_x Wx[7k+a, x] * T[7k+b, x, c]
//
// and the result is group n-1's (the gate overwrites its output every
// group). The gate's dense two-product form is kept on purpose: it is
// what the gate timed, so the one-hot structure of Wy and Wx is not
// exploited, and every group does 28 x 128 x 10240 + 4 x 49 x 40 x 256
// multiply-adds.
//
// What bounds it on the H100: operations. 77.5 MFLOP a group in float32
// on the CUDA cores (67 TFLOP/s) against 5.2 MB of patches read once;
// 2,500 groups take at least 2.9 ms, 0.29 us a box. It is a study, so the
// kernel is simple: CTAs walk the groups with a grid stride, thread t
// owns channels 2t and 2t+1 (one 8-byte load of patches feeds 14
// multiply-adds), the group's dense weights live in shared memory, the
// patches stream from L2 (5.2 MB stay resident), and each thread keeps
// its box's 7x7 sums for both channels in registers. Only the CTA that
// runs group n-1 stores its result; an empty asm on the sums keeps the
// other groups' work from being dropped as dead code.
//
// Products and sums are explicit fused multiply-adds (__fmaf_rn, which
// -fmad=false leaves alone): against exact weights 0.25, 0.75 and 0.5 a
// fused and an unfused sum differ by at most an ulp of the result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 4;
constexpr int kPool = 7;
constexpr int kPatch = 32;
constexpr int kPx = 40;
constexpr int kC = 256;
constexpr int kThreads = kC / 2;    // two channels a thread
constexpr int kRows = kK * kPatch;  // 128 patch rows
constexpr int kQ = kK * kPool;      // 28 output rows of a group
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_roi_kernel(const T* __restrict__ patches, float* __restrict__ out,
                 int n_groups) {
  __shared__ __align__(16) float wy[kQ][kRows];
  __shared__ float wx[kQ][kPx];
  const int c = 2 * threadIdx.x;
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    __syncthreads();  // the last group's readers are done with wy and wx
    for (int e = threadIdx.x; e < kQ * kRows; e += kThreads) {
      const int r = e / kRows;
      const int y = e - r * kRows;
      const int base = (r / kPool) * kPatch + (r % kPool) * 2 + g % 3;
      wy[r][y] = (y == base ? 0.25f : 0.0f) + (y == base + 1 ? 0.75f : 0.0f);
    }
    for (int e = threadIdx.x; e < kQ * kPx; e += kThreads) {
      const int q = e / kPx;
      const int x = e - q * kPx;
      const int xb = (q % kPool) * 2 + g % 5;
      wx[q][x] = (x == xb ? 0.5f : 0.0f) + (x == xb + 1 ? 0.5f : 0.0f);
    }
    __syncthreads();
    for (int k = 0; k < kK; ++k) {
      float acc[2][kPool][kPool];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int a = 0; a < kPool; ++a)
#pragma unroll
          for (int b = 0; b < kPool; ++b) acc[h][a][b] = 0.0f;
      for (int x = 0; x < kPx; ++x) {
        // T[7k+b, x, c..c+1] for the box's 7 rows: the dense 128-deep product
        float t[2][kPool];
#pragma unroll
        for (int b = 0; b < kPool; ++b) t[0][b] = t[1][b] = 0.0f;
        for (int y = 0; y < kRows; y += 4) {
          float2 p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) p[j] = load2(patches + ((y + j) * kPx + x) * kC + c);
#pragma unroll
          for (int b = 0; b < kPool; ++b) {
            const float4 w = *reinterpret_cast<const float4*>(&wy[k * kPool + b][y]);
            const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              t[0][b] = __fmaf_rn(ws[j], p[j].x, t[0][b]);
              t[1][b] = __fmaf_rn(ws[j], p[j].y, t[1][b]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < kPool; ++a) {
          const float w = wx[k * kPool + a][x];
#pragma unroll
          for (int b = 0; b < kPool; ++b) {
            acc[0][a][b] = __fmaf_rn(w, t[0][b], acc[0][a][b]);
            acc[1][a][b] = __fmaf_rn(w, t[1][b], acc[1][a][b]);
          }
        }
      }
      // every group's sums are computed, though only group n-1 stores
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int a = 0; a < kPool; ++a)
#pragma unroll
          for (int b = 0; b < kPool; ++b) asm volatile("" : "+f"(acc[h][a][b]));
      if (g == n_groups - 1) {
#pragma unroll
        for (int a = 0; a < kPool; ++a)
#pragma unroll
          for (int b = 0; b < kPool; ++b)
            *reinterpret_cast<float2*>(&out[((k * kPool + a) * kPool + b) * kC + c]) =
                make_float2(acc[0][a][b], acc[1][a][b]);
      }
    }
  }
}

}  // namespace

extern "C" {

// patches: [128, 40, 256] contiguous, dtype 0 = float32, 1 = bfloat16
// (cast to float32 on load); out: [4, 7, 7, 256] float32, group
// n_groups-1's result. Returns the CUDA error of the launch.
int mrt_group_roi(const void* patches, int dtype, int n_groups, float* out,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_groups < sms * kBlocksPerSm ? n_groups : sms * kBlocksPerSm;
  if (dtype == 0) {
    group_roi_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(patches), out, n_groups);
  } else if (dtype == 1) {
    group_roi_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(patches), out, n_groups);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
