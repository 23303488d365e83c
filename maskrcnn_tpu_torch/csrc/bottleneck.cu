// Fused ResNet identity bottleneck with frozen BN pre-folded, for sm_90a.
//
// Replaces the Pallas TPU kernel maskrcnn_tpu/ops/bottleneck_pallas.py:38
// `_kernel` (entry point fused_identity_bottleneck). Per image, NHWC:
//
//     h1 = relu(x @ W1 + b1)          1x1 reduce   C -> P, bf16 out
//     h2 = relu(conv3x3(h1) + b2)     3x3 SAME     P -> P, bf16 out
//     y  = relu(h2 @ W3 + b3 + x)     1x1 expand   P -> C, residual in f32
//
// with the numerics of the Pallas kernel and of the plain version
// (ops/bottleneck.fused_identity_bottleneck_plain): products accumulated
// in float32, biases float32, h1 and h2 rounded to the compute dtype once
// after the relu, h1 ZERO outside the image (not relu(b1)), the residual
// added in float32 before the last relu and the one cast.
//
// What bounds it on the H100: arithmetic. A block costs 34*H*W*P^2 flops
// (9.1 GFLOP per 1024^2 image at every stage), far above the card's
// flop-per-byte balance, so the bf16 path runs on the tensor cores (wmma
// 16x16x16, float32 accumulators). What the fusion saves is memory: h1
// and h2 never leave shared memory, so a block reads x once (plus its
// halo) and writes y once, against five full-map round trips unfused.
// As written it reaches neither bound: about 60 TFLOP/s on an H100 SXM at
// 700 W, held back by the short k steps between barriers (16-deep steps
// four stages deep were slower; larger tiles at one CTA an SM no faster).
//
// Design: one CTA per (image, TH x 16 output tile), 8 warps. Each stage
// is a GEMM in passes of up to 256 output columns; per 32-deep k step the
// CTA copies that slice of the weights into shared memory (cp.async,
// double-buffered, so the next slice loads while the tensor cores run),
// every weight byte read from L2 feeds all the tile's rows, and each warp
// holds the float32 accumulators of up to two items (16 rows x 64
// columns).
//  1. h1 over the (TH+2) x 18 halo tile, A = x staged 32 channels a step
//     (zeros outside the image); the epilogue adds b1, applies relu,
//     zeroes halo pixels outside the image and stores bf16 h1 in shared
//     memory.
//  2. h2: a 16-pixel output row is one wmma row fragment, so each of the 9
//     taps reads h1 as a plain strided fragment (row stride P+16 keeps
//     every fragment 32-byte aligned).
//  3. the expand reads h2 from shared memory, adds b3 and the residual
//     re-read from x, and writes y for the pixels inside the image.
// Weights live in device memory and stay L2-resident (2.2 MB of bf16 for
// a C4 block, 9 MB for C5). TH is the largest of 8, 4, 2, 1 whose shared
// memory fits two CTAs an SM (one CTA past that). Any H and W: partial
// tiles compute on zeros and store nothing outside the image.
// The Pallas kernel's full-width row tiles and manual halo DMA existed
// for VMEM and Mosaic and are not carried over.
//
// The float32 path (parity checks only) has the same tiling on scalar
// FMA-free float math: h1 and h2 in shared memory as float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileW = 16;            // output tile width: one fragment row
constexpr int kHaloW = kTileW + 2;    // halo tile width
constexpr int kKB = 32;               // k rows staged per step (A and B)
constexpr int kGroup = 4;             // 16-column fragments per work item
constexpr int kMaxNW = 256;           // widest pass of output columns
constexpr int kPad = 16;              // shared row padding, in elements
constexpr int kMaxSmem = 227 * 1024;
constexpr int kPairSmem = 113 * 1024; // two CTAs an SM

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

struct Geometry {
  int rows1;   // halo pixels, (th + 2) * kHaloW
  int mf1;     // 16-row fragments covering them
  int ld_h;    // row stride of h1 and h2 (bf16 elements)
  int ld_x;    // row stride of the x staging buffer
  int bs;      // elements of one staged weight tile (two are double-buffered)
  int xs;      // elements of one x staging tile (two)
  int h2;      // elements of the region shared by h2 and the x tiles
};

__host__ __device__ inline Geometry bf16_geometry(int th, int planes) {
  Geometry g;
  g.rows1 = (th + 2) * kHaloW;
  g.mf1 = round16(g.rows1) / 16;
  g.ld_h = planes + kPad;
  g.ld_x = kKB + kPad;
  g.bs = kKB * (kMaxNW + 8);
  g.xs = g.mf1 * 16 * g.ld_x;
  // stage 1 stages x where stage 2 later writes h2
  g.h2 = th * kTileW * g.ld_h > 2 * g.xs ? th * kTileW * g.ld_h : 2 * g.xs;
  return g;
}

size_t bf16_smem_bytes(int th, int planes) {
  const Geometry g = bf16_geometry(th, planes);
  return (static_cast<size_t>(g.mf1) * 16 * g.ld_h      // h1
          + static_cast<size_t>(g.h2)                    // h2, or x staging
          + 2 * static_cast<size_t>(g.bs))               // weight tiles
             * sizeof(bf16)
         + kWarps * 256 * sizeof(float);                 // epilogue scratch
}

size_t f32_smem_bytes(int th, int planes) {
  return (static_cast<size_t>((th + 2) * kHaloW) + th * kTileW) * planes *
         sizeof(float);
}

// Eight bf16 values <-> eight floats, as one 16-byte access.
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}

// Pixel (gy, gx) lies inside the H x W map.
__device__ __forceinline__ bool inside(int gy, int gx, int height, int width) {
  return gy >= 0 && gy < height && gx >= 0 && gx < width;
}

// Output columns of one pass, in 64-column groups: as many as keep every
// warp at two work items (16-row fragment x 64 columns) or fewer.
__device__ __forceinline__ int pass_groups(int mfrags, int n_total) {
  int groups = 1;
  while (mfrags * groups * 2 <= 2 * kWarps && (n_total / 64) % (groups * 2) == 0 &&
         groups * 2 * 64 <= kMaxNW)
    groups *= 2;
  return groups;
}

// One pass of out[m, n_pass : n_pass + 64*groups] = A[m, :] @ B[:, ...]
// over k in [0, k_total), kKB rows a step. Weight slices (and, through
// stage_a, the matching A columns where A comes from device memory) are
// copied into shared memory with cp.async, double-buffered: step s+1's
// copy is in flight while the tensor cores run step s, and one barrier a
// step both publishes a tile and frees the other. Each warp runs its
// items (16-row fragment x 64 columns) on the staged tiles.
template <typename StageA, typename PtrA>
__device__ __forceinline__ void gemm_pass(FragC (&acc)[2][kGroup], int mfrags,
                                          int groups, int n_pass,
                                          const bf16* __restrict__ b, int ldb,
                                          int k_total, bf16* bs, int bs_elems,
                                          StageA stage_a, PtrA ptr_a, int lda) {
  const int warp = threadIdx.x / 32;
  const int nw = groups * 64;
  const int ld_bs = nw + 8;
  const int items = mfrags * groups;
  const int vecs = nw / 8;
  auto load_step = [&](int k0, int buf) {
    stage_a(k0, buf);
    bf16* dst = bs + buf * bs_elems;
    for (int i = threadIdx.x; i < kKB * vecs; i += kThreads) {
      const int r = i / vecs;
      const int v = i - r * vecs;
      __pipeline_memcpy_async(dst + r * ld_bs + v * 8,
                              b + static_cast<size_t>(k0 + r) * ldb + n_pass + v * 8, 16);
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int it = 0; it < 2; ++it)
#pragma unroll
    for (int g = 0; g < kGroup; ++g) wmma::fill_fragment(acc[it][g], 0.0f);
  __syncthreads();  // the buffers' previous readers are done
  load_step(0, 0);
  for (int k0 = 0, step = 0; k0 < k_total; k0 += kKB, ++step) {
    const int buf = step & 1;
    __pipeline_wait_prior(0);
    // this step's tiles are visible to every warp, and every warp is done
    // with the last step's, whose buffers the next copy reuses
    __syncthreads();
    if (k0 + kKB < k_total) load_step(k0 + kKB, buf ^ 1);
    const bf16* tile = bs + buf * bs_elems;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int item = warp + it * kWarps;
      if (item >= items) continue;
      const int mi = item % mfrags;
      const int c0 = (item / mfrags) * 64;
#pragma unroll
      for (int kk = 0; kk < kKB; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, ptr_a(mi, k0 + kk, buf), lda);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          FragB bf;
          wmma::load_matrix_sync(bf, tile + kk * ld_bs + c0 + 16 * g, ld_bs);
          wmma::mma_sync(acc[it][g], a, bf, acc[it][g]);
        }
      }
    }
  }
}

// Hands the pass's accumulators to epi(mi, row, col, v) eight columns at
// a time (v: 8 floats of one row, col a multiple of 8), through the
// warp's float32 scratch tile, so the epilogues move 16 bytes a lane.
template <typename Epi>
__device__ __forceinline__ void epilogue(FragC (&acc)[2][kGroup], int mfrags,
                                         int groups, int n_pass, float* wscratch,
                                         Epi epi) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int item = warp + it * kWarps;
    if (item >= mfrags * groups) continue;
    const int mi = item % mfrags;
    const int n0 = n_pass + (item / mfrags) * 64;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      wmma::store_matrix_sync(wscratch, acc[it][g], 16, wmma::mem_row_major);
      __syncwarp();
      epi(mi, lane / 2, n0 + 16 * g + (lane % 2) * 8, wscratch + lane * 8);
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bottleneck_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, const bf16* __restrict__ w3,
                const float* __restrict__ b3, bf16* __restrict__ y, int height,
                int width, int channels, int planes, int th) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry geo = bf16_geometry(th, planes);
  bf16* h1 = reinterpret_cast<bf16*>(smem);
  bf16* h2 = h1 + geo.mf1 * 16 * geo.ld_h;
  bf16* xs = h2;  // x tiles live in h2's region until stage 2
  bf16* bs = h2 + geo.h2;
  float* wscratch = reinterpret_cast<float*>(bs + 2 * geo.bs) + threadIdx.x / 32 * 256;

  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * th;
  const size_t img = static_cast<size_t>(blockIdx.z) * height * width;
  FragC acc[2][kGroup];

  // ---- stage 1: h1 = relu(x @ W1 + b1) over the halo tile, zero outside
  // the image; x is staged kKB channels a step
  const int rows1 = geo.rows1;
  const int ld_x = geo.ld_x;
  const int ld_h = geo.ld_h;
  const int xs_elems = geo.xs;
  auto stage_x = [&](int k0, int buf) {
    constexpr int kVecs = kKB / 8;
    bf16* dst = xs + buf * xs_elems;
    for (int i = threadIdx.x; i < geo.mf1 * 16 * kVecs; i += kThreads) {
      const int r = i / kVecs;
      const int v = i - r * kVecs;
      const int gy = y0 - 1 + r / kHaloW;
      const int gx = x0 - 1 + r % kHaloW;
      if (r < rows1 && inside(gy, gx, height, width))
        __pipeline_memcpy_async(
            dst + r * ld_x + v * 8,
            x + (img + static_cast<size_t>(gy) * width + gx) * channels + k0 + v * 8, 16);
      else
        *reinterpret_cast<uint4*>(dst + r * ld_x + v * 8) = make_uint4(0, 0, 0, 0);
    }
  };
  const int groups1 = pass_groups(geo.mf1, planes);
  for (int n_pass = 0; n_pass < planes; n_pass += groups1 * 64) {
    gemm_pass(acc, geo.mf1, groups1, n_pass, w1, planes, channels, bs, geo.bs, stage_x,
              [&](int mi, int k, int buf) {
                return xs + buf * xs_elems + mi * 16 * ld_x + k % kKB;
              },
              ld_x);
    epilogue(acc, geo.mf1, groups1, n_pass, wscratch,
             [&](int mi, int row, int col, const float* v) {
               const int r = mi * 16 + row;
               const int gy = y0 - 1 + r / kHaloW;
               const int gx = x0 - 1 + r % kHaloW;
               const bool in = r < rows1 && inside(gy, gx, height, width);
               float out[8];
#pragma unroll
               for (int j = 0; j < 8; ++j) out[j] = in ? fmaxf(v[j] + b1[col + j], 0.0f) : 0.0f;
               store8(h1 + r * ld_h + col, out);
             });
  }

  // ---- stage 2: h2 = relu(conv3x3(h1) + b2); a 16-pixel output row is a
  // fragment, and tap t of k = t*P + c reads h1 shifted by (t/3, t%3)
  auto no_stage = [](int, int) {};
  const int groups2 = pass_groups(th, planes);
  for (int n_pass = 0; n_pass < planes; n_pass += groups2 * 64) {
    gemm_pass(acc, th, groups2, n_pass, w2, planes, 9 * planes, bs, geo.bs, no_stage,
              [&](int mi, int k, int) {
                const int tap = k / planes;
                return h1 + ((mi + tap / 3) * kHaloW + tap % 3) * ld_h + (k - tap * planes);
              },
              ld_h);
    epilogue(acc, th, groups2, n_pass, wscratch,
             [&](int mi, int row, int col, const float* v) {
               float out[8];
#pragma unroll
               for (int j = 0; j < 8; ++j) out[j] = fmaxf(v[j] + b2[col + j], 0.0f);
               store8(h2 + (mi * 16 + row) * ld_h + col, out);
             });
  }

  // ---- stage 3: y = relu(h2 @ W3 + b3 + x) for the pixels in the image
  const int groups3 = pass_groups(th, channels);
  for (int n_pass = 0; n_pass < channels; n_pass += groups3 * 64) {
    gemm_pass(acc, th, groups3, n_pass, w3, channels, planes, bs, geo.bs, no_stage,
              [&](int mi, int k, int) { return h2 + mi * 16 * ld_h + k; }, ld_h);
    epilogue(acc, th, groups3, n_pass, wscratch,
             [&](int mi, int row, int col, const float* v) {
               const int gy = y0 + mi;
               const int gx = x0 + row;
               if (!inside(gy, gx, height, width)) return;
               const size_t at = (img + static_cast<size_t>(gy) * width + gx) * channels + col;
               float res[8], out[8];
               load8(x + at, res);
#pragma unroll
               for (int j = 0; j < 8; ++j) out[j] = fmaxf((v[j] + b3[col + j]) + res[j], 0.0f);
               store8(y + at, out);
             });
  }
}

__global__ void __launch_bounds__(kThreads)
bottleneck_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ w3,
               const float* __restrict__ b3, float* __restrict__ y, int height,
               int width, int channels, int planes, int th) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows1 = (th + 2) * kHaloW;
  float* h1 = reinterpret_cast<float*>(smem);
  float* h2 = h1 + rows1 * planes;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * th;
  const size_t img = static_cast<size_t>(blockIdx.z) * height * width;

  for (int i = threadIdx.x; i < rows1 * planes; i += kThreads) {
    const int r = i / planes;
    const int n = i - r * planes;
    const int gy = y0 - 1 + r / kHaloW;
    const int gx = x0 - 1 + r % kHaloW;
    float v = 0.0f;
    if (inside(gy, gx, height, width)) {
      const float* xp = x + (img + static_cast<size_t>(gy) * width + gx) * channels;
      float acc = 0.0f;
      for (int k = 0; k < channels; ++k) acc += xp[k] * w1[static_cast<size_t>(k) * planes + n];
      v = fmaxf(acc + b1[n], 0.0f);
    }
    h1[i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < th * kTileW * planes; i += kThreads) {
    const int p = i / planes;
    const int n = i - p * planes;
    const int py = p / kTileW;
    const int px = p - py * kTileW;
    float acc = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* hp = h1 + ((py + tap / 3) * kHaloW + px + tap % 3) * planes;
      const float* wp = w2 + static_cast<size_t>(tap) * planes * planes + n;
      for (int k = 0; k < planes; ++k) acc += hp[k] * wp[static_cast<size_t>(k) * planes];
    }
    h2[i] = fmaxf(acc + b2[n], 0.0f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < th * kTileW * channels; i += kThreads) {
    const int p = i / channels;
    const int n = i - p * channels;
    const int gy = y0 + p / kTileW;
    const int gx = x0 + p % kTileW;
    if (!inside(gy, gx, height, width)) continue;
    const float* hp = h2 + p * planes;
    float acc = 0.0f;
    for (int k = 0; k < planes; ++k) acc += hp[k] * w3[static_cast<size_t>(k) * channels + n];
    const size_t at = (img + static_cast<size_t>(gy) * width + gx) * channels + n;
    y[at] = fmaxf((acc + b3[n]) + x[at], 0.0f);
  }
}

// Largest tile height of 8, 4, 2, 1 whose shared memory fits two CTAs an
// SM, else the largest that fits one; 0 if none does.
int pick_tile_height(size_t (*smem_bytes)(int, int), int planes) {
  const int budgets[2] = {kPairSmem, kMaxSmem};
  const int heights[4] = {8, 4, 2, 1};
  for (int b = 0; b < 2; ++b)
    for (int t = 0; t < 4; ++t)
      if (smem_bytes(heights[t], planes) <= static_cast<size_t>(budgets[b]))
        return heights[t];
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x/y [B, H, W, C] NHWC; w1 [C, P],
// w2 [9, P, P] (tap dy*3+dx, in, out), w3 [P, C] in x's dtype; biases
// float32. bf16 needs C and P multiples of 64 and 16-byte aligned rows.
// Returns the CUDA error of the launch (0 on success).
int mrt_bottleneck(const void* x, const void* w1, const float* b1,
                   const void* w2, const float* b2, const void* w3,
                   const float* b3, void* y, int batch, int height, int width,
                   int channels, int planes, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int th;
  size_t smem;
  if (dtype == 1) {
    if (channels % 64 || planes % 64) return static_cast<int>(cudaErrorInvalidValue);
    th = pick_tile_height(bf16_smem_bytes, planes);
    if (th == 0) return static_cast<int>(cudaErrorInvalidValue);
    smem = bf16_smem_bytes(th, planes);
    cudaError_t err = cudaFuncSetAttribute(
        bottleneck_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (dtype == 0) {
    th = pick_tile_height(f32_smem_bytes, planes);
    if (th == 0) return static_cast<int>(cudaErrorInvalidValue);
    smem = f32_smem_bytes(th, planes);
    cudaError_t err = cudaFuncSetAttribute(
        bottleneck_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((width + kTileW - 1) / kTileW, (height + th - 1) / th, batch);
  if (dtype == 1) {
    bottleneck_bf16<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
        static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(w3), b3,
        static_cast<bf16*>(y), height, width, channels, planes, th);
  } else {
    bottleneck_f32<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), b1,
        static_cast<const float*>(w2), b2, static_cast<const float*>(w3), b3,
        static_cast<float*>(y), height, width, channels, planes, th);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
