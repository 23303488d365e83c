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
// in float32, biases float32, h1 and h2 rounded to bf16 once after the
// relu, h1 ZERO outside the image (not relu(b1)), the residual added in
// float32 before the last relu and the one cast. Any H and W: partial
// tiles compute on zeros and store nothing outside the image.
//
// Weights are K-major, as the conv weights [O, I, kh, kw] already are:
// w1 [P, C], w2 [P, 9, P] (out, tap dy*3+dx, in), w3 [C, P], so every
// weight slice is a TMA box of 64 input channels (128 bytes) by up to
// 128 output channels, the layout wgmma reads B in.
//
// What bounds it on the H100. A block costs 34*H*W*P^2 flops (9.1 GFLOP
// per 1024^2 image at every stage) against x read once and y written
// once. At B=8 on the 1024^2 canvas: C2 (256^2, C=256, P=64) is bound by
// memory (537 MB, 0.160 ms), C3 (128^2, 512, 128) by memory (268 MB,
// 0.080 ms), C4 (64^2, 1024, 256) and C5 (32^2, 2048, 512) by arithmetic
// (73 GFLOP, 0.074 ms at 989 TFLOP/s). Version 3 of this kernel (wmma
// 16x16x16, cp.async double buffer, TH x 16-pixel tiles picked for two
// CTAs an SM) took 1.2275 / 1.0877 / 1.2884 / 1.1814 ms at C2-C5 (H100
// 80GB HBM3, 700 W), 6-13% of those bounds. What held it back:
//   - small tiles: 32-64 pixels at C3-C5, and every CTA streams all of
//     the block's weights through L2 and shared memory (0.57 / 1.14 /
//     2.28 / 1.14 GB of weight traffic at C2-C5, 4-17x the activations),
//     for only 32-80 rows of product per weight byte;
//   - the legacy mma.sync path (wmma), 16 products between barriers, one
//     __syncthreads a 32-deep k step, 2-way bank conflicts on h1;
//   - the 1x1 reduce recomputed 1.5-2.5x over the halo;
//   - epilogues through a per-warp float scratch, fragment by fragment.
//
// Design (version 4):
//   - 128-pixel output tiles (8 x 16) at P <= 256: two consumer
//     warpgroups of 64 rows each. At C4 that is 256 CTAs and 0.57 GB of
//     weight traffic (4x less), and the halo recompute is 1.4x (180 halo
//     pixels for 128). At P = 512 (C5) the 8 x 16 tile's h1 (180 rows x
//     1 KB) does not fit beside the ring, so C5 takes 4 x 16 tiles (64
//     pixels, 108 halo rows; 128 CTAs, one wave), and the two warpgroups
//     split the columns instead of the rows.
//   - wgmma.mma_async for all three products, float32 accumulators in
//     registers, in passes of 128 output columns (64 a warpgroup in stage
//     1, where each warpgroup covers all halo rows).
//   - A producer warp keeps a ring of 3-5 slots full by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, mbarrier transaction
//     counts); consumers free a slot by arriving on its "empty" barrier.
//     The schedule runs across stages, so the next stage's first weight
//     slices load while the current epilogue runs.
//   - Stage 1: A is x's halo tile, a 4-D TMA box [1, TH+2, 18, 64] over
//     [B, H, W, C] that zero-fills outside the image; A and B both come
//     from swizzled shared memory through wgmma descriptors.
//   - Stage 2: A comes from registers, by ldmatrix over the shifted h1
//     rows: a 3x3 tap shifts the rows by one pixel, which breaks the
//     8-row alignment of a shared-memory descriptor, while ldmatrix takes
//     one row address a lane. Stage 3 reads h2 the same way.
//   - h1 and h2 live in shared memory as bf16 rows with the 16-byte
//     chunks XOR-swizzled by the row (no padding, no bank conflicts for
//     the epilogue's stores or ldmatrix); h2 reuses the x slots, which
//     stage 1 no longer needs.
//   - Epilogues straight from the accumulator registers: bias, relu and
//     the bf16 rounding in registers, h1/h2 to shared memory, y (with the
//     residual read from x) to device memory.
//
// The float32 path (parity checks only) keeps version 3's tiling on
// scalar math: h1 and h2 in shared memory as float32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileW = 16;            // output tile width
constexpr int kHaloW = kTileW + 2;    // halo tile width
constexpr int kKStep = 64;            // k per ring slot: 128 bytes of bf16
constexpr int kSlice3 = 128;          // stage 3 weight slice (output columns)
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kThreadsW = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kMaxSmem = 227 * 1024;  // a block's shared memory on the H100
constexpr int kMaxStages = 5;

// ---------------------------------------------------------------------------
// Shared memory plan of the bf16 kernel, the same on host and device.

struct Plan {
  int rows1;     // halo pixels, (th + 2) * kHaloW
  int x_bytes;   // one x slot: 64-row blocks covering rows1, 128 B a row
  int w_bytes;   // one weight slot: up to 128 rows of 128 B
  int h1_off;    // h1 [rows1, P] bf16
  int x_off;     // the x slots, later h2 [th * 16, P] bf16
  int w_off;     // the weight slots
  int bar_off;   // full[stages], empty[stages]
  int total;     // bytes, before the 1 KB alignment slack
};

__host__ __device__ inline int align1024(int v) { return (v + 1023) / 1024 * 1024; }

__host__ __device__ inline Plan make_plan(int th, int planes, int stages) {
  Plan p;
  p.rows1 = (th + 2) * kHaloW;
  p.x_bytes = (p.rows1 + 63) / 64 * 64 * 128;
  p.w_bytes = kSlice3 * 128;
  const int h2_bytes = th * kTileW * planes * 2;
  p.h1_off = 0;
  p.x_off = align1024(p.rows1 * planes * 2);
  const int x_region = stages * p.x_bytes > h2_bytes ? stages * p.x_bytes : h2_bytes;
  p.w_off = p.x_off + align1024(x_region);
  p.bar_off = p.w_off + stages * p.w_bytes;
  p.total = p.bar_off + 2 * stages * 8;
  return p;
}

// ---------------------------------------------------------------------------
// PTX wrappers: shared addresses, mbarriers, TMA, ldmatrix, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The two consumer warpgroups' barrier (the producer warp never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerWarps * 32) : "memory");
}

// wgmma descriptor of a K-major tile in 128-byte-swizzled shared memory:
// rows of 128 bytes (64 bf16 of k), 8-row groups 1024 bytes apart, the
// tile 1024-byte aligned. One k16 step further along k is +32 bytes, +2
// in the address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin registers at this point of the program, so the compiler neither
// reads accumulators before the wgmma that writes them has been waited
// for nor reuses A registers that an issued wgmma still reads.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 inputs, float32 accumulators (scale-d 1,
// no transposes). wgmma_ss: A and B from shared memory descriptors;
// wgmma_rs: A from registers (the mma.m16n8k16 A fragment of the warp's
// 16 rows), B from a descriptor. d[4i + {0,1}] hold row lane/4, columns
// 8i + 2*(lane%4) + {0,1} of the warp's 16 rows; d[4i + {2,3}] row + 8.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// The bf16 kernel.

// Byte offset of element (row, col) in an h1/h2 row of `planes` bf16
// values: the 16-byte chunks of each row XOR-swizzled by row % 8, so
// eight consecutive rows at one logical chunk hit eight distinct banks.
__device__ __forceinline__ uint32_t swz(int row, int col, int planes) {
  return static_cast<uint32_t>(row * planes * 2 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1)));
}

__device__ __forceinline__ bool inside(int gy, int gx, int height, int width) {
  return gy >= 0 && gy < height && gx >= 0 && gx < width;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Tile geometry. TH output rows of 16 pixels; NS the stage 1 and 2
// weight slice (output columns of a pass). With TH = 8 the warpgroups
// take 64 output rows each in stages 2 and 3; with TH = 4 (64 rows) they
// take half the columns each.
template <int TH, int NS>
struct Tile {
  static constexpr int kRows1 = (TH + 2) * kHaloW;
  static constexpr int kMb1 = (kRows1 + 63) / 64;            // stage 1 row blocks
  static constexpr int kNw1 = NS / 2;                         // stage 1 columns a warpgroup
  static constexpr bool kSplitRows = TH * kTileW == 128;      // stages 2 and 3
  static constexpr int kNw2 = kSplitRows ? NS : NS / 2;
  static constexpr int kNw3 = kSplitRows ? kSlice3 : kSlice3 / 2;
};

// The ring: slot = step % stages, used for the (step / stages)-th time.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int step;
  __device__ __forceinline__ int slot() const { return step % stages; }
  __device__ __forceinline__ uint32_t parity() const { return (step / stages) & 1; }
};

template <int TH, int NS>
__device__ __forceinline__ void produce(const CUtensorMap* x_map, const CUtensorMap* w1_map,
                                        const CUtensorMap* w2_map, const CUtensorMap* w3_map,
                                        Ring ring, unsigned char* xs, unsigned char* ws,
                                        const Plan& plan, int channels, int planes) {
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * TH;
  const int img = blockIdx.z;
  auto acquire = [&](uint32_t bytes) {
    const int s = ring.slot();
    mbar_wait(&ring.empty[s], ring.parity() ^ 1);  // the slot's last readers are done
    mbar_expect_tx(&ring.full[s], bytes);
    ++ring.step;
    return s;
  };
  for (int n0 = 0; n0 < planes; n0 += NS)
    for (int k0 = 0; k0 < channels; k0 += kKStep) {
      const int s = acquire(plan.rows1 * 128 + NS * 128);
      tma_load_4d(xs + s * plan.x_bytes, x_map, &ring.full[s], k0, x0 - 1, y0 - 1, img);
      tma_load_2d(ws + s * plan.w_bytes, w1_map, &ring.full[s], k0, n0);
    }
  for (int n0 = 0; n0 < planes; n0 += NS)
    for (int k0 = 0; k0 < 9 * planes; k0 += kKStep) {
      const int s = acquire(NS * 128);
      tma_load_2d(ws + s * plan.w_bytes, w2_map, &ring.full[s], k0, n0);
    }
  for (int n0 = 0; n0 < channels; n0 += kSlice3)
    for (int k0 = 0; k0 < planes; k0 += kKStep) {
      const int s = acquire(kSlice3 * 128);
      tma_load_2d(ws + s * plan.w_bytes, w3_map, &ring.full[s], k0, n0);
    }
}

// One k step of a register-A product: four ldmatrix.x4 (16 rows x 64 k
// of this warp, row address `row_addr` for this lane's row, chunk 0),
// then four wgmma on the slot's weights.
template <int N>
__device__ __forceinline__ void rs_step(float (&acc)[N], uint32_t row_addr, int row, int kc,
                                        uint32_t b_addr) {
  const int lane = threadIdx.x % 32;
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = (kc >> 3) + 2 * kk + (lane >> 4);
    ldmatrix_x4(a[kk], row_addr + (((chunk ^ (row & 7)) << 4)));
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], sw128_desc(b_addr) + 2 * kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
  fence_regs(a);
}

template <int TH, int NS>
__device__ __forceinline__ void consume(Ring ring, unsigned char* h1, unsigned char* xs,
                                        unsigned char* ws, const Plan& plan,
                                        const bf16* __restrict__ x, const float* __restrict__ b1,
                                        const float* __restrict__ b2,
                                        const float* __restrict__ b3, bf16* __restrict__ y,
                                        int height, int width, int channels, int planes) {
  using T = Tile<TH, NS>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;  // consumer warpgroup
  const int wi = warp % 4;  // warp in its warpgroup: rows 16 wi .. 16 wi + 15
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * TH;
  const size_t img = static_cast<size_t>(blockIdx.z) * height * width;
  const uint32_t h1_addr = smem_u32(h1);
  const uint32_t h2_addr = smem_u32(xs);  // h2 reuses the x slots
  const uint32_t xs_addr = smem_u32(xs);
  const uint32_t ws_addr = smem_u32(ws);
  unsigned char* h2 = xs;
  auto wait_full = [&]() {
    const int s = ring.slot();
    mbar_wait(&ring.full[s], ring.parity());
    return s;
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[s]);
    ++ring.step;
  };

  // ---- stage 1: h1 = relu(x @ W1 + b1) over the halo tile, zero outside
  // the image. Each warpgroup: all halo row blocks x kNw1 columns.
  for (int n0 = 0; n0 < planes; n0 += NS) {
    float acc[T::kMb1][T::kNw1 / 2];
#pragma unroll
    for (int mb = 0; mb < T::kMb1; ++mb)
#pragma unroll
      for (int i = 0; i < T::kNw1 / 2; ++i) acc[mb][i] = 0.0f;
    for (int k0 = 0; k0 < channels; k0 += kKStep) {
      const int s = wait_full();
      const uint32_t a_addr = xs_addr + s * plan.x_bytes;
      const uint32_t b_addr = ws_addr + s * plan.w_bytes + wg * T::kNw1 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mb = 0; mb < T::kMb1; ++mb)
          wgmma_ss(acc[mb], sw128_desc(a_addr + mb * 8192) + 2 * kk,
                   sw128_desc(b_addr) + 2 * kk);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int mb = 0; mb < T::kMb1; ++mb) fence_regs(acc[mb]);
      release(s);
    }
#pragma unroll
    for (int mb = 0; mb < T::kMb1; ++mb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mb * 64 + wi * 16 + (lane >> 2) + 8 * half;
        if (r >= T::kRows1) continue;
        const int gy = y0 - 1 + r / kHaloW;
        const int gx = x0 - 1 + r % kHaloW;
        const bool in = inside(gy, gx, height, width);
#pragma unroll
        for (int i = 0; i < T::kNw1 / 8; ++i) {
          const int col = n0 + wg * T::kNw1 + 8 * i + 2 * (lane & 3);
          const float v0 = in ? fmaxf(acc[mb][4 * i + 2 * half] + b1[col], 0.0f) : 0.0f;
          const float v1 = in ? fmaxf(acc[mb][4 * i + 2 * half + 1] + b1[col + 1], 0.0f) : 0.0f;
          *reinterpret_cast<uint32_t*>(h1 + swz(r, col, planes)) = pack_bf16x2(v0, v1);
        }
      }
  }
  consumer_sync();  // h1 complete; the x slots are free for h2

  // ---- stage 2: h2 = relu(conv3x3(h1) + b2); k = tap * P + c, and tap
  // (dy, dx) reads h1 at halo row (py + dy) * 18 + px + dx.
  const int mrow = T::kSplitRows ? wg * 64 : 0;          // first output row
  const int o_lane = mrow + wi * 16 + (lane & 15);       // this lane's ldmatrix row
  const int o_py = o_lane >> 4;
  const int o_px = o_lane & 15;
  for (int n0 = 0; n0 < planes; n0 += NS) {
    const int ncol = T::kSplitRows ? 0 : wg * T::kNw2;    // within the slice
    float acc[T::kNw2 / 2];
#pragma unroll
    for (int i = 0; i < T::kNw2 / 2; ++i) acc[i] = 0.0f;
    for (int k0 = 0; k0 < 9 * planes; k0 += kKStep) {
      const int s = wait_full();
      const int tap = k0 / planes;
      const int kc = k0 - tap * planes;
      const int hr = (o_py + tap / 3) * kHaloW + o_px + tap % 3;
      rs_step(acc, h1_addr + hr * planes * 2, hr, kc,
              ws_addr + s * plan.w_bytes + ncol * 128);
      release(s);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = mrow + wi * 16 + (lane >> 2) + 8 * half;
#pragma unroll
      for (int i = 0; i < T::kNw2 / 8; ++i) {
        const int col = n0 + ncol + 8 * i + 2 * (lane & 3);
        const float v0 = fmaxf(acc[4 * i + 2 * half] + b2[col], 0.0f);
        const float v1 = fmaxf(acc[4 * i + 2 * half + 1] + b2[col + 1], 0.0f);
        *reinterpret_cast<uint32_t*>(h2 + swz(o, col, planes)) = pack_bf16x2(v0, v1);
      }
    }
  }
  consumer_sync();  // h2 complete

  // ---- stage 3: y = relu(h2 @ W3 + b3 + x) for the pixels in the image
  for (int n0 = 0; n0 < channels; n0 += kSlice3) {
    const int ncol = T::kSplitRows ? 0 : wg * T::kNw3;
    float acc[T::kNw3 / 2];
#pragma unroll
    for (int i = 0; i < T::kNw3 / 2; ++i) acc[i] = 0.0f;
    for (int k0 = 0; k0 < planes; k0 += kKStep) {
      const int s = wait_full();
      rs_step(acc, h2_addr + o_lane * planes * 2, o_lane, k0,
              ws_addr + s * plan.w_bytes + ncol * 128);
      release(s);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = mrow + wi * 16 + (lane >> 2) + 8 * half;
      const int gy = y0 + (o >> 4);
      const int gx = x0 + (o & 15);
      if (!inside(gy, gx, height, width)) continue;
      const size_t at = (img + static_cast<size_t>(gy) * width + gx) * channels;
#pragma unroll
      for (int i = 0; i < T::kNw3 / 8; ++i) {
        const int col = n0 + ncol + 8 * i + 2 * (lane & 3);
        const float2 res =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at + col));
        const float v0 = fmaxf((acc[4 * i + 2 * half] + b3[col]) + res.x, 0.0f);
        const float v1 = fmaxf((acc[4 * i + 2 * half + 1] + b3[col + 1]) + res.y, 0.0f);
        *reinterpret_cast<uint32_t*>(y + at + col) = pack_bf16x2(v0, v1);
      }
    }
  }
}

// One CTA per (image, TH x 16 output tile): warps 0-7 are the consumer
// warpgroups, warp 8 the producer (one lane issues every TMA load).
template <int TH, int NS>
__global__ void __launch_bounds__(kThreadsW, 1)
bottleneck_bf16(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap w1_map,
                const __grid_constant__ CUtensorMap w2_map,
                const __grid_constant__ CUtensorMap w3_map, const bf16* __restrict__ x,
                const float* __restrict__ b1, const float* __restrict__ b2,
                const float* __restrict__ b3, bf16* __restrict__ y, int height, int width,
                int channels, int planes, int stages) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment in the shared window
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Plan plan = make_plan(TH, planes, stages);
  unsigned char* h1 = smem + plan.h1_off;
  unsigned char* xs = smem + plan.x_off;
  unsigned char* ws = smem + plan.w_off;
  Ring ring{reinterpret_cast<uint64_t*>(smem + plan.bar_off), nullptr, stages, 0};
  ring.empty = ring.full + stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x / 32 == kConsumerWarps) {
    if (threadIdx.x % 32 == 0)
      produce<TH, NS>(&x_map, &w1_map, &w2_map, &w3_map, ring, xs, ws, plan, channels, planes);
    return;
  }
  consume<TH, NS>(ring, h1, xs, ws, plan, x, b1, b2, b3, y, height, width, channels, planes);
}

// ---------------------------------------------------------------------------
// The float32 kernel (parity checks only): version 3's scalar loops over
// the packed K-major weights, one output channel a thread, its inputs
// summed in order.

constexpr int kThreadsF = 256;
constexpr int kPairSmem = 113 * 1024;  // two CTAs an SM

size_t f32_smem_bytes(int th, int planes) {
  return (static_cast<size_t>((th + 2) * kHaloW) + th * kTileW) * planes * sizeof(float);
}

__global__ void __launch_bounds__(kThreadsF)
bottleneck_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ w3,
               const float* __restrict__ b3, float* __restrict__ y, int height,
               int width, int channels, int planes, int th) {
  extern __shared__ __align__(128) unsigned char smem_f[];
  const int rows1 = (th + 2) * kHaloW;
  float* h1 = reinterpret_cast<float*>(smem_f);
  float* h2 = h1 + rows1 * planes;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * th;
  const size_t img = static_cast<size_t>(blockIdx.z) * height * width;

  for (int i = threadIdx.x; i < rows1 * planes; i += kThreadsF) {
    const int r = i / planes;
    const int n = i - r * planes;
    const int gy = y0 - 1 + r / kHaloW;
    const int gx = x0 - 1 + r % kHaloW;
    float v = 0.0f;
    if (inside(gy, gx, height, width)) {
      const float* xp = x + (img + static_cast<size_t>(gy) * width + gx) * channels;
      float acc = 0.0f;
      for (int k = 0; k < channels; ++k) acc += xp[k] * w1[static_cast<size_t>(n) * channels + k];
      v = fmaxf(acc + b1[n], 0.0f);
    }
    h1[i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < th * kTileW * planes; i += kThreadsF) {
    const int p = i / planes;
    const int n = i - p * planes;
    const int py = p / kTileW;
    const int px = p - py * kTileW;
    float acc = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* hp = h1 + ((py + tap / 3) * kHaloW + px + tap % 3) * planes;
      const float* wp = w2 + (static_cast<size_t>(n) * 9 + tap) * planes;
      for (int k = 0; k < planes; ++k) acc += hp[k] * wp[k];
    }
    h2[i] = fmaxf(acc + b2[n], 0.0f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < th * kTileW * channels; i += kThreadsF) {
    const int p = i / channels;
    const int n = i - p * channels;
    const int gy = y0 + p / kTileW;
    const int gx = x0 + p % kTileW;
    if (!inside(gy, gx, height, width)) continue;
    const float* hp = h2 + p * planes;
    float acc = 0.0f;
    for (int k = 0; k < planes; ++k) acc += hp[k] * w3[static_cast<size_t>(n) * planes + k];
    const size_t at = (img + static_cast<size_t>(gy) * width + gx) * channels + n;
    y[at] = fmaxf((acc + b3[n]) + x[at], 0.0f);
  }
}

// Largest tile height of 8, 4, 2, 1 whose shared memory fits two CTAs an
// SM, else the largest that fits one; 0 if none does.
int pick_f32_tile_height(int planes) {
  const int budgets[2] = {kPairSmem, kMaxSmem};
  const int heights[4] = {8, 4, 2, 1};
  for (int b = 0; b < 2; ++b)
    for (int t = 0; t < 4; ++t)
      if (f32_smem_bytes(heights[t], planes) <= static_cast<size_t>(budgets[b]))
        return heights[t];
  return 0;
}

// ---------------------------------------------------------------------------
// Host side of the bf16 kernel: the plan, the tensor maps, the launch.

// The deepest ring (up to kMaxStages) whose plan fits a block's shared
// memory with the alignment slack; 0 if not even `min_stages` fit.
int fit_stages(int th, int planes, int min_stages) {
  for (int s = kMaxStages; s >= min_stages; --s)
    if (make_plan(th, planes, s).total + 1024 <= kMaxSmem) return s;
  return 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the CUDA runtime has
// loaded, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A bf16 tensor map with 128-byte swizzle; dims and box innermost first,
// strides in bytes for dims 1.. . Out-of-bounds elements read as zero.
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 tile for P: 8 x 16 pixels while h1 and a ring of at least 3
// slots fit, else 4 x 16 (P a multiple of 128, at least 2 slots); the
// stage 1/2 weight slices are 128 columns wide where P allows, else 64.
bool choose_tile(int planes, int* th, int* slice, int* stages) {
  if (planes % 64) return false;
  *slice = planes % 128 == 0 ? 128 : 64;
  *th = 8;
  *stages = fit_stages(8, planes, 3);
  if (*stages) return true;
  *th = 4;
  *stages = fit_stages(4, planes, 2);
  return *stages != 0 && *slice == 128;
}

template <int TH, int NS>
cudaError_t launch_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                        const float* b2, const bf16* w3, const float* b3, bf16* y, int batch,
                        int height, int width, int channels, int planes, int stages,
                        cudaStream_t s) {
  CUtensorMap maps[4];
  const cuuint64_t c2 = static_cast<cuuint64_t>(channels) * 2;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(channels),
                                static_cast<cuuint64_t>(width),
                                static_cast<cuuint64_t>(height),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t x_strides[3] = {c2, c2 * width, c2 * width * height};
  const cuuint32_t x_box[4] = {kKStep, kHaloW, TH + 2, 1};
  const cuuint64_t w1_dims[2] = {static_cast<cuuint64_t>(channels),
                                 static_cast<cuuint64_t>(planes)};
  const cuuint64_t w1_strides[1] = {c2};
  const cuuint32_t w12_box[2] = {kKStep, NS};
  const cuuint64_t w2_dims[2] = {static_cast<cuuint64_t>(9) * planes,
                                 static_cast<cuuint64_t>(planes)};
  const cuuint64_t w2_strides[1] = {static_cast<cuuint64_t>(planes) * 18};
  const cuuint64_t w3_dims[2] = {static_cast<cuuint64_t>(planes),
                                 static_cast<cuuint64_t>(channels)};
  const cuuint64_t w3_strides[1] = {static_cast<cuuint64_t>(planes) * 2};
  const cuuint32_t w3_box[2] = {kKStep, kSlice3};
  if (!make_map(&maps[0], x, 4, x_dims, x_strides, x_box) ||
      !make_map(&maps[1], w1, 2, w1_dims, w1_strides, w12_box) ||
      !make_map(&maps[2], w2, 2, w2_dims, w2_strides, w12_box) ||
      !make_map(&maps[3], w3, 2, w3_dims, w3_strides, w3_box))
    return cudaErrorInvalidValue;
  const int smem = make_plan(TH, planes, stages).total + 1024;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_bf16<TH, NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((width + kTileW - 1) / kTileW, (height + TH - 1) / TH, batch);
  bottleneck_bf16<TH, NS><<<grid, kThreadsW, smem, s>>>(maps[0], maps[1], maps[2], maps[3], x,
                                                         b1, b2, b3, y, height, width,
                                                         channels, planes, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x/y [B, H, W, C] NHWC; biases
// float32; weights K-major in x's dtype, w1 [P, C], w2 [P, 9, P] (out,
// tap dy*3+dx, in), w3 [C, P]. bf16 needs C = 4P, P a multiple of 64 up
// to 256, or 384 or 512, and 16-byte aligned tensors. Returns the CUDA
// error of the launch (0 on success).
int mrt_bottleneck(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, const void* w3, const float* b3, void* y, int batch,
                   int height, int width, int channels, int planes, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (channels % 64 || planes % 64) return static_cast<int>(cudaErrorInvalidValue);
    const bf16 *xb = static_cast<const bf16*>(x), *w1b = static_cast<const bf16*>(w1),
               *w2b = static_cast<const bf16*>(w2), *w3b = static_cast<const bf16*>(w3);
    bf16* yb = static_cast<bf16*>(y);
    int th, slice, stages;
    if (!choose_tile(planes, &th, &slice, &stages))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    if (th == 8 && slice == 128)
      err = launch_bf16<8, 128>(xb, w1b, b1, w2b, b2, w3b, b3, yb, batch, height, width,
                                channels, planes, stages, s);
    else if (th == 8)
      err = launch_bf16<8, 64>(xb, w1b, b1, w2b, b2, w3b, b3, yb, batch, height, width,
                               channels, planes, stages, s);
    else
      err = launch_bf16<4, 128>(xb, w1b, b1, w2b, b2, w3b, b3, yb, batch, height, width,
                                channels, planes, stages, s);
    return static_cast<int>(err);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int th = pick_f32_tile_height(planes);
  if (th == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = f32_smem_bytes(th, planes);
  cudaError_t err = cudaFuncSetAttribute(bottleneck_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + th - 1) / th, batch);
  bottleneck_f32<<<grid, kThreadsF, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<const float*>(w3), b3,
      static_cast<float*>(y), height, width, channels, planes, th);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
