// Greedy NMS keep mask over score-sorted boxes, batched over images, for
// sm_90a (version 2).
//
// Replaces the Pallas TPU kernel maskrcnn_tpu/ops/nms_pallas.py:35
// `_nms_kernel` (entry point nms_mask_pallas). Semantics of
// maskrcnn_tpu/ops/nms.py nms_mask: the +1 pixel-area IoU, suppression at
// iou >= thr, invalid rows neither survive nor suppress; any N.
//
// What bounds it on the H100: the greedy order. Which box survives
// depends on every earlier decision, a chain of N dependent steps; the
// IoU work (N^2/2 pairs, 125k at N=500) is small and parallel.
//
// Design, one launch a call on the caller's stream, no copy to the host:
//  - a thread-block cluster per image (up to 8 CTAs). Its CTAs build the
//    image's IoU bitmask in 64x64 tiles of the upper triangle, dealt round
//    the CTAs: a tile's 64 column boxes (and their areas) are staged in
//    shared memory, then a thread owns one row and builds the 64-bit word
//    of later columns that the row suppresses. The IoU's terms follow
//    _iou_plus_one's op order and the build passes -fmad=false; iou >= thr
//    is read from a fast approximate quotient where that lies clear of
//    thr (2^-19 of it), and from the IEEE quotient elsewhere, so the bits
//    are the plain PyTorch version's with no IEEE division on the common
//    path and no branch in the tile's loop. The words go into
//    rank 0's shared memory (distributed shared memory stores, after a
//    cluster barrier) while the
//    bitmask fits there (N <= 1,320), else into device memory (the
//    wrapper's scratch), which rank 0 then reads back 64 rows at a time.
//  - rank 0 stages `valid` as bit words (invalid rows start removed),
//    waits on the cluster barrier, and walks the 64-row blocks: thread 0
//    resolves the block's 64 greedy steps in registers against the
//    block's diagonal words, which do not depend on the chain and are
//    loaded 16 rows ahead of their steps (no load waits and no barrier
//    inside the chain: a step is a bit test and a predicated OR); then
//    one warp a later word ORs the kept rows' words into the removed
//    bits, 64 rows across 32 lanes and a warp reduction.
// So a call at N=500 is set by the cluster's IoU build and the chain (8
// blocks of 64 dependent bit-test-and-OR steps), not by memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = kThreads / kBlock;  // tiles a CTA builds at once
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kAhead = 16;                 // chain rows loaded ahead of their steps
constexpr size_t kMaxSmem = 227 * 1024 - kSlots * kBlock * 20;  // less the static

// The IoU's numerator and denominator, in the op order of
// maskrcnn_tpu.ops.nms._iou_plus_one with a the earlier row; boxes
// (y1, x1, y2, x2) in (x, y, z, w).
__device__ __forceinline__ void iou_terms(float4 a, float area_a, float4 b, float area_b,
                                          float& inter, float& uni) {
  const float yy1 = fmaxf(a.x, b.x);
  const float xx1 = fmaxf(a.y, b.y);
  const float yy2 = fminf(a.z, b.z);
  const float xx2 = fminf(a.w, b.w);
  const float w = fmaxf(xx2 - xx1 + 1.0f, 0.0f);
  const float h = fmaxf(yy2 - yy1 + 1.0f, 0.0f);
  inter = w * h;
  uni = area_a + area_b - inter;
}

// One greedy step, row j of a 64-row block: unless bit j of rem is set
// (the row is removed), OR the row's diagonal word d into rem. The
// compiler predicates it: a bit test and an OR in registers.
__device__ __forceinline__ void chain_step(u64& rem, int j, u64 d) {
  if (!((rem >> j) & 1ull)) rem |= d;
}

__device__ __forceinline__ float area(float4 b) {
  return (b.w - b.y + 1.0f) * (b.z - b.x + 1.0f);
}

// the 64 threads of one tile slot
__device__ __forceinline__ void slot_sync(int slot) {
  asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(kBlock) : "memory");
}

// Shared memory of rank 0: removed [words], kept [words], then the
// bitmask rows [n, words] when they fit (else they live in `scratch`).
__global__ void __launch_bounds__(kThreads, 1)
nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
           int n, float thr, u64* scratch, uint8_t* __restrict__ keep) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned ranks = cluster.num_blocks();
  const int img = blockIdx.y;
  const int words = (n + kBlock - 1) / kBlock;
  extern __shared__ u64 smem[];
  __shared__ float4 col_box[kSlots][kBlock];
  __shared__ float col_area[kSlots][kBlock];
  u64* removed = smem;
  u64* kept = smem + words;
  u64* rows = scratch ? scratch + static_cast<size_t>(img) * n * words
                      : smem + 2 * words;
  // where every CTA of the cluster writes the rows: rank 0's
  u64* rows0 = scratch ? rows : cluster.map_shared_rank(rows, 0);
  const float4* ib = boxes + static_cast<size_t>(img) * n;

  // 1. the bitmask: tile t of the upper triangle is (bi, bj), bj >= bi;
  // tiles go round the cluster's CTAs, then their slots
  const int tiles = words * (words + 1) / 2;
  const int slot = threadIdx.x / kBlock;
  const int r = threadIdx.x % kBlock;
  // every CTA of the cluster runs before another stores into its shared
  // memory (the distributed shared memory rule)
  if (!scratch) cluster.sync();
  for (int t = rank + slot * ranks; t < tiles; t += ranks * kSlots) {
    int bi = 0, rest = t;
    while (rest >= words - bi) {
      rest -= words - bi;
      ++bi;
    }
    const int bj = bi + rest;
    const int cols = min(n - bj * kBlock, kBlock);
    const float4 c = ib[bj * kBlock + min(r, cols - 1)];
    col_box[slot][r] = c;
    col_area[slot][r] = area(c);
    slot_sync(slot);  // the tile's columns are staged
    const int row = bi * kBlock + r;
    if (row < n) {
      const float4 a = ib[row];
      const float area_a = area(a);
      // iou >= thr decided from an approximate quotient (2 ulp) where it
      // lies 2^-19 of thr or more from thr: the IEEE quotient is then on
      // the same side. The others (and operands outside the
      // approximation's range, NaN, or thr outside [2^-100, 2^100]) take
      // the IEEE division after the loop, which stays free of branches.
      const bool fast = thr >= 0x1p-100f && thr <= 0x1p100f;
      const float thr_hi = thr * (1.0f + 0x1p-19f), thr_lo = thr * (1.0f - 0x1p-19f);
      u64 bits = 0, exact = 0;
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        float inter, uni;
        iou_terms(a, area_a, col_box[slot][j], col_area[slot][j], inter, uni);
        const float q = __fdividef(inter, uni);
        const bool sure = fast && uni >= 0x1p-126f && uni <= 0x1p126f &&
                          inter >= 0.0f && inter <= 0x1p126f;
        bits |= static_cast<u64>(sure && q >= thr_hi) << j;
        exact |= static_cast<u64>(!sure || (q > thr_lo && q < thr_hi)) << j;
      }
      while (exact) {
        const int j = __ffsll(static_cast<long long>(exact)) - 1;
        exact &= exact - 1;
        float inter, uni;
        iou_terms(a, area_a, col_box[slot][j], col_area[slot][j], inter, uni);
        if (inter / uni >= thr) bits |= 1ull << j;
      }
      if (cols < kBlock) bits &= (1ull << cols) - 1ull;  // columns of the image
      if (bi == bj) bits &= r == kBlock - 1 ? 0ull : ~0ull << (r + 1);  // later
      rows0[static_cast<size_t>(row) * words + bj] = bits;
    }
    slot_sync(slot);  // read before the next tile's columns land
  }

  // 2. rank 0: valid as bit words; invalid rows and rows past n start
  // removed (words * 64 is a multiple of 32: whole warps take each step)
  if (rank == 0) {
    uint32_t* removed32 = reinterpret_cast<uint32_t*>(removed);
    const uint8_t* iv = valid + static_cast<size_t>(img) * n;
    for (int i = threadIdx.x; i < words * kBlock; i += kThreads) {
      const unsigned alive = __ballot_sync(0xffffffffu, i < n && iv[i]);
      if ((i & 31) == 0) removed32[i >> 5] = ~alive;
    }
  }
  if (scratch) __threadfence();
  cluster.sync();  // every CTA's words are written (release / acquire)
  if (rank != 0) return;

  // 3. the greedy chain, 64 rows at a time: thread 0 resolves the block's
  // 64 steps in registers, the diagonal words of 16 rows loaded ahead of
  // their steps (they do not depend on the chain); then one warp a later
  // word ORs in the kept rows' words, 64 rows over 32 lanes and a warp
  // reduction
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int bi = 0; bi < words; ++bi) {
    const u64* blk = rows + static_cast<size_t>(bi) * kBlock * words;
    if (threadIdx.x == 0) {
      // rows past n are removed from the start; their words are not read
      const int nrows = min(n - bi * kBlock, kBlock);
      u64 rem = removed[bi];
#pragma unroll
      for (int q = 0; q < kBlock; q += kAhead) {
        u64 d[kAhead];
#pragma unroll
        for (int j = 0; j < kAhead; ++j)
          d[j] = q + j < nrows ? blk[static_cast<size_t>(q + j) * words + bi] : 0ull;
#pragma unroll
        for (int j = 0; j < kAhead; ++j) chain_step(rem, q + j, d[j]);
      }
      kept[bi] = ~rem;
    }
    __syncthreads();
    const u64 kw = kept[bi];
    for (int w = bi + 1 + warp; w < words; w += kWarps) {
      u64 v = 0;
      if ((kw >> lane) & 1ull) v = blk[static_cast<size_t>(lane) * words + w];
      if ((kw >> (lane + 32)) & 1ull)
        v |= blk[static_cast<size_t>(lane + 32) * words + w];
      const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
      const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
      if (lane == 0) removed[w] |= (static_cast<u64>(hi) << 32) | lo;
    }
    __syncthreads();
  }
  uint8_t* ik = keep + static_cast<size_t>(img) * n;
  for (int i = threadIdx.x; i < n; i += kThreads)
    ik[i] = static_cast<uint8_t>((kept[i / kBlock] >> (i % kBlock)) & 1ull);
}

size_t resident_smem(int n) {
  const size_t words = (n + kBlock - 1) / kBlock;
  return sizeof(u64) * (2 * words + static_cast<size_t>(n) * words);
}

// One thread: `blocks` x 64 dependent steps of the chain's resolve, on
// words that differ from block to block, and the cycles they took.
__global__ void nms_chain_probe_kernel(const u64* __restrict__ words, int blocks,
                                       u64* out, long long* cycles) {
  u64 d[kBlock];
#pragma unroll
  for (int j = 0; j < kBlock; ++j) d[j] = words[j];
  u64 rem = words[kBlock];
  const long long t0 = clock64();
  for (int b = 0; b < blocks; ++b) {
#pragma unroll
    for (int j = 0; j < kBlock; ++j) chain_step(rem, j, d[j]);
    rem ^= static_cast<u64>(b);
  }
  const long long t1 = clock64();
  *out = rem;
  *cycles = t1 - t0;
}

}  // namespace

extern "C" {

// Words of device scratch an image needs: 0 while its bitmask fits rank
// 0's shared memory (N <= 1,320), else N * ceil(N/64).
long long mrt_nms_scratch_words(int n) {
  if (n < 1 || resident_smem(n) <= kMaxSmem) return 0;
  return static_cast<long long>(n) * ((n + kBlock - 1) / kBlock);
}

// boxes [B, N, 4] float32 (16-byte aligned), valid [B, N] bool (one
// byte), scratch null or [B, mrt_nms_scratch_words(N)] 64-bit words, keep
// [B, N] bool; all device pointers. One launch. Returns its CUDA error
// (0 on success).
int mrt_nms(const float* boxes, const uint8_t* valid, int batch, int n, float thr,
            unsigned long long* scratch, uint8_t* keep, void* stream) {
  if (batch < 1 || n < 1 || (mrt_nms_scratch_words(n) > 0) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (n + kBlock - 1) / kBlock;
  const size_t smem = scratch ? sizeof(u64) * 2 * words : resident_smem(n);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = words * (words + 1) / 2;
  const int ranks = tiles < kMaxCluster ? tiles : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_kernel, reinterpret_cast<const float4*>(boxes),
                           valid, n, thr, reinterpret_cast<u64*>(scratch), keep);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A measurement helper for the chain bound, not part of the port's API.
// words [65] device 64-bit words (64 diagonal words and a start), out [1],
// cycles [1] int64: one thread of `blocks` x 64 chain steps. Returns the
// launch's CUDA error.
int mrt_nms_chain_probe(const unsigned long long* words, int blocks,
                        unsigned long long* out, long long* cycles, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  nms_chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const u64*>(words), blocks, reinterpret_cast<u64*>(out), cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
