// Grouped (K=4) RoIAlign compute skeleton for sm_90a (version 2: the
// first product on the tensor cores, patches resident in shared memory,
// the two products overlapped by warp specialisation).
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
// What bounds it on the H100: operations, 95% of them in the first
// product (73.4 MFLOP a group; 184 GFLOP over the gate's 2,500 groups,
// 0.19 ms at the bf16 tensor-core peak, 0.37 ms for float32 as two TF32
// products). Version 1 ran both products on the CUDA cores and every CTA
// re-read the whole 5.2 MB of patches from L2 for each box of each group
// (52 GB over 2,500 groups), at 22% of the float32 CUDA-core bound.
//
// Design:
//  - A CTA holds a slice of the patches' channels, all 128 rows x 40 x
//    (bf16: 8 channels, 80 KB; float32: 4 channels, 80 KB), loaded once
//    into shared memory, and walks a range of groups: 128 CTAs.
//  - Ten mma warps run the first product transposed, T^T = P^T Wy^T,
//    with mma.sync: the slice's patch columns are the M side (bf16: 20
//    tiles of 16, two a warp; float32: 10, one a warp), Wy padded from 28
//    to 32 rows is the N side (4 tiles of 8), the 128 patch rows the
//    depth. bf16 patches: m16n8k16 bf16 products with float32 sums; the
//    values and 0.25 / 0.75 are exact, so every product is exact. The A
//    fragments (the patches) do not change from group to group, so each
//    warp loads its own once and holds them in registers; only Wy's B
//    fragments come from shared memory per group. float32 patches:
//    m16n8k8 TF32 on a high part, hi = tf32(p), and a low part,
//    tf32(p - hi), of each value (Wy is exact in TF32): two products
//    leave an error near 2^-22 of the value; the split parts would take
//    4x the registers, so they are made from shared memory per group.
//  - The accumulators are staged in shared memory as T[q][c][x] (a pitch
//    per q of 4 mod 16 words and per c of an odd count: the fragments'
//    stores are free of bank conflicts), two buffers deep, and four
//    product warps run the second product (5% of the operations) on the
//    CUDA cores, a thread owning items (7k+b, c) and each item's 7 sums
//    over a. While the mma warps take group i, the product warps take
//    group i-1; two barriers a group. Shared memory's bandwidth, which
//    both phases use (fragments, staging, T and Wx reads), sets the
//    pace more than either unit.
//  - Wy and Wx are kept dense in shared memory (Wx two buffers deep) and
//    rewritten per group: only their nonzeros move, so a group clears the
//    entries an earlier group set and writes its own (the products stay
//    dense).
//  - Only the CTAs that run group n-1 store; an empty asm on the sums
//    keeps the other groups' second product from being dropped as dead
//    code, and the staging stores keep the first product's mma.sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 4;
constexpr int kPool = 7;
constexpr int kPatch = 32;
constexpr int kPx = 40;
constexpr int kC = 256;
constexpr int kRows = kK * kPatch;  // 128 patch rows: the first product's depth
constexpr int kQ = kK * kPool;      // 28 output rows of a group
constexpr int kQPad = 32;           // ... padded to 4 n-tiles of 8
constexpr int kMmaWarps = 10;
constexpr int kCtas = 128;
constexpr int kXP = 41;             // T staging: c pitch (odd)

// Per operand type: channels a CTA holds and the pitches that keep the
// fragment loads free of bank conflicts.
template <typename T> struct Plan;
template <> struct Plan<__nv_bfloat16> {
  static constexpr int kCs = 8;
  static constexpr int kWyPitch = 136;  // 68 words, 4 mod 32
  static constexpr int kQP = 340;       // >= kCs * kXP, 4 mod 16
};
template <> struct Plan<float> {
  static constexpr int kCs = 4;
  static constexpr int kWyPitch = 132;  // 4 mod 32 words
  static constexpr int kQP = 164;       // >= kCs * kXP, 4 mod 16
};

template <typename T> struct Shape {
  static constexpr int kCs = Plan<T>::kCs;
  static constexpr int kWy = Plan<T>::kWyPitch;
  static constexpr int kQP = Plan<T>::kQP;
  static constexpr int kSlices = kC / kCs;
  static constexpr int kM = kPx * kCs;            // patch columns a CTA holds
  static constexpr int kPPitch = kM + 8;          // 16 B (bf16) or 8 words
                                                  // (f32) past 128 B
  static constexpr int kMTiles = kM / 16 / kMmaWarps;
  static constexpr int kItems = kQ * kCs;         // second-product items
  static constexpr int kProdWarps = 4;            // 128 threads: 2 items
                                                  // a thread (bf16), 1 (f32)
  static constexpr int kThreads = (kMmaWarps + kProdWarps) * 32;
  static constexpr int kRanges = kCtas / kSlices;
  static constexpr size_t kBytes =
      sizeof(T) * (static_cast<size_t>(kRows) * kPPitch + kQPad * kWy) +
      sizeof(float) * (2 * kQ * kPx + 2 * kQ * kQP);
  static_assert(kMTiles * 16 * kMmaWarps == kM, "m-tiles split evenly");
  static_assert(kQP >= kCs * kXP && kQP % 16 == 4, "T staging pitch");
};

__device__ __forceinline__ void to_operand(float v, float* p) { *p = v; }
__device__ __forceinline__ void to_operand(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: the warp's A fragments (P^T, its m-tiles over all 128 rows) by
// ldmatrix.trans from P [y][m] (rows k, 8 columns m a matrix). They do
// not change from group to group, so a warp loads them once.
template <int MT>
__device__ __forceinline__ void load_a(const __nv_bfloat16* ps, int warp, int lane,
                                       uint32_t (&a)[kRows / 16][MT][4]) {
  using S = Shape<__nv_bfloat16>;
  // lane l addresses row l % 8 of matrix l / 8: (k 0-7 | 8-15) x (m 0-7 | 8-15)
  const int mat = lane >> 3;
  const int lrow = (lane & 7) + (mat >> 1) * 8;
  const int lcol = (mat & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < kRows / 16; ++ks)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = (warp * MT + mt) * 16;
      const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(
          ps + (ks * 16 + lrow) * S::kPPitch + m0 + lcol));
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
          : "=r"(a[ks][mt][0]), "=r"(a[ks][mt][1]), "=r"(a[ks][mt][2]), "=r"(a[ks][mt][3])
          : "r"(addr));
    }
}

// acc[mt][nt] += P^T Wy^T, bf16, the A fragments in registers; B as
// (k, k+1) pairs of a Wy row.
template <int MT>
__device__ __forceinline__ void first_product(const uint32_t (&a)[kRows / 16][MT][4],
                                              const __nv_bfloat16* wy, int lane,
                                              float (&acc)[MT][4][4]) {
  using S = Shape<__nv_bfloat16>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kRows / 16; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const __nv_bfloat16* wrow = wy + (nt * 8 + g) * S::kWy + ks * 16 + 2 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wrow);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wrow + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[ks][mt], b0, b1);
    }
  }
}

// float32: the A fragments split into TF32 high and low parts, two
// products into the same sums.
template <int MT>
__device__ __forceinline__ void first_product(const float* ps, const float* wy,
                                              int warp, int lane,
                                              float (&acc)[MT][4][4]) {
  using S = Shape<float>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < kRows; k0 += 8) {
    uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = (warp * MT + mt) * 16 + g;
      const float v[4] = {ps[(k0 + t) * S::kPPitch + m0], ps[(k0 + t) * S::kPPitch + m0 + 8],
                          ps[(k0 + t + 4) * S::kPPitch + m0],
                          ps[(k0 + t + 4) * S::kPPitch + m0 + 8]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[mt][e] = tf32(v[e]);
        lo[mt][e] = tf32(v[e] - __uint_as_float(hi[mt][e]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* wrow = wy + (nt * 8 + g) * S::kWy + k0 + t;
      const uint32_t b0 = __float_as_uint(wrow[0]);
      const uint32_t b1 = __float_as_uint(wrow[4]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_tf32(acc[mt][nt], lo[mt], b0, b1);
        mma_tf32(acc[mt][nt], hi[mt], b0, b1);
      }
    }
  }
}

// Thread r < 28 moves row r's nonzeros of Wy (one buffer) from group
// `wy_old` to group g, and of the Wx buffer from group `wx_old` to g (a
// negative old group: the row is still zero).
template <typename T>
__device__ __forceinline__ void move_weights(T* wy, float* wx, int r, int g,
                                             int wy_old, int wx_old) {
  constexpr int kWy = Plan<T>::kWyPitch;
  const int ybase = (r / kPool) * kPatch + (r % kPool) * 2;
  const int xbase = (r % kPool) * 2;
  if (wy_old >= 0) {
    to_operand(0.0f, wy + r * kWy + ybase + wy_old % 3);
    to_operand(0.0f, wy + r * kWy + ybase + wy_old % 3 + 1);
  }
  if (wx_old >= 0) {
    wx[r * kPx + xbase + wx_old % 5] = 0.0f;
    wx[r * kPx + xbase + wx_old % 5 + 1] = 0.0f;
  }
  to_operand(0.25f, wy + r * kWy + ybase + g % 3);
  to_operand(0.75f, wy + r * kWy + ybase + g % 3 + 1);
  wx[r * kPx + xbase + g % 5] = 0.5f;
  wx[r * kPx + xbase + g % 5 + 1] = 0.5f;
}

template <typename T>
__global__ void __launch_bounds__(Shape<T>::kThreads, 1)
group_roi_kernel(const T* __restrict__ patches, float* __restrict__ out,
                 int n_groups) {
  using S = Shape<T>;
  constexpr int kCs = S::kCs;
  constexpr int kQP = S::kQP;
  constexpr int MT = S::kMTiles;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ps = reinterpret_cast<T*>(smem);                          // [128][kPPitch]
  T* wy = ps + kRows * S::kPPitch;                             // [32][kWy]
  float* wx = reinterpret_cast<float*>(wy + kQPad * S::kWy);   // 2 x [28][40]
  float* ts = wx + 2 * kQ * kPx;                               // 2 x [28][kQP]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int slice = blockIdx.x % S::kSlices;
  const int range = blockIdx.x / S::kSlices;
  const int ranges = gridDim.x / S::kSlices;
  const int c0 = slice * kCs;
  const int g_begin = static_cast<int>(static_cast<long long>(n_groups) * range / ranges);
  const int count =
      static_cast<int>(static_cast<long long>(n_groups) * (range + 1) / ranges) - g_begin;

  // the slice of the patches, once: [y][x * kCs + c], 16 bytes a copy
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kCs / kVec;
  static_assert(kChunks == 1, "one 16-byte copy a (y, x)");
  for (int e = tid; e < kRows * kPx; e += S::kThreads) {
    const int y = e / kPx, x = e - y * kPx;
    *reinterpret_cast<uint4*>(ps + y * S::kPPitch + x * kCs) =
        *reinterpret_cast<const uint4*>(patches + (y * kPx + x) * kC + c0);
  }
  // the dense weights start as zeros (Wy's padding rows stay zero)
  for (int e = tid; e < kQPad * S::kWy; e += S::kThreads) to_operand(0.0f, wy + e);
  for (int e = tid; e < 2 * kQ * kPx; e += S::kThreads) wx[e] = 0.0f;

  const int g8 = lane >> 2, t4 = lane & 3;
  constexpr bool kBf16 = sizeof(T) == 2;
  // bf16: the mma warps' A fragments, loaded once (float32's high and low
  // parts would take 4x the registers: they are split per group)
  uint32_t a_frag[kBf16 ? kRows / 16 : 1][kBf16 ? MT : 1][4];
  // step i: the mma warps take group g_begin + i, the product warps group
  // g_begin + i - 1
  for (int i = 0; i <= count; ++i) {
    const int g = g_begin + i;
    __syncthreads();  // step i-1 is done: its weights and T buffer are free
    if (tid < kQ && i < count)
      move_weights(wy, wx + (i & 1) * kQ * kPx, tid, g, i > 0 ? g - 1 : -1,
                   i > 1 ? g - 2 : -1);
    __syncthreads();  // group g's weights are written; T of g - 1 is staged

    if (warp < kMmaWarps) {
      if (i == count) continue;
      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      if constexpr (kBf16) {
        if (i == 0) load_a<MT>(ps, warp, lane, a_frag);
        first_product<MT>(a_frag, wy, lane, acc);
      } else {
        first_product<MT>(ps, wy, warp, lane, acc);
      }
      // stage T[q][c][x]: element e of a tile is (m = g8 + 8 (e / 2),
      // q = 2 t4 + e % 2); m = x * kCs + c
      float* tb = ts + (i & 1) * kQ * kQP;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = (warp * MT + mt) * 16 + g8 + 8 * (e >> 1);
            const int q = nt * 8 + 2 * t4 + (e & 1);
            if (q < kQ) tb[q * kQP + (m % kCs) * kXP + m / kCs] = acc[mt][nt][e];
          }
      continue;
    }
    // product warps: the second product of group g - 1, item (7k + b, c),
    // the 7 sums over a
    if (i == 0) continue;
    for (int item = tid - kMmaWarps * 32; item < S::kItems;
         item += S::kProdWarps * 32) {
      const int kb = item / kCs;
      const int c = item - kb * kCs;
      const int k = kb / kPool;
      const float* trow = ts + ((i - 1) & 1) * kQ * kQP + kb * kQP + c * kXP;
      const float* wk = wx + ((i - 1) & 1) * kQ * kPx + k * kPool * kPx;
      float s[kPool];
#pragma unroll
      for (int a = 0; a < kPool; ++a) s[a] = 0.0f;
      for (int x = 0; x < kPx; x += 4) {
        const float tv[4] = {trow[x], trow[x + 1], trow[x + 2], trow[x + 3]};
#pragma unroll
        for (int a = 0; a < kPool; ++a) {
          const float4 w = *reinterpret_cast<const float4*>(wk + a * kPx + x);
          s[a] = __fmaf_rn(w.x, tv[0], s[a]);
          s[a] = __fmaf_rn(w.y, tv[1], s[a]);
          s[a] = __fmaf_rn(w.z, tv[2], s[a]);
          s[a] = __fmaf_rn(w.w, tv[3], s[a]);
        }
      }
      // every group's sums are computed, though only group n-1 stores
#pragma unroll
      for (int a = 0; a < kPool; ++a) asm volatile("" : "+f"(s[a]));
      if (g - 1 == n_groups - 1) {
        const int b = kb - k * kPool;
#pragma unroll
        for (int a = 0; a < kPool; ++a)
          out[((k * kPool + a) * kPool + b) * kC + c0 + c] = s[a];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* patches, int n_groups, float* out, cudaStream_t s) {
  using S = Shape<T>;
  const int ranges = n_groups < S::kRanges ? n_groups : S::kRanges;
  cudaError_t err = cudaFuncSetAttribute(
      group_roi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return err;
  group_roi_kernel<T><<<S::kSlices * ranges, S::kThreads, S::kBytes, s>>>(
      static_cast<const T*>(patches), out, n_groups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// patches: [128, 40, 256] contiguous, 16-byte aligned, dtype 0 = float32
// (two TF32 products), 1 = bfloat16; out: [4, 7, 7, 256] float32, group
// n_groups-1's result. Returns the CUDA error of the launch.
int mrt_group_roi(const void* patches, int dtype, int n_groups, float* out,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(launch<float>(patches, n_groups, out, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(patches, n_groups, out, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
