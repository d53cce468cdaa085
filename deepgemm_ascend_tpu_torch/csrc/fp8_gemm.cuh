// Blockwise-scaled FP8 GEMM routines shared by the dense (fp8_gemm.cu, K1)
// and grouped (grouped_gemm.cu, K3 and K8) kernels.
//
// Computes C = sum_g (A_g . B_g) * a_s[:, g] * b_s[g, :] over 128-deep K
// groups g, in group order, with an f32 accumulator -- the function of
// deepgemm_ascend_tpu/ops/fp8_gemm.py:_fp8_gemm_kernel_blocked (and its
// single-K-step twin _fp8_gemm_kernel_static).
//
// The arithmetic of one output element, which both routines below share
// exactly (so that they agree bit for bit on the same operands):
//   * e4m3 -> f16 is exact (cvt.rn.f16x2.e4m3x2), and the f16 tensor-core
//     product mma.m16n8k16 accumulates exact products in f32: the group
//     partial p_g is the f32 accumulator of eight m16n8k16 steps, from 0;
//   * inside one m16n8k16 step the 16 k indices are permuted identically
//     for A and B (thread t holds k = 16 ks + 4t .. 4t + 3: one 32-bit word
//     a row), which changes nothing in a product;
//   * the partial is scaled into the running accumulator on the CUDA cores
//     in group order: acc = acc + (p_g * a_s) * b_s, each step rounded as
//     written (__fmul_rn, __fadd_rn: never contracted);
//   * one rounding to the output type at the end.
// A row's place in an m16 fragment (row % 16) and a column's in an n8
// fragment (col % 8) are the same in every tile of both routines.
//
// gemm_tile, the "tile" route (any layout of B, any 16-byte alignment):
// one block of 4 warps per 64x64 output tile, synchronous 16-byte loads of
// each 128-deep group into shared memory (144-byte row pitch), then the
// math. Nothing is in flight while the math runs, so a block takes one
// DRAM round trip per group. It stays for b_layout='n' (K1, K3, K8) and
// for K8's layouts whose block_m 64 does not divide.
//
// ring_kernel, the "ring" route (B K-major, TMA-describable operands):
//   * a ring of stages in shared memory, one 128-deep scale group each (a
//     box of BM activation rows and a box of BN weight rows of 128 bytes,
//     loaded by TMA with the 128-byte swizzle), filled by one producer warp
//     as soon as a stage is released, so that STAGES groups are in flight
//     while the consumer warps compute;
//   * consumer warps read their fragments as 32-bit words from the swizzled
//     stage (byte (row, kk) at row*128 + ((kk/16 ^ row%8) << 4) + kk%16:
//     eight rows x four threads hit 32 distinct banks), convert, run the
//     eight m16n8k16 steps, release the stage, and promote the partial with
//     the group's scales, which they read from L2 a group ahead;
//   * tiles by m (mma's own M is 16): 16 x 64 at decode (one warp row, the
//     warps split N), 64 x 64 beyond, three blocks an SM; an m16 fragment
//     past the valid rows (m, or masked_m[e]) is neither computed nor
//     promoted;
//   * the producer warp's lanes also copy each group's scales (BM row and
//     BN column scales) beside the stage (cp.async, tracked by the same
//     full barrier), so the consumers read them from shared memory;
//   * a 3-D map (batch = expert for K3) keeps every box inside its expert;
//     a K3 tile at or past masked_m[e] loads nothing and stores zeros;
//   * split groups (K1 only, where the tiles are too few to fill the card):
//     the `splits` CTAs of a cluster each run a contiguous range of groups
//     from acc = 0, and CTA 0 adds the others' accumulators, read through
//     distributed shared memory, in rank order. That changes only the f32
//     order of the group sum; splits == 1 keeps the arithmetic above.
// Bound on the card: the weight bytes at decode (m <= 64), which the ring
// keeps streaming (and the splits spread over the SMs); the tensor cores
// at prefill, where the f16 mma.sync runs at most at half the fp8 wgmma
// rate (the fp8 wgmma sum keeps fewer bits than the f32 checks hold K1 to;
// that route is later work).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace dga {

constexpr int kGroup = 128;               // quantisation block along K
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kThreads = 128;              // 4 warps in a 2 x 2 layout
constexpr int kPitch = kGroup + 16;        // smem row pitch in bytes

__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t two_bytes) {
  __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two_bytes & 0xffffu), __NV_E4M3);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

__device__ __forceinline__ void mma_f16_f32(float c[4], const uint32_t a[4],
                                            const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_pair(float* c, float x, float y) {
  *reinterpret_cast<float2*>(c) = make_float2(x, y);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* c, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(x, y);
}

struct GemmArgs {
  const uint8_t* a;      // (m, k) e4m3, row-major, k contiguous
  const float* a_s;      // a_s[row * k_blocks + g]
  const uint8_t* b;      // element (kk, col) at b[kk * sbk + col * sbn]
  const float* b_s;      // scale (g, col) at b_s[g * bs_g + (col >> bs_shift) * bs_n]
  int m, n, k;
  long long sbk, sbn;
  long long bs_g, bs_n;
  int bs_shift;
};

// Writes zeros over the tile (m0, n0) of c (m x n, row-major).
template <typename OutT>
__device__ void zero_tile(OutT* c, int m, int n, int m0, int n0) {
  for (int idx = threadIdx.x; idx < kBM * kBN / 2; idx += kThreads) {
    const int r = idx / (kBN / 2);
    const int col = (idx % (kBN / 2)) * 2;
    if (m0 + r < m) store_pair(c + (size_t)(m0 + r) * n + n0 + col, 0.f, 0.f);
  }
}

template <bool B_KMAJOR, typename OutT>
__device__ void gemm_tile(const GemmArgs& p, OutT* c, int m0, int n0) {
  __shared__ __align__(16) uint8_t As[kBM * kPitch];
  __shared__ __align__(16) uint8_t Bs[kBN * kPitch];
  __shared__ float sa[kBM];
  __shared__ float sb[kBN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int k_blocks = p.k / kGroup;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  for (int g = 0; g < k_blocks; ++g) {
    const int kbase = g * kGroup;
    // A tile: 64 rows x 128 bytes = 512 16-byte chunks.
#pragma unroll
    for (int it = 0; it < (kBM * kGroup / 16) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx >> 3, ch = (idx & 7) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < p.m)
        v = *reinterpret_cast<const uint4*>(p.a + (size_t)(m0 + r) * p.k + kbase + ch);
      *reinterpret_cast<uint4*>(As + r * kPitch + ch) = v;
    }
    // B tile, stored n-major in shared memory (k contiguous per column).
    if (B_KMAJOR) {
#pragma unroll
      for (int it = 0; it < (kBN * kGroup / 16) / kThreads; ++it) {
        const int idx = tid + it * kThreads;
        const int r = idx >> 3, ch = (idx & 7) * 16;
        const uint4 v = *reinterpret_cast<const uint4*>(
            p.b + (size_t)(n0 + r) * p.sbn + kbase + ch);
        *reinterpret_cast<uint4*>(Bs + r * kPitch + ch) = v;
      }
    } else {
      for (int idx = tid; idx < kBN * kGroup; idx += kThreads) {
        const int kk = idx / kBN, col = idx % kBN;
        Bs[col * kPitch + kk] =
            p.b[(size_t)(kbase + kk) * p.sbk + (size_t)(n0 + col) * p.sbn];
      }
    }
    if (tid < kBM) {
      sa[tid] = (m0 + tid < p.m) ? p.a_s[(size_t)(m0 + tid) * k_blocks + g] : 0.f;
    } else {
      const int col = n0 + tid - kBM;
      sb[tid - kBM] = p.b_s[(size_t)g * p.bs_g + (size_t)(col >> p.bs_shift) * p.bs_n];
    }
    __syncthreads();

    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[i][j][v] = 0.f;

#pragma unroll
    for (int ks = 0; ks < kGroup / 16; ++ks) {
      const int kofs = ks * 16 + tig * 4;
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + gid;
        const uint32_t lo = *reinterpret_cast<const uint32_t*>(As + r * kPitch + kofs);
        const uint32_t hi = *reinterpret_cast<const uint32_t*>(As + (r + 8) * kPitch + kofs);
        af[i][0] = e4m3x2_to_f16x2(lo);
        af[i][1] = e4m3x2_to_f16x2(hi);
        af[i][2] = e4m3x2_to_f16x2(lo >> 16);
        af[i][3] = e4m3x2_to_f16x2(hi >> 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + gid;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(Bs + col * kPitch + kofs);
        bf[j][0] = e4m3x2_to_f16x2(w);
        bf[j][1] = e4m3x2_to_f16x2(w >> 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_f16_f32(part[i][j], af[i], bf[j]);
    }

    // Dequant in the accumulator, in group order: acc += (p_g * a_s) * b_s.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm * 32 + i * 16 + gid;
      const float s_lo = sa[r], s_hi = sa[r + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + tig * 2;
        const float b0 = sb[col], b1 = sb[col + 1];
        acc[i][j][0] = __fadd_rn(acc[i][j][0], __fmul_rn(__fmul_rn(part[i][j][0], s_lo), b0));
        acc[i][j][1] = __fadd_rn(acc[i][j][1], __fmul_rn(__fmul_rn(part[i][j][1], s_lo), b1));
        acc[i][j][2] = __fadd_rn(acc[i][j][2], __fmul_rn(__fmul_rn(part[i][j][2], s_hi), b0));
        acc[i][j][3] = __fadd_rn(acc[i][j][3], __fmul_rn(__fmul_rn(part[i][j][3], s_hi), b1));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + wm * 32 + i * 16 + gid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + tig * 2;
      if (r < p.m) store_pair(c + (size_t)r * p.n + col, acc[i][j][0], acc[i][j][1]);
      if (r + 8 < p.m) store_pair(c + (size_t)(r + 8) * p.n + col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

// ------------------------------------------------------------ the ring route

// Internal linkage: fp8_gemm.cu and grouped_gemm.cu each build their own
// instances into their own library.
namespace {
namespace ring {

namespace s9 = sm90;

// A ring tile: BM x BN outputs computed by WARPS_M x WARPS_N consumer warps
// (each a WM x WN warp tile of FM x FN mma fragments) fed by one producer
// warp, with STAGES scale groups in flight.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kMinBlocks = MIN_BLOCKS_;   // blocks an SM (caps registers)
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int FM = WM / 16, FN = WN / 8;
  static constexpr int kConsumers = WARPS_M * WARPS_N;
  static constexpr int kThreads = (kConsumers + 1) * 32;
  static constexpr int kA = BM * kGroup, kB = BN * kGroup, kStage = kA + kB;
  static constexpr int kRing = STAGES * kStage;
  static constexpr int kScales = BM + BN;          // floats of a stage's scale slot
  // The ring, its scale slots, its full and empty barriers, and the slack
  // to round the base up to the 1024-byte swizzle period.
  static constexpr int kSmem = kRing + STAGES * kScales * 4 + 2 * STAGES * 8 + 1024;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "whole mma fragments");
  static_assert(kA % 1024 == 0, "B's box starts on the swizzle period");
  static_assert(BM * BN * 4 <= kRing, "a split's partials fit in the ring");
};

// The tiles, in the order of the wrappers' index (ops/fp8_gemm.py
// RING_TILES), as (rows, columns, warp rows, warp columns, stages, blocks
// an SM): 16 x 64 at decode (m <= 16; four warps split N, 42 KB, up to
// five blocks an SM), 64 x 64 beyond (2 x 2 warps of 32 x 32, 67 KB, three
// blocks an SM: registers capped at 128). Chosen by measurement
// (scripts/ring_sweep.py): a 128 x 128 tile with eight consumer warps ran
// slower at prefill than three 64 x 64 blocks an SM.
using Tile16 = Tile<16, 64, 1, 4, 4, 1>;
using Tile64 = Tile<64, 64, 2, 2, 4, 3>;
constexpr int kMaxSplits = 8;   // a portable cluster

struct RingArgs {
  const float* a_s;     // a_s[(e * m + row) * k_blocks + g]
  const float* b_s;     // scale (e, g, col) at b_s[e * bs_e + g * bs_g + (col >> bs_shift) * bs_n]
  const int* masked_m;  // K3: the valid rows of expert e; K1: null (all m rows)
  void* c;              // (batch, m, n), row-major
  int m, n, k;          // m: rows of one batch element (K3: M_max)
  long long bs_e, bs_g, bs_n;
  int bs_shift;
  int splits;           // CTAs of a cluster that split the groups; 1: none
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The 16 bytes at `local` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ float4 load_remote(const float4* local, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(s9::smem_u32(local)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Zeros over rows [m0, min(m0 + BM, m)) x columns [n0, n0 + BN) of c, in
// 16-byte stores by the `threads` threads numbered from 0 (n is a multiple
// of BN, c 16-byte aligned).
template <typename T, typename OutT>
__device__ void zero_rows(OutT* c, int m, int n, int m0, int n0, int threads) {
  constexpr int kVec = 16 / (int)sizeof(OutT);
  constexpr int kPerRow = T::BN / kVec;
  for (int i = threadIdx.x; i < T::BM * kPerRow; i += threads) {
    const int r = m0 + i / kPerRow;
    if (r < m)
      *reinterpret_cast<uint4*>(c + (size_t)r * n + n0 + (i % kPerRow) * kVec) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// The warp's accumulators to rows [row0, row0 + WM) and columns [col0,
// col0 + WN) of c (m x n, row-major), rounded once to OutT, rows past m
// dropped.
template <typename T, typename OutT>
__device__ __forceinline__ void store_acc(const float (&acc)[T::FM][T::FN][4], OutT* c, int m,
                                          int n, int row0, int col0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * i + gid + 8 * h;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        store_pair(c + (size_t)r * n + col0 + 8 * j + 2 * tig, acc[i][j][2 * h],
                   acc[i][j][2 * h + 1]);
    }
}

// One stage (scale group) for one consumer warp: the scales of its rows
// and columns from the stage's scale slot, the eight m16n8k16 steps into
// a zeroed partial, the slot handed back, then the promotion into acc.
// FULL: every m16 fragment of the warp holds valid rows (no checks).
template <typename T, bool FULL>
__device__ __forceinline__ void consume_stage(float (&acc)[T::FM][T::FN][4], const uint8_t* st,
                                              const float* ss, const bool (&act)[T::FM],
                                              int rbase, int cbase, uint64_t* empty_bar) {
  constexpr int FM = T::FM, FN = T::FN;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  // The scales (0 past m, as gemm_tile) into registers before the slot
  // is handed back.
  float sa[FM][2], sb[FN][2];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
    sa[i][0] = ss[rbase + 16 * i + gid];
    sa[i][1] = ss[rbase + 16 * i + gid + 8];
  }
#pragma unroll
  for (int j = 0; j < FN; ++j) {
    sb[j][0] = ss[T::BM + cbase + 8 * j + 2 * tig];
    sb[j][1] = ss[T::BM + cbase + 8 * j + 2 * tig + 1];
  }
  const uint8_t* sa_ = st;
  const uint8_t* sb_ = st + T::kA;
  float part[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) part[i][j][v] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kGroup / 16; ++ks) {
    // Rows (and B's columns) gid + 8q all have row % 8 == gid: the
    // swizzled place of this thread's word in chunk ks.
    const int ofs = ((ks ^ gid) << 4) + tig * 4;
    uint32_t af[FM][4], bf[FN][2];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      if (!FULL && !act[i]) continue;
      const int r = rbase + 16 * i + gid;
      const uint32_t lo = *reinterpret_cast<const uint32_t*>(sa_ + r * kGroup + ofs);
      const uint32_t hi = *reinterpret_cast<const uint32_t*>(sa_ + (r + 8) * kGroup + ofs);
      af[i][0] = e4m3x2_to_f16x2(lo);
      af[i][1] = e4m3x2_to_f16x2(hi);
      af[i][2] = e4m3x2_to_f16x2(lo >> 16);
      af[i][3] = e4m3x2_to_f16x2(hi >> 16);
    }
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int col = cbase + 8 * j + gid;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(sb_ + col * kGroup + ofs);
      bf[j][0] = e4m3x2_to_f16x2(w);
      bf[j][1] = e4m3x2_to_f16x2(w >> 16);
    }
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      if (!FULL && !act[i]) continue;
#pragma unroll
      for (int j = 0; j < FN; ++j) mma_f16_f32(part[i][j], af[i], bf[j]);
    }
  }
  // The stage's words and scales are in registers: hand the slot back.
  __syncwarp();
  if (lane == 0) s9::mbar_arrive(empty_bar);
#pragma unroll
  for (int i = 0; i < FM; ++i) {
    if (!FULL && !act[i]) continue;
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        acc[i][j][v] = __fadd_rn(acc[i][j][v],
                                 __fmul_rn(__fmul_rn(part[i][j][v], sa[i][v >> 1]), sb[j][v & 1]));
  }
}

// K3 CTAs walk the m-tiles y, y + Y, ... of their (expert, n-tile), with
// Y = ceil(m-tiles / kTilesPerCta), and at least 2 for 64-row tiles: the
// tiles past masked_m[e] (most of the buffer) are zeroed by the CTA that
// walks them, after its valid tiles, rather than by CTAs of their own, and
// the valid tiles, which come first, are spread over the Y CTAs (the
// 16-row tile runs at decode capacity, where an expert's valid rows fit
// one tile). K1 runs one m-tile a CTA.
constexpr int kTilesPerCta = 8;

// Grid (n / BN * splits, Y, batch); with splits > 1 launched in clusters of
// `splits` CTAs along x. Threads: the consumer warps, then the producer
// warp. Shared memory: the ring's stages, their scale slots (BM row scales
// then BN column scales a stage), the full and empty barriers.
template <typename T, typename OutT>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    ring_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                RingArgs p) {
  constexpr int FM = T::FM, FN = T::FN, kCons = T::kConsumers * 32;
  constexpr int kScales = T::kScales;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = s9::aligned_smem(smem_raw);
  float* scales = reinterpret_cast<float*>(ring + T::kRing);
  uint64_t* full = reinterpret_cast<uint64_t*>(scales + T::STAGES * kScales);
  uint64_t* empty = full + T::STAGES;
  const int split = blockIdx.x % p.splits;   // the CTA's rank in its cluster
  const int n0 = blockIdx.x / p.splits * T::BN;
  const int e = blockIdx.z;
  const int tiles_m = (p.m + T::BM - 1) / T::BM;
  const int rows = p.masked_m ? min(p.masked_m[e], p.m) : p.m;
  OutT* c = static_cast<OutT*>(p.c) + (size_t)e * p.m * p.n;
  const int k_blocks = p.k / kGroup;
  const int per = (k_blocks + p.splits - 1) / p.splits;
  const int g0 = min(split * per, k_blocks), g1 = min(g0 + per, k_blocks);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) {
      // full: the producer's expect_tx arrival and each producer lane's
      // once its scale copies have landed; empty: one per consumer warp.
      s9::mbar_init(&full[i], 33);
      s9::mbar_init(&empty[i], T::kConsumers);
    }
    s9::fence_barrier_init();
  }
  __syncthreads();

  const int rbase = warp / T::WARPS_N * T::WM;   // the warp tile in the block tile
  const int cbase = warp % T::WARPS_N * T::WN;
  float acc[FM][FN][4];
  int m0 = 0;
  if (warp == T::kConsumers) {
    // The producer: each valid tile's groups into the ring, slot j %
    // STAGES once it is empty, with the group's scales copied beside it
    // by the warp's lanes (cp.async, each lane's arrival on the full
    // barrier once its copies land: nothing waits for them here, so the
    // stages are issued as fast as slots free up).
    const float* a_s = p.a_s + (size_t)e * p.m * k_blocks;
    const float* b_s = p.b_s + (size_t)e * p.bs_e;
    int j = 0;
    for (int mt = blockIdx.y; mt < tiles_m && mt * T::BM < rows; mt += gridDim.y) {
      const int t0 = mt * T::BM;
      for (int g = g0; g < g1; ++g, ++j) {
        const int s = j % T::STAGES;
        if (lane == 0) {
          s9::mbar_wait(&empty[s], ((j / T::STAGES) & 1) ^ 1);
          s9::mbar_expect_tx(&full[s], T::kStage);
          uint8_t* st = ring + s * T::kStage;
          s9::tma_load(st, &ta, &full[s], g * kGroup, t0, e);
          s9::tma_load(st + T::kA, &tb, &full[s], g * kGroup, n0, e);
        }
        __syncwarp();
        float* ss = scales + s * kScales;
        for (int idx = lane; idx < kScales; idx += 32) {
          if (idx < T::BM) {
            // 0 past m, as gemm_tile.
            const bool in = t0 + idx < p.m;
            s9::copy4_async(ss + idx, a_s + (size_t)(in ? t0 + idx : 0) * k_blocks + g, in);
          } else {
            const int col = n0 + idx - T::BM;
            s9::copy4_async(ss + idx,
                        b_s + (size_t)g * p.bs_g + (size_t)(col >> p.bs_shift) * p.bs_n, true);
          }
        }
        s9::arrive_after_copies(&full[s]);
      }
    }
  } else {
    int j = 0;
    for (int mt = blockIdx.y; mt < tiles_m; mt += gridDim.y) {
      m0 = mt * T::BM;
      if (m0 >= rows) {
        // K3 only (every K1 tile holds rows, so no CTA of a cluster gets
        // here): a tile past masked_m[e] is zeros.
        zero_rows<T>(c, p.m, p.n, m0, n0, kCons);
        continue;
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int jn = 0; jn < FN; ++jn)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][jn][v] = 0.f;
      // A fragment whose first row is past the valid rows is skipped; a
      // warp whose first one is skipped only passes the stages on.
      bool act[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) act[i] = m0 + rbase + 16 * i < rows;
      const bool full_tile = m0 + T::BM <= rows;
      for (int g = g0; g < g1; ++g, ++j) {
        const int s = j % T::STAGES;
        s9::mbar_wait(&full[s], (j / T::STAGES) & 1);
        const uint8_t* st = ring + s * T::kStage;
        const float* ss = scales + s * kScales;
        if (!act[0]) {
          __syncwarp();
          if (lane == 0) s9::mbar_arrive(&empty[s]);
        } else if (full_tile) {
          consume_stage<T, true>(acc, st, ss, act, rbase, cbase, &empty[s]);
        } else {
          consume_stage<T, false>(acc, st, ss, act, rbase, cbase, &empty[s]);
        }
      }
      if (p.splits == 1) store_acc<T>(acc, c, p.m, p.n, m0 + rbase, n0 + cbase);
    }
  }
  if (p.splits == 1) return;

  // Every thread of every CTA of the cluster gets here, with one m-tile
  // each. The last stage has been read (the block barrier), so the ring
  // takes this CTA's partial accumulators; CTA 0 adds the others' in rank
  // order and stores the sums.
  const bool consumer = warp < T::kConsumers;
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(ring);
  if (consumer) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int jn = 0; jn < FN; ++jn)
        red[(i * FN + jn) * kCons + threadIdx.x] =
            make_float4(acc[i][jn][0], acc[i][jn][1], acc[i][jn][2], acc[i][jn][3]);
  }
  cluster_sync();
  if (split == 0 && consumer) {
    for (int r = 1; r < p.splits; ++r) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int jn = 0; jn < FN; ++jn) {
          const float4 v = load_remote(&red[(i * FN + jn) * kCons + threadIdx.x], r);
          acc[i][jn][0] = __fadd_rn(acc[i][jn][0], v.x);
          acc[i][jn][1] = __fadd_rn(acc[i][jn][1], v.y);
          acc[i][jn][2] = __fadd_rn(acc[i][jn][2], v.z);
          acc[i][jn][3] = __fadd_rn(acc[i][jn][3], v.w);
        }
    }
    store_acc<T>(acc, c, p.m, p.n, m0 + rbase, n0 + cbase);
  }
  // No CTA leaves (its shared memory) before CTA 0 has read it.
  cluster_sync();
}

// Launches the ring over `batch` elements: A (batch, m, k) dense, B (batch,
// n, k) K-major with batch pitch b_batch bytes. 0, or the error of a map
// TMA cannot describe, a refused attribute or launch.
template <typename T, typename OutT>
int run(const void* a, const void* b, long long b_batch, int batch, const RingArgs& p,
        cudaStream_t s) {
  if (p.n % T::BN || p.splits < 1 || p.splits > kMaxSplits || (p.masked_m && p.splits != 1))
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap ta, tb;
  int rc = s9::make_map(&ta, u8, 1, a, p.k, p.m, batch, p.k, (uint64_t)p.m * p.k, kGroup, T::BM,
                        sw);
  if (rc) return rc;
  rc = s9::make_map(&tb, u8, 1, b, p.k, p.n, batch, p.k, b_batch, kGroup, T::BN, sw);
  if (rc) return rc;
  const int tiles_m = (p.m + T::BM - 1) / T::BM;
  const int y = !p.masked_m ? tiles_m
                            : max((tiles_m + kTilesPerCta - 1) / kTilesPerCta,
                                  T::BM == 16 ? 1 : min(tiles_m, 2));
  const dim3 grid(p.n / T::BN * p.splits, y, batch);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  void (*kernel)(CUtensorMap, CUtensorMap, RingArgs) = ring_kernel<T, OutT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  if (p.splits == 1) {
    kernel<<<grid, T::kThreads, T::kSmem, s>>>(ta, tb, p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  RingArgs q = p;
  void* args[] = {&ta, &tb, &q};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The ring for tile index `tile` (Tile16, Tile64) and the output type; an
// unknown index is refused.
inline int launch(int tile, int out_f32, const void* a, const void* b, long long b_batch,
                  int batch, const RingArgs& p, cudaStream_t s) {
  switch (tile * 2 + (out_f32 ? 1 : 0)) {
    case 0: return run<Tile16, __nv_bfloat16>(a, b, b_batch, batch, p, s);
    case 1: return run<Tile16, float>(a, b, b_batch, batch, p, s);
    case 2: return run<Tile64, __nv_bfloat16>(a, b, b_batch, batch, p, s);
    case 3: return run<Tile64, float>(a, b, b_batch, batch, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ring
}  // namespace

// The routes of K1 and K3, as the wrappers number them (ROUTES).
enum Route { kRouteTile = 0, kRouteRing = 1 };

}  // namespace dga
