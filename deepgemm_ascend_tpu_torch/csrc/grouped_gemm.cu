// K3 and K8: masked and contiguous grouped FP8 GEMMs for Hopper (sm_90a).
//
// Replaces two kernels of deepgemm_ascend_tpu/ops/grouped_gemm.py:
//   K3 _masked_kernel (:282, call :407)  -> dga_grouped_gemm_masked
//   K8 _grouped_kernel (:70, call :183)  -> dga_grouped_gemm_contiguous
// Both keep K1's arithmetic for one element (fp8_gemm.cuh): e4m3 -> f16
// exact, m16n8k16 group partials, acc += (p * a_s) * b_s in group order,
// so a valid row gets the same bits whichever kernel or route computes it.
// B's block scales stay compact and are addressed through strides; B is
// stored (E, K, N) or K-major (E, N, K).
//
// K3: per expert e, C_e = A_e (M_max, K) x B_e; grid dimension z walks the
// experts. Two routes, chosen by the wrapper (ops/grouped_gemm.py: route,
// ring_tile) and refused here where they cannot run:
//   * "ring" (B K-major, b_layout='t', the layout of the port's expert
//     weights; TMA-describable pointers and pitches): fp8_gemm.cuh's
//     ring_kernel over 3-D maps whose batch is the expert, so that no box
//     reads the next expert's rows; 16-row tiles where an expert is
//     expected to hold a few rows (decode), and m16 fragments past
//     masked_m[e] skipped inside the larger tiles. K3 never splits its
//     groups: it stays bit-equal to K8;
//   * "tile" (b_layout='n', unaligned operands): gemm_tile's 64 x 64 grid.
// Either way a tile whose first row is at or past masked_m[e] loads
// nothing and writes zeros, as the TPU kernel's inactive tiles do; rows
// past masked_m[e] inside an active tile are unspecified (as in the TPU
// kernel). The MoE block sizes every expert for T*top_k rows, so at
// prefill almost every tile is idle, and those zero stores are the floor
// of the kernel while zeros stay in the contract (at 12288 rows, 32
// experts, n = 2816: 2.2 GB, ~0.66 ms at 3.35 TB/s).
//
// Bound on the card: the expert weight bytes at decode, which the ring
// streams with several groups in flight per SM; tensor-core work (f16
// mma.sync) and the zero stores at prefill.
//
// K8: one flat (M_total, K) activation matrix whose rows are grouped by
// expert in spans of block_m rows (the layout's m-tiles); tile_gids[t] is
// the expert of m-tile t, -1 for a padding tile. A padding tile stores
// zeros and loads nothing, as the TPU kernel's inactive tiles do (:117).
// Two routes, chosen by the wrapper (ops/grouped_gemm.py:
// contiguous_route, contiguous_tile) and refused here where they cannot
// run:
//   * "wgmma16" (B K-major, TMA-describable operands, 64 dividing block_m):
//     the f16 tensor cores on e4m3 operands converted exactly, with K1's
//     group arithmetic kept (w16 below); 128 x 128 tiles where 128 divides
//     block_m, else 64 x 128, so that no tile spans two experts;
//   * "tile" (b_layout='n', block_m 96, unaligned operands): the grid walks
//     the layout tiles times their 64-row kernel sub-tiles (K9's int8_tile
//     grid, int8_gemm.cu), gemm_tile seeing the sub-tile's end as its row
//     limit.
// Bound on the card: tensor-core work at prefill (the layout carries the
// routed rows and their padding, not T*top_k rows per expert as K3's
// buffer does).
#include "fp8_gemm.cuh"

namespace {

struct GroupStrides {
  long long a_e, as_e, b_e, bs_e;
};

template <bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(dga::kThreads)
masked_gemm_kernel(dga::GemmArgs p, GroupStrides gs, const int* masked_m, OutT* c) {
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * dga::kBM, n0 = blockIdx.x * dga::kBN;
  OutT* ce = c + (size_t)e * p.m * p.n;
  if (m0 >= masked_m[e]) {
    dga::zero_tile(ce, p.m, p.n, m0, n0);
    return;
  }
  dga::GemmArgs q = p;
  q.a += (size_t)e * gs.a_e;
  q.a_s += (size_t)e * gs.as_e;
  q.b += (size_t)e * gs.b_e;
  q.b_s += (size_t)e * gs.bs_e;
  dga::gemm_tile<B_KMAJOR, OutT>(q, ce, m0, n0);
}

template <bool B_KMAJOR, typename OutT>
void launch(const dga::GemmArgs& p, const GroupStrides& gs, int e,
            const int* masked_m, void* c, cudaStream_t stream) {
  dim3 grid(p.n / dga::kBN, (p.m + dga::kBM - 1) / dga::kBM, e);
  masked_gemm_kernel<B_KMAJOR, OutT><<<grid, dga::kThreads, 0, stream>>>(
      p, gs, masked_m, static_cast<OutT*>(c));
}

template <bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(dga::kThreads)
contiguous_gemm_kernel(dga::GemmArgs p, const int* tile_gids, int block_m, long long b_e,
                       long long bs_e, OutT* c) {
  const int sub = (block_m + dga::kBM - 1) / dga::kBM;   // kernel tiles per layout tile
  const int tile = blockIdx.y / sub;
  const int m0 = tile * block_m + (blockIdx.y % sub) * dga::kBM;
  const int m_end = min(m0 + dga::kBM, (tile + 1) * block_m);
  const int n0 = blockIdx.x * dga::kBN;
  const int e = tile_gids[tile];
  if (e < 0) {
    dga::zero_tile(c, m_end, p.n, m0, n0);
    return;
  }
  dga::GemmArgs q = p;
  q.m = m_end;
  q.b += (size_t)e * b_e;
  q.b_s += (size_t)e * bs_e;
  dga::gemm_tile<B_KMAJOR, OutT>(q, c, m0, n0);
}

template <bool B_KMAJOR, typename OutT>
void launch_contiguous(const dga::GemmArgs& p, const int* gids, int n_tiles, int block_m,
                       long long b_e, long long bs_e, void* c, cudaStream_t stream) {
  dim3 grid(p.n / dga::kBN, n_tiles * ((block_m + dga::kBM - 1) / dga::kBM));
  contiguous_gemm_kernel<B_KMAJOR, OutT><<<grid, dga::kThreads, 0, stream>>>(
      p, gids, block_m, b_e, bs_e, static_cast<OutT*>(c));
}

// ------------------------------------------------------- K8's route wgmma16
namespace w16 {

namespace s9 = dga::sm90;

constexpr int kBN = 128;                  // one 128-column scale block of B a tile
constexpr int kRawB = kBN * 128;          // B's 128 rows of a group, e4m3
constexpr int kHalfB = 2 * kBN * 128;     // the same in f16: two 64-deep K-major panels

// Shared memory of a tile of BM rows: two f16 B stages, kStages raw stages
// (BM A rows, then B's 128 rows), then the raw stages' full barriers, and
// the slack to round the base up to 1024 bytes (it is 16-byte aligned).
// The 64-row tile keeps two raw stages, so that two CTAs share an SM
// (228 KB, 1 KB of it reserved a block) and overlap each other's phases.
template <int BM>
struct Smem {
  static constexpr int kStages = BM == 64 ? 2 : 4;   // raw groups in flight
  static constexpr int kPerSm = BM == 64 ? 2 : 1;
  static constexpr int kRawA = BM * 128;
  static constexpr int kRaw = kRawA + kRawB;
  static constexpr int kRawOff = 2 * kHalfB;
  static constexpr int kBarOff = kRawOff + kStages * kRaw;
  static constexpr int kBytes = kBarOff + kStages * 8 + 1008;
  static constexpr int kThreads = BM / 64 * 128;
  static_assert(kPerSm * (kBytes + 1024) <= 228 * 1024, "CTAs an SM");
};

struct Args {
  const float* a_s;      // (m, k / 128)
  const float* b_s;      // scale (e, g, col) at b_s[e * bs_e + g * bs_g + (col >> 7) * bs_n]
  const int* tile_gids;  // expert of each layout tile of block_m rows, -1: padding
  void* c;               // (m, n)
  int m, n, block_m, nk; // nk: 128-deep groups
  long long bs_e, bs_g, bs_n;
  int tiles_m, tiles_n;
};

// 16 e4m3 values (k 16c .. 16c + 15 of one row) as the 32 bytes of f16
// that one wgmma k16 step reads, in mma.sync's order inside the step (word
// t, k 4t..4t+3, in slots 2t, 2t+1 and 2t+8, 2t+9): lo the slots 0-7, hi
// 8-15.
__device__ __forceinline__ void to_half(uint4 v, uint4& lo, uint4& hi) {
  lo = make_uint4(dga::e4m3x2_to_f16x2(v.x), dga::e4m3x2_to_f16x2(v.y),
                  dga::e4m3x2_to_f16x2(v.z), dga::e4m3x2_to_f16x2(v.w));
  hi = make_uint4(dga::e4m3x2_to_f16x2(v.x >> 16), dga::e4m3x2_to_f16x2(v.y >> 16),
                  dga::e4m3x2_to_f16x2(v.z >> 16), dga::e4m3x2_to_f16x2(v.w >> 16));
}

// The CTA's work, in the order every role walks it: its tiles t =
// blockIdx.x, + gridDim.x, ... (n fastest), the padding tiles skipped, and
// the nk groups of each; e is tile t's expert, read once a tile.
struct Walk {
  int t, g, e;
};

__device__ __forceinline__ int expert(const Args& p, int t) {
  return p.tile_gids[t / p.tiles_n * (p.m / p.tiles_m) / p.block_m];
}

// w at the first tile from w.t on that is not padding (w.t >= tiles: none).
__device__ __forceinline__ void seek(const Args& p, Walk& w) {
  const int tiles = p.tiles_m * p.tiles_n;
  for (; w.t < tiles; w.t += gridDim.x)
    if ((w.e = expert(p, w.t)) >= 0) break;
}

__device__ __forceinline__ Walk first_walk(const Args& p) {
  Walk w{(int)blockIdx.x, 0, -1};
  seek(p, w);
  return w;
}

__device__ __forceinline__ void advance(const Args& p, Walk& w) {
  if (++w.g == p.nk) {
    w.g = 0;
    w.t += gridDim.x;
    seek(p, w);
  }
}

// Measurement hook, 0 in the package's build: DGA_K8_ABLATION takes parts
// of the route out, so that scripts/k8_ablation.py can time what each
// costs (the products are then wrong by design). 1: no promotion (the
// partials copied); 2: no B conversion; 3: no products; 4: none of the
// three and no A reads either (the loads, barriers and stores alone).
#ifndef DGA_K8_ABLATION
#define DGA_K8_ABLATION 0
#endif

// K8 on tensor cores, with K1's arithmetic: each 128-deep group of a
// BM x 128 tile is eight f16 wgmma m64n128k16 steps from 0 (the probe
// below shows them equal to gemm_tile's eight mma.sync steps bit for bit),
// then acc = acc + (p * a_s) * b_s on the CUDA cores, in group order.
// Threads: BM / 64 warpgroups and nothing else, so that ptxas leaves each
// thread up to 255 registers (a 64 x 128 warpgroup tile holds 64 partials,
// 64 sums and a group's A fragments, 32); persistent CTAs, one an SM with
// the 128-row tile, two with the 64-row one.
//   * Thread 0 loads each group's raw e4m3 operands by TMA (BM A rows from
//     a 2-D map, B's 128 rows from the 3-D map whose batch is the tile's
//     expert; 128-byte swizzle) kStages groups ahead.
//   * While a group's products run, the warpgroups convert the next
//     group's B (warpgroup w its 64-deep panel w, a row a thread; with one
//     warpgroup both panels) into the other of two f16 stages, 128-byte
//     swizzled K-major as the descriptors read it, and read the next
//     group's A words; after the products they promote the partials,
//     convert the words into mma.sync's A fragments (the k order the probe
//     checks) and meet at the block barrier, after which thread 0 refills
//     the raw slot.
// Bound: the f16 tensor cores (989 TFLOP/s), half the fp8 rate. The
// products of a group are not overlapped with anything but the next
// group's conversion: the promotion (three f32 operations an output), the
// barrier and the refill follow them, and the raw operands' bytes from L2
// (each A row read once per 128 columns) add their own time
// (scripts/k8_ablation.py measures each part).
template <int BM, typename OutT>
__global__ void __launch_bounds__(Smem<BM>::kThreads, Smem<BM>::kPerSm)
    contiguous_wgmma16_kernel(const __grid_constant__ CUtensorMap ta,
                              const __grid_constant__ CUtensorMap tb, Args p) {
  using L = Smem<BM>;
  constexpr int kWarpgroups = BM / 64, kSteps = dga::kGroup / 16, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = s9::aligned_smem(smem_raw);
  uint8_t* raw = base + L::kRawOff;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBarOff);
  const int tiles = p.tiles_m * p.tiles_n;
  const int wg = threadIdx.x / 128, lt = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) s9::mbar_init(&full[i], 1);
    s9::fence_barrier_init();
  }
  __syncthreads();
  Walk load = first_walk(p);
  auto load_next = [&](int slot) {
    s9::mbar_expect_tx(&full[slot], L::kRaw);
    uint8_t* st = raw + slot * L::kRaw;
    s9::tma_load(st, &ta, &full[slot], load.g * dga::kGroup, load.t / p.tiles_n * BM, 0);
    s9::tma_load(st + L::kRawA, &tb, &full[slot], load.g * dga::kGroup, load.t % p.tiles_n * kBN,
                 load.e);
    advance(p, load);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages && load.t < tiles; ++i) load_next(i);

  const int warp = lt >> 5, lane = lt & 31, g = lane >> 2, q = lane & 3;
  const int rr = 64 * wg + 16 * warp + g;   // the thread's first A row in the tile
  // Group j's raw stage: B's panels into f16 stage j & 1, and the thread's
  // sixteen A words.
  auto convert_b = [&](int j) {
    if (DGA_K8_ABLATION == 2 || DGA_K8_ABLATION == 4) return;
    const uint8_t* src = raw + (j % kStages) * L::kRaw + L::kRawA + lt * 128;
    uint8_t* dst = base + (j & 1) * kHalfB + lt * 128;
    constexpr int kChunks = 8 / kWarpgroups;   // 16-byte chunks of the row a thread converts
    const int c0 = kWarpgroups == 2 ? 4 * wg : 0;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = c0 + i, h = i % 4;
      uint4 lo, hi;
      to_half(*reinterpret_cast<const uint4*>(src + ((c ^ (lt & 7)) << 4)), lo, hi);
      uint8_t* row = dst + (c / 4) * kBN * 128;
      *reinterpret_cast<uint4*>(row + (((2 * h) ^ (lt & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(row + (((2 * h + 1) ^ (lt & 7)) << 4)) = hi;
    }
  };
  uint32_t words[kSteps][2];
  auto read_a = [&](int j) {
    if (DGA_K8_ABLATION == 4) return;
    const uint8_t* r0 = raw + (j % kStages) * L::kRaw + rr * 128 + 4 * q;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int ofs = (st ^ g) << 4;   // rows rr and rr + 8 have row % 8 == g
      words[st][0] = *reinterpret_cast<const uint32_t*>(r0 + ofs);
      words[st][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * 128 + ofs);
    }
  };
  uint32_t af[kSteps][4];
  auto to_fragments = [&]() {
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      af[st][0] = dga::e4m3x2_to_f16x2(words[st][0]);
      af[st][1] = dga::e4m3x2_to_f16x2(words[st][1]);
      af[st][2] = dga::e4m3x2_to_f16x2(words[st][0] >> 16);
      af[st][3] = dga::e4m3x2_to_f16x2(words[st][1] >> 16);
    }
  };
  // Group j's raw stage consumed by every thread: f16 stage j & 1 written
  // and fenced for the async proxy, the slot free for group j + kStages.
  auto stage_done = [&](int j) {
    s9::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0 && load.t < tiles) load_next(j % kStages);
  };

  Walk w = first_walk(p);
  if (w.t < tiles) {
    s9::mbar_wait(&full[0], 0);
    convert_b(0);
    read_a(0);
    to_fragments();
    stage_done(0);
  }
  OutT* c = static_cast<OutT*>(p.c);
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  int j = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / p.tiles_n * BM + 64 * wg, n0 = t % p.tiles_n * kBN;
    const int e = expert(p, t);
    if (e < 0) {
      // A padding tile: zeros, in 16-byte stores (n is a multiple of 128).
      constexpr int kVec = 16 / (int)sizeof(OutT), kPerRow = kBN / kVec;
      for (int i = lt; i < 64 * kPerRow; i += 128)
        *reinterpret_cast<uint4*>(c + (size_t)(m0 + i / kPerRow) * p.n + n0 +
                                  (i % kPerRow) * kVec) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const float* a_s = p.a_s + (size_t)(t / p.tiles_n * BM + rr) * p.nk;
    const float* b_s = p.b_s + (size_t)e * p.bs_e + (size_t)(n0 >> 7) * p.bs_n;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int gi = 0; gi < p.nk; ++gi, ++j) {
      // The group's scales, read now, used after its products.
      const float sa_lo = __ldg(a_s + gi), sa_hi = __ldg(a_s + 8 * p.nk + gi);
      const float sb = __ldg(b_s + gi * p.bs_g);
      const uint32_t hb = s9::smem_u32(base + (j & 1) * kHalfB);
      s9::fence_acc(part);
      s9::wgmma_fence();
      if (DGA_K8_ABLATION != 3 && DGA_K8_ABLATION != 4) {
#pragma unroll
        for (int st = 0; st < kSteps; ++st)
          s9::wgmma_f16_ra(part, af[st], s9::desc(hb + (st / 4) * kBN * 128 + (st % 4) * 32, 16),
                           st > 0);
      }
      s9::wgmma_commit();
      advance(p, w);
      const bool next = w.t < tiles;
      if (next) {
        s9::mbar_wait(&full[(j + 1) % kStages], ((j + 1) / kStages) & 1);
        convert_b(j + 1);
        read_a(j + 1);
      }
      s9::wgmma_wait<0>();
      s9::fence_acc(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float sa = (i & 2) ? sa_hi : sa_lo;   // rows rr + 8 in d[4j + 2, 3]
        acc[i] = DGA_K8_ABLATION == 1 || DGA_K8_ABLATION == 4
                     ? part[i]
                     : __fadd_rn(acc[i], __fmul_rn(__fmul_rn(part[i], sa), sb));
      }
      if (next) {
        to_fragments();
        stage_done(j + 1);
      }
    }
    s9::store_tile<kBN>(acc, c, p.m, p.n, m0, n0);
  }
}

template <int BM, typename OutT>
int run(const void* a, const void* b, long long b_e, int e, int k, const Args& p0,
        cudaStream_t s) {
  if (p0.block_m % BM) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap ta, tb;
  int rc = s9::make_map(&ta, u8, 1, a, k, p0.m, 1, k, 0, 128, BM, sw);
  if (rc) return rc;
  rc = s9::make_map(&tb, u8, 1, b, k, p0.n, e, k, b_e, 128, kBN, sw);
  if (rc) return rc;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  Args p = p0;
  p.tiles_m = p.m / BM;
  p.tiles_n = p.n / kBN;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  return s9::launch<contiguous_wgmma16_kernel<BM, OutT>>(
      dim3((unsigned)(tiles < (long long)sms * Smem<BM>::kPerSm ? tiles
                                                                 : sms * Smem<BM>::kPerSm)),
      Smem<BM>::kThreads, Smem<BM>::kBytes, s, ta,
      tb, p);
}

}  // namespace w16

// ------------------------------------------------------------- the probe
//
// Does an f16 wgmma (A from registers, B K-major in shared memory) give
// the group partial of gemm_tile and the ring bit for bit? One warpgroup
// computes the 64 x 128 partial of one 128-deep group three ways from the
// same e4m3 operands: (0) gemm_tile's eight mma.sync m16n8k16 steps, (1)
// eight wgmma m64n128k16 steps from 0 with the k order of (0) inside each
// step (thread t's word, k 4t..4t+3, in slots 2t, 2t+1, 2t+8, 2t+9), and
// (2) the same in natural k order. A tensor-core sum of 16 products is not
// exact in f32, so the order or grouping of the terms can show in the
// bits.
namespace probe {

namespace s9 = dga::sm90;

constexpr int kM = 64, kN = 128, kK = dga::kGroup;
constexpr int kPanels = kK / 64;                    // 64 f16 of K a 128-byte row
constexpr int kSmem = kPanels * kN * 128 + kM * kK + kN * kK + 1024;

__device__ __forceinline__ uint32_t word(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t cvt_half(uint32_t two_bytes) {
  return dga::e4m3x2_to_f16x2(two_bytes);
}

// Stores the warpgroup's 64 x 128 accumulator fragment (sm90::store_tile's
// layout; mma.sync's fragments map the same way).
__device__ void store_frag(const float (&d)[64], float* c) {
  const int t = threadIdx.x, r = (t >> 5) * 16 + ((t & 31) >> 2), cb = (t & 3) * 2;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    c[r * kN + cb + 8 * j] = d[4 * j];
    c[r * kN + cb + 8 * j + 1] = d[4 * j + 1];
    c[(r + 8) * kN + cb + 8 * j] = d[4 * j + 2];
    c[(r + 8) * kN + cb + 8 * j + 1] = d[4 * j + 3];
  }
}

// a (64, 128) and b (128, 128) e4m3, K contiguous; c: three (64, 128) f32.
__global__ void __launch_bounds__(128) wgmma16_probe_kernel(const uint8_t* a, const uint8_t* b,
                                                             float* c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* panels = s9::aligned_smem(smem_raw);
  uint8_t* as = panels + kPanels * kN * 128;
  uint8_t* bs = as + kM * kK;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, g = lane >> 2, q = lane & 3;
  for (int i = t; i < kM * kK / 16; i += 128)
    reinterpret_cast<uint4*>(as)[i] = reinterpret_cast<const uint4*>(a)[i];
  for (int i = t; i < kN * kK / 16; i += 128)
    reinterpret_cast<uint4*>(bs)[i] = reinterpret_cast<const uint4*>(b)[i];
  __syncthreads();
  const uint8_t* r0 = as + (16 * w + g) * kK;
  const uint8_t* r8 = r0 + 8 * kK;

  // (0) mma.sync, as gemm_tile.
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kK / 16; ++ks) {
    const int ko = ks * 16 + q * 4;
    const uint32_t lo = word(r0 + ko), hi = word(r8 + ko);
    const uint32_t af[4] = {cvt_half(lo), cvt_half(hi), cvt_half(lo >> 16), cvt_half(hi >> 16)};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const uint32_t wb = word(bs + (8 * j + g) * kK + ko);
      const uint32_t bf[2] = {cvt_half(wb), cvt_half(wb >> 16)};
      dga::mma_f16_f32(&d[4 * j], af, bf);
    }
  }
  store_frag(d, c);

  // (1) and (2): B converted into 128-byte-swizzled K-major panels, then
  // wgmma with A from registers.
  for (int order = 0; order < 2; ++order) {
    const bool permuted = order == 0;
    __syncthreads();
    for (int ch = 0; ch < kK / 16; ++ch) {
      const uint4 v = *reinterpret_cast<const uint4*>(bs + t * kK + ch * 16);
      uint4 lo, hi;
      if (permuted) {
        w16::to_half(v, lo, hi);   // route wgmma16's conversion
      } else {
        lo = make_uint4(cvt_half(v.x), cvt_half(v.x >> 16), cvt_half(v.y), cvt_half(v.y >> 16));
        hi = make_uint4(cvt_half(v.z), cvt_half(v.z >> 16), cvt_half(v.w), cvt_half(v.w >> 16));
      }
      uint8_t* row = panels + (ch / 4) * kN * 128 + t * 128;
      const int h = ch % 4;
      *reinterpret_cast<uint4*>(row + (((2 * h) ^ (t & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(row + (((2 * h + 1) ^ (t & 7)) << 4)) = hi;
    }
    s9::fence_proxy_async();
    __syncthreads();
    const uint32_t base = s9::smem_u32(panels);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      uint32_t af[4];
      if (permuted) {
        const int ko = ks * 16 + q * 4;
        const uint32_t lo = word(r0 + ko), hi = word(r8 + ko);
        af[0] = cvt_half(lo);
        af[1] = cvt_half(hi);
        af[2] = cvt_half(lo >> 16);
        af[3] = cvt_half(hi >> 16);
      } else {
        const int ko = ks * 16 + q * 2;
        auto pair = [](const uint8_t* p) {
          return cvt_half(*reinterpret_cast<const uint16_t*>(p));
        };
        af[0] = pair(r0 + ko);
        af[1] = pair(r8 + ko);
        af[2] = pair(r0 + ko + 8);
        af[3] = pair(r8 + ko + 8);
      }
      s9::fence_acc(d);
      s9::wgmma_fence();
      s9::wgmma_f16_ra(d, af, s9::desc(base + (ks / 4) * kN * 128 + (ks % 4) * 32, 16), ks > 0);
      s9::wgmma_commit();
      s9::wgmma_wait<0>();
      s9::fence_acc(d);
    }
    store_frag(d, c + (1 + order) * kM * kN);
  }
}

}  // namespace probe

}  // namespace

// The probe above: a (64, 128), b (128, 128) e4m3; c (3, 64, 128) f32.
extern "C" int dga_wgmma16_probe(const void* a, const void* b, void* c, void* stream) {
  return dga::sm90::launch<probe::wgmma16_probe_kernel>(
      dim3(1), 128, probe::kSmem, static_cast<cudaStream_t>(stream),
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), static_cast<float*>(c));
}

// route: 0 tile, 1 ring (dga::Route); tile: the ring's tile index
// (dga::ring::launch), not read on the tile route.
extern "C" int dga_grouped_gemm_masked(
    const void* a, const void* a_s, const void* b, const void* b_s,
    const void* masked_m, void* c, int e, int m_max, int n, int k,
    long long b_e, long long sbk, long long sbn, long long bs_e,
    long long bs_g, long long bs_n, int bs_shift, int out_f32, int route,
    int tile, void* stream) {
  if (e <= 0 || m_max <= 0 || n % dga::kBN || k % dga::kGroup)
    return (int)cudaErrorInvalidValue;
  if (route == dga::kRouteRing) {
    // TMA reads B as (E, n, k) rows of k bytes: K-major and dense rows.
    if (sbk != 1 || sbn != k) return (int)cudaErrorInvalidValue;
    const dga::ring::RingArgs p{static_cast<const float*>(a_s), static_cast<const float*>(b_s),
                                static_cast<const int*>(masked_m), c, m_max, n, k, bs_e, bs_g,
                                bs_n, bs_shift, 1};
    return dga::ring::launch(tile, out_f32, a, b, b_e, e, p, static_cast<cudaStream_t>(stream));
  }
  if (route != dga::kRouteTile) return (int)cudaErrorInvalidValue;
  dga::GemmArgs p{static_cast<const uint8_t*>(a), static_cast<const float*>(a_s),
                  static_cast<const uint8_t*>(b), static_cast<const float*>(b_s),
                  m_max, n, k, sbk, sbn, bs_g, bs_n, bs_shift};
  GroupStrides gs{(long long)m_max * k, (long long)m_max * (k / dga::kGroup), b_e, bs_e};
  const int* mm = static_cast<const int*>(masked_m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kmajor = sbk == 1;
  if (kmajor && out_f32) launch<true, float>(p, gs, e, mm, c, s);
  else if (kmajor) launch<true, __nv_bfloat16>(p, gs, e, mm, c, s);
  else if (out_f32) launch<false, float>(p, gs, e, mm, c, s);
  else launch<false, __nv_bfloat16>(p, gs, e, mm, c, s);
  return (int)cudaGetLastError();
}

// K8 over `e` experts. route: 0 tile (gemm_tile), 1 wgmma16 (B K-major,
// sbk == 1 and sbn == k; one scale per 128 columns, bs_shift 7; tile 0:
// 64 x 128 for a block_m that 64 divides, 1: 128 x 128 for one that 128
// divides; the tensor maps refuse pointers and pitches TMA cannot
// describe); `tile` is not read on route 0.
extern "C" int dga_grouped_gemm_contiguous(
    const void* a, const void* a_s, const void* b, const void* b_s,
    const void* tile_gids, void* c, int m, int n, int k, int block_m,
    long long b_e, long long sbk, long long sbn, long long bs_e,
    long long bs_g, long long bs_n, int bs_shift, int out_f32, int e, int route,
    int tile, void* stream) {
  if (m <= 0 || block_m <= 0 || m % block_m || n <= 0 || n % dga::kBN || k <= 0 ||
      k % dga::kGroup)
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (sbk != 1 || sbn != k || bs_shift != 7 || n % w16::kBN || e <= 0)
      return (int)cudaErrorInvalidValue;
    const w16::Args p{static_cast<const float*>(a_s), static_cast<const float*>(b_s),
                      static_cast<const int*>(tile_gids), c, m, n, block_m, k / dga::kGroup,
                      bs_e, bs_g, bs_n, 0, 0};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (tile * 2 + (out_f32 ? 1 : 0)) {
      case 0: return w16::run<64, __nv_bfloat16>(a, b, b_e, e, k, p, s);
      case 1: return w16::run<64, float>(a, b, b_e, e, k, p, s);
      case 2: return w16::run<128, __nv_bfloat16>(a, b, b_e, e, k, p, s);
      case 3: return w16::run<128, float>(a, b, b_e, e, k, p, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = m / block_m;
  if ((long long)n_tiles * ((block_m + dga::kBM - 1) / dga::kBM) > 65535)
    return (int)cudaErrorInvalidValue;
  dga::GemmArgs p{static_cast<const uint8_t*>(a), static_cast<const float*>(a_s),
                  static_cast<const uint8_t*>(b), static_cast<const float*>(b_s),
                  m, n, k, sbk, sbn, bs_g, bs_n, bs_shift};
  const int* gids = static_cast<const int*>(tile_gids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kmajor = sbk == 1;
  if (kmajor && out_f32) launch_contiguous<true, float>(p, gids, n_tiles, block_m, b_e, bs_e, c, s);
  else if (kmajor) launch_contiguous<true, __nv_bfloat16>(p, gids, n_tiles, block_m, b_e, bs_e, c, s);
  else if (out_f32) launch_contiguous<false, float>(p, gids, n_tiles, block_m, b_e, bs_e, c, s);
  else launch_contiguous<false, __nv_bfloat16>(p, gids, n_tiles, block_m, b_e, bs_e, c, s);
  return (int)cudaGetLastError();
}
