// K1 and K12: blockwise-scaled FP8 GEMMs for Hopper (sm_90a).
//
// K1 replaces deepgemm_ascend_tpu/ops/fp8_gemm.py:_fp8_gemm_kernel_static
// (:152) and :_fp8_gemm_kernel_blocked (:182), called at :379 and :415 (one
// function: the TPU kernel splits it only because Mosaic needs static scale
// slices). Two routes, chosen by the wrapper (ops/fp8_gemm.py: route,
// ring_plan) and refused here where they cannot run:
//   * "ring" (B stored K-major, b_layout='t', the layout of the port's
//     weights; TMA-describable pointers and pitches): fp8_gemm.cuh's
//     ring_kernel, a TMA ring of 128-deep scale groups fed by a producer
//     warp, with tiles by m (16 x 64 at decode, 64 x 64 beyond) and,
//     where the tiles are too few to fill the card, the groups split over
//     the CTAs of a cluster (`splits`);
//   * "tile" (b_layout='n', unaligned operands): gemm_tile's 64 x 64 grid.
// Both keep one element's arithmetic (fp8_gemm.cuh), so they agree bit for
// bit where K is not split. Bound on the card: the weight bytes at decode,
// which the ring streams with several groups in flight on every SM; the
// tensor cores at prefill (f16 mma.sync, at most half the fp8 rate).
//
// K12 replaces :_fp8_gemm_kernel_folded (scale_mode='folded', call :435):
// the scales are folded into the operands and one bf16 product follows,
//   C = sum_k bf16(a[row, k] * a_s[row, k/128]) * bf16(b[k, col] * b_s[k/128, col/128]),
// each fold an f32 multiply of the exact e4m3 value rounded once to bf16
// (RN), exactly as the plain version rounds, so the two differ only in the
// order of the f32 sum. It runs on the Hopper main loop of sm90_gemm.cuh,
// with a fold between the loads and the math:
//   * TMA loads the e4m3 bytes of A and B into a raw ring (64-deep K
//     blocks, half a scale group; B (n, k) for b_layout='t' in boxes of 64
//     bytes per row, B (k, n) for 'n' in boxes of a whole tile row of n:
//     no byte loads), each part issued by the group that reads it as soon
//     as that group has copied its slot into registers;
//   * the fold writes bf16 in the 128-byte-swizzled layout wgmma reads (A
//     and B 't' K-major; B 'n' MN-major, read through wgmma's transpose
//     bit) and fences its reads and writes for the async proxy: one fold
//     warpgroup folds B, and the consumer warpgroups fold A of stage
//     kb + 1 right after issuing stage kb's products, while those run;
//   * consumer warpgroups run wgmma on the bf16 ring (sm90::mma_loop).
// Tiles, the caller's (a tile code from tiling/analytic.py): 128 x 256
// (n a multiple of 256) and 128 x 128 (two consumer warpgroups, one fold
// warpgroup, 3 bf16 stages), 64 x 64 (one each, three blocks an SM). The
// analytic default takes the 128-row tiles for m > 64 where their grid
// fills the card, 64 x 64 at m <= 64, where the weight bytes bound it, and
// wherever the large tile would leave most SMs idle.
// Bound on the card: as K1 (weight bytes at decode, tensor cores at
// prefill: here the bf16 rate, 989 TFLOP/s, since the product is bf16).
// At prefill the fold costs more than the math hides, so K12 runs below
// K10's rate: besides two conversions and a multiply per element on the
// CUDA cores, it moves each stage through shared memory three more times
// than K10 does (the raw bytes in by TMA and out to registers, the bf16
// values in). DGA_K12_ABLATION below takes these parts out one at a time
// to measure which costs the time. K and N are multiples of 128 (checked
// by the wrapper); a ragged M is masked (TMA zero-fills the rows past M).
#include <type_traits>

#include "fp8_gemm.cuh"

namespace {

namespace s9 = dga::sm90;

__device__ __forceinline__ uint32_t fold2(uint32_t two_bytes, float s0, float s1) {
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two_bytes & 0xffffu), __NV_E4M3)));
  const __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(f.x, s0), __fmul_rn(f.y, s1));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 e4m3 values times their scales (se(i) for value i), rounded to bf16,
// as two 16-byte chunks: values 0-7 in lo, 8-15 in hi.
template <typename Scale>
__device__ __forceinline__ void fold16(uint4& lo, uint4& hi, uint4 v, Scale se) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = fold2(w[i], se(4 * i), se(4 * i + 1));
    o[2 * i + 1] = fold2(w[i] >> 16, se(4 * i + 2), se(4 * i + 3));
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// Stores the two folded chunks of logical 16-byte chunks 2h, 2h + 1 of
// row `row` of a 128-byte-swizzled panel at `panel`.
__device__ __forceinline__ void store_swizzled(uint8_t* panel, int row, int h, uint4 lo, uint4 hi) {
  uint8_t* r = panel + row * 128;
  *reinterpret_cast<uint4*>(r + (((2 * h) ^ (row & 7)) << 4)) = lo;
  *reinterpret_cast<uint4*>(r + (((2 * h + 1) ^ (row & 7)) << 4)) = hi;
}

// Measurement hook, 0 in the package's build: DGA_K12_ABLATION takes parts
// of the fold out, so that scripts/k12_fold_ablation.py can time what each
// costs (the products are then wrong by design). 1: no conversion (the raw
// bytes stored where the bf16 values go: the same shared-memory traffic);
// 2: the conversions without their bf16 stores; 3: neither (the raw bytes
// not read either: only the rings and the products).
#ifndef DGA_K12_ABLATION
#define DGA_K12_ABLATION 0
#endif

// Chunk v folded (fold16, scales se) and stored (store_swizzled).
template <typename Scale>
__device__ __forceinline__ void fold_store(uint8_t* panel, int row, int h, uint4 v, Scale se) {
  uint4 lo = v, hi = v;
  if constexpr (DGA_K12_ABLATION == 0 || DGA_K12_ABLATION == 2) fold16(lo, hi, v, se);
  if constexpr (DGA_K12_ABLATION == 2)
    asm volatile("" ::"r"(lo.x), "r"(lo.y), "r"(lo.z), "r"(lo.w), "r"(hi.x), "r"(hi.y),
                 "r"(hi.z), "r"(hi.w));
  else if constexpr (DGA_K12_ABLATION != 3)
    store_swizzled(panel, row, h, lo, hi);
}

struct FoldArgs {
  const float* a_s;   // a_s[row * k_blocks + g]
  const float* b_s;   // scale (g, col) at b_s[g * bs_g + (col >> bs_shift) * bs_n]
  void* c;
  int m, n, k;
  long long bs_g, bs_n;
  int bs_shift;
  int tiles_m, tiles_n;
};

// Threads: BM / 64 consumer warpgroups, then one fold warpgroup; no
// producer warp (the raw loads are issued by the groups that read them).
// Registers: ptxas holds every thread to the launch's share (65536 / 384
// = 168 for the 128-row tile, enough for 128 accumulators), so no
// setmaxnreg here.
template <int BM>
struct FoldShape {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kCons = kConsumers * 128;   // consumer threads
  static constexpr int kFold = 128;
  static constexpr int kThreads = kCons + kFold;
  static constexpr int kBlocksPerSm = BM == 128 ? 1 : 3;
};

// Shared memory: the bf16 ring (sm90::Ring, STAGES stages), the raw e4m3
// ring (RAW stages of A's then B's bytes), then the barriers: bf16
// full/empty, raw A full, raw B full.
template <int BM, int BN, int STAGES, int RAW>
struct FoldRing {
  using Bf = s9::Ring<BM, BN, STAGES>;
  static constexpr int kRawA = BM * s9::kBK;
  static constexpr int kRawStage = kRawA + BN * s9::kBK;
  static constexpr int kRaw = Bf::kBytes;
  static constexpr int kBars = kRaw + RAW * kRawStage;
  static constexpr int kSmem = kBars + (2 * STAGES + 2 * RAW) * 8 + 1024;
};

// Named barriers (0 is __syncthreads): 1 for the fold warpgroup, 2 for the
// consumer warpgroups.
template <int kId, int kThreads>
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kId), "n"(kThreads) : "memory");
}

// Raw stage kb (e4m3 bytes, by TMA) -> bf16 stage kb -> wgmma. The fold is
// split between the two groups that are not the tensor cores' bottleneck:
// the fold warpgroup folds B, and the consumer warpgroups fold A of stage
// kb + 1 right after issuing stage kb's products (sm90::mma_loop's
// `issued`), while those run. Each group copies its part of a raw slot
// into registers, fences the reads for the async proxy and meets at its
// named barrier; then its first thread loads that part of raw stage
// kb + RAW into the freed slot. bf16 stage kb is full once all of both
// groups have arrived; only the fold warpgroup waits for it to be empty
// (the consumers' own wgmma wait already covers their A writes).
template <int BM, int BN, int STAGES, int RAW, bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(FoldShape<BM>::kThreads, FoldShape<BM>::kBlocksPerSm)
    folded_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, FoldArgs p) {
  using Sh = FoldShape<BM>;
  using L = FoldRing<BM, BN, STAGES, RAW>;
  using Bf = typename L::Bf;
  static_assert(STAGES >= 3, "A of stage kb + 1 is folded while stage kb - 1 may still be read");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = s9::aligned_smem(smem_raw);
  uint8_t* raw = ring + L::kRaw;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kBars);
  uint64_t* empty = full + STAGES;
  uint64_t* raw_a = empty + STAGES;
  uint64_t* raw_b = raw_a + RAW;
  int tm, tn;
  s9::tile_of(p.tiles_m, p.tiles_n, 0, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int nk = p.k / s9::kBK;
  const int k_blocks = p.k / dga::kGroup;
  const int tid = threadIdx.x;
  auto load_a = [&](int kb) {
    const int s = kb % RAW;
    s9::mbar_expect_tx(&raw_a[s], L::kRawA);
    s9::tma_load(raw + s * L::kRawStage, &ta, &raw_a[s], kb * s9::kBK, m0, 0);
  };
  auto load_b = [&](int kb) {
    const int s = kb % RAW;
    uint8_t* rb = raw + s * L::kRawStage + L::kRawA;
    s9::mbar_expect_tx(&raw_b[s], L::kRawStage - L::kRawA);
    if (B_KMAJOR) s9::tma_load(rb, &tb, &raw_b[s], kb * s9::kBK, n0, 0);
    else s9::tma_load(rb, &tb, &raw_b[s], n0, kb * s9::kBK, 0);
  };
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      s9::mbar_init(&full[i], Sh::kCons + Sh::kFold);
      s9::mbar_init(&empty[i], Sh::kConsumers);
    }
    for (int i = 0; i < RAW; ++i) {
      s9::mbar_init(&raw_a[i], 1);
      s9::mbar_init(&raw_b[i], 1);
    }
    s9::fence_barrier_init();
    for (int kb = 0; kb < min(nk, RAW); ++kb) {
      load_a(kb);
      load_b(kb);
    }
  }
  __syncthreads();
  if (tid < Sh::kCons) {
    // Consumers: A of stage j into bf16 slot j % STAGES (its previous
    // contents, stage j - STAGES, were read by products already waited
    // for), then the bf16 ring through wgmma, then the epilogue.
    constexpr int kCh = BM * 4 / Sh::kCons;              // A: BM rows x 4 chunks
    constexpr int kPerGroup = dga::kGroup / s9::kBK;     // stages per scale group
    // The rows' scales of group g, in registers a group ahead of their use.
    auto a_scales = [&](float (&sa)[kCh], int g) {
#pragma unroll
      for (int i = 0; i < kCh; ++i) {
        const int row = m0 + (tid + i * Sh::kCons) / 4;
        sa[i] = row < p.m && g < k_blocks ? __ldg(p.a_s + (size_t)row * k_blocks + g) : 0.f;
      }
    };
    float sa[kCh], sa_next[kCh];
    a_scales(sa, 0);
    a_scales(sa_next, 1);
    auto fold_a = [&](int j) {
      const int rs = j % RAW;
      if (j > 0 && j % kPerGroup == 0) {
#pragma unroll
        for (int i = 0; i < kCh; ++i) sa[i] = sa_next[i];
        a_scales(sa_next, j / kPerGroup + 1);
      }
      s9::mbar_wait(&raw_a[rs], (j / RAW) & 1);
      uint4 va[kCh];
#pragma unroll
      for (int i = 0; i < kCh; ++i)
        va[i] = reinterpret_cast<const uint4*>(raw + rs * L::kRawStage)[tid + i * Sh::kCons];
      s9::fence_proxy_async();
      group_sync<2, Sh::kCons>();
      if (tid == 0 && j + RAW < nk) load_a(j + RAW);
      uint8_t* fa = ring + (j % STAGES) * Bf::kStage;
#pragma unroll
      for (int i = 0; i < kCh; ++i) {
        const int q = tid + i * Sh::kCons;
        const float sai = sa[i];
        fold_store(fa, q / 4, q % 4, va[i], [=](int) { return sai; });
      }
      s9::fence_proxy_async();
      s9::mbar_arrive(&full[j % STAGES]);
    };
    const int wg = tid / 128;
    float acc[BN / 2];
    if (nk > 0) fold_a(0);
    s9::mma_loop<__nv_bfloat16, BM, BN, STAGES, false, !B_KMAJOR>(
        acc, ring, full, empty, nk, wg, [&](int kb) {
          if (kb + 1 < nk) fold_a(kb + 1);
        });
    s9::store_tile<BN>(acc, static_cast<OutT*>(p.c), p.m, p.n, m0 + wg * 64, n0);
  } else {
    // The fold warpgroup: B. Chunk q of a stage is 16 bytes of one raw row.
    const int ft = tid - Sh::kCons;
    constexpr int kCh = BN * 4 / Sh::kFold;              // B: BN x 64 bytes either way
    const bool one_scale = p.bs_shift >= 4;              // 16 columns share a scale
    const int shift = p.bs_shift;
    const long long bs_n = p.bs_n;
    constexpr int kPerGroup = dga::kGroup / s9::kBK;
    // The chunks' scales of group g (one per chunk: 16 columns in one
    // 128-column block; an expanded panel, bs_shift < 4, takes its 16
    // scales in the fold below), in registers a group ahead of their use.
    auto b_scales = [&](float (&sb)[kCh], int g) {
      const float* bs = p.b_s + (size_t)min(g, k_blocks - 1) * p.bs_g;
#pragma unroll
      for (int i = 0; i < kCh; ++i) {
        const int q = ft + i * Sh::kFold;
        const int col = B_KMAJOR ? n0 + q / 4 : n0 + (q % (BN / 16)) * 16;
        sb[i] = __ldg(bs + (size_t)(col >> shift) * bs_n);
      }
    };
    float sb[kCh], sb_next[kCh];
    b_scales(sb, 0);
    b_scales(sb_next, 1);
    int s = 0, rs = 0;
    uint32_t phase = 0, rphase = 0;
    for (int kb = 0; kb < nk; ++kb) {
      const int g = kb / kPerGroup;
      const float* bs = p.b_s + (size_t)g * p.bs_g;
      if (kb > 0 && kb % kPerGroup == 0) {
#pragma unroll
        for (int i = 0; i < kCh; ++i) sb[i] = sb_next[i];
        b_scales(sb_next, g + 1);
      }
      s9::mbar_wait(&raw_b[rs], rphase);
      const uint8_t* rb = raw + rs * L::kRawStage + L::kRawA;
      uint4 vb[kCh];
#pragma unroll
      for (int i = 0; i < kCh; ++i) vb[i] = reinterpret_cast<const uint4*>(rb)[ft + i * Sh::kFold];
      s9::fence_proxy_async();
      group_sync<1, Sh::kFold>();
      if (ft == 0 && kb + RAW < nk) load_b(kb + RAW);
      s9::mbar_wait(&empty[s], phase ^ 1);
      uint8_t* fb = ring + s * Bf::kStage + Bf::kA;
#pragma unroll
      for (int i = 0; i < kCh; ++i) {
        const int q = ft + i * Sh::kFold;
        const float sbi = sb[i];
        if (B_KMAJOR) {
          fold_store(fb, q / 4, q % 4, vb[i], [=](int) { return sbi; });
        } else {
          // Raw row kk holds BN columns; chunk c covers columns 16c..16c+15,
          // which land in panel c / 4 (64 columns), chunks 2(c % 4), +1.
          const int kk = q / (BN / 16), c = q % (BN / 16);
          const int col = n0 + 16 * c;
          uint8_t* panel = fb + (c / 4) * s9::kPanel;
          if (one_scale)
            fold_store(panel, kk, c % 4, vb[i], [=](int) { return sbi; });
          else
            fold_store(panel, kk, c % 4, vb[i],
                       [=](int e) { return __ldg(bs + (size_t)((col + e) >> shift) * bs_n); });
        }
      }
      // The bf16 writes, fenced for wgmma (async proxy), then handed on.
      s9::fence_proxy_async();
      s9::mbar_arrive(&full[s]);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
      if (++rs == RAW) {
        rs = 0;
        rphase ^= 1;
      }
    }
  }
}

template <int BM, int BN, int STAGES, int RAW, bool B_KMAJOR, typename OutT>
int run_folded(const void* a, const void* a_s, const void* b, const void* b_s, void* c, int m,
               int n, int k, long long bs_g, long long bs_n, int bs_shift, cudaStream_t s) {
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap ta, tb;
  int rc = s9::make_map(&ta, u8, 1, a, k, m, 1, k, 0, s9::kBK, BM, none);
  if (rc) return rc;
  rc = B_KMAJOR ? s9::make_map(&tb, u8, 1, b, k, n, 1, k, 0, s9::kBK, BN, none)
                : s9::make_map(&tb, u8, 1, b, n, k, 1, n, 0, BN, s9::kBK, none);
  if (rc) return rc;
  const int tiles_m = (m + BM - 1) / BM, tiles_n = n / BN;
  const FoldArgs p{static_cast<const float*>(a_s), static_cast<const float*>(b_s), c, m, n, k,
                   bs_g, bs_n, bs_shift, tiles_m, tiles_n};
  return s9::launch<folded_sm90_kernel<BM, BN, STAGES, RAW, B_KMAJOR, OutT>>(
      dim3(tiles_m * tiles_n), FoldShape<BM>::kThreads, FoldRing<BM, BN, STAGES, RAW>::kSmem, s,
      ta, tb, p);
}

// The caller's tile (tiling/analytic.py: TILES[("fp8", "folded")]): 0 is
// 64 x 64 with three blocks an SM, 1 128 x 128, 2 128 x 256 (n a multiple
// of 256 only: the grid covers n / 256 tiles).
template <bool B_KMAJOR, typename OutT>
int tile_folded(int tile, const void* a, const void* a_s, const void* b, const void* b_s, void* c,
                int m, int n, int k, long long bs_g, long long bs_n, int bs_shift,
                cudaStream_t s) {
  if (tile == 0)
    return run_folded<64, 64, 3, 3, B_KMAJOR, OutT>(a, a_s, b, b_s, c, m, n, k, bs_g, bs_n,
                                                     bs_shift, s);
  if (tile == 1)
    return run_folded<128, 128, 3, 6, B_KMAJOR, OutT>(a, a_s, b, b_s, c, m, n, k, bs_g, bs_n,
                                                       bs_shift, s);
  if (tile == 2 && n % 256 == 0)
    return run_folded<128, 256, 3, 3, B_KMAJOR, OutT>(a, a_s, b, b_s, c, m, n, k, bs_g, bs_n,
                                                       bs_shift, s);
  return (int)cudaErrorInvalidValue;
}

template <bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(dga::kThreads) fp8_gemm_kernel(dga::GemmArgs p, OutT* c) {
  dga::gemm_tile<B_KMAJOR, OutT>(p, c, blockIdx.y * dga::kBM, blockIdx.x * dga::kBN);
}

template <bool B_KMAJOR, typename OutT>
void launch(const dga::GemmArgs& p, void* c, cudaStream_t stream) {
  dim3 grid(p.n / dga::kBN, (p.m + dga::kBM - 1) / dga::kBM);
  fp8_gemm_kernel<B_KMAJOR, OutT><<<grid, dga::kThreads, 0, stream>>>(p, static_cast<OutT*>(c));
}

bool bad_shape(int m, int n, int k) { return m <= 0 || n % dga::kBN || k % dga::kGroup; }

// Layouts and output types of K1 (FOLDED false; its route, ring tile and
// splits) and K12 (its tile).
template <bool FOLDED>
int run(const void* a, const void* a_s, const void* b, const void* b_s, void* c, int m, int n,
        int k, long long sbk, long long sbn, long long bs_g, long long bs_n, int bs_shift,
        int out_f32, int route, int tile, int splits, void* stream) {
  if (bad_shape(m, n, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kmajor = sbk == 1;
  if constexpr (FOLDED) {
    // The two layouts the maps describe: (n, k) and (k, n), both dense.
    if (kmajor ? sbn != k : sbn != 1 || sbk != n) return (int)cudaErrorInvalidValue;
    if (kmajor && out_f32)
      return tile_folded<true, float>(tile, a, a_s, b, b_s, c, m, n, k, bs_g, bs_n, bs_shift, s);
    if (kmajor)
      return tile_folded<true, __nv_bfloat16>(tile, a, a_s, b, b_s, c, m, n, k, bs_g, bs_n,
                                              bs_shift, s);
    if (out_f32)
      return tile_folded<false, float>(tile, a, a_s, b, b_s, c, m, n, k, bs_g, bs_n, bs_shift, s);
    return tile_folded<false, __nv_bfloat16>(tile, a, a_s, b, b_s, c, m, n, k, bs_g, bs_n,
                                             bs_shift, s);
  } else if (route == dga::kRouteRing) {
    // TMA reads B as (n, k) rows of k bytes: K-major and dense only.
    if (sbk != 1 || sbn != k) return (int)cudaErrorInvalidValue;
    const dga::ring::RingArgs p{static_cast<const float*>(a_s), static_cast<const float*>(b_s),
                                nullptr, c, m, n, k, 0, bs_g, bs_n, bs_shift, splits};
    return dga::ring::launch(tile, out_f32, a, b, 0, 1, p, s);
  } else {
    if (route != dga::kRouteTile || splits != 1) return (int)cudaErrorInvalidValue;
    dga::GemmArgs p{static_cast<const uint8_t*>(a), static_cast<const float*>(a_s),
                    static_cast<const uint8_t*>(b), static_cast<const float*>(b_s),
                    m, n, k, sbk, sbn, bs_g, bs_n, bs_shift};
    if (kmajor && out_f32) launch<true, float>(p, c, s);
    else if (kmajor) launch<true, __nv_bfloat16>(p, c, s);
    else if (out_f32) launch<false, float>(p, c, s);
    else launch<false, __nv_bfloat16>(p, c, s);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// K1: element (kk, col) of B at b[kk * sbk + col * sbn]; scale (g, col) at
// b_s[g * bs_g + (col >> bs_shift) * bs_n].
// route: 0 tile, 1 ring (dga::Route); tile: the ring's tile index
// (dga::ring::launch); splits: CTAs per cluster splitting the groups (ring
// only; 1 on the tile route).
extern "C" int dga_fp8_gemm(const void* a, const void* a_s, const void* b,
                            const void* b_s, void* c, int m, int n, int k,
                            long long sbk, long long sbn, long long bs_g,
                            long long bs_n, int bs_shift, int out_f32,
                            int route, int tile, int splits, void* stream) {
  return run<false>(a, a_s, b, b_s, c, m, n, k, sbk, sbn, bs_g, bs_n, bs_shift, out_f32, route,
                    tile, splits, stream);
}

// K12: the same operands and addressing, folded scales; tile: 0 64 x 64,
// 1 128 x 128, 2 128 x 256 (tile_folded).
extern "C" int dga_fp8_gemm_folded(const void* a, const void* a_s, const void* b,
                                   const void* b_s, void* c, int m, int n, int k,
                                   long long sbk, long long sbn, long long bs_g,
                                   long long bs_n, int bs_shift, int out_f32,
                                   int tile, void* stream) {
  return run<true>(a, a_s, b, b_s, c, m, n, k, sbk, sbn, bs_g, bs_n, bs_shift, out_f32, 0, tile,
                   1, stream);
}
