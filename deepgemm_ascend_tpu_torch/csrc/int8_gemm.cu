// K7, K9, K6: W8A8 int8 GEMMs for Hopper (sm_90a).
//
// Replaces three kernels of deepgemm_ascend_tpu/ops/int8_gemm.py:
//   K7 _int8_kernel (:45)          dense          -> dga_int8_gemm
//   K9 _int8_grouped_kernel (:217) contiguous MoE -> dga_int8_grouped_contiguous
//   K6 _int8_masked_kernel (:371)  masked MoE     -> dga_int8_grouped_masked
// All three compute
//     out[i, j] = (sum_k a_q[i, k] * b_q[k, j]) * a_s[i] * b_s[j]
// with one exact int32 K-sum and one f32 epilogue. They differ only in how
// rows map to experts, so one tile routine (int8_tile) serves all three:
//   K7: a plain 2-D grid of 64 x 64 output tiles;
//   K9: grid y walks the layout's m-tiles (block_m rows, one expert each) and
//       the 64-row kernel tiles inside each, so a kernel tile never spans two
//       experts whatever block_m is; an expert id of -1 stores zeros and
//       loads nothing;
//   K6 (route int8_tile): grid z walks the experts; a tile whose first
//       row is at or past masked_m[e] stores zeros and returns before any
//       load, as K3 does.
//
// Numerics. mma.sync m16n8k32 s8 x s8 -> s32 sums exactly, in any order, so
// the int32 accumulators are held across the whole K loop and a permutation
// of k inside a step (applied to A and B alike) changes nothing. The
// epilogue converts with cvt.rn.f32.s32 (__int2float_rn) and multiplies
// (acc * a_s) * b_s with __fmul_rn, never folding a_s * b_s and never
// contracted, then rounds to bf16 (RN) or stores f32: the order of the JAX
// kernels (int8_gemm.py:71-72, :246, :402). The result therefore equals the
// plain PyTorch version bit for bit.
//
// Any M, N and K: the K tail and the M and N edges are zero-filled in shared
// memory (int8 garbage would corrupt the exact sum) and masked on store.
// Rows and B are read with 16-byte loads where K (and, for B stored (k, n),
// N) is a multiple of 16 and the pointers are aligned, else byte by byte.
// B stored (k, n) is transposed through shared memory: ldmatrix .trans
// works on 16-bit elements only.
//
// Bound on the card: the weight bytes at decode (m = 16, or a few rows per
// expert), int8 tensor-core work at prefill.
//
// K7 takes one of two routes, chosen by the caller (ops/int8_gemm.py:route)
// and passed in; the entry refuses a route it cannot take:
//   route 1, "wgmma" (B stored K-major, (n, k): b_layout 't'; k a multiple
//     of 16 and 16-byte aligned operands, so that TMA can describe both):
//     the Hopper main loop of sm90_gemm.cuh with 8-bit stages. A stage is
//     128 bytes of K a row, 128 int8 elements, the bytes of the 16-bit
//     loop's 64-element stage, so the ring, the TMA boxes and the 128-byte
//     swizzle are the same; wgmma.mma_async m64nNk32.s32.s8.s8, four a
//     stage, sums exactly into s32 accumulators; the epilogue scales them
//     (sm90::store_tile_scaled). TMA zero-fills the K tail and the M/N
//     edges, which keeps the sum exact. Tiles as K10's (sm90::large_tile):
//     128 x 256 where those fill the card, else 64 x 64, two blocks an SM
//     (m <= 64: 344 tiles at n = 22016). wgmma reads 8-bit operands
//     K-major only, so B stored (k, n) cannot take this route.
//   route 0, "int8_tile" (every layout and shape; K9 and K6 with B stored
//     (k, n), K9 with a block_m that 64 does not divide): the simple
//     design below: 64 x 64 tiles, 4 warps of 32 x 32, 128-deep K steps
//     staged in shared memory through registers
//     (the next step's global loads are in flight during this step's math;
//     no cp.async/TMA ring), mma.sync at a fraction of the wgmma s8 rate.
//     Idle masked tiles cost a block and a zero store each.
//
// K6 (_int8_masked_kernel, :371) with B stored K-major takes one of two
// routes by the rows an expert is expected to hold (ops/int8_gemm.py:
// masked_plan, from the MoE layer's expected_m), both over 3-D TMA maps
// with batch = expert, both with CTAs that walk the m-tiles of their
// (expert, n-tile) (ceil(m-tiles / 8) CTAs of them) and zero the tiles
// past masked_m[e], which load nothing:
//   route 1, "ring" (decode: <= 16 rows an expert): 16 x 64 tiles, a ring
//     of six 128-deep stages (16 A rows and 64 B rows of 128 bytes,
//     128-byte swizzle) fed by a producer warp, four consumer warps of
//     16 x 16 running mma.sync m16n8k32 s8 into int32 accumulators held
//     over the whole K loop, then int8_tile's epilogue. Bound on the card:
//     the weight bytes of the active experts (0.052 ms at V2_LITE's decode
//     shape).
//   route 2, "wgmma" (beyond): K7's main loop, 64 x 64 tiles up to 64
//     rows an expert and 128 x 256 beyond (the crossovers that
//     scripts/decode_sweep.py measures), the ring carried
//     from tile to tile of a CTA (produce / mma_loop from stage `it`).
//     At prefill (6T rows an expert, ~T/E valid) the zero stores of the
//     buffer and the operand reads together bound it (DRAM).
// K9 (_int8_grouped_kernel, :217) with B stored K-major and a block_m that
// 64 divides takes route 1, "wgmma" (ops/int8_gemm.py: contiguous_route):
// K6's route 2 with the contiguous map in place of masked_m (a 2-D map over
// the flat A, the 3-D B map whose batch is the tile's expert, read from
// tile_gids before the tile's boxes are issued); 128 x 256 tiles where 128
// divides block_m, else 64 x 64, so that no tile spans two experts;
// persistent CTAs carry one ring across their tiles, and a padding tile
// (-1) loads nothing and is zeroed by the consumers, which skip it in step
// with the producer. Bound on the card: the operand bytes from L2 and the
// int8 tensor cores.
// The sums are exact, so every route equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

namespace s9 = dga::sm90;
using s9::store_cols;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 128;
constexpr int kThreads = 128;            // 4 warps in a 2 x 2 layout
constexpr int kPitch = kBK + 16;         // smem row pitch in bytes: conflict-free fragment reads
constexpr int kMaxGridY = 65535;

struct Args {
  const int8_t* a;     // (rows, k) row-major, k contiguous
  const float* a_s;    // one scale per row
  const int8_t* b;     // B_KMAJOR: (n, k) with row stride ldb; else (k, n) with row stride ldb
  const float* b_s;    // one scale per output column
  int n, k;
  long long ldb;
  bool vec_a, vec_b;   // 16-byte loads are legal
};

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Zeros over rows [m0, m_end) and columns [n0, n0 + kBN) of c (n columns).
template <typename OutT>
__device__ void zero_tile(OutT* c, int n, int m0, int m_end, int n0) {
  for (int idx = threadIdx.x; idx < kBM * kBN / 2; idx += kThreads) {
    const int r = m0 + idx / (kBN / 2);
    const int col = n0 + (idx % (kBN / 2)) * 2;
    if (r < m_end) store_cols(c + (size_t)r * n, col, n, 0.f, 0.f);
  }
}

constexpr int kChunks = kBM * kBK / 16 / kThreads;   // 16-byte chunks per thread per tile

__device__ __forceinline__ uint4 ldg16(const int8_t* ptr) {
  return __ldg(reinterpret_cast<const uint4*>(ptr));
}

// One K step of the operands that take 16-byte loads, held in registers
// between the global load and the shared-memory store.
struct Staged {
  uint4 a[kChunks];
  uint4 b[kChunks];
};

template <bool B_KMAJOR>
__device__ __forceinline__ void load_vec(const Args& p, Staged& s, int m0, int m_end, int n0,
                                         int k0) {
  const int kr = min(kBK, p.k - k0);   // valid depth of the step; the rest is zero
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx >> 3, ch = (idx & 7) * 16;     // row, byte offset in a 128-byte row
    if (p.vec_a)
      s.a[it] = (m0 + r < m_end && ch < kr) ? ldg16(p.a + (size_t)(m0 + r) * p.k + k0 + ch)
                                            : zero;
    if (p.vec_b) {
      if (B_KMAJOR) {
        s.b[it] = (n0 + r < p.n && ch < kr) ? ldg16(p.b + (size_t)(n0 + r) * p.ldb + k0 + ch)
                                            : zero;
      } else {
        // 16 neighbouring columns of one k row (kBN / 16 chunks per row).
        const int kk = idx >> 2, cc = (idx & 3) * 16;
        s.b[it] = (kk < kr && n0 + cc < p.n) ? ldg16(p.b + (size_t)(k0 + kk) * p.ldb + n0 + cc)
                                             : zero;
      }
    }
  }
}

template <bool B_KMAJOR>
__device__ __forceinline__ void store_vec(const Args& p, const Staged& s, int8_t* As,
                                          int8_t* Bs) {
#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx >> 3, ch = (idx & 7) * 16;
    if (p.vec_a) *reinterpret_cast<uint4*>(As + r * kPitch + ch) = s.a[it];
    if (p.vec_b) {
      if (B_KMAJOR) {
        *reinterpret_cast<uint4*>(Bs + r * kPitch + ch) = s.b[it];
      } else {
        // Transposed through shared memory: one byte to each of 16 columns.
        const int kk = idx >> 2, cc = (idx & 3) * 16;
        const int8_t* bytes = reinterpret_cast<const int8_t*>(&s.b[it]);
#pragma unroll
        for (int j = 0; j < 16; ++j) Bs[(cc + j) * kPitch + kk] = bytes[j];
      }
    }
  }
}

// The operands that 16-byte loads cannot serve (ragged K or N, unaligned
// pointers), byte by byte straight into shared memory.
template <bool B_KMAJOR>
__device__ void load_bytes(const Args& p, int8_t* As, int8_t* Bs, int m0, int m_end, int n0,
                           int k0) {
  const int kr = min(kBK, p.k - k0);
  if (!p.vec_a) {
    for (int idx = threadIdx.x; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, kk = idx % kBK;
      As[r * kPitch + kk] =
          (m0 + r < m_end && kk < kr) ? __ldg(p.a + (size_t)(m0 + r) * p.k + k0 + kk) : int8_t(0);
    }
  }
  if (!p.vec_b) {
    for (int idx = threadIdx.x; idx < kBN * kBK; idx += kThreads) {
      if (B_KMAJOR) {
        const int r = idx / kBK, kk = idx % kBK;
        Bs[r * kPitch + kk] =
            (n0 + r < p.n && kk < kr) ? __ldg(p.b + (size_t)(n0 + r) * p.ldb + k0 + kk) : int8_t(0);
      } else {
        const int kk = idx / kBN, col = idx % kBN;
        Bs[col * kPitch + kk] =
            (kk < kr && n0 + col < p.n) ? __ldg(p.b + (size_t)(k0 + kk) * p.ldb + n0 + col)
                                        : int8_t(0);
      }
    }
  }
}

// Rows [m0, m_end) (m_end - m0 <= kBM) and columns [n0, n0 + kBN) of
// C = A . B, C row-major with p.n columns. Rows from m_end and columns from
// p.n on are neither loaded nor stored. The 16-byte loads of step k + 1 are
// issued before the math of step k, so their latency hides behind it.
template <bool B_KMAJOR, typename OutT>
__device__ void int8_tile(const Args& p, OutT* c, int m0, int m_end, int n0) {
  __shared__ __align__(16) int8_t As[kBM * kPitch];
  __shared__ __align__(16) int8_t Bs[kBN * kPitch];   // column-major: k contiguous per column

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  Staged staged;
  load_vec<B_KMAJOR>(p, staged, m0, m_end, n0, 0);
  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    store_vec<B_KMAJOR>(p, staged, As, Bs);
    load_bytes<B_KMAJOR>(p, As, Bs, m0, m_end, n0, k0);
    __syncthreads();
    if (k0 + kBK < p.k) load_vec<B_KMAJOR>(p, staged, m0, m_end, n0, k0 + kBK);

    // Thread (g, t) holds k = 4t..4t+3 and 16+4t..16+4t+3 of each 32-deep
    // step, for A rows g and g + 8 and for B column g (PTX m16n8k32 .s8).
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      const int ko = ks * 32 + t * 4;
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r0 = As + (wm * 32 + i * 16 + g) * kPitch + ko;
        const int8_t* r8 = r0 + 8 * kPitch;
        af[i][0] = ld32(r0);
        af[i][1] = ld32(r8);
        af[i][2] = ld32(r0 + 16);
        af[i][3] = ld32(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* col = Bs + (wn * 32 + j * 8 + g) * kPitch + ko;
        bf[j][0] = ld32(col);
        bf[j][1] = ld32(col + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // Epilogue: (acc * a_s) * b_s, rounded as written (sm90::dequant).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + wm * 32 + i * 16 + g;
    const float s_lo = r < m_end ? p.a_s[r] : 0.f;
    const float s_hi = r + 8 < m_end ? p.a_s[r + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + t * 2;
      const float b0 = col < p.n ? p.b_s[col] : 0.f;
      const float b1 = col + 1 < p.n ? p.b_s[col + 1] : 0.f;
      if (r < m_end)
        store_cols(c + (size_t)r * p.n, col, p.n, s9::dequant(acc[i][j][0], s_lo, b0),
                   s9::dequant(acc[i][j][1], s_lo, b1));
      if (r + 8 < m_end)
        store_cols(c + (size_t)(r + 8) * p.n, col, p.n, s9::dequant(acc[i][j][2], s_hi, b0),
                   s9::dequant(acc[i][j][3], s_hi, b1));
    }
  }
}

// K7: dense.
template <bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(kThreads) int8_gemm_kernel(Args p, int m, OutT* c) {
  const int m0 = blockIdx.y * kBM;
  int8_tile<B_KMAJOR, OutT>(p, c, m0, min(m0 + kBM, m), blockIdx.x * kBN);
}

// K9: contiguous grouped; tile_gids[t] is the expert of rows
// [t * block_m, (t + 1) * block_m), -1 for a padding tile.
template <bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_contiguous_kernel(Args p, const int* tile_gids, int block_m, long long b_e, OutT* c) {
  const int sub = (block_m + kBM - 1) / kBM;    // kernel tiles per layout tile
  const int tile = blockIdx.y / sub;
  const int m0 = tile * block_m + (blockIdx.y % sub) * kBM;
  const int m_end = min(m0 + kBM, (tile + 1) * block_m);
  const int n0 = blockIdx.x * kBN;
  const int e = tile_gids[tile];
  if (e < 0) {
    zero_tile(c, p.n, m0, m_end, n0);
    return;
  }
  Args q = p;
  q.b += (size_t)e * b_e;
  q.b_s += (size_t)e * p.n;
  int8_tile<B_KMAJOR, OutT>(q, c, m0, m_end, n0);
}

// K6: masked grouped over (E, m_max, ·) buffers.
template <bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_masked_kernel(Args p, const int* masked_m, int m_max, long long b_e, OutT* c) {
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int m_end = min(m0 + kBM, m_max);
  OutT* ce = c + (size_t)e * m_max * p.n;
  if (m0 >= masked_m[e]) {
    zero_tile(ce, p.n, m0, m_end, n0);
    return;
  }
  Args q = p;
  q.a += (size_t)e * m_max * p.k;
  q.a_s += (size_t)e * m_max;
  q.b += (size_t)e * b_e;
  q.b_s += (size_t)e * p.n;
  int8_tile<B_KMAJOR, OutT>(q, ce, m0, m_end, n0);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// B is K-major ((n, k): b_layout 't') when its k stride is 1.
Args make_args(const void* a, const void* a_s, const void* b, const void* b_s, int n, int k,
               long long sbk, long long sbn, long long b_e) {
  const bool kmajor = sbk == 1;
  Args p;
  p.a = static_cast<const int8_t*>(a);
  p.a_s = static_cast<const float*>(a_s);
  p.b = static_cast<const int8_t*>(b);
  p.b_s = static_cast<const float*>(b_s);
  p.n = n;
  p.k = k;
  p.ldb = kmajor ? sbn : sbk;
  p.vec_a = k % 16 == 0 && aligned16(a);
  p.vec_b = (kmajor ? k % 16 == 0 : n % 16 == 0) && p.ldb % 16 == 0 && b_e % 16 == 0 &&
            aligned16(b);
  return p;
}

int n_blocks(int n) { return (n + kBN - 1) / kBN; }

// Instantiates launch<B_KMAJOR, OutT> for the four (layout, output) pairs.
template <template <bool, typename> class L, typename... T>
void dispatch(bool kmajor, int out_f32, T... args) {
  if (kmajor && out_f32) L<true, float>::run(args...);
  else if (kmajor) L<true, __nv_bfloat16>::run(args...);
  else if (out_f32) L<false, float>::run(args...);
  else L<false, __nv_bfloat16>::run(args...);
}

template <bool KM, typename OutT>
struct DenseLaunch {
  static void run(Args p, int m, void* c, cudaStream_t s) {
    dim3 grid(n_blocks(p.n), (m + kBM - 1) / kBM);
    int8_gemm_kernel<KM, OutT><<<grid, kThreads, 0, s>>>(p, m, static_cast<OutT*>(c));
  }
};

template <bool KM, typename OutT>
struct ContiguousLaunch {
  static void run(Args p, const int* gids, int n_tiles, int block_m, long long b_e, void* c,
                  cudaStream_t s) {
    dim3 grid(n_blocks(p.n), n_tiles * ((block_m + kBM - 1) / kBM));
    int8_contiguous_kernel<KM, OutT><<<grid, kThreads, 0, s>>>(p, gids, block_m, b_e,
                                                                static_cast<OutT*>(c));
  }
};

template <bool KM, typename OutT>
struct MaskedLaunch {
  static void run(Args p, const int* masked_m, int e, int m_max, long long b_e, void* c,
                  cudaStream_t s) {
    dim3 grid(n_blocks(p.n), (m_max + kBM - 1) / kBM, e);
    int8_masked_kernel<KM, OutT><<<grid, kThreads, 0, s>>>(p, masked_m, m_max, b_e,
                                                            static_cast<OutT*>(c));
  }
};

// ---------------------------------------------------------------- route 1

struct Sm90Args {
  void* c;
  const float* a_s;
  const float* b_s;
  int m, n;
  int tiles_m, tiles_n;
  int kb;   // 128-deep K stages
};

// K7 on the Hopper main loop: BM / 64 consumer warpgroups, then the
// producer warpgroup, as gemm.cu's gemm_sm90_kernel; both operands K-major.
template <int BM, int BN, int STAGES, typename OutT>
__global__ void __launch_bounds__((BM / 64 + 1) * 128, BM == 64 ? 2 : 1)
    int8_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, Sm90Args p) {
  using R = s9::Ring<BM, BN, STAGES>;
  constexpr int kConsumers = BM / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = s9::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kBytes);
  uint64_t* empty = full + STAGES;
  int tm, tn;
  s9::tile_of(p.tiles_m, p.tiles_n, 0, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int wg = threadIdx.x / 128;
  s9::init_ring<STAGES>(full, empty, kConsumers);
  __syncthreads();
  if (wg == kConsumers) {
    if constexpr (kConsumers == 2) s9::regs_dec<40>();
    if (threadIdx.x == kConsumers * 128)
      s9::produce<int8_t, BM, BN, STAGES, false, false>(ring, full, empty, &ta, &tb, m0, n0, 0, 0,
                                                        p.kb);
  } else {
    if constexpr (kConsumers == 2) s9::regs_inc<232>();
    int acc[BN / 2];
    s9::mma_loop<int8_t, BM, BN, STAGES, false, false>(acc, ring, full, empty, p.kb, wg,
                                                       [](int) {});
    s9::store_tile_scaled<BN>(acc, static_cast<OutT*>(p.c), p.a_s, p.b_s, p.m, p.n,
                              m0 + wg * 64, n0);
  }
}

// Maps of A (m, k) and B (n, k, row pitch ldb) as bytes, 128-byte boxes of
// K, then the launch.
template <int BM, int BN, int STAGES, typename OutT>
int run_int8_sm90(const void* a, const void* a_s, const void* b, const void* b_s, void* c, int m,
                  int n, int k, long long ldb, cudaStream_t s) {
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  constexpr int kDepth = s9::kStageK<int8_t>;   // 128 int8 of K a stage
  CUtensorMap ta, tb;
  int rc = s9::make_map(&ta, u8, 1, a, k, m, 1, k, 0, kDepth, BM, sw);
  if (rc) return rc;
  rc = s9::make_map(&tb, u8, 1, b, k, n, 1, ldb, 0, kDepth, BN, sw);
  if (rc) return rc;
  const int tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const Sm90Args p{c, static_cast<const float*>(a_s), static_cast<const float*>(b_s), m, n,
                   tiles_m, tiles_n, (k + kDepth - 1) / kDepth};
  return s9::launch<int8_sm90_kernel<BM, BN, STAGES, OutT>>(
      dim3(tiles_m * tiles_n), (BM / 64 + 1) * 128, s9::Ring<BM, BN, STAGES>::kSmem, s, ta, tb, p);
}

template <typename OutT>
int tile_int8_sm90(const void* a, const void* a_s, const void* b, const void* b_s, void* c, int m,
                   int n, int k, long long ldb, cudaStream_t s) {
  const long long tiles = (long long)((m + 127) / 128) * ((n + 255) / 256);
  if (s9::large_tile(m, tiles))
    return run_int8_sm90<128, 256, 4, OutT>(a, a_s, b, b_s, c, m, n, k, ldb, s);
  return run_int8_sm90<64, 64, 6, OutT>(a, a_s, b, b_s, c, m, n, k, ldb, s);
}

// ------------------------------------------------------ K6's routes 1 and 2

struct MaskedArgs {
  void* c;               // (E, m, n), row-major
  const float* a_s;      // (E, m)
  const float* b_s;      // (E, n)
  const int* masked_m;   // the valid rows of expert e
  int m, n;              // m: M_max
  int kb;                // 128-deep K stages
};

// K6's CTAs walk the m-tiles y, y + Y, ... of their (expert, n-tile), Y =
// ceil(m-tiles / kTilesPerCta): the tiles past masked_m[e] (most of the
// buffer) are zeroed by the CTA that walks them, after its valid tiles,
// which come first and are spread over the Y CTAs.
constexpr int kTilesPerCta = 8;

int walkers(int tiles_m) { return (tiles_m + kTilesPerCta - 1) / kTilesPerCta; }

// Zeros over rows [r0, r1) x columns [c0, c1) of c (n columns), by the
// `threads` threads numbered from `tid`: 16-byte stores where the row
// pitch and c0 allow them, else one element at a time.
template <typename OutT>
__device__ void zero_block(OutT* c, int n, int r0, int r1, int c0, int c1, int tid, int threads) {
  constexpr int kVec = 16 / (int)sizeof(OutT);
  if (n % kVec == 0 && c0 % kVec == 0) {
    const int per_row = (c1 - c0) / kVec;
    for (int i = tid; i < (r1 - r0) * per_row; i += threads)
      *reinterpret_cast<uint4*>(c + (size_t)(r0 + i / per_row) * n + c0 + (i % per_row) * kVec) =
          make_uint4(0u, 0u, 0u, 0u);
  } else {
    const int w = c1 - c0;
    for (int i = tid; i < (r1 - r0) * w; i += threads)
      s9::store1(c + (size_t)(r0 + i / w) * n + c0 + i % w, 0.f);
  }
}

// Route 1, "ring" (decode: a few rows an expert): 16 x 64 tiles, a TMA
// ring of kStages 128-deep stages (16 A rows and 64 B rows of 128 bytes,
// 128-byte swizzle, 3-D maps with batch = expert) fed by a producer warp;
// four consumer warps of 16 x 16 run mma.sync m16n8k32 s8 into int32
// accumulators held over the whole K loop, then int8_tile's epilogue.
namespace ring8 {

constexpr int kBM = 16, kBN = 64, kWarps = 4, kStages = 6;
constexpr int kThreads = (kWarps + 1) * 32;
constexpr int kA = kBM * 128, kB = kBN * 128, kStage = kA + kB;
constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;
static_assert(kA % 1024 == 0, "B's box starts on the swizzle period");

// The word at byte kk (a multiple of 4) of row r of a 128-byte-swizzled
// box: eight rows x four threads of a warp hit 32 distinct banks.
__device__ __forceinline__ uint32_t ld_sw(const uint8_t* box, int r, int kk) {
  return *reinterpret_cast<const uint32_t*>(box + r * 128 + (((kk >> 4) ^ (r & 7)) << 4) +
                                            (kk & 15));
}

// Grid (ceil(n / kBN), walkers, E). Threads: the consumer warps, then the
// producer warp.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 3)
    masked_ring_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, MaskedArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = s9::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kBN, e = blockIdx.z;
  const int tiles_m = (p.m + kBM - 1) / kBM;
  const int rows = min(p.masked_m[e], p.m);
  OutT* c = static_cast<OutT*>(p.c) + (size_t)e * p.m * p.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  s9::init_ring<kStages>(full, empty, kWarps);
  __syncthreads();
  if (warp == kWarps) {
    if (lane == 0) {
      int j = 0;
      for (int mt = blockIdx.y; mt < tiles_m && mt * kBM < rows; mt += gridDim.y)
        for (int g = 0; g < p.kb; ++g, ++j) {
          const int s = j % kStages;
          s9::mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
          s9::mbar_expect_tx(&full[s], kStage);
          uint8_t* st = ring + s * kStage;
          s9::tma_load(st, &ta, &full[s], g * 128, mt * kBM, e);
          s9::tma_load(st + kA, &tb, &full[s], g * 128, n0, e);
        }
    }
    return;
  }
  const int gid = lane >> 2, t = lane & 3;
  const int cb = warp * 16;   // the warp's columns in the tile
  int j = 0;
  for (int mt = blockIdx.y; mt < tiles_m; mt += gridDim.y) {
    const int m0 = mt * kBM;
    if (m0 >= rows) {
      zero_block(c, p.n, m0, min(m0 + kBM, p.m), n0, min(n0 + kBN, p.n), threadIdx.x,
                 kWarps * 32);
      continue;
    }
    int acc[2][4] = {};
    for (int g = 0; g < p.kb; ++g, ++j) {
      const int s = j % kStages;
      s9::mbar_wait(&full[s], (j / kStages) & 1);
      const uint8_t* sa = ring + s * kStage;
      const uint8_t* sb = sa + kA;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int kk = 32 * ks + 4 * t;
        const uint32_t a[4] = {ld_sw(sa, gid, kk), ld_sw(sa, gid + 8, kk),
                               ld_sw(sa, gid, kk + 16), ld_sw(sa, gid + 8, kk + 16)};
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const int col = cb + 8 * jn + gid;
          const uint32_t b[2] = {ld_sw(sb, col, kk), ld_sw(sb, col, kk + 16)};
          mma_s8(acc[jn], a, b);
        }
      }
      __syncwarp();
      if (lane == 0) s9::mbar_arrive(&empty[s]);
    }
    // int8_tile's epilogue: (acc * a_s) * b_s, rows past M_max dropped.
    const int r = m0 + gid;
    const float s_lo = r < p.m ? p.a_s[(size_t)e * p.m + r] : 0.f;
    const float s_hi = r + 8 < p.m ? p.a_s[(size_t)e * p.m + r + 8] : 0.f;
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int col = n0 + cb + 8 * jn + 2 * t;
      const float b0 = col < p.n ? p.b_s[(size_t)e * p.n + col] : 0.f;
      const float b1 = col + 1 < p.n ? p.b_s[(size_t)e * p.n + col + 1] : 0.f;
      if (r < p.m)
        store_cols(c + (size_t)r * p.n, col, p.n, s9::dequant(acc[jn][0], s_lo, b0),
                   s9::dequant(acc[jn][1], s_lo, b1));
      if (r + 8 < p.m)
        store_cols(c + (size_t)(r + 8) * p.n, col, p.n, s9::dequant(acc[jn][2], s_hi, b0),
                   s9::dequant(acc[jn][3], s_hi, b1));
    }
  }
}

}  // namespace ring8

// Route 2, "wgmma" (prefill: many rows an expert): K7's Hopper main loop
// (8-bit stages, wgmma s8) over 3-D maps with batch = expert; a CTA walks
// its valid m-tiles with one ring (produce / mma_loop from stage `it` on),
// then zeroes the rest. At prefill most of the (E, 6T, n) buffer is zeros
// past masked_m: the kernel is bound by those stores and the operand reads
// together (DRAM; scripts/decode_sweep.py times Tensor.zero_ beside it).
template <int BM, int BN, int STAGES, typename OutT>
__global__ void __launch_bounds__((BM / 64 + 1) * 128, BM == 64 ? 2 : 1)
    int8_masked_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tb, MaskedArgs p) {
  using R = s9::Ring<BM, BN, STAGES>;
  constexpr int kConsumers = BM / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = s9::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kBytes);
  uint64_t* empty = full + STAGES;
  const int n0 = blockIdx.x * BN, e = blockIdx.z;
  const int tiles_m = (p.m + BM - 1) / BM;
  const int rows = min(p.masked_m[e], p.m);
  OutT* c = static_cast<OutT*>(p.c) + (size_t)e * p.m * p.n;
  const int wg = threadIdx.x / 128;
  // The CTA's tiles: blockIdx.y + j * gridDim.y for j < mine; the first
  // `valid` of them hold rows below masked_m[e] (spread over the CTAs).
  const int mine = (tiles_m - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y;
  const int valid =
      min(mine, max(0, ((rows + BM - 1) / BM - (int)blockIdx.y + (int)gridDim.y - 1) /
                           (int)gridDim.y));
  s9::init_ring<STAGES>(full, empty, kConsumers);
  __syncthreads();
  if (wg == kConsumers) {
    if constexpr (kConsumers == 2) s9::regs_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      for (int j = 0; j < valid; ++j)
        s9::produce<int8_t, BM, BN, STAGES, false, false>(ring, full, empty, &ta, &tb,
                                                          (blockIdx.y + j * gridDim.y) * BM, n0,
                                                          e, 0, p.kb, j * p.kb);
    }
  } else {
    if constexpr (kConsumers == 2) s9::regs_inc<232>();
    const int tid = threadIdx.x & 127;
    for (int j = 0; j < mine; ++j) {
      const int m0 = (blockIdx.y + j * gridDim.y) * BM, it = j * p.kb;
      if (j >= valid) {
        const int r0 = min(m0 + wg * 64, p.m);
        zero_block(c, p.n, r0, min(r0 + 64, p.m), n0, min(n0 + BN, p.n), tid, 128);
        continue;
      }
      int acc[BN / 2];
      s9::mma_loop<int8_t, BM, BN, STAGES, false, false>(acc, ring, full, empty, p.kb, wg,
                                                         [](int) {}, it);
      if (tid == 0) s9::mbar_arrive(&empty[(it + p.kb - 1) % STAGES]);
      s9::store_tile_scaled<BN>(acc, c, p.a_s + (size_t)e * p.m, p.b_s + (size_t)e * p.n, p.m,
                                p.n, m0 + wg * 64, n0);
    }
  }
}

// Maps of A (E, m, k) and B (E, n, k, expert pitch b_e) as bytes, 128-byte
// boxes of K, then the launch of `kernel` over (ceil(n / BN), walkers, E).
template <int BM, int BN>
int masked_maps(CUtensorMap* ta, CUtensorMap* tb, const void* a, const void* b, long long b_e,
                int e, int k, const MaskedArgs& p) {
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const int rc = s9::make_map(ta, u8, 1, a, k, p.m, e, k, (uint64_t)p.m * k, 128, BM, sw);
  return rc ? rc : s9::make_map(tb, u8, 1, b, k, p.n, e, k, b_e, 128, BN, sw);
}

template <int BM, int BN>
dim3 masked_grid(int e, const MaskedArgs& p) {
  return dim3((p.n + BN - 1) / BN, walkers((p.m + BM - 1) / BM), e);
}

template <typename OutT>
int run_masked_ring(const void* a, const void* b, long long b_e, int e, int k,
                    const MaskedArgs& p, cudaStream_t s) {
  CUtensorMap ta, tb;
  const int rc = masked_maps<ring8::kBM, ring8::kBN>(&ta, &tb, a, b, b_e, e, k, p);
  if (rc) return rc;
  return s9::launch<ring8::masked_ring_kernel<OutT>>(masked_grid<ring8::kBM, ring8::kBN>(e, p),
                                                      ring8::kThreads, ring8::kSmem, s, ta, tb,
                                                      p);
}

template <int BM, int BN, int STAGES, typename OutT>
int run_masked_sm90(const void* a, const void* b, long long b_e, int e, int k,
                    const MaskedArgs& p, cudaStream_t s) {
  CUtensorMap ta, tb;
  const int rc = masked_maps<BM, BN>(&ta, &tb, a, b, b_e, e, k, p);
  if (rc) return rc;
  return s9::launch<int8_masked_sm90_kernel<BM, BN, STAGES, OutT>>(
      masked_grid<BM, BN>(e, p), (BM / 64 + 1) * 128, s9::Ring<BM, BN, STAGES>::kSmem, s, ta, tb,
      p);
}

// K6 on route 1 (tile ignored) or 2 (tile 0: 64 x 64, tile 1: 128 x 256).
template <typename OutT>
int run_masked(int route, int tile, const void* a, const void* b, long long b_e, int e, int k,
               const MaskedArgs& p, cudaStream_t s) {
  if (route == 1) return run_masked_ring<OutT>(a, b, b_e, e, k, p, s);
  if (tile == 0) return run_masked_sm90<64, 64, 6, OutT>(a, b, b_e, e, k, p, s);
  if (tile == 1) return run_masked_sm90<128, 256, 4, OutT>(a, b, b_e, e, k, p, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------- K9's route 1

struct ContigArgs {
  void* c;                // (m, n), row-major
  const float* a_s;       // (m)
  const float* b_s;       // (E, n)
  const int* tile_gids;   // expert of each layout tile of block_m rows, -1: padding
  int m, n, block_m;
  int tiles_m, tiles_n;   // kernel tiles
  int kb;                 // 128-deep K stages
};

// Route 1, "wgmma": K6's route 2 with the contiguous map in place of
// masked_m. Persistent CTAs walk the kernel tiles b, b + G, ... (G CTAs, n
// fastest, so that the CTAs in flight share an expert's weights in L2)
// with one ring; BM divides block_m, so a tile lies in one layout tile,
// whose expert the producer reads before it issues the tile's B boxes (the
// 3-D map's batch). A padding tile (-1) loads nothing and is zeroed by the
// consumers; producer and consumers skip it alike, so their stage counts
// stay in step.
template <int BM, int BN, int STAGES, typename OutT>
__global__ void __launch_bounds__((BM / 64 + 1) * 128, BM == 64 ? 2 : 1)
    int8_contiguous_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                                const __grid_constant__ CUtensorMap tb, ContigArgs p) {
  constexpr int kConsumers = BM / 64;
  using R = s9::Ring<BM, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = s9::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kBytes);
  uint64_t* empty = full + STAGES;
  const int tiles = p.tiles_m * p.tiles_n;
  const int wg = threadIdx.x / 128;
  auto expert = [&](int t) { return p.tile_gids[t / p.tiles_n * BM / p.block_m]; };
  s9::init_ring<STAGES>(full, empty, kConsumers);
  __syncthreads();
  if (wg == kConsumers) {
    if constexpr (kConsumers == 2) s9::regs_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int e = expert(t);
        if (e < 0) continue;
        s9::produce<int8_t, BM, BN, STAGES, false, false>(ring, full, empty, &ta, &tb,
                                                          t / p.tiles_n * BM, t % p.tiles_n * BN,
                                                          0, 0, p.kb, it, e);
        it += p.kb;
      }
    }
  } else {
    if constexpr (kConsumers == 2) s9::regs_inc<232>();
    const int tid = threadIdx.x & 127;
    OutT* c = static_cast<OutT*>(p.c);
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / p.tiles_n * BM, n0 = t % p.tiles_n * BN;
      const int e = expert(t);
      if (e < 0) {
        zero_block(c, p.n, m0 + wg * 64, m0 + wg * 64 + 64, n0, min(n0 + BN, p.n), tid, 128);
        continue;
      }
      int acc[BN / 2];
      s9::mma_loop<int8_t, BM, BN, STAGES, false, false>(acc, ring, full, empty, p.kb, wg,
                                                         [](int) {}, it);
      if (tid == 0) s9::mbar_arrive(&empty[(it + p.kb - 1) % STAGES]);
      s9::store_tile_scaled<BN>(acc, c, p.a_s, p.b_s + (size_t)e * p.n, p.m, p.n, m0 + wg * 64,
                                n0);
      it += p.kb;
    }
  }
}

// Maps of A (m, k) and B (E, n, k, expert pitch b_e) as bytes, 128-byte
// boxes of K; CTAs: `per_sm` a multiprocessor, at most one a tile.
template <int BM, int BN, int STAGES, typename OutT>
int run_contiguous_sm90(const void* a, const void* b, long long b_e, int e, int k, int per_sm,
                        const ContigArgs& p, cudaStream_t s) {
  if (p.block_m % BM) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap ta, tb;
  int rc = s9::make_map(&ta, u8, 1, a, k, p.m, 1, k, 0, 128, BM, sw);
  if (rc) return rc;
  rc = s9::make_map(&tb, u8, 1, b, k, p.n, e, k, b_e, 128, BN, sw);
  if (rc) return rc;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  ContigArgs q = p;
  q.tiles_m = p.m / BM;
  q.tiles_n = (p.n + BN - 1) / BN;
  const long long tiles = (long long)q.tiles_m * q.tiles_n;
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  return s9::launch<int8_contiguous_sm90_kernel<BM, BN, STAGES, OutT>>(
      dim3(grid), (BM / 64 + 1) * 128, s9::Ring<BM, BN, STAGES>::kSmem, s, ta, tb, q);
}

// K9 on route 1, tile 0 (64 x 64, two CTAs an SM) or 1 (128 x 256).
template <typename OutT>
int run_contiguous(int tile, const void* a, const void* b, long long b_e, int e, int k,
                   const ContigArgs& p, cudaStream_t s) {
  if (tile == 0) return run_contiguous_sm90<64, 64, 6, OutT>(a, b, b_e, e, k, 2, p, s);
  if (tile == 1) return run_contiguous_sm90<128, 256, 4, OutT>(a, b, b_e, e, k, 1, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K7: c (m, n) = (a . b) * a_s * b_s, bf16 or f32 (out_f32); B's strides
// sbk (along k) and sbn (along n); on route 0 (int8_tile) or 1 (wgmma: B
// K-major, sbk == 1; the tensor maps refuse what TMA cannot describe).
extern "C" int dga_int8_gemm(const void* a, const void* a_s, const void* b, const void* b_s,
                             void* c, int m, int n, int k, long long sbk, long long sbn,
                             int out_f32, int route, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (sbk != 1) return (int)cudaErrorInvalidValue;
    return out_f32 ? tile_int8_sm90<float>(a, a_s, b, b_s, c, m, n, k, sbn, s)
                   : tile_int8_sm90<__nv_bfloat16>(a, a_s, b, b_s, c, m, n, k, sbn, s);
  }
  if (route != 0 || (m + kBM - 1) / kBM > kMaxGridY) return (int)cudaErrorInvalidValue;
  const Args p = make_args(a, a_s, b, b_s, n, k, sbk, sbn, 0);
  dispatch<DenseLaunch>(sbk == 1, out_f32, p, m, c, s);
  return (int)cudaGetLastError();
}

// K9 on route 0 (int8_tile) or 1 (wgmma, `tile` 0: 64 x 64 for block_m a
// multiple of 64, 1: 128 x 256 for a multiple of 128); route 1 takes B
// K-major (sbk == 1) over `e` experts only, and the tensor maps refuse what
// TMA cannot describe (k not a multiple of 16, a pointer off 16 bytes).
extern "C" int dga_int8_grouped_contiguous(const void* a, const void* a_s, const void* b,
                                           const void* b_s, const void* tile_gids, void* c,
                                           int m, int n, int k, int block_m, long long b_e,
                                           long long sbk, long long sbn, int out_f32, int e,
                                           int route, int tile, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || block_m <= 0 || m % block_m)
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (sbk != 1 || sbn != k || e <= 0) return (int)cudaErrorInvalidValue;
    const ContigArgs p{c, static_cast<const float*>(a_s), static_cast<const float*>(b_s),
                       static_cast<const int*>(tile_gids), m, n, block_m, 0, 0, (k + 127) / 128};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return out_f32 ? run_contiguous<float>(tile, a, b, b_e, e, k, p, s)
                   : run_contiguous<__nv_bfloat16>(tile, a, b, b_e, e, k, p, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = m / block_m;
  if ((long long)n_tiles * ((block_m + kBM - 1) / kBM) > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  const Args p = make_args(a, a_s, b, b_s, n, k, sbk, sbn, b_e);
  dispatch<ContiguousLaunch>(sbk == 1, out_f32, p, static_cast<const int*>(tile_gids),
                             n_tiles, block_m, b_e, c, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// K6 on route 0 (int8_tile), 1 (ring) or 2 (wgmma, `tile` 0 or 1); routes
// 1 and 2 take B K-major (sbk == 1) only, and the tensor maps refuse what
// TMA cannot describe.
extern "C" int dga_int8_grouped_masked(const void* a, const void* a_s, const void* b,
                                       const void* b_s, const void* masked_m, void* c, int e,
                                       int m_max, int n, int k, long long b_e, long long sbk,
                                       long long sbn, int out_f32, int route, int tile,
                                       void* stream) {
  if (e <= 0 || e > kMaxGridY || m_max <= 0 || n <= 0 || k <= 0 ||
      (m_max + kBM - 1) / kBM > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  if (route == 1 || route == 2) {
    if (sbk != 1 || sbn != k) return (int)cudaErrorInvalidValue;
    const MaskedArgs p{c, static_cast<const float*>(a_s), static_cast<const float*>(b_s),
                       static_cast<const int*>(masked_m), m_max, n, (k + 127) / 128};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return out_f32 ? run_masked<float>(route, tile, a, b, b_e, e, k, p, s)
                   : run_masked<__nv_bfloat16>(route, tile, a, b, b_e, e, k, p, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  const Args p = make_args(a, a_s, b, b_s, n, k, sbk, sbn, b_e);
  dispatch<MaskedLaunch>(sbk == 1, out_f32, p, static_cast<const int*>(masked_m), e, m_max,
                         b_e, c, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
