// K10, K11: dense GEMM and split-K GEMM for Hopper (sm_90a).
//
// Replaces two kernels of deepgemm_ascend_tpu/ops/gemm.py:
//   K10 _gemm_kernel (:52, call :202)   dense, nn/nt/tn/tt -> dga_gemm
//   K11 _ksplit_kernel (:219, call :269) split-K, nn       -> dga_gemm_ksplit
// Both compute C = A . B with an f32 accumulator held across the block's
// whole K range; A is stored (m, k) or, transposed, (k, m); B (k, n) or
// (n, k). The accumulator is rounded once to the output type (RN), as
// acc_ref[:].astype(out_dtype) does (:90).
//
// Three routes, chosen by the caller (ops/gemm.py:route) and passed in; an
// entry refuses (cudaErrorInvalidValue) a route it cannot take, so no call
// switches routes silently.
//
// Route 1, "wgmma" (K10 and K11, bf16/fp16 inputs whose operands TMA can
// describe: 16-byte aligned bases, row and batch pitches that are
// multiples of 16 bytes): the Hopper main loop of sm90_gemm.cuh. A
// producer warp keeps a ring of shared-memory stages filled by TMA
// (64-deep K blocks, 128-byte swizzle, out-of-bounds boxes zero-filled:
// the K tail and the M/N edges need no mask), and consumer warpgroups run
// wgmma.mma_async on them, each owning 64 rows of the tile, with
// setmaxnreg moving registers from the producer warpgroup to them. Tiles:
// 128 x 256 (two consumer warpgroups, 4 stages of 48 KB) for m > 64;
// 64 x 64 (one consumer, 6 stages of 16 KB, two blocks an SM) for
// m <= 64, where the operand bytes bound the kernel
// and the stages keep B streaming, and wherever 128 x 256 tiles would
// leave most SMs idle. Operands stored with K as the row index
// (A (k, m), B (k, n)) are read MN-major through wgmma's transpose bits.
// The grid is 1-D over the output tiles in bands of 16 (sm90::tile_of)
// and z over the batch (K11: batch x splits); the kernel takes a K range,
// which K10 sets to all of K and K11 to its split's. K11's tile follows
// from its whole grid: at decode (m = 16) the 64 x 64 tile, two blocks an
// SM, which is what lets the splits fill the card where K10's few tiles
// leave most SMs idle.
//
// Every route splits K the same way: K11 gives block (s, tile) the 64-deep
// K blocks [s*per, min(nk, (s+1)*per)) and stores its f32 sum into slice s
// of a (k_split, m, n) partials buffer; a range past K stores zeros (the
// buffer comes from torch.empty). The wrapper sums the slices, as jnp.sum
// does outside the TPU kernel (:285).
//
// Route 0, "mma_tile" (every shape: f32 and 16-bit operands that routes 2
// and 1 cannot take, such as an odd leading dimension): a block owns one
// 64 x 64 output tile and one K range [k_begin, k_end); K10 gives every
// block all of K.
//
// bf16 and fp16 inputs on route 0: mma.sync.m16n8k16 with f32
// accumulators, each input type with its own mma. Fragments come from
// shared memory through ldmatrix; the 16-bit elements allow .trans, so an
// operand stored with K as its row index loads through ldmatrix.trans and
// no layout needs a transpose in memory. Shared-memory rows are 64
// elements plus 8 of padding (144 bytes), which keeps the eight 16-byte
// rows of each ldmatrix on distinct banks. Global loads are 16 bytes wide
// where the contiguous extent is a multiple of 8 elements and the pointer
// is aligned, staged in registers one K step ahead (the next step's loads
// are in flight during this step's math); else element by element.
//
// f32 inputs (route 0, and route 2 below): FFMA on the CUDA cores in full
// f32, each output one running fmaf over k in ascending order from the
// block's k_begin, rounded once to the output type. Not TF32, which keeps
// ~3 decimal digits where the JAX package holds its f32 GEMM to 1e-4
// (tests/test_gemm.py:51-67). Both f32 designs zero-fill the K tail to
// whole 16-deep steps and sum in that one order, so route 2 equals route
// 0 bit for bit at every shape, layout and K range.
//
// Route 2, "ffma" (K10 and K11, f32 operands with 16-byte aligned bases
// and stored row pitches that are multiples of 4 elements): the classic
// register-blocked SIMT GEMM, for the 67 TFLOP/s of FFMA that bound it
// at prefill sizes (namespace ffma below).
//
// Ragged edges on route 0: the K tail of both operands is zero-filled in
// shared memory (garbage times zero can be NaN, gemm.py:72-83); rows past
// M and columns past N are zero-filled and never stored.
//
// Grid of route 0: x and y walk the output tiles, in M-major raster (n
// tiles along x) or N-major (m tiles along x: SwizzleDir.N_MAJOR); z walks
// batch x splits.
//
// Bound on the card: the operand bytes at decode (m = 16), the tensor
// cores (989 TFLOP/s bf16/fp16) or the CUDA cores (67 TFLOP/s f32) at
// prefill. Route 0 is the simple design (mma.sync or FFMA, no TMA or
// cp.async ring, 64 x 64 tiles); route 1 runs at the wgmma rate with loads
// overlapped with math; route 2 keeps the FFMA pipes fed from registers
// with the next stage's loads in flight.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;                    // 4 warps in a 2 x 2 layout, 32 x 32 each
constexpr int kPitch = kBK + 8;                  // smem row pitch, elements
constexpr int kChunks = 64 * 64 / 8 / kThreads;  // 16-byte chunks per thread per operand
constexpr int kFThreads = 256;                   // f32 kernel: 16 x 16 threads, 4 x 4 outputs each
constexpr int kFK = 16;                          // f32 kernel: K step
constexpr int kFPitch = kBM + 4;
constexpr int kMaxGridYZ = 65535;

struct Args {
  const void* a;
  const void* b;
  void* c;
  int m, n, k;
  int k_per;     // K range of one split (all of K for K10)
  int splits;    // grid z = batch * splits
  int n_major;   // m tiles along grid x
  int a_t, b_t;  // A stored (k, m); B stored (n, k)
  bool vec_a, vec_b;
};

// The stored rows [r0, r0 + 64) and contiguous columns [c0, c0 + 64) of an
// operand tile, and the limits past which it is zero.
struct Win {
  int r0, rl, c0, cl;
};

__device__ __forceinline__ Win a_win(bool a_t, int m, int m0, int k0, int k_end) {
  return a_t ? Win{k0, k_end, m0, m} : Win{m0, m, k0, k_end};
}

__device__ __forceinline__ Win b_win(bool b_t, int n, int n0, int k0, int k_end) {
  return b_t ? Win{n0, n, k0, k_end} : Win{k0, k_end, n0, n};
}

using dga::sm90::smem_u32;
using dga::sm90::store1;
using dga::sm90::store_cols;

// ldmatrix: four 8 x 8 16-bit matrices from shared memory, as stored or
// transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// mma.sync.m16n8k16 with f32 accumulators, one per input type.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// 16-byte loads of one operand tile into registers (zeros outside the
// window). Legal when the contiguous extent is a multiple of 8 elements:
// then a chunk lies wholly inside or wholly outside the column limit.
__device__ __forceinline__ void load_vec(uint4 (&s)[kChunks], const uint16_t* base, long long ld,
                                         const Win& w) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx >> 3, ch = (idx & 7) * 8;
    s[it] = (w.r0 + r < w.rl && w.c0 + ch < w.cl)
                ? __ldg(reinterpret_cast<const uint4*>(base + (size_t)(w.r0 + r) * ld + w.c0 + ch))
                : zero;
  }
}

__device__ __forceinline__ void store_vec(uint16_t* S, const uint4 (&s)[kChunks]) {
#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    *reinterpret_cast<uint4*>(S + (idx >> 3) * kPitch + (idx & 7) * 8) = s[it];
  }
}

// Element loads straight into shared memory: ragged extents, unaligned
// pointers.
__device__ void load_elems(uint16_t* S, const uint16_t* base, long long ld, const Win& w) {
  for (int idx = threadIdx.x; idx < 64 * 64; idx += kThreads) {
    const int r = idx >> 6, c = idx & 63;
    S[r * kPitch + c] = (w.r0 + r < w.rl && w.c0 + c < w.cl)
                            ? __ldg(base + (size_t)(w.r0 + r) * ld + w.c0 + c)
                            : uint16_t(0);
  }
}

// Rows [m0, m0 + 64) x columns [n0, n0 + 64) of C = A . B over K range
// [k_begin, k_end), bf16 or fp16 operands.
template <typename T, bool A_T, bool B_T, typename OutT>
__device__ void mma_tile(const Args& p, const uint16_t* A, const uint16_t* B, OutT* C, int m0,
                         int n0, int k_begin, int k_end) {
  __shared__ __align__(16) uint16_t As[64 * kPitch];   // rows: m (or k if A_T)
  __shared__ __align__(16) uint16_t Bs[64 * kPitch];   // rows: k (or n if B_T)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int j4 = lane >> 3, r8 = lane & 7;             // ldmatrix: matrix and row of this lane
  const long long lda = A_T ? p.m : p.k;
  const long long ldb = B_T ? p.k : p.n;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  uint4 sa[kChunks], sb[kChunks];
  if (k_begin < k_end) {
    if (p.vec_a) load_vec(sa, A, lda, a_win(A_T, p.m, m0, k_begin, k_end));
    if (p.vec_b) load_vec(sb, B, ldb, b_win(B_T, p.n, n0, k_begin, k_end));
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    if (p.vec_a) store_vec(As, sa);
    else load_elems(As, A, lda, a_win(A_T, p.m, m0, k0, k_end));
    if (p.vec_b) store_vec(Bs, sb);
    else load_elems(Bs, B, ldb, b_win(B_T, p.n, n0, k0, k_end));
    __syncthreads();
    if (k0 + kBK < k_end) {
      if (p.vec_a) load_vec(sa, A, lda, a_win(A_T, p.m, m0, k0 + kBK, k_end));
      if (p.vec_b) load_vec(sb, B, ldb, b_win(B_T, p.n, n0, k0 + kBK, k_end));
    }

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mb = wm * 32 + i * 16;
        if (A_T)   // stored rows k, columns m: matrix j4 = (m half j4 & 1, k half j4 >> 1)
          ldsm_x4_trans(af[i], As + (kk + r8 + (j4 >> 1) * 8) * kPitch + mb + (j4 & 1) * 8);
        else       // stored rows m: lanes 0-15 rows at k 0-7, lanes 16-31 at k 8-15
          ldsm_x4(af[i], As + (mb + (lane & 15)) * kPitch + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        const int nb = wn * 32 + pp * 16;
        uint32_t r[4];   // (n tile 2pp, k 0-7), (2pp, k 8-15), (2pp+1, k 0-7), (2pp+1, k 8-15)
        if (B_T)
          ldsm_x4(r, Bs + (nb + r8 + (j4 >> 1) * 8) * kPitch + kk + (j4 & 1) * 8);
        else
          ldsm_x4_trans(r, Bs + (kk + r8 + (j4 & 1) * 8) * kPitch + nb + (j4 >> 1) * 8);
        bf[2 * pp][0] = r[0];
        bf[2 * pp][1] = r[1];
        bf[2 * pp + 1][0] = r[2];
        bf[2 * pp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Mma<T>::run(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + wm * 32 + i * 16 + gid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + tig * 2;
      if (r < p.m) store_cols(C + (size_t)r * p.n, col, p.n, acc[i][j][0], acc[i][j][1]);
      if (r + 8 < p.m) store_cols(C + (size_t)(r + 8) * p.n, col, p.n, acc[i][j][2], acc[i][j][3]);
    }
  }
}

// The f32 twin on the CUDA cores: thread (ty, tx) owns rows 4ty..4ty+3
// and columns 4tx..4tx+3 of the tile; shared memory holds 16-deep K
// slices of both operands, K-major.
template <typename OutT>
__device__ void ffma_tile(const Args& p, const float* A, const float* B, OutT* C, int m0, int n0,
                          int k_begin, int k_end) {
  __shared__ __align__(16) float As[kFK * kFPitch];   // [k][m]
  __shared__ __align__(16) float Bs[kFK * kFPitch];   // [k][n]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kFK) {
    // Neighbouring threads read neighbouring addresses of the stored layout.
    for (int idx = threadIdx.x; idx < kBM * kFK; idx += kFThreads) {
      const int r = p.a_t ? (idx & 63) : (idx >> 4);
      const int kk = p.a_t ? (idx >> 6) : (idx & 15);
      const int gm = m0 + r, gk = k0 + kk;
      As[kk * kFPitch + r] =
          (gm < p.m && gk < k_end)
              ? __ldg(A + (p.a_t ? (size_t)gk * p.m + gm : (size_t)gm * p.k + gk))
              : 0.f;
      const int c = p.b_t ? (idx >> 4) : (idx & 63);
      const int kb = p.b_t ? (idx & 15) : (idx >> 6);
      const int gn = n0 + c, gkb = k0 + kb;
      Bs[kb * kFPitch + c] =
          (gn < p.n && gkb < k_end)
              ? __ldg(B + (p.b_t ? (size_t)gn * p.k + gkb : (size_t)gkb * p.n + gn))
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(As + kk * kFPitch + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * kFPitch + tx * 4);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < p.n) store1(C + (size_t)r * p.n + col, acc[i][j]);
    }
  }
}

// Output tile origin, batch element and K range of this block.
struct Block {
  int m0, n0, batch, k_begin, k_end;
};

__device__ __forceinline__ Block block_of(const Args& p) {
  Block blk;
  blk.m0 = (p.n_major ? blockIdx.x : blockIdx.y) * kBM;
  blk.n0 = (p.n_major ? blockIdx.y : blockIdx.x) * kBN;
  blk.batch = blockIdx.z / p.splits;
  blk.k_begin = (blockIdx.z % p.splits) * p.k_per;
  blk.k_end = min(p.k, blk.k_begin + p.k_per);
  return blk;
}

template <typename T, bool A_T, bool B_T, typename OutT>
__global__ void __launch_bounds__(kThreads) gemm16_kernel(Args p) {
  const Block blk = block_of(p);
  const uint16_t* A = static_cast<const uint16_t*>(p.a) + (size_t)blk.batch * p.m * p.k;
  const uint16_t* B = static_cast<const uint16_t*>(p.b) + (size_t)blk.batch * p.k * p.n;
  OutT* C = static_cast<OutT*>(p.c) + (size_t)blockIdx.z * p.m * p.n;
  mma_tile<T, A_T, B_T, OutT>(p, A, B, C, blk.m0, blk.n0, blk.k_begin, blk.k_end);
}

template <typename OutT>
__global__ void __launch_bounds__(kFThreads) gemm32_kernel(Args p) {
  const Block blk = block_of(p);
  const float* A = static_cast<const float*>(p.a) + (size_t)blk.batch * p.m * p.k;
  const float* B = static_cast<const float*>(p.b) + (size_t)blk.batch * p.k * p.n;
  OutT* C = static_cast<OutT*>(p.c) + (size_t)blockIdx.z * p.m * p.n;
  ffma_tile<OutT>(p, A, B, C, blk.m0, blk.n0, blk.k_begin, blk.k_end);
}

// Type codes of the C interface: 0 f32, 1 bf16, 2 fp16.
template <template <typename> class L, typename... Xs>
void by_out(int code, Xs... xs) {
  if (code == 0) L<float>::run(xs...);
  else if (code == 1) L<__nv_bfloat16>::run(xs...);
  else L<__half>::run(xs...);
}

template <typename T, bool AT, bool BT>
struct Launch16 {
  template <typename OutT>
  struct Out {
    static void run(const Args& p, dim3 grid, cudaStream_t s) {
      gemm16_kernel<T, AT, BT, OutT><<<grid, kThreads, 0, s>>>(p);
    }
  };
};

template <typename OutT>
struct Launch32 {
  static void run(const Args& p, dim3 grid, cudaStream_t s) {
    gemm32_kernel<OutT><<<grid, kFThreads, 0, s>>>(p);
  }
};

template <typename T>
void launch16(const Args& p, int out_code, dim3 grid, cudaStream_t s) {
  if (p.a_t && p.b_t) by_out<Launch16<T, true, true>::template Out>(out_code, p, grid, s);
  else if (p.a_t) by_out<Launch16<T, true, false>::template Out>(out_code, p, grid, s);
  else if (p.b_t) by_out<Launch16<T, false, true>::template Out>(out_code, p, grid, s);
  else by_out<Launch16<T, false, false>::template Out>(out_code, p, grid, s);
}

// ---------------------------------------------------------------- route 1

namespace s9 = dga::sm90;

struct TmaArgs {
  void* c;
  int m, n;
  int tiles_m, tiles_n;
  int n_major;
  int kb_begin, kb_count;   // the K range in s9::kBK-deep blocks (K11: 0, blocks a split)
  int splits, kb_total;     // K11: splits of a batch element, K blocks in all
};

// BM / 64 consumer warpgroups, then the producer warpgroup (one thread of
// it issues every TMA load). With two consumers, setmaxnreg moves the
// registers: 128 x 40 + 256 x 232 = 384 x 168, the launch's share.
// SPLIT (K11): blockIdx.z is batch element z / splits, split z % splits,
// which sums K blocks [s * kb_count, min(kb_total, (s + 1) * kb_count));
// a split past K issues no load and stores a zero tile. Either way block
// z writes the z-th m x n slice of c.
template <typename T, int BM, int BN, int STAGES, bool A_MN, bool B_MN, typename OutT, bool SPLIT>
__global__ void __launch_bounds__((BM / 64 + 1) * 128, BM == 64 ? 2 : 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, TmaArgs p) {
  using R = s9::Ring<BM, BN, STAGES>;
  constexpr int kConsumers = BM / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = s9::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::kBytes);
  uint64_t* empty = full + STAGES;
  int tm, tn;
  s9::tile_of(p.tiles_m, p.tiles_n, p.n_major, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  int batch = blockIdx.z, kb_begin = p.kb_begin, kb_count = p.kb_count;
  if constexpr (SPLIT) {
    batch = blockIdx.z / p.splits;
    kb_begin = (blockIdx.z % p.splits) * p.kb_count;
    kb_count = max(0, min(p.kb_total - kb_begin, p.kb_count));
  }
  const int wg = threadIdx.x / 128;
  s9::init_ring<STAGES>(full, empty, kConsumers);
  __syncthreads();
  if (wg == kConsumers) {
    if constexpr (kConsumers == 2) s9::regs_dec<40>();
    if (threadIdx.x == kConsumers * 128)
      s9::produce<T, BM, BN, STAGES, A_MN, B_MN>(ring, full, empty, &ta, &tb, m0, n0, batch,
                                                 kb_begin, kb_count);
  } else {
    if constexpr (kConsumers == 2) s9::regs_inc<232>();
    float acc[BN / 2];
    s9::mma_loop<T, BM, BN, STAGES, A_MN, B_MN>(acc, ring, full, empty, kb_count, wg,
                                                [](int) {});
    OutT* c = static_cast<OutT*>(p.c) + (size_t)blockIdx.z * p.m * p.n;
    s9::store_tile<BN>(acc, c, p.m, p.n, m0 + wg * 64, n0);
  }
}

// Maps of A and B (16-bit), then the launch: K10 over all of K, K11
// (SPLIT) over `splits` ranges of kb_per K blocks each, the grid's z axis
// batch x splits.
template <typename T, int BM, int BN, int STAGES, bool A_MN, bool B_MN, typename OutT, bool SPLIT>
int run_sm90(const void* a, const void* b, void* c, int batch, int m, int n, int k, int n_major,
             int splits, int kb_per, cudaStream_t s) {
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t mk = (uint64_t)m * k, kn = (uint64_t)k * n;
  CUtensorMap ta, tb;
  int rc = A_MN ? s9::make_map(&ta, dt, 2, a, m, k, batch, m, mk, 64, 64, sw)
                : s9::make_map(&ta, dt, 2, a, k, m, batch, k, mk, 64, BM, sw);
  if (rc) return rc;
  rc = B_MN ? s9::make_map(&tb, dt, 2, b, n, k, batch, n, kn, 64, 64, sw)
            : s9::make_map(&tb, dt, 2, b, k, n, batch, k, kn, 64, BN, sw);
  if (rc) return rc;
  const int tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const int kb = (k + s9::kBK - 1) / s9::kBK;
  const TmaArgs p{c, m, n, tiles_m, tiles_n, n_major, 0, SPLIT ? kb_per : kb, splits, kb};
  const dim3 grid(tiles_m * tiles_n, 1, batch * splits);
  return s9::launch<gemm_sm90_kernel<T, BM, BN, STAGES, A_MN, B_MN, OutT, SPLIT>>(
      grid, (BM / 64 + 1) * 128, s9::Ring<BM, BN, STAGES>::kSmem, s, ta, tb, p);
}

// The tile (sm90::large_tile over the grid's tiles, splits included):
// 128 x 256, or 64 x 64 with two blocks an SM.
template <typename T, bool A_MN, bool B_MN, typename OutT, bool SPLIT = false>
int tile_sm90(const void* a, const void* b, void* c, int batch, int m, int n, int k, int n_major,
              cudaStream_t s, int splits = 1, int kb_per = 0) {
  const long long tiles = (long long)((m + 127) / 128) * ((n + 255) / 256) * batch * splits;
  if (s9::large_tile(m, tiles))
    return run_sm90<T, 128, 256, 4, A_MN, B_MN, OutT, SPLIT>(a, b, c, batch, m, n, k, n_major,
                                                             splits, kb_per, s);
  return run_sm90<T, 64, 64, 6, A_MN, B_MN, OutT, SPLIT>(a, b, c, batch, m, n, k, n_major, splits,
                                                         kb_per, s);
}

template <typename T, bool A_MN, bool B_MN>
int out_sm90(int out_code, const void* a, const void* b, void* c, int batch, int m, int n, int k,
             int n_major, cudaStream_t s) {
  if (out_code == 0) return tile_sm90<T, A_MN, B_MN, float>(a, b, c, batch, m, n, k, n_major, s);
  if (out_code == 1)
    return tile_sm90<T, A_MN, B_MN, __nv_bfloat16>(a, b, c, batch, m, n, k, n_major, s);
  return tile_sm90<T, A_MN, B_MN, __half>(a, b, c, batch, m, n, k, n_major, s);
}

// A stored (k, m) is MN-major for wgmma; B stored (k, n) too (not b_t).
template <typename T>
int layout_sm90(int a_t, int b_t, int out_code, const void* a, const void* b, void* c, int batch,
                int m, int n, int k, int n_major, cudaStream_t s) {
  if (a_t && b_t) return out_sm90<T, true, false>(out_code, a, b, c, batch, m, n, k, n_major, s);
  if (a_t) return out_sm90<T, true, true>(out_code, a, b, c, batch, m, n, k, n_major, s);
  if (b_t) return out_sm90<T, false, false>(out_code, a, b, c, batch, m, n, k, n_major, s);
  return out_sm90<T, false, true>(out_code, a, b, c, batch, m, n, k, n_major, s);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// Route 0: the 64 x 64 tile (every input type).
int launch(const void* a, const void* b, void* c, int batch, int m, int n, int k, int a_t, int b_t,
           int in_code, int out_code, int n_major, int splits, int k_per, void* stream) {
  const long long tiles_m = (m + kBM - 1) / kBM, tiles_n = (n + kBN - 1) / kBN;
  if (batch <= 0 || m <= 0 || n <= 0 || k < 0 || splits <= 0 || k_per < 0 ||
      (long long)batch * splits > kMaxGridYZ || (n_major ? tiles_n : tiles_m) > kMaxGridYZ ||
      in_code < 0 || in_code > 2 || out_code < 0 || out_code > 2 ||
      (splits > 1 && (k_per == 0 || k_per % kBK)))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.a = a;
  p.b = b;
  p.c = c;
  p.m = m;
  p.n = n;
  p.k = k;
  p.k_per = k_per;
  p.splits = splits;
  p.n_major = n_major;
  p.a_t = a_t;
  p.b_t = b_t;
  p.vec_a = (a_t ? m : k) % 8 == 0 && aligned16(a);
  p.vec_b = (b_t ? k : n) % 8 == 0 && aligned16(b);
  const dim3 grid(n_major ? tiles_m : tiles_n, n_major ? tiles_n : tiles_m, batch * splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == 0) by_out<Launch32>(out_code, p, grid, s);
  else if (in_code == 1) launch16<__nv_bfloat16>(p, out_code, grid, s);
  else launch16<__half>(p, out_code, grid, s);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- route 2
//
// "ffma": f32 on the CUDA cores, bound by FFMA issue at prefill sizes
// (67 TFLOP/s; 2048^3 takes 0.256 ms at that rate) and by the operand
// bytes at decode. Route 0 reached a quarter of that rate: 4 x 4 outputs a
// thread, element loads, no load in flight during the math.
//
// A block of T threads owns a BM x BN output tile; thread (ty, tx) owns
// QM x QN quadrants of 4 x 4 outputs, rows q * BM / QM + 4 ty + i and
// columns q * BN / QN + 4 tx + j: every fragment read from shared memory is
// one float4 that the warp's threads of one ty (A) share as a broadcast,
// and its tx read as one contiguous run (B). The 128 x 128 tile (8 x 8
// outputs a thread, 256 threads, two blocks an SM) where m > 64 and its
// grid fills the card (sm90::large_tile, splits and batch counted); else
// 64 x 64 (4 x 4, 256 threads), and at m <= 16 a 16 x 128 tile (4 x 4,
// 128 threads) that spends no FMA on padding rows.
//
// Shared memory (dynamic) holds a ring of S 16-deep stages of both
// operands in the [k][mn] layout the fragment reads need, with a pitch of
// mn + 4 floats (4 mod 8, see KMajor): two stages for the 64- and
// 128-row tiles, six for the bytes-bound 16-row tile. Every load is a
// 16-byte cp.async. The operand that is MN-major in memory (A stored (k,
// m), B stored (k, n)) lands in its stage as it lies. The K-major one (A
// stored (m, k), B stored (n, k)) must be transposed (TMA cannot
// transpose 32-bit elements): it lands in a raw buffer, and the thread
// that copied a chunk stores it transposed once it has landed, so no
// staged load holds registers across the math (held in registers, they
// made the 128 x 128 instances spill). One __syncthreads a stage: while
// the block multiplies stage s, stages s + 1 .. s + S - 1 are in flight;
// the fragments of step kk + 1 are read from shared memory while step
// kk's FMAs run.
//
// Registers (-Xptxas -v, f32 output): the 128 x 128 instances 119-128 (64
// accumulators, two fragment sets of 16), under the 128 that two blocks an
// SM leave a thread, with no spill; 64 x 64 79-80; 16 x 128 91-109.
// chip_smoke.py's phase 1 prints every instance's figures.
namespace ffma {

constexpr int kBK = 16;   // K step of a stage

__device__ __forceinline__ void copy16_async(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A tile shape: BM x BN outputs, QM x QN quadrants of 4 x 4 a thread, T
// threads, a ring of S stages.
template <int BM_, int BN_, int QM_, int QN_, int T_, int S_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, QM = QM_, QN = QN_, T = T_, S = S_;
  static constexpr int TM = 4 * QM, TN = 4 * QN;   // outputs a thread
  static constexpr int TX = BN / TN;               // threads along n
  static_assert((BM / TM) * TX == T, "one thread a 4QM x 4QN microtile");
  static constexpr int PA = BM + 4, PB = BN + 4;   // stage pitches, floats
};

using Large = Tile<128, 128, 2, 2, 256, 2>;
using Mid = Tile<64, 64, 1, 1, 256, 2>;
using Thin = Tile<16, 128, 1, 1, 128, 6>;   // bytes bound: more stages in flight

// Stage rows [k0, k0 + kBK) x columns [r0, r0 + R) of an MN-major operand
// (stored (k, ld)) into S[kBK][R + 4] by cp.async; zeros past k_end or
// r_lim (a multiple of 4: a chunk lies wholly inside or outside).
template <int R, int T>
__device__ __forceinline__ void stage_mn(float* S, const float* X, long long ld, int k0, int k_end,
                                         int r0, int r_lim) {
  constexpr int kC = R / 4, kN = kBK * kC;
#pragma unroll
  for (int it = 0; it < (kN + T - 1) / T; ++it) {
    const int idx = threadIdx.x + it * T;
    if (kN % T == 0 || idx < kN) {
      const int kk = idx / kC, c = (idx % kC) * 4;
      const bool ok = k0 + kk < k_end && r0 + c < r_lim;
      copy16_async(S + kk * (R + 4) + c, ok ? X + (size_t)(k0 + kk) * ld + r0 + c : X, ok);
    }
  }
}

// A K-major operand (stored (mn, ld = k)): the stage [r0, r0 + R) x
// [k0, k0 + kBK) as 16-byte chunks, copied by cp.async as they lie into a
// raw buffer (chunk idx at raw[4 idx]), then, once landed, read back by
// the thread that copied it and stored transposed into S[kBK][R + 4]: no
// registers held across the math, no barrier between copy and transpose.
// A warp's 32 chunks are 16 rows x 32 bytes (a whole sector a row); its
// stores of one k land on rows r..r+15 at column chunks kc and kc + 4, and
// a pitch of 4 mod 8 floats puts those two halves 16 banks apart: no
// conflict.
template <int R, int T>
struct KMajor {
  static constexpr int kN = R * kBK / 4;
  static constexpr int kPer = (kN + T - 1) / T;

  __device__ __forceinline__ static void at(int idx, int& row, int& kc) {
    row = (idx >> 1) % R;
    kc = ((idx & 1) + 2 * (idx / (2 * R))) * 4;
  }

  __device__ __forceinline__ static void copy(float* raw, const float* X, long long ld, int k0,
                                              int k_end, int r0, int r_lim) {
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int idx = threadIdx.x + it * T;
      if (kN % T == 0 || idx < kN) {
        int row, kc;
        at(idx, row, kc);
        const bool ok = r0 + row < r_lim && k0 + kc < k_end;
        copy16_async(raw + 4 * idx, ok ? X + (size_t)(r0 + row) * ld + k0 + kc : X, ok);
      }
    }
  }

  __device__ __forceinline__ static void transpose(float* S, const float* raw) {
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int idx = threadIdx.x + it * T;
      if (kN % T == 0 || idx < kN) {
        int row, kc;
        at(idx, row, kc);
        const float4 v = *reinterpret_cast<const float4*>(raw + 4 * idx);
        float* s = S + kc * (R + 4) + row;
        s[0] = v.x;
        s[R + 4] = v.y;
        s[2 * (R + 4)] = v.z;
        s[3 * (R + 4)] = v.w;
      }
    }
  }
};

// The fragments of K step kk: a thread's TM rows of A and TN columns of B.
template <class C>
__device__ __forceinline__ void fragments(const float* As, const float* Bs, int kk, int ty, int tx,
                                          float (&a)[C::TM], float (&b)[C::TN]) {
#pragma unroll
  for (int q = 0; q < C::QM; ++q) {
    const float4 v =
        *reinterpret_cast<const float4*>(As + kk * C::PA + q * (C::BM / C::QM) + 4 * ty);
    a[4 * q] = v.x;
    a[4 * q + 1] = v.y;
    a[4 * q + 2] = v.z;
    a[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int q = 0; q < C::QN; ++q) {
    const float4 v =
        *reinterpret_cast<const float4*>(Bs + kk * C::PB + q * (C::BN / C::QN) + 4 * tx);
    b[4 * q] = v.x;
    b[4 * q + 1] = v.y;
    b[4 * q + 2] = v.z;
    b[4 * q + 3] = v.w;
  }
}

// One stage's kBK steps: every output one fmaf a step, k ascending; the
// next step's fragments read while this step's FMAs run.
template <class C>
__device__ __forceinline__ void fma_stage(float (&acc)[C::TM][C::TN], const float* As,
                                          const float* Bs, int ty, int tx) {
  float a[2][C::TM], b[2][C::TN];
  fragments<C>(As, Bs, 0, ty, tx, a[0], b[0]);
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    if (kk + 1 < kBK) fragments<C>(As, Bs, kk + 1, ty, tx, a[(kk + 1) & 1], b[(kk + 1) & 1]);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
  }
}

// The block's ring in dynamic shared memory (floats): S stages of A's and
// B's [kBK][mn + 4] tiles, then S - 1 raw buffers of the K-major
// operands' chunks (stage s's in buffer s % (S - 1)).
template <class C, bool A_T, bool B_T>
struct Ring {
  static constexpr int kA = kBK * C::PA, kB = kBK * C::PB;
  static constexpr int kRawA = A_T ? 0 : C::BM * kBK;   // A stored (m, k)
  static constexpr int kRawB = B_T ? C::BN * kBK : 0;   // B stored (n, k)
  static constexpr int kStage = kA + kB, kRaw = kRawA + kRawB;
  static constexpr int kBytes = (C::S * kStage + (C::S - 1) * kRaw) * 4;

  float* base;
  const float* A;
  const float* B;
  int k_begin, k_end, m0, n0;

  __device__ __forceinline__ float* a(int s) const { return base + (s % C::S) * kStage; }
  __device__ __forceinline__ float* b(int s) const { return a(s) + kA; }
  __device__ __forceinline__ float* raw(int s) const {
    return base + C::S * kStage + (s % (C::S - 1)) * kRaw;
  }

  // Stage s's copies: into its tiles (MN-major) or its raw buffer.
  __device__ __forceinline__ void issue(const Args& p, int s) const {
    const int k0 = k_begin + s * kBK;
    if constexpr (A_T) stage_mn<C::BM, C::T>(a(s), A, p.m, k0, k_end, m0, p.m);
    else KMajor<C::BM, C::T>::copy(raw(s), A, p.k, k0, k_end, m0, p.m);
    if constexpr (B_T) KMajor<C::BN, C::T>::copy(raw(s) + kRawA, B, p.k, k0, k_end, n0, p.n);
    else stage_mn<C::BN, C::T>(b(s), B, p.n, k0, k_end, n0, p.n);
  }

  // Stage s landed (this thread's copies): its raw chunks into its tiles.
  __device__ __forceinline__ void transpose(int s) const {
    if constexpr (!A_T) KMajor<C::BM, C::T>::transpose(a(s), raw(s));
    if constexpr (B_T) KMajor<C::BN, C::T>::transpose(b(s), raw(s) + kRawA);
  }
};

// A_T: A stored (k, m) (MN-major), else (m, k); B_T: B stored (n, k)
// (K-major), else (k, n). The grid: x the output tiles in sm90::tile_of's
// bands (p.n_major: the raster), z batch x splits as route 0's.
// Stage s: wait for its copies, transpose its raw chunks, one barrier
// (stage s visible; stage s - 1's tiles free), start stage s + S - 1's
// copies into them, multiply stage s.
template <class C, bool A_T, bool B_T, typename OutT>
__global__ void __launch_bounds__(C::T, 2) gemm_ffma_kernel(Args p) {
  extern __shared__ float4 ffma_smem[];
  int tm, tn;
  dga::sm90::tile_of((p.m + C::BM - 1) / C::BM, (p.n + C::BN - 1) / C::BN, p.n_major, tm, tn);
  const int m0 = tm * C::BM, n0 = tn * C::BN;
  const int batch = blockIdx.z / p.splits;
  const int k_begin = (blockIdx.z % p.splits) * p.k_per;
  const int k_end = min(p.k, k_begin + p.k_per);
  const Ring<C, A_T, B_T> ring{reinterpret_cast<float*>(ffma_smem),
                               static_cast<const float*>(p.a) + (size_t)batch * p.m * p.k,
                               static_cast<const float*>(p.b) + (size_t)batch * p.k * p.n,
                               k_begin, k_end, m0, n0};
  OutT* C_ = static_cast<OutT*>(p.c) + (size_t)blockIdx.z * p.m * p.n;
  const int ty = threadIdx.x / C::TX, tx = threadIdx.x % C::TX;

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;

  const int steps = k_begin < k_end ? (k_end - k_begin + kBK - 1) / kBK : 0;
#pragma unroll
  for (int s = 0; s < C::S - 1; ++s) {
    if (s < steps) ring.issue(p, s);
    copies_commit();
  }
  for (int s = 0; s < steps; ++s) {
    copies_wait<C::S - 2>();
    ring.transpose(s);
    __syncthreads();
    if (s + C::S - 1 < steps) ring.issue(p, s + C::S - 1);
    copies_commit();
    fma_stage<C>(acc, ring.a(s), ring.b(s), ty, tx);
  }

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = m0 + (i / 4) * (C::BM / C::QM) + 4 * ty + i % 4;
    if (r >= p.m) continue;
    OutT* row = C_ + (size_t)r * p.n;
#pragma unroll
    for (int q = 0; q < C::QN; ++q) {
      const int col = n0 + q * (C::BN / C::QN) + 4 * tx;
      store_cols(row, col, p.n, acc[i][4 * q], acc[i][4 * q + 1]);
      store_cols(row, col + 2, p.n, acc[i][4 * q + 2], acc[i][4 * q + 3]);
    }
  }
}

template <class C, bool AT, bool BT>
struct Launch {
  template <typename OutT>
  struct Out {
    static void run(const Args& p, dim3 grid, cudaStream_t s, int* rc) {
      *rc = dga::sm90::launch<gemm_ffma_kernel<C, AT, BT, OutT>>(
          grid, C::T, Ring<C, AT, BT>::kBytes, s, p);
    }
  };
};

template <class C>
int launch_tile(const Args& p, int batch, int out_code, cudaStream_t s) {
  const dim3 grid(((p.m + C::BM - 1) / C::BM) * ((p.n + C::BN - 1) / C::BN), 1, batch * p.splits);
  int rc = 0;
  if (p.a_t && p.b_t) by_out<Launch<C, true, true>::template Out>(out_code, p, grid, s, &rc);
  else if (p.a_t) by_out<Launch<C, true, false>::template Out>(out_code, p, grid, s, &rc);
  else if (p.b_t) by_out<Launch<C, false, true>::template Out>(out_code, p, grid, s, &rc);
  else by_out<Launch<C, false, false>::template Out>(out_code, p, grid, s, &rc);
  return rc;
}

}  // namespace ffma

// Route 2: f32 operands with 16-byte aligned bases and stored row pitches
// (the stored last dims) that are multiples of 4; the tile from the whole
// grid, splits and batch counted. K10 passes one split over all of K.
int launch_ffma(const void* a, const void* b, void* c, int batch, int m, int n, int k, int a_t,
                int b_t, int in_code, int out_code, int n_major, int splits, int k_per,
                void* stream) {
  const long long tiles128 = (long long)((m + 127) / 128) * ((n + 127) / 128);
  if (batch <= 0 || m <= 0 || n <= 0 || k < 0 || splits <= 0 || k_per < 0 ||
      (long long)batch * splits > kMaxGridYZ || tiles128 > (1 << 29) || in_code != 0 ||
      out_code < 0 || out_code > 2 || (splits > 1 && (k_per == 0 || k_per % kBK)) ||
      !aligned16(a) || !aligned16(b) || (a_t ? m : k) % 4 || (b_t ? k : n) % 4)
    return (int)cudaErrorInvalidValue;
  Args p{};
  p.a = a;
  p.b = b;
  p.c = c;
  p.m = m;
  p.n = n;
  p.k = k;
  p.k_per = k_per;
  p.splits = splits;
  p.n_major = n_major;
  p.a_t = a_t;
  p.b_t = b_t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 16) return ffma::launch_tile<ffma::Thin>(p, batch, out_code, s);
  if (dga::sm90::large_tile(m, tiles128 * batch * splits))
    return ffma::launch_tile<ffma::Large>(p, batch, out_code, s);
  return ffma::launch_tile<ffma::Mid>(p, batch, out_code, s);
}

// Route 1: 16-bit inputs, K > 0, operands TMA can describe (the maps
// refuse the rest).
int launch_sm90(const void* a, const void* b, void* c, int batch, int m, int n, int k, int a_t,
                int b_t, int in_code, int out_code, int n_major, void* stream) {
  if (batch <= 0 || batch > kMaxGridYZ || m <= 0 || n <= 0 || k <= 0 || in_code < 1 ||
      in_code > 2 || out_code < 0 || out_code > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == 1)
    return layout_sm90<__nv_bfloat16>(a_t, b_t, out_code, a, b, c, batch, m, n, k, n_major, s);
  return layout_sm90<__half>(a_t, b_t, out_code, a, b, c, batch, m, n, k, n_major, s);
}

// K11 on route 1: nn (A K-major, B MN-major), f32 partials.
int ksplit_sm90(const void* a, const void* b, void* partials, int batch, int m, int n, int k,
                int splits, int k_per, int in_code, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0 || splits <= 0 ||
      (long long)batch * splits > kMaxGridYZ || k_per <= 0 || k_per % s9::kBK || in_code < 1 ||
      in_code > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kb_per = k_per / s9::kBK;
  if (in_code == 1)
    return tile_sm90<__nv_bfloat16, false, true, float, true>(a, b, partials, batch, m, n, k, 0, s,
                                                              splits, kb_per);
  return tile_sm90<__half, false, true, float, true>(a, b, partials, batch, m, n, k, 0, s, splits,
                                                     kb_per);
}

}  // namespace

// K10: c (batch, m, n) of out type out_code = a . b per batch element, on
// route 0 (mma_tile), 1 (wgmma) or 2 (ffma).
extern "C" int dga_gemm(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                        int a_t, int b_t, int in_code, int out_code, int n_major, int route,
                        void* stream) {
  if (route == 1)
    return launch_sm90(a, b, c, batch, m, n, k, a_t, b_t, in_code, out_code, n_major, stream);
  if (route == 2)
    return launch_ffma(a, b, c, batch, m, n, k, a_t, b_t, in_code, out_code, n_major, 1, k,
                       stream);
  if (route != 0) return (int)cudaErrorInvalidValue;
  return launch(a, b, c, batch, m, n, k, a_t, b_t, in_code, out_code, n_major, 1, k, stream);
}

// K11: f32 partials (batch, splits, m, n), nn layout; split s sums K range
// [s * k_per, min(k, (s + 1) * k_per)), k_per a multiple of 64, and a
// split past K writes zeros; on route 0 (mma_tile), 1 (wgmma) or 2 (ffma).
extern "C" int dga_gemm_ksplit(const void* a, const void* b, void* partials, int batch, int m,
                               int n, int k, int splits, int k_per, int in_code, int route,
                               void* stream) {
  if (route == 1)
    return ksplit_sm90(a, b, partials, batch, m, n, k, splits, k_per, in_code, stream);
  if (route == 2)
    return launch_ffma(a, b, partials, batch, m, n, k, 0, 0, in_code, 0, 0, splits, k_per,
                       stream);
  if (route != 0) return (int)cudaErrorInvalidValue;
  return launch(a, b, partials, batch, m, n, k, 0, 0, in_code, 0, 0, splits, k_per, stream);
}
