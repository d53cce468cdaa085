// Hopper (sm_90a) 16-bit GEMM main loop shared by the dense GEMM (gemm.cu,
// K10) and the folded-scale FP8 GEMM (fp8_gemm.cu, K12).
//
// The pieces, each written once:
//   * TMA tensor maps (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint, so that nothing links libcuda): 3-D maps
//     (inner, outer, batch) of row-major operands, passed to the kernels by
//     value as __grid_constant__ parameters; out-of-bounds boxes are
//     zero-filled, which is how the K tail and the M/N edges are masked.
//   * mbarrier helpers for a ring of shared-memory stages with full/empty
//     barriers (full: the stage's bytes or its writers have arrived; empty:
//     its readers are done).
//   * wgmma.mma_async m64nNk16 (N = 64, 128, 256) for bf16 and f16 with f32
//     accumulators, from 128-byte-swizzled shared memory, with descriptors
//     for K-major and MN-major operands (the trans bits).
//   * the consumer loop: one warpgroup per 64 output rows runs the stages of
//     the ring through wgmma, keeping one stage's products in flight while
//     it waits for the next, and releases each stage once its products are
//     done;
//   * the epilogue: the f32 accumulators rounded once (RN) to the output
//     type and stored straight from the fragments, masked at the M and N
//     edges.
//
// Stage layout (bf16/f16, kBK = 64 deep: one 128-byte swizzle span): a
// K-major operand tile of R rows is R rows of 128 bytes; an MN-major tile
// of R columns is R/64 panels of 64 K-rows x 128 bytes (8 KB each), since a
// 128-byte swizzle box is at most 64 16-bit elements wide. Every stage
// starts on a 1024-byte boundary (the swizzle repeats every 8 rows).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only: no libcuda at link time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <type_traits>

namespace dga {
namespace sm90 {

constexpr int kBK = 64;             // K depth of one stage (16-bit elements)
constexpr int kPanel = 64 * 128;    // one 64-row x 128-byte swizzle panel, bytes
constexpr int kBand = 16;           // output tiles per raster band (L2 reuse)

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over `batch` row-major matrices of `outer` rows x `inner` elements
// (row pitch `ld`, batch pitch `batch_pitch`, both in elements), read in
// boxes of box_outer rows x box_inner elements. 0, or cudaErrorInvalidValue
// when TMA cannot describe it (base not 16-byte aligned, a pitch not a
// multiple of 16 bytes).
inline int make_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem_bytes, const void* base,
                    uint64_t inner, uint64_t outer, uint64_t batch, uint64_t ld,
                    uint64_t batch_pitch, uint32_t box_inner, uint32_t box_outer,
                    CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return (int)cudaErrorInvalidValue;
  // A batch of one is never stepped: any 16-byte multiple past the matrix.
  if (batch == 1) batch_pitch = (outer * ld * elem_bytes + 15) / 16 * 16 / elem_bytes;
  const cuuint64_t dims[3] = {inner, outer, batch};
  const cuuint64_t strides[2] = {ld * elem_bytes, batch_pitch * elem_bytes};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if ((reinterpret_cast<uintptr_t>(base) & 15u) || strides[0] % 16 || strides[1] % 16)
    return (int)cudaErrorInvalidValue;
  const CUresult r = fn(map, dtype, 3, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The tile rule of both kernels: a 128-row tile where m > 64 and its grid
// (`tiles` blocks) fills the card, at least kFullGrid blocks; else the
// 64 x 64 tile, several blocks an SM (m <= 64, or a narrow n such as 512
// at m = 2048).
constexpr long long kFullGrid = 100;

inline bool large_tile(int m, long long tiles) { return m > 64 && tiles >= kFullGrid; }

// Sets the kernel's dynamic shared memory once per kernel instance (above
// 48 KB it must be asked for), then launches it; returns the launch's
// error, a refused attribute included.
template <auto kKernel, typename... Args>
int launch(dim3 grid, int threads, int smem, cudaStream_t s, Args... args) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kKernel<<<grid, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, rounded up to the 1024-byte swizzle period.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// The producer's arrival: one arrival plus `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that
// lasts ~2^34 cycles (about 10 s) can only be a broken ring: it traps, so
// that the fault surfaces at the next synchronize instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// Box (c0 inner, c1 outer, c2 batch) of `map` into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (MN-major: from one 64-element panel to the next; unused
// K-major), stride byte offset (from one 8-row group to the next: 1024).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)(1024u >> 4) << 32) | (1ull << 62);
}

// Operand tile of a stage at shared address `base`, K step kk (16 deep):
// K-major rows of 128 bytes (row0: first row), or MN-major 8 KB panels
// (panel0: first panel).
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t base, int first64, int kk) {
  return MN ? desc(base + first64 * kPanel + kk * 16 * 128, kPanel)
            : desc(base + first64 * 64 * 128 + kk * 32, 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it writes the registers behind the compiler's back).
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64nNk16: N/2 f32 accumulators a thread.
#define DGA_WGMMA_REGS_N64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DGA_WGMMA_OUTS_N64                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define DGA_WGMMA_REGS_N128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define DGA_WGMMA_OUTS_N128                                                                      \
  DGA_WGMMA_OUTS_N64, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),         \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),            \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),            \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),            \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),            \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define DGA_WGMMA_REGS_N256 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define DGA_WGMMA_OUTS_N256                                                                      \
  DGA_WGMMA_OUTS_N128, "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]),        \
      "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),            \
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),            \
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),            \
      "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]),            \
      "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]),            \
      "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),       \
      "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),      \
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),      \
      "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]),      \
      "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
// Operand numbers after the N/2 accumulators: desc a, desc b, scale-d (1:
// accumulate), trans-a, trans-b.
#define DGA_WGMMA(N, TY, IA, IB, IS, ITA, ITB)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "                  \
               DGA_WGMMA_REGS_N##N ", %" #IA ", %" #IB ", p, 1, 1, %" #ITA ", %" #ITB ";\n}\n" \
               : DGA_WGMMA_OUTS_N##N                                                            \
               : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

// d (64 x N per warpgroup) += A (64 x 16) . B (16 x N); TA / TB: the
// operand is MN-major.
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(N == 64 || N == 128 || N == 256, "wgmma width");
  if constexpr (N == 64) {
    if constexpr (kBf16) DGA_WGMMA(64, "bf16", 32, 33, 34, 35, 36);
    else DGA_WGMMA(64, "f16", 32, 33, 34, 35, 36);
  } else if constexpr (N == 128) {
    if constexpr (kBf16) DGA_WGMMA(128, "bf16", 64, 65, 66, 67, 68);
    else DGA_WGMMA(128, "f16", 64, 65, 66, 67, 68);
  } else {
    if constexpr (kBf16) DGA_WGMMA(256, "bf16", 128, 129, 130, 131, 132);
    else DGA_WGMMA(256, "f16", 128, 129, 130, 131, 132);
  }
}

// The stage ring of a BM x BN tile: STAGES stages of A (BM x kBK) then B
// (BN x kBK), 16-bit, and after them the full and empty barriers.
template <int BM, int BN, int STAGES>
struct Ring {
  static constexpr int kA = BM * kBK * 2;
  static constexpr int kB = BN * kBK * 2;
  static constexpr int kStage = kA + kB;
  static constexpr int kBytes = STAGES * kStage;
  // The barriers, and the slack to round the base up to 1024 bytes.
  static constexpr int kSmem = kBytes + 2 * STAGES * 8 + 1024;
};

// Output tile (tm, tn) of this block: the 1-D grid walks bands of kBand
// tiles of the slow dimension, and inside a band the fast dimension first
// (SwizzleDir: M-major walks n fastest, N-major m fastest), so that a wave
// of blocks shares its operand panels in L2.
__device__ __forceinline__ void tile_of(int tiles_m, int tiles_n, int n_major, int& tm, int& tn) {
  const int fast = n_major ? tiles_m : tiles_n;   // walked first
  const int slow = n_major ? tiles_n : tiles_m;
  const int per_band = kBand * slow;
  const int pid = blockIdx.x;
  const int first = (pid / per_band) * kBand;
  const int width = min(fast - first, kBand);
  const int r = pid % per_band;
  const int f = first + r % width, s = r / width;
  tm = n_major ? f : s;
  tn = n_major ? s : f;
}

// The consumer loop of warpgroup `wg` (its 64 rows of the tile) over
// `nk` stages: wait for each stage, issue its four K steps, keep them in
// flight while the next stage is awaited, release a stage once its
// products are done (one arrival per warpgroup on `empty`). issued(kb)
// runs once stage kb's products are issued, while they run (K12 folds the
// next stage's A there).
template <typename T, int BM, int BN, int STAGES, bool A_MN, bool B_MN, typename Issued>
__device__ __forceinline__ void mma_loop(float (&acc)[BN / 2], const uint8_t* ring, uint64_t* full,
                                         uint64_t* empty, int nk, int wg, Issued issued) {
  using R = Ring<BM, BN, STAGES>;
  const uint32_t base = smem_u32(ring);
  const bool leader = (threadIdx.x & 127) == 0;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&full[s], phase);
    const uint32_t a = base + s * R::kStage, b = a + R::kA;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma<T, BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, operand_desc<A_MN>(a, wg, kk),
                                               operand_desc<B_MN>(b, 0, kk));
    wgmma_commit();
    fence_acc(acc);
    issued(kb);
    if (kb > 0) {
      wgmma_wait<1>();
      if (leader) mbar_arrive(&empty[prev]);
    }
    prev = s;
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

__device__ __forceinline__ void store1(float* c, float x) { *c = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* c, float x) { *c = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store1(__half* c, float x) { *c = __float2half_rn(x); }
__device__ __forceinline__ void store2(float* c, float x, float y) {
  *reinterpret_cast<float2*>(c) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* c, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(__half* c, float x, float y) {
  *reinterpret_cast<__half2*>(c) = __floats2half2_rn(x, y);
}

// Stores x, y at columns col, col + 1 (col even) of a row of n columns,
// dropping what lies past n; a pair store needs an even n to be aligned.
template <typename OutT>
__device__ __forceinline__ void store_cols(OutT* row, int col, int n, float x, float y) {
  if (col + 1 < n && (n & 1) == 0) {
    store2(row + col, x, y);
  } else {
    if (col < n) store1(row + col, x);
    if (col + 1 < n) store1(row + col + 1, y);
  }
}

// The warpgroup's 64 x BN accumulators to rows [row0, row0 + 64) and
// columns [col0, col0 + BN) of c (m x n, row-major), rounded once to OutT.
// Fragment: warp w, lane l holds rows 16w + l/4 (+8) and, in each 8-column
// chunk j, columns 8j + 2(l%4) (+1).
template <int BN, typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], OutT* c, int m, int n,
                                           int row0, int col0) {
  const int t = threadIdx.x & 127;
  const int r = row0 + (t >> 5) * 16 + ((t & 31) >> 2);
  const int cb = col0 + (t & 3) * 2;
  OutT* lo = c + (size_t)r * n;
  OutT* hi = lo + (size_t)8 * n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (r < m) store_cols(lo, cb + 8 * j, n, acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < m) store_cols(hi, cb + 8 * j, n, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace sm90
}  // namespace dga
