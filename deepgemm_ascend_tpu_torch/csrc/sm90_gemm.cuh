// Hopper (sm_90a) GEMM main loop shared by the dense GEMM and split-K GEMM
// (gemm.cu, K10 and K11), the folded-scale FP8 GEMM (fp8_gemm.cu, K12) and
// the W8A8 int8 GEMMs (int8_gemm.cu: K7, and K6's and K9's wgmma routes,
// whose CTAs carry one ring across several tiles); its TMA, mbarrier and
// cp.async pieces also serve the TMA rings of fp8_gemm.cuh (K1, K3), K6's
// ring route, K2's live route (flash_decode.cu) and K8's wgmma16 route
// (grouped_gemm.cu, with the f16 wgmma that takes A from registers).
//
// The pieces, each written once and generic in the element size:
//   * TMA tensor maps (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint, so that nothing links libcuda): 3-D maps
//     (inner, outer, batch) of row-major operands, passed to the kernels by
//     value as __grid_constant__ parameters; out-of-bounds boxes are
//     zero-filled, which is how the K tail and the M/N edges are masked
//     (for int8 the zeros also keep the integer sum exact);
//   * mbarrier helpers for a ring of shared-memory stages with full/empty
//     barriers (full: the stage's bytes or its writers have arrived; empty:
//     its readers are done), and the producer that fills the ring by TMA;
//   * wgmma.mma_async m64nNk16 (N = 64, 128, 256) for bf16 and f16 with f32
//     accumulators, from 128-byte-swizzled shared memory, with descriptors
//     for K-major and MN-major operands (the trans bits); and m64nNk32 for
//     s8 x s8 with s32 accumulators, K-major only (the trans bits exist for
//     16-bit types alone);
//   * the consumer loop: one warpgroup per 64 output rows runs the stages of
//     the ring through wgmma, keeping one stage's products in flight while
//     it waits for the next, and releases each stage once its products are
//     done;
//   * the epilogues: the f32 accumulators rounded once (RN) to the output
//     type, or the s32 accumulators scaled as (acc * a_s) * b_s in f32,
//     and stored straight from the fragments, masked at the M and N edges.
//
// Stage layout: a stage holds kRowBytes = 128 bytes of K a row (one
// 128-byte swizzle span): 64 bf16/f16 elements (kBK) or 128 int8. A
// K-major operand tile of R rows is R rows of 128 bytes, and each of the
// four wgmma steps of a stage reads the next 32 bytes of K (k16 of 16-bit
// types, k32 of int8); an MN-major tile (16-bit only) of R columns is R/64
// panels of 64 K-rows x 128 bytes (8 KB each), since a 128-byte swizzle
// box is at most 64 16-bit elements wide. Every stage starts on a
// 1024-byte boundary (the swizzle repeats every 8 rows).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only: no libcuda at link time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <type_traits>

namespace dga {
namespace sm90 {

constexpr int kRowBytes = 128;      // K bytes of one stage row: one swizzle span
constexpr int kBK = 64;             // K depth of one stage, 16-bit elements
// K depth of one stage in elements of T: 64 for 16-bit types, 128 for int8.
template <typename T>
constexpr int kStageK = kRowBytes / (int)sizeof(T);
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

// 4 bytes from global src to shared dst, asynchronously (cp.async); zeros
// when !valid (src is not read).
__device__ __forceinline__ void copy4_async(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// An arrival on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void arrive_after_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_u32(bar))
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

// Operand tile of a stage at shared address `base`, K step kk (32 bytes
// of K: 16 deep for 16-bit types, 32 for int8): K-major rows of 128 bytes
// (first64: first 64-row group), or MN-major 8 KB panels (first64: first
// panel).
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
template <int kN>
__device__ __forceinline__ void fence_acc(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// m64nNk16 (16-bit) and m64nNk32 (s8): N/2 accumulators a thread, bound
// with constraint C ("f" for f32, "r" for s32).
#define DGA_WGMMA_REGS_N64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DGA_WGMMA_OUTS_N64(C)                                                                      \
  "+" C(d[0]), "+" C(d[1]), "+" C(d[2]), "+" C(d[3]), "+" C(d[4]), "+" C(d[5]),                    \
      "+" C(d[6]), "+" C(d[7]), "+" C(d[8]), "+" C(d[9]), "+" C(d[10]), "+" C(d[11]),              \
      "+" C(d[12]), "+" C(d[13]), "+" C(d[14]), "+" C(d[15]), "+" C(d[16]), "+" C(d[17]),          \
      "+" C(d[18]), "+" C(d[19]), "+" C(d[20]), "+" C(d[21]), "+" C(d[22]), "+" C(d[23]),          \
      "+" C(d[24]), "+" C(d[25]), "+" C(d[26]), "+" C(d[27]), "+" C(d[28]), "+" C(d[29]),          \
      "+" C(d[30]), "+" C(d[31])
#define DGA_WGMMA_REGS_N128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define DGA_WGMMA_OUTS_N128(C)                                                                     \
  DGA_WGMMA_OUTS_N64(C), "+" C(d[32]), "+" C(d[33]), "+" C(d[34]), "+" C(d[35]),                   \
      "+" C(d[36]), "+" C(d[37]), "+" C(d[38]), "+" C(d[39]), "+" C(d[40]), "+" C(d[41]),          \
      "+" C(d[42]), "+" C(d[43]), "+" C(d[44]), "+" C(d[45]), "+" C(d[46]), "+" C(d[47]),          \
      "+" C(d[48]), "+" C(d[49]), "+" C(d[50]), "+" C(d[51]), "+" C(d[52]), "+" C(d[53]),          \
      "+" C(d[54]), "+" C(d[55]), "+" C(d[56]), "+" C(d[57]), "+" C(d[58]), "+" C(d[59]),          \
      "+" C(d[60]), "+" C(d[61]), "+" C(d[62]), "+" C(d[63])
#define DGA_WGMMA_REGS_N256 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define DGA_WGMMA_OUTS_N256(C)                                                                     \
  DGA_WGMMA_OUTS_N128(C), "+" C(d[64]), "+" C(d[65]), "+" C(d[66]), "+" C(d[67]),                  \
      "+" C(d[68]), "+" C(d[69]), "+" C(d[70]), "+" C(d[71]), "+" C(d[72]), "+" C(d[73]),          \
      "+" C(d[74]), "+" C(d[75]), "+" C(d[76]), "+" C(d[77]), "+" C(d[78]), "+" C(d[79]),          \
      "+" C(d[80]), "+" C(d[81]), "+" C(d[82]), "+" C(d[83]), "+" C(d[84]), "+" C(d[85]),          \
      "+" C(d[86]), "+" C(d[87]), "+" C(d[88]), "+" C(d[89]), "+" C(d[90]), "+" C(d[91]),          \
      "+" C(d[92]), "+" C(d[93]), "+" C(d[94]), "+" C(d[95]), "+" C(d[96]), "+" C(d[97]),          \
      "+" C(d[98]), "+" C(d[99]), "+" C(d[100]), "+" C(d[101]), "+" C(d[102]),                     \
      "+" C(d[103]), "+" C(d[104]), "+" C(d[105]), "+" C(d[106]), "+" C(d[107]),                   \
      "+" C(d[108]), "+" C(d[109]), "+" C(d[110]), "+" C(d[111]), "+" C(d[112]),                   \
      "+" C(d[113]), "+" C(d[114]), "+" C(d[115]), "+" C(d[116]), "+" C(d[117]),                   \
      "+" C(d[118]), "+" C(d[119]), "+" C(d[120]), "+" C(d[121]), "+" C(d[122]),                   \
      "+" C(d[123]), "+" C(d[124]), "+" C(d[125]), "+" C(d[126]), "+" C(d[127])
// Operand numbers after the N/2 accumulators: desc a, desc b, scale-d (1:
// accumulate), trans-a, trans-b.
#define DGA_WGMMA(N, TY, IA, IB, IS, ITA, ITB)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "                  \
               DGA_WGMMA_REGS_N##N ", %" #IA ", %" #IB ", p, 1, 1, %" #ITA ", %" #ITB ";\n}\n" \
               : DGA_WGMMA_OUTS_N##N("f")                                                          \
               : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))
// s8 x s8 -> s32: no scale or transpose operands (K-major only).
#define DGA_WGMMA_S8(N, IA, IB, IS)                                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 "                          \
               DGA_WGMMA_REGS_N##N ", %" #IA ", %" #IB ", p;\n}\n"                              \
               : DGA_WGMMA_OUTS_N##N("r")                                                          \
               : "l"(da), "l"(db), "r"(1))

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

// d (64 x 128 per warpgroup) = A (64 x 16) . B (16 x 128) (+ d where
// accumulate), f16 operands: A from registers, in mma.m16n8k16's A
// fragment per warp (warp w: rows 16w..16w+15; a0 row g, k 2t..2t+1; a1
// row g+8; a2 row g, k 2t+8..2t+9; a3 row g+8), B K-major in shared
// memory. The registers of `a` must stay unchanged until the wgmma is
// waited for.
__device__ __forceinline__ void wgmma_f16_ra(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " DGA_WGMMA_REGS_N128
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
               : DGA_WGMMA_OUTS_N128("f")
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x N per warpgroup, s32) += A (64 x 32) . B (32 x N), s8, both
// operands K-major; exact (|d| stays far below 2^31 for k < 2^17).
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma width");
  if constexpr (N == 64) DGA_WGMMA_S8(64, 32, 33, 34);
  else if constexpr (N == 128) DGA_WGMMA_S8(128, 64, 65, 66);
  else DGA_WGMMA_S8(256, 128, 129, 130);
}

// The stage ring of a BM x BN tile: STAGES stages of A (BM rows of
// kRowBytes) then B (BN rows, or for MN-major B its 64-row panels, of
// kRowBytes), and after them the full and empty barriers. The bytes do not
// depend on the element type.
template <int BM, int BN, int STAGES>
struct Ring {
  static constexpr int kA = BM * kRowBytes;
  static constexpr int kB = BN * kRowBytes;
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

// Thread 0 initialises the ring's barriers: `full` completes on the
// producer's one arrival plus its bytes, `empty` on one arrival per
// consumer warpgroup. The caller then syncs the block.
template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int consumers) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], consumers);
    }
    fence_barrier_init();
  }
}

// The producer (one thread): stages kb_begin .. kb_begin + kb_count - 1 of
// K (kStageK<T> elements each) of the tile at (m0, n0) of batch element
// `batch`, by TMA into the ring, each once its slot is empty. An operand
// stored K-major is one box (K inner); an MN-major one (16-bit only) is
// 64-column panels (MN inner). `it0`: stages this ring has already
// carried (a block that walks several tiles), which sets the first slot
// and its phase. `b_batch`: B's batch element where it is not A's (K9's
// flat A against the expert of the tile), else -1.
template <typename T, int BM, int BN, int STAGES, bool A_MN, bool B_MN>
__device__ __forceinline__ void produce(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* ta, const CUtensorMap* tb, int m0,
                                        int n0, int batch, int kb_begin, int kb_count,
                                        int it0 = 0, int b_batch = -1) {
  using R = Ring<BM, BN, STAGES>;
  static_assert(sizeof(T) == 2 || !(A_MN || B_MN), "8-bit operands are K-major only");
  const int bb = b_batch < 0 ? batch : b_batch;
  int s = it0 % STAGES;
  uint32_t phase = (it0 / STAGES) & 1;
  for (int kb = 0; kb < kb_count; ++kb) {
    const int k0 = (kb_begin + kb) * kStageK<T>;
    mbar_wait(&empty[s], phase ^ 1);
    mbar_expect_tx(&full[s], R::kStage);
    uint8_t* a = ring + s * R::kStage;
    uint8_t* b = a + R::kA;
    if (A_MN) {
#pragma unroll
      for (int i = 0; i < BM / 64; ++i)
        tma_load(a + i * kPanel, ta, &full[s], m0 + 64 * i, k0, batch);
    } else {
      tma_load(a, ta, &full[s], k0, m0, batch);
    }
    if (B_MN) {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_load(b + j * kPanel, tb, &full[s], n0 + 64 * j, k0, bb);
    } else {
      tma_load(b, tb, &full[s], k0, n0, bb);
    }
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
}

// The consumer loop of warpgroup `wg` (its 64 rows of the tile) over
// `nk` stages: wait for each stage, issue its four K steps (32 bytes of K
// each), keep them in flight while the next stage is awaited, release a
// stage once its products are done (one arrival per warpgroup on
// `empty`). issued(kb) runs once stage kb's products are issued, while
// they run (K12 folds the next stage's A there). Acc is float for 16-bit
// T, int for int8; acc is zero when nk is 0. `it0` as in produce. The last
// stage is not handed back: a block that walks on to another tile arrives
// on its empty barrier itself.
template <typename T, int BM, int BN, int STAGES, bool A_MN, bool B_MN, typename Acc,
          typename Issued>
__device__ __forceinline__ void mma_loop(Acc (&acc)[BN / 2], const uint8_t* ring, uint64_t* full,
                                         uint64_t* empty, int nk, int wg, Issued issued,
                                         int it0 = 0) {
  using R = Ring<BM, BN, STAGES>;
  constexpr bool kS8 = std::is_same<T, int8_t>::value;
  static_assert(kS8 == std::is_same<Acc, int>::value, "s32 accumulators for int8 only");
  static_assert(!kS8 || !(A_MN || B_MN), "8-bit operands are K-major only");
  const uint32_t base = smem_u32(ring);
  const bool leader = (threadIdx.x & 127) == 0;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
  int s = it0 % STAGES, prev = s;
  uint32_t phase = (it0 / STAGES) & 1;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&full[s], phase);
    const uint32_t a = base + s * R::kStage, b = a + R::kA;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowBytes / 32; ++kk) {
      if constexpr (kS8)
        wgmma_s8<BN>(acc, operand_desc<false>(a, wg, kk), operand_desc<false>(b, 0, kk));
      else
        wgmma<T, BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, operand_desc<A_MN>(a, wg, kk),
                                                 operand_desc<B_MN>(b, 0, kk));
    }
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

// The W8A8 epilogue of one exact int32 sum: converted with cvt.rn.f32.s32,
// then (acc * a_s) * b_s with __fmul_rn (never folding a_s * b_s, never
// contracted), the order of the JAX kernels and the plain version.
__device__ __forceinline__ float dequant(int acc, float a_s, float b_s) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), a_s), b_s);
}

// store_tile for the s32 accumulators of a W8A8 product: each thread's two
// rows take their per-row scales a_s[r], a_s[r + 8] and each column pair
// its per-column scales from b_s (m and n entries), then dequant, rounded
// once to OutT.
template <int BN, typename OutT>
__device__ __forceinline__ void store_tile_scaled(const int (&acc)[BN / 2], OutT* c,
                                                  const float* a_s, const float* b_s, int m,
                                                  int n, int row0, int col0) {
  const int t = threadIdx.x & 127;
  const int r = row0 + (t >> 5) * 16 + ((t & 31) >> 2);
  const int cb = col0 + (t & 3) * 2;
  const float s_lo = r < m ? a_s[r] : 0.f;
  const float s_hi = r + 8 < m ? a_s[r + 8] : 0.f;
  OutT* lo = c + (size_t)r * n;
  OutT* hi = lo + (size_t)8 * n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = cb + 8 * j;
    const float b0 = col < n ? b_s[col] : 0.f;
    const float b1 = col + 1 < n ? b_s[col + 1] : 0.f;
    if (r < m)
      store_cols(lo, col, n, dequant(acc[4 * j], s_lo, b0), dequant(acc[4 * j + 1], s_lo, b1));
    if (r + 8 < m)
      store_cols(hi, col, n, dequant(acc[4 * j + 2], s_hi, b0),
                 dequant(acc[4 * j + 3], s_hi, b1));
  }
}

}  // namespace sm90
}  // namespace dga
