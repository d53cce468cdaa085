// K1 and K12: blockwise-scaled FP8 GEMMs for Hopper (sm_90a).
//
// K1 replaces deepgemm_ascend_tpu/ops/fp8_gemm.py:_fp8_gemm_kernel_static and
// :_fp8_gemm_kernel_blocked (one function: the TPU kernel splits it only
// because Mosaic needs static scale slices). Its tile routine, numerics,
// bound and what it leaves for later are described in fp8_gemm.cuh.
//
// K12 replaces :_fp8_gemm_kernel_folded (scale_mode='folded'): the scales
// are folded into the operands and one bf16 product follows,
//   C = sum_k bf16(a[row, k] * a_s[row, k/128]) * bf16(b[k, col] * b_s[k/128, col/128]),
// each fold an f32 multiply of the exact e4m3 value rounded once to bf16
// (RN), exactly as the plain version rounds, so the two differ only in the
// order of the f32 sum. The fold happens while each 128-deep K group is
// staged into shared memory as bf16 (rows of 128 + 8 elements: an
// ldmatrix's eight 16-byte rows land on distinct banks); then the bf16
// mma.sync.m16n8k16 + ldmatrix tile of the dense GEMM (gemm.cu, K10) runs
// over the group, accumulating in f32 registers across all of K. Bound on
// the card: as K1 (weight bytes at decode, tensor cores at prefill); the
// bf16 product runs at the mma.sync rate, the fold costs two conversions
// and a multiply per operand byte, and nothing overlaps loads with math.
//
// B is addressed through strides, so one kernel serves b_layout='t'
// ((n, k), K-major: DeepGEMM's NT and the port's weight layout, 16-byte
// vector loads) and b_layout='n' ((k, n): byte loads). K and N are
// multiples of 128 (checked by the wrapper); a ragged M is masked.
#include "fp8_gemm.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kFPitch = dga::kGroup + 8;   // bf16 elements per staged row

__device__ __forceinline__ float e4m3_to_float(uint8_t byte) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(byte, __NV_E4M3)));
}

__device__ __forceinline__ uint32_t fold2(uint32_t two_bytes, float s) {
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two_bytes & 0xffffu), __NV_E4M3)));
  const __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(f.x, s), __fmul_rn(f.y, s));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 e4m3 values times one scale, rounded to bf16, stored at dst (16-byte
// aligned) in their order.
__device__ __forceinline__ void fold16(uint16_t* dst, uint4 v, float s) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = fold2(w[i], s);
    o[2 * i + 1] = fold2(w[i] >> 16, s);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

template <bool B_KMAJOR, typename OutT>
__device__ void folded_tile(const dga::GemmArgs& p, OutT* c, int m0, int n0) {
  __shared__ __align__(16) uint16_t As[dga::kBM * kFPitch];   // rows m, k contiguous
  __shared__ __align__(16) uint16_t Bs[dga::kBN * kFPitch];   // rows n, k contiguous

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int j4 = lane >> 3, r8 = lane & 7;
  const int k_blocks = p.k / dga::kGroup;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  for (int g = 0; g < k_blocks; ++g) {
    const int kbase = g * dga::kGroup;
    // A: 64 rows x 8 chunks of 16 bytes; rows past M fold to zeros.
#pragma unroll
    for (int it = 0; it < (dga::kBM * dga::kGroup / 16) / dga::kThreads; ++it) {
      const int idx = tid + it * dga::kThreads;
      const int r = idx >> 3, ch = (idx & 7) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      float s = 0.f;
      if (m0 + r < p.m) {
        v = *reinterpret_cast<const uint4*>(p.a + (size_t)(m0 + r) * p.k + kbase + ch);
        s = p.a_s[(size_t)(m0 + r) * k_blocks + g];
      }
      fold16(As + r * kFPitch + ch, v, s);
    }
    if (B_KMAJOR) {
#pragma unroll
      for (int it = 0; it < (dga::kBN * dga::kGroup / 16) / dga::kThreads; ++it) {
        const int idx = tid + it * dga::kThreads;
        const int r = idx >> 3, ch = (idx & 7) * 16;
        const int col = n0 + r;
        const uint4 v = *reinterpret_cast<const uint4*>(p.b + (size_t)col * p.sbn + kbase + ch);
        const float s = p.b_s[(size_t)g * p.bs_g + (size_t)(col >> p.bs_shift) * p.bs_n];
        fold16(Bs + r * kFPitch + ch, v, s);
      }
    } else {
      // Column (tid & 63) is this thread's for the whole group.
      const int cl = tid & (dga::kBN - 1);
      const float s = p.b_s[(size_t)g * p.bs_g + (size_t)((n0 + cl) >> p.bs_shift) * p.bs_n];
      for (int idx = tid; idx < dga::kBN * dga::kGroup; idx += dga::kThreads) {
        const int kk = idx / dga::kBN;
        const float f = e4m3_to_float(p.b[(size_t)(kbase + kk) * p.sbk + (size_t)(n0 + cl) * p.sbn]);
        const __nv_bfloat16 h = __float2bfloat16_rn(__fmul_rn(f, s));
        Bs[cl * kFPitch + kk] = *reinterpret_cast<const uint16_t*>(&h);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < dga::kGroup; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mb = wm * 32 + i * 16;
        dga::ldsm_x4(af[i], As + (mb + (lane & 15)) * kFPitch + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        const int nb = wn * 32 + pp * 16;
        uint32_t r[4];   // (n tile 2pp, k 0-7), (2pp, k 8-15), (2pp+1, k 0-7), (2pp+1, k 8-15)
        dga::ldsm_x4(r, Bs + (nb + r8 + (j4 >> 1) * 8) * kFPitch + kk + (j4 & 1) * 8);
        bf[2 * pp][0] = r[0];
        bf[2 * pp][1] = r[1];
        bf[2 * pp + 1][0] = r[2];
        bf[2 * pp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dga::mma_bf16_f32(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + wm * 32 + i * 16 + gid;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + tig * 2;
      if (r < p.m) dga::store_pair(c + (size_t)r * p.n + col, acc[i][j][0], acc[i][j][1]);
      if (r + 8 < p.m) dga::store_pair(c + (size_t)(r + 8) * p.n + col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <bool FOLDED, bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(dga::kThreads)
fp8_gemm_kernel(dga::GemmArgs p, OutT* c) {
  if constexpr (FOLDED)
    folded_tile<B_KMAJOR, OutT>(p, c, blockIdx.y * dga::kBM, blockIdx.x * dga::kBN);
  else
    dga::gemm_tile<B_KMAJOR, OutT>(p, c, blockIdx.y * dga::kBM, blockIdx.x * dga::kBN);
}

template <bool FOLDED, bool B_KMAJOR, typename OutT>
void launch(const dga::GemmArgs& p, void* c, cudaStream_t stream) {
  dim3 grid(p.n / dga::kBN, (p.m + dga::kBM - 1) / dga::kBM);
  fp8_gemm_kernel<FOLDED, B_KMAJOR, OutT><<<grid, dga::kThreads, 0, stream>>>(
      p, static_cast<OutT*>(c));
}

template <bool FOLDED>
int run(const void* a, const void* a_s, const void* b, const void* b_s, void* c, int m, int n,
        int k, long long sbk, long long sbn, long long bs_g, long long bs_n, int bs_shift,
        int out_f32, void* stream) {
  if (m <= 0 || n % dga::kBN || k % dga::kGroup) return (int)cudaErrorInvalidValue;
  dga::GemmArgs p{static_cast<const uint8_t*>(a), static_cast<const float*>(a_s),
                  static_cast<const uint8_t*>(b), static_cast<const float*>(b_s),
                  m, n, k, sbk, sbn, bs_g, bs_n, bs_shift};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kmajor = sbk == 1;
  if (kmajor && out_f32) launch<FOLDED, true, float>(p, c, s);
  else if (kmajor) launch<FOLDED, true, __nv_bfloat16>(p, c, s);
  else if (out_f32) launch<FOLDED, false, float>(p, c, s);
  else launch<FOLDED, false, __nv_bfloat16>(p, c, s);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: element (kk, col) of B at b[kk * sbk + col * sbn]; scale (g, col) at
// b_s[g * bs_g + (col >> bs_shift) * bs_n].
extern "C" int dga_fp8_gemm(const void* a, const void* a_s, const void* b,
                            const void* b_s, void* c, int m, int n, int k,
                            long long sbk, long long sbn, long long bs_g,
                            long long bs_n, int bs_shift, int out_f32,
                            void* stream) {
  return run<false>(a, a_s, b, b_s, c, m, n, k, sbk, sbn, bs_g, bs_n, bs_shift, out_f32, stream);
}

// K12: the same operands and addressing, folded scales.
extern "C" int dga_fp8_gemm_folded(const void* a, const void* a_s, const void* b,
                                   const void* b_s, void* c, int m, int n, int k,
                                   long long sbk, long long sbn, long long bs_g,
                                   long long bs_n, int bs_shift, int out_f32,
                                   void* stream) {
  return run<true>(a, a_s, b, b_s, c, m, n, k, sbk, sbn, bs_g, bs_n, bs_shift, out_f32, stream);
}
