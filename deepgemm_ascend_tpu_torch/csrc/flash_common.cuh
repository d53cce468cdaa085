// Shared pieces of the flash attention kernels (flash_decode.cu and
// flash_prefill.cu): the same numerics as
// deepgemm_ascend_tpu/ops/flash_common.py, in one place, and the helpers
// of the two tensor-core kernels, which read int8 K/V from 128-byte-swizzled
// TMA stages and convert them exactly to bf16: K2's route "live" runs both
// products as mma.sync m16n8k16 on them in registers, K4 converts them once
// into shared memory for wgmma.
//
//   scores  s = (q_bf16 . k_int8) * (k_scale * 1/sqrt(hd))      (f32)
//   online softmax with NEG_INF = -1e30 and the empty-row guard;
//   (p * v_scale) is rounded to bf16 before the PV product;
//   out = acc / l, with l == 0 giving 0.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dga {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One online-softmax step for one row, run by one warp over `n` scores in
// row[0..n). Rewrites row[j] with bf16(p_j * v_s[j]) and updates the row's
// running (m, l); returns alpha = exp(m_prev - m_new) for rescaling acc.
__device__ __forceinline__ float softmax_row_step(float* row, const float* v_s,
                                                  int n, float* m, float* l) {
  const int lane = threadIdx.x & 31;
  float mx = kNegInf;
  for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
  mx = warp_max(mx);
  const float m_prev = *m;
  const float m_new = fmaxf(m_prev, mx);
  const float alpha = expf(m_prev - m_new);
  const bool live = m_new > kNegInf * 0.5f;
  float sum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float pj = live ? expf(row[j] - m_new) : 0.f;
    sum += pj;
    row[j] = round_bf16(pj * v_s[j]);
  }
  sum = warp_sum(sum);
  __syncwarp();
  if (lane == 0) {
    *l = *l * alpha + sum;
    *m = m_new;
  }
  return alpha;
}

__device__ __forceinline__ float finalize(float acc, float l) {
  return acc / (l > 0.f ? l : 1.f);
}

// ------------------------------------------------- tensor-core fragments

constexpr int kTileRow = 128;   // bytes of a stage row: one int8 head row, one swizzle span

// Bytes 0 and 2 of w, int8, as an exact bf16x2 (byte 0 in the low half):
// 0x4300 | (x & 0x7f) is 128 + (x & 0x7f), 0x4300 | (x & 0x80) is 128 or
// 256 by the sign, and their difference, x, is exact in one fma.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t w) {
  const uint32_t a = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (w & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16 bytes of logical chunk `ch` of row `r` of a 128-byte-swizzled
// tile (eight rows x four threads of a warp's loads hit distinct banks).
__device__ __forceinline__ uint4 ld_tile(const uint8_t* tile, int r, int ch) {
  return *reinterpret_cast<const uint4*>(tile + r * kTileRow + ((ch ^ (r & 7)) << 4));
}

// 2^x (ex2.approx: 2 ulp); the kernel keeps its scores and maxima in the
// log2 domain, s * log2(e), so that e^(s - m) is one instruction.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace dga
