// K4 and K4-stats: causal GQA flash prefill over the int8 KV cache, for
// Hopper (sm_90a).
//
// Replaces deepgemm_ascend_tpu/ops/flash_prefill.py:_kernel in both its
// forms: return_stats=False (dga_flash_prefill: acc / l) and
// return_stats=True (dga_flash_prefill_stats: the raw online-softmax state
// acc, m, l for merging across ring-attention hops). Query row i of batch b
// sits at absolute position start[b] + i (start may be negative) and attends
// cache rows t with t <= start[b] + i and t < seq_len[b]; chunks past both
// are never loaded. A row that sees no key (before position 0, or a hop
// wholly in its future) keeps the initial state (acc 0, m -1e30, l 0); a
// start at or past the cache length sees every valid key. Numerics as in
// flash_common.cuh.
//
// Design (simple first): one block of 256 threads per (batch, kv head,
// q block); a q block is BQ = 64 / G consecutive positions of all G heads of
// the group, so the block works on 64 rows (the TPU kernel's g*bq collapse,
// without its VMEM-driven block search). Per 64-key chunk the int8 K rows
// are widened to f32 in shared memory, each thread scores a 4 x 4 patch on
// the CUDA cores, one warp per 8 rows runs the online softmax, then the
// V chunk replaces K in shared memory and each thread accumulates a 4 x 8
// output patch.
//
// Bound on the card: tensor-core work at long prompts, cache bytes at short
// ones. Left for later: mma/wgmma for both products (the CUDA cores run far
// below the bf16 tensor-core rate), overlap of the next chunk's loads.
#include "flash_common.cuh"

namespace {

constexpr int kHD = 128;
constexpr int kThreads = 256;
constexpr int kRows = 64;      // G * BQ
constexpr int kChunk = 64;     // keys per step
constexpr int kQP = kHD + 1;   // f32 pitch of the Q and K/V tiles
constexpr int kPP = kChunk + 1;

constexpr size_t kSmemFloats = 2 * kRows * kQP + kRows * kPP + 2 * kChunk + 3 * kRows;

// out: (b, kvh, G, s, hd) f32, normalized, or with STATS the unnormalized
// acc, and m_out / l_out (b, kvh, G, s).
template <int G, bool STATS>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const int8_t* __restrict__ kq, const float* __restrict__ ks,
                     const int8_t* __restrict__ vq, const float* __restrict__ vs,
                     const int* __restrict__ start, const int* __restrict__ seq_lens,
                     float* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int kvh, int s, int S, float scale) {
  constexpr int BQ = kRows / G;
  extern __shared__ float smem[];
  float* sQ = smem;                       // [kRows][kQP]
  float* sKV = sQ + kRows * kQP;          // [kChunk][kQP]
  float* sP = sKV + kChunk * kQP;         // [kRows][kPP]
  float* sks = sP + kRows * kPP;          // [kChunk]
  float* svs = sks + kChunk;              // [kChunk]
  float* sm = svs + kChunk;               // [kRows]
  float* sl = sm + kRows;
  float* salpha = sl + kRows;

  const int tid = threadIdx.x;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * kvh + h;
  const int q0 = qb * BQ;
  const int st = start[b];
  const int limit = min(seq_lens[b], S);
  const int8_t* kc = kq + bh * S * kHD;
  const int8_t* vc = vq + bh * S * kHD;
  const float* ksc = ks + bh * S;
  const float* vsc = vs + bh * S;

  // Row r = gi * BQ + qi holds head gi of the group at position q0 + qi.
  for (int i = tid; i < kRows * kHD; i += kThreads) {
    const int r = i / kHD, d = i % kHD;
    const int gi = r / BQ, qpos = q0 + r % BQ;
    sQ[r * kQP + d] = qpos < s ? __bfloat162float(q[((bh * G + gi) * s + qpos) * kHD + d]) : 0.f;
  }
  if (tid < kRows) {
    sm[tid] = dga::kNegInf;
    sl[tid] = 0.f;
  }

  const int ty = tid >> 4, tx = tid & 15;   // rows ty*4+i; keys tx+16j / dims tx+16j
  int rpos[4];                              // absolute position of each owned row
#pragma unroll
  for (int i = 0; i < 4; ++i) rpos[i] = st + q0 + (ty * 4 + i) % BQ;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int q_hi = st + min(q0 + BQ, s) - 1;        // last query position
  const int kv_end = min(limit, q_hi + 1);           // keys needed: [0, kv_end)
  const int warp = tid >> 5;

  for (int t0 = 0; t0 < kv_end; t0 += kChunk) {
    __syncthreads();   // previous chunk's PV reads of sKV / sP are done
    for (int i = tid; i < kChunk * kHD / 16; i += kThreads) {
      const int key = i >> 3, c = (i & 7) * 16;
      const int t = t0 + key;
      int4 w = make_int4(0, 0, 0, 0);
      if (t < kv_end) w = *reinterpret_cast<const int4*>(kc + (size_t)t * kHD + c);
      const int8_t* kb = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
      for (int u = 0; u < 16; ++u) sKV[key * kQP + c + u] = static_cast<float>(kb[u]);
    }
    if (tid < kChunk) {
      const int t = t0 + tid;
      sks[tid] = t < kv_end ? ksc[t] : 0.f;
      svs[tid] = t < kv_end ? vsc[t] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * kQP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKV[(tx + 16 * j) * kQP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = tx + 16 * j;
      const int t = t0 + key;
      const float f = sks[key] * scale;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = t < limit && t <= rpos[i];
        sP[(ty * 4 + i) * kPP + key] = ok ? sc[i][j] * f : dga::kNegInf;
      }
    }
    __syncthreads();

    const int n = min(kChunk, kv_end - t0);
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const float alpha = dga::softmax_row_step(sP + r * kPP, svs, n, &sm[r], &sl[r]);
      if ((tid & 31) == 0) salpha[r] = alpha;
    }
    // V replaces K in shared memory (all score reads of sKV are done).
    for (int i = tid; i < kChunk * kHD / 16; i += kThreads) {
      const int key = i >> 3, c = (i & 7) * 16;
      const int t = t0 + key;
      int4 w = make_int4(0, 0, 0, 0);
      if (t < kv_end) w = *reinterpret_cast<const int4*>(vc + (size_t)t * kHD + c);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
      for (int u = 0; u < 16; ++u) sKV[key * kQP + c + u] = static_cast<float>(vb[u]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = salpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= a;
    }
    for (int key = 0; key < n; ++key) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * kPP + key];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = sKV[key * kQP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int gi = r / BQ, qpos = q0 + r % BQ;
    if (qpos >= s) continue;
    const size_t row = (bh * G + gi) * s + qpos;
    float* o = out + row * kHD;
    if (STATS) {
#pragma unroll
      for (int j = 0; j < 8; ++j) o[tx + 16 * j] = acc[i][j];
      if (tx == 0) {
        m_out[row] = sm[r];
        l_out[row] = sl[r];
      }
    } else {
      const float l = sl[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[tx + 16 * j] = dga::finalize(acc[i][j], l);
    }
  }
}

struct Args {
  const void *q, *kq, *ks, *vq, *vs, *start, *seq_lens;
  void *out, *m, *l;
  int b, kvh, s, S;
  float scale;
};

template <int G, bool STATS>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<G, STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = kRows / G;
  dim3 grid((a.s + BQ - 1) / BQ, a.kvh, a.b);
  flash_prefill_kernel<G, STATS><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int8_t*>(a.kq),
      static_cast<const float*>(a.ks), static_cast<const int8_t*>(a.vq),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.start),
      static_cast<const int*>(a.seq_lens), static_cast<float*>(a.out),
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.kvh, a.s, a.S, a.scale);
  return (int)cudaGetLastError();
}

template <bool STATS>
int dispatch(const Args& a, int g, int hd, void* stream) {
  if (hd != kHD || a.b <= 0 || a.kvh <= 0 || a.s <= 0 || a.S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1: return launch<1, STATS>(a, st);
    case 2: return launch<2, STATS>(a, st);
    case 4: return launch<4, STATS>(a, st);
    case 8: return launch<8, STATS>(a, st);
    case 16: return launch<16, STATS>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K4: out (b, kvh, g, s, hd) f32 = acc / l.
extern "C" int dga_flash_prefill(const void* q, const void* kq, const void* ks,
                                 const void* vq, const void* vs, const void* start,
                                 const void* seq_lens, void* out, int b, int kvh,
                                 int g, int s, int S, int hd, float scale,
                                 void* stream) {
  const Args a{q, kq, ks, vq, vs, start, seq_lens, out, nullptr, nullptr, b, kvh, s, S, scale};
  return dispatch<false>(a, g, hd, stream);
}

// K4-stats: acc (b, kvh, g, s, hd), m and l (b, kvh, g, s), all f32.
extern "C" int dga_flash_prefill_stats(const void* q, const void* kq, const void* ks,
                                       const void* vq, const void* vs, const void* start,
                                       const void* seq_lens, void* acc, void* m, void* l,
                                       int b, int kvh, int g, int s, int S, int hd,
                                       float scale, void* stream) {
  const Args a{q, kq, ks, vq, vs, start, seq_lens, acc, m, l, b, kvh, s, S, scale};
  return dispatch<true>(a, g, hd, stream);
}
