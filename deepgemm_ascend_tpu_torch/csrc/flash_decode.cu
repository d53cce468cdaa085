// K2, K5a, K5b: flash decode over the int8 KV cache, for Hopper (sm_90a).
//
// Replace three kernels of deepgemm_ascend_tpu/ops/flash_decode.py. For one
// query token per sequence each attends cache rows [0, seq_len) of its kv
// head:
//   K2  _kernel_inplace -> dga_flash_decode_inplace: row seq_len-1 is the
//       new token's K/V row and scale (spliced in from k_new/v_new/k_snew/
//       v_snew, never read back from the cache), and that row and its kv
//       head's scale are written into the four cache arrays in place. Only
//       one block per (batch, kv head) writes, and no block reads what it
//       writes (the reads of that row take the spliced inputs), so the
//       writes cannot race; the TPU kernel's idempotent whole-slab scale
//       write is not needed here.
//   K5a _kernel -> dga_flash_decode_read: the same attention, read only,
//       normalized output.
//   K5b _kernel_state -> dga_flash_decode_state: read only; the merge
//       writes the raw state (acc, m, l) instead of acc / l. An empty
//       sequence gives (0, -1e30, 0).
// One span kernel, templated on WRITE (splice and write, or read only),
// and one merge kernel, templated on STATE.
//
// Design: the keys of each (batch, kv head) are split into spans of
// split_len keys, one block of 128 threads per span (16 slots x 4 kv heads
// alone would leave most of the 132 SMs idle); a span past seq_len leaves
// the empty state at once. The G query rows of the GQA group share every K/V byte a block
// reads. Per chunk of 128 keys: thread j scores key j against all G rows
// (CUDA-core f32 FMAs of exact bf16 x int8 values), one warp per row runs
// the online softmax (flash_common.cuh), then thread d accumulates output
// column d. Each block leaves its unnormalized (acc, m, l) in scratch; a
// second kernel merges the spans: M = max m_i, l = sum l_i e^(m_i-M),
// acc = sum acc_i e^(m_i-M), and out = acc / l (K2, K5a) or (acc, M, l) (K5b).
// With split_len >= S this is the one-block-per-(batch, kv head) design.
//
// Bound on the card: cache bytes (seq_len x hd x 2 int8 per kv head). Left
// for later: V is read one byte per thread, and nothing overlaps loads with
// math.
#include "flash_common.cuh"

namespace {

constexpr int kHD = 128;
constexpr int kThreads = 128;
constexpr int kChunk = 128;   // keys per step; one per thread when scoring

// WRITE = false: k_new, v_new, ks_new, vs_new are null and the caches are
// only read.
template <int G, bool WRITE>
__global__ void __launch_bounds__(kThreads)
flash_decode_span_kernel(const __nv_bfloat16* __restrict__ q, int8_t* kq,
                            float* ks, int8_t* vq, float* vs,
                            const int8_t* __restrict__ k_new,
                            const int8_t* __restrict__ v_new,
                            const float* __restrict__ ks_new,
                            const float* __restrict__ vs_new,
                            const int* __restrict__ seq_lens,
                            float* __restrict__ part, int kvh, int S,
                            int split_len, float scale) {
  __shared__ float sq[G][kHD];
  __shared__ float sp[G][kChunk + 1];
  __shared__ float svs[kChunk];
  __shared__ float sm[G], sl[G], salpha[G];

  const int tid = threadIdx.x;
  const int b = blockIdx.y, h = blockIdx.x, span = blockIdx.z;
  const size_t bh = (size_t)b * kvh + h;
  const int len = seq_lens[b];
  const int pos = WRITE ? len - 1 : -1;  // the new token's row (none: -1)
  const int t_begin = span * split_len;
  const int t_end = min(len, t_begin + split_len);
  int8_t* kc = kq + bh * S * kHD;
  int8_t* vc = vq + bh * S * kHD;
  const int8_t* kn = WRITE ? k_new + bh * kHD : nullptr;
  const int8_t* vn = WRITE ? v_new + bh * kHD : nullptr;

  for (int i = tid; i < G * kHD; i += kThreads)
    sq[i / kHD][i % kHD] = __bfloat162float(q[bh * G * kHD + i]);
  if (tid < G) {
    sm[tid] = dga::kNegInf;
    sl[tid] = 0.f;
  }
  // In-place cache write (by the first span's block). Reads of row `pos`
  // take the spliced inputs, so no thread reads what these stores write.
  if (WRITE && span == 0 && pos >= 0) {
    kc[(size_t)pos * kHD + tid] = kn[tid];
    vc[(size_t)pos * kHD + tid] = vn[tid];
    if (tid == 0) {
      ks[bh * S + pos] = ks_new[bh];
      vs[bh * S + pos] = vs_new[bh];
    }
  }
  float acc[G];
#pragma unroll
  for (int r = 0; r < G; ++r) acc[r] = 0.f;
  __syncthreads();

  const int warp = tid >> 5;
  for (int t0 = t_begin; t0 < t_end; t0 += kChunk) {
    const int t = t0 + tid;
    if (t < t_end) {
      const int8_t* krow = (WRITE && t == pos) ? kn : kc + (size_t)t * kHD;
      const float kscale = (WRITE && t == pos) ? ks_new[bh] : ks[bh * S + t];
      float sc[G];
#pragma unroll
      for (int r = 0; r < G; ++r) sc[r] = 0.f;
#pragma unroll 2
      for (int c = 0; c < kHD; c += 16) {
        const int4 w = *reinterpret_cast<const int4*>(krow + c);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const float kv = static_cast<float>(kb[u]);
#pragma unroll
          for (int r = 0; r < G; ++r) sc[r] = fmaf(sq[r][c + u], kv, sc[r]);
        }
      }
      const float f = kscale * scale;
#pragma unroll
      for (int r = 0; r < G; ++r) sp[r][tid] = sc[r] * f;
      svs[tid] = (WRITE && t == pos) ? vs_new[bh] : vs[bh * S + t];
    } else {
#pragma unroll
      for (int r = 0; r < G; ++r) sp[r][tid] = dga::kNegInf;
      svs[tid] = 0.f;
    }
    __syncthreads();

    const int n = min(kChunk, t_end - t0);
    for (int r = warp; r < G; r += kThreads / 32) {
      const float alpha = dga::softmax_row_step(sp[r], svs, n, &sm[r], &sl[r]);
      if ((tid & 31) == 0) salpha[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < G; ++r) acc[r] *= salpha[r];
    for (int j = 0; j < n; ++j) {
      const int tk = t0 + j;
      const float v = static_cast<float>(WRITE && tk == pos ? vn[tid] : vc[(size_t)tk * kHD + tid]);
#pragma unroll
      for (int r = 0; r < G; ++r) acc[r] = fmaf(sp[r][j], v, acc[r]);
    }
    __syncthreads();
  }

  // This span's unnormalized state: per row r, [acc(kHD), m, l].
  float* mine = part + ((bh * gridDim.z + span) * G) * (kHD + 2);
#pragma unroll
  for (int r = 0; r < G; ++r) mine[r * (kHD + 2) + tid] = acc[r];
  if (tid < G) {
    mine[tid * (kHD + 2) + kHD] = sm[tid];
    mine[tid * (kHD + 2) + kHD + 1] = sl[tid];
  }
}

// Merges the spans of one (batch, kv head): thread d owns output column d.
// out: (b, kvh, G, hd) f32, normalized, or with STATE the merged acc and
// m_out / l_out (b, kvh, G).
template <int G, bool STATE>
__global__ void __launch_bounds__(kThreads)
flash_decode_merge_kernel(const float* __restrict__ part,
                          float* __restrict__ out, float* __restrict__ m_out,
                          float* __restrict__ l_out, int n_split) {
  const int tid = threadIdx.x;
  const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* base = part + bh * n_split * G * (kHD + 2);
#pragma unroll
  for (int r = 0; r < G; ++r) {
    float m_all = dga::kNegInf;
    for (int s = 0; s < n_split; ++s)
      m_all = fmaxf(m_all, base[(s * G + r) * (kHD + 2) + kHD]);
    float l_all = 0.f, a_all = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* p = base + (s * G + r) * (kHD + 2);
      const float w = expf(p[kHD] - m_all);
      l_all += p[kHD + 1] * w;
      a_all += p[tid] * w;
    }
    if (STATE) {
      out[(bh * G + r) * kHD + tid] = a_all;
      if (tid == 0) {
        m_out[bh * G + r] = m_all;
        l_out[bh * G + r] = l_all;
      }
    } else {
      out[(bh * G + r) * kHD + tid] = dga::finalize(a_all, l_all);
    }
  }
}

struct Args {
  const void* q;
  void *kq, *ks, *vq, *vs;
  const void *k_new, *v_new, *ks_new, *vs_new, *seq_lens;
  void *part, *out, *m, *l;
  int b, kvh, S, split_len;
  float scale;
};

template <int G, bool WRITE, bool STATE>
void launch(const Args& a, cudaStream_t stream) {
  const int n_split = (a.S + a.split_len - 1) / a.split_len;
  flash_decode_span_kernel<G, WRITE><<<dim3(a.kvh, a.b, n_split), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<int8_t*>(a.kq),
      static_cast<float*>(a.ks), static_cast<int8_t*>(a.vq), static_cast<float*>(a.vs),
      static_cast<const int8_t*>(a.k_new), static_cast<const int8_t*>(a.v_new),
      static_cast<const float*>(a.ks_new), static_cast<const float*>(a.vs_new),
      static_cast<const int*>(a.seq_lens), static_cast<float*>(a.part), a.kvh, a.S,
      a.split_len, a.scale);
  flash_decode_merge_kernel<G, STATE><<<dim3(a.kvh, a.b), kThreads, 0, stream>>>(
      static_cast<const float*>(a.part), static_cast<float*>(a.out),
      static_cast<float*>(a.m), static_cast<float*>(a.l), n_split);
}

template <bool WRITE, bool STATE>
int dispatch(const Args& a, int g, int hd, void* stream) {
  if (hd != kHD || a.b <= 0 || a.kvh <= 0 || a.S <= 0 || a.split_len <= 0 ||
      a.split_len % kChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1: launch<1, WRITE, STATE>(a, s); break;
    case 2: launch<2, WRITE, STATE>(a, s); break;
    case 4: launch<4, WRITE, STATE>(a, s); break;
    case 8: launch<8, WRITE, STATE>(a, s); break;
    case 16: launch<16, WRITE, STATE>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// part (all three): scratch of b * kvh * ceil(S / split_len) * g * (hd + 2)
// floats.
// K2: out (b, kvh, g, hd) f32; writes the new rows into the caches.
extern "C" int dga_flash_decode_inplace(
    const void* q, void* kq, void* ks, void* vq, void* vs, const void* k_new,
    const void* v_new, const void* ks_new, const void* vs_new,
    const void* seq_lens, void* part, void* out, int b, int kvh, int g, int S,
    int hd, int split_len, float scale, void* stream) {
  const Args a{q, kq, ks, vq, vs, k_new, v_new, ks_new, vs_new, seq_lens,
               part, out, nullptr, nullptr, b, kvh, S, split_len, scale};
  return dispatch<true, false>(a, g, hd, stream);
}

// K5a: out (b, kvh, g, hd) f32; the caches are only read.
extern "C" int dga_flash_decode_read(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* seq_lens, void* part, void* out, int b, int kvh, int g, int S,
    int hd, int split_len, float scale, void* stream) {
  const Args a{q, const_cast<void*>(kq), const_cast<void*>(ks), const_cast<void*>(vq),
               const_cast<void*>(vs), nullptr, nullptr, nullptr, nullptr, seq_lens,
               part, out, nullptr, nullptr, b, kvh, S, split_len, scale};
  return dispatch<false, false>(a, g, hd, stream);
}

// K5b: acc (b, kvh, g, hd), m and l (b, kvh, g), all f32; read only.
extern "C" int dga_flash_decode_state(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* seq_lens, void* part, void* acc, void* m, void* l, int b, int kvh,
    int g, int S, int hd, int split_len, float scale, void* stream) {
  const Args a{q, const_cast<void*>(kq), const_cast<void*>(ks), const_cast<void*>(vq),
               const_cast<void*>(vs), nullptr, nullptr, nullptr, nullptr, seq_lens,
               part, acc, m, l, b, kvh, S, split_len, scale};
  return dispatch<false, true>(a, g, hd, stream);
}
