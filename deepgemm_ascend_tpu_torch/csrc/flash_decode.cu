// K2, K5a, K5b: flash decode over the int8 KV cache, for Hopper (sm_90a).
//
// Replace three kernels of deepgemm_ascend_tpu/ops/flash_decode.py. For one
// query token per sequence each attends cache rows [0, seq_len) of its kv
// head:
//   K2  _kernel_inplace (:251) -> dga_flash_decode_inplace: row seq_len-1
//       is the new token's K/V row and scale (taken from k_new/v_new/
//       k_snew/v_snew, never read back from the cache), and that row and
//       its kv head's scale are written into the four cache arrays in
//       place, by one block per (batch, kv head) once no block reads that
//       cache any more; the TPU kernel's idempotent whole-slab scale write
//       is not needed here.
//   K5a _kernel -> dga_flash_decode_read: the same attention, read only,
//       normalized output.
//   K5b _kernel_state -> dga_flash_decode_state: read only; the merge
//       writes the raw state (acc, m, l) instead of acc / l. An empty
//       sequence gives (0, -1e30, 0).
//
// Bound on the card: the cache bytes of the live keys (seq_len x (2 hd + 8)
// bytes per kv head), at decode a few to tens of MB: at the phase-2 V2_LITE
// shape 0.0111 ms at 3.35 TB/s.
//
// Two routes (ops/flash_decode.py: ROUTES), the same for the three:
//   "span" (where the caches, or K2's new rows, are off 16 bytes, or the
//     head size is 64; head sizes 64 and 128): the keys
//     of each (batch, kv head) split into spans of split_len keys, one
//     block of 128 threads per span, however many keys are live; per chunk
//     of 128 keys thread j scores key j against the G rows on the CUDA
//     cores, one warp per row runs the online softmax (flash_common.cuh),
//     then thread d accumulates column d reading V a byte a thread, key
//     after key; nothing overlaps loads with math. A second kernel merges
//     the spans: M = max m_i, l = sum l_i e^(m_i-M), acc = sum acc_i
//     e^(m_i-M), and out = acc / l (K5a) or (acc, M, l) (K5b). One span
//     kernel, templated on WRITE and the head size, and one merge kernel,
//     on STATE and the head size.
//   "live" (head size 128, K2's decode path and K5a/K5b's default): the
//     live keys of all sequences dealt over a grid fixed by the shapes, a
//     TMA ring, and both products on the tensor cores, with the merge done
//     by the last block of each (batch, kv head) to finish. One kernel,
//     templated on WRITE and STATE as the span route is; its design note
//     is at namespace live below.

#include "flash_common.cuh"
#include "sm90_gemm.cuh"

namespace {

constexpr int kHD = 128;       // route "live"'s head size
constexpr int kThreads = 128;
constexpr int kChunk = 128;   // keys per step; one per thread when scoring

// WRITE = false: k_new, v_new, ks_new, vs_new are null and the caches are
// only read. HD, the head size (64 or 128): thread d < HD owns column d of
// the new row, of V and of the state; every thread scores a key.
template <int G, bool WRITE, int HD>
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
  static_assert(HD % 16 == 0 && HD <= kThreads, "a column a thread");
  __shared__ float sq[G][HD];
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
  int8_t* kc = kq + bh * S * HD;
  int8_t* vc = vq + bh * S * HD;
  const int8_t* kn = WRITE ? k_new + bh * HD : nullptr;
  const int8_t* vn = WRITE ? v_new + bh * HD : nullptr;

  for (int i = tid; i < G * HD; i += kThreads)
    sq[i / HD][i % HD] = __bfloat162float(q[bh * G * HD + i]);
  if (tid < G) {
    sm[tid] = dga::kNegInf;
    sl[tid] = 0.f;
  }
  // In-place cache write (by the first span's block). Reads of row `pos`
  // take the spliced inputs, so no thread reads what these stores write.
  if (WRITE && span == 0 && pos >= 0) {
    if (tid < HD) {
      kc[(size_t)pos * HD + tid] = kn[tid];
      vc[(size_t)pos * HD + tid] = vn[tid];
    }
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
      const int8_t* krow = (WRITE && t == pos) ? kn : kc + (size_t)t * HD;
      const float kscale = (WRITE && t == pos) ? ks_new[bh] : ks[bh * S + t];
      float sc[G];
#pragma unroll
      for (int r = 0; r < G; ++r) sc[r] = 0.f;
#pragma unroll 2
      for (int c = 0; c < HD; c += 16) {
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

    if (tid < HD) {
#pragma unroll
      for (int r = 0; r < G; ++r) acc[r] *= salpha[r];
      for (int j = 0; j < n; ++j) {
        const int tk = t0 + j;
        const float v = static_cast<float>(WRITE && tk == pos ? vn[tid] : vc[(size_t)tk * HD + tid]);
#pragma unroll
        for (int r = 0; r < G; ++r) acc[r] = fmaf(sp[r][j], v, acc[r]);
      }
    }
    __syncthreads();
  }

  // This span's unnormalized state: per row r, [acc(HD), m, l].
  float* mine = part + ((bh * gridDim.z + span) * G) * (HD + 2);
  if (tid < HD) {
#pragma unroll
    for (int r = 0; r < G; ++r) mine[r * (HD + 2) + tid] = acc[r];
  }
  if (tid < G) {
    mine[tid * (HD + 2) + HD] = sm[tid];
    mine[tid * (HD + 2) + HD + 1] = sl[tid];
  }
}

// Merges the spans of one (batch, kv head): thread d owns output column d.
// out: (b, kvh, G, hd) f32, normalized, or with STATE the merged acc and
// m_out / l_out (b, kvh, G).
template <int G, bool STATE, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_merge_kernel(const float* __restrict__ part,
                          float* __restrict__ out, float* __restrict__ m_out,
                          float* __restrict__ l_out, int n_split) {
  const int tid = threadIdx.x;
  if (tid >= HD) return;
  const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* base = part + bh * n_split * G * (HD + 2);
#pragma unroll
  for (int r = 0; r < G; ++r) {
    float m_all = dga::kNegInf;
    for (int s = 0; s < n_split; ++s)
      m_all = fmaxf(m_all, base[(s * G + r) * (HD + 2) + HD]);
    float l_all = 0.f, a_all = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* p = base + (s * G + r) * (HD + 2);
      const float w = expf(p[HD] - m_all);
      l_all += p[HD + 1] * w;
      a_all += p[tid] * w;
    }
    if (STATE) {
      out[(bh * G + r) * HD + tid] = a_all;
      if (tid == 0) {
        m_out[bh * G + r] = m_all;
        l_out[bh * G + r] = l_all;
      }
    } else {
      out[(bh * G + r) * HD + tid] = dga::finalize(a_all, l_all);
    }
  }
}

// ------------------------------------------------------------ route "live"
//
// K2's route for the decode path (ops/flash_decode.py: route, live_blocks,
// live_plan), and K5a's and K5b's at head size 128 (read_route). The grid
// is fixed by (b, kvh, S) alone, so the wrapper reads
// nothing back: one block per (batch, kv head) and LIVE_BLOCKS_PER_SM per
// SM more. Every block reads all the lengths on the card (plan_scan) and
// finds its (batch, kv head) and its share of that head's live keys: the
// ceil(len / kChunk) chunks of each head dealt to nb blocks, nb in
// proportion to its chunks (a quota of ceil(C / spare blocks) chunks a
// block, C all heads' live chunks), so that a 16-key sequence and a
// 4096-key one each cost their own chunks, and a head's blocks differ by
// at most one chunk (block_range). Blocks past the plan leave at once;
// an empty sequence's one block writes zeros.
//
// A block: one producer warp keeps kStages chunks in flight (TMA boxes of
// 64 K rows and 64 V rows, 128-byte swizzle, from 3-D maps with batch =
// (batch, kv head); its lanes copy the chunk's k and v scales beside them
// by cp.async); four consumer warps each take 16 keys of every chunk and
// keep their own online softmax (m, l, acc), merged in shared memory when
// the block is done into one partial state per block. The last block of a
// (batch, kv head) to finish (an arrival count it resets) merges that
// head's partial states in block order, writes out, and writes the new
// token's row into the cache; a head with one block writes out directly. A warp runs both products on the tensor cores,
// mma.sync m16n8k16 bf16 with f32 sums, the reference's arithmetic (JAX
// casts the int8 K and V to bf16 and runs bf16 dots into f32): every int8
// value is exact in bf16 (s8x2_to_bf16x2), so each product is exact and
// only the order of the f32 sums differs from the plain version.
//   scores  S (query rows x 16 keys) = Q (the G rows padded to 16) . K^T:
//           Q's fragments are built once into shared memory (registers
//           kept for three blocks an SM); K's come
//           from the swizzled stage as 32 bytes of a key row a thread (the
//           head dimension permuted alike in Q and K, which changes no
//           product);
//   softmax per query row over the warp's 16 keys, in the log2 domain
//           (s * log2 e, so e^(s - m) is one ex2): the running max across
//           the four threads of a row (two shuffles), p = e^(s - m), and
//           w = bf16(p * v_scale) against that running max (the rounding
//           point of flash_common.cuh); masked keys give w = 0;
//   PV      acc (rows x hd) += W . V: S's accumulator fragments are W's A
//           fragments as they stand; V's B fragments are 16 bytes of four
//           key rows a thread, paired across rows with byte_perm.
// K2 (WRITE): the new token's row (seq_len - 1) is read from k_new / v_new
// / k_snew / v_snew by the thread that would read it from the stage, and
// written into the cache by the merging block, after every block of its
// (batch, kv head) has read that cache: no TMA read can race with that
// store. K5a and K5b read that row from the ring like every other, so K5a
// over the cache K2 wrote, at K2's lengths and grid, runs the same plan
// and arithmetic: K2's output bit for bit. K5b writes the merged acc and
// l that K5a divides (finalize) and m converted from the log2 domain (one
// more rounding), so acc / l is K5a's output bit for bit; an empty
// sequence's state is (0, -1e30, 0).
// Registers cap the block at 136 (three blocks an SM, 3 x kStages x 16 KB
// in flight): ptxas gives every instance 119-123, no spill (K2's before
// WRITE and STATE were template arguments: 126-127); the score k steps
// run in two chains of four, and acc is rescaled only where a row's max
// moved.
namespace live {

namespace s9 = dga::sm90;
using dga::ex2;
using dga::ld_tile;
using dga::mma_bf16;
using dga::pack_bf16x2;
using dga::quad_max;
using dga::quad_sum;
using dga::s8x2_to_bf16x2;

constexpr int kChunk = 64;                  // keys a stage
constexpr int kWarps = 4;                   // consumer warps, 16 keys of each stage each
constexpr int kStages = 4;
constexpr int kThreads = (kWarps + 1) * 32;
constexpr int kKV = kChunk * kHD;           // bytes of K (and of V) a stage
constexpr int kStage = 2 * kKV;
constexpr int kScales = 2 * kChunk;         // a stage's k scales, then its v scales
constexpr int kQFrags = 8 * 32 * 16;        // Q's A fragments, every lane's
constexpr int kSmem = kStages * kStage + kStages * kScales * 4 + 2 * kStages * 8 + kQFrags + 1024;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kWarps * 16 * (kHD + 2) * 4 <= kStages * kStage, "the warps' states fit the ring");

constexpr int kMaxSplits = 256;             // the fused merge's weights fit the ring
static_assert((2 * kMaxSplits * 16 + 32) * 4 <= kStages * kStage, "");

struct Args {
  const __nv_bfloat16* q;
  int8_t* kq;
  float* ks;
  int8_t* vq;
  float* vs;
  const int8_t* k_new;
  const int8_t* v_new;
  const float* ks_new;
  const float* vs_new;
  const int* seq_lens;
  float* part;
  float* out;        // acc with STATE
  int* arrivals;     // per (batch, kv head), zero between launches
  int b, kvh, S;
  int blocks;        // the grid: at least b * kvh + 1
  float scale;
  float* m_out;      // STATE: the merged m and l, (b, kvh, G)
  float* l_out;
};

__device__ __forceinline__ int clamp_len(const int* seq_lens, int b, int S) {
  return min(max(seq_lens[b], 0), S);
}

__device__ __forceinline__ int chunks_of(int len) { return (len + kChunk - 1) / kChunk; }

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The plan (ops/flash_decode.py: live_plan), read from the lengths on the
// card by every block: with C the live chunks of all (batch, kv head)s and
// A = blocks - b * kvh, each head of sequence b takes
// nb_b = min(kMaxSplits, max(1, ceil(chunks_b / ceil(C / A)))) blocks, in
// the order (b, h, split); sum_b kvh * nb_b <= C / ceil(C / A) + b * kvh
// <= blocks. Fills sh[kW..] with (sequence, first block, nb) of block
// `want_block` (sequence -1 if it has none). sh: kW + 3 ints, kW the
// block's warps.
__device__ void plan_scan(const Args& p, int* sh, int want_block) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, kW = threads / 32;
  int c = 0;
  for (int i = tid; i < p.b; i += threads) c += chunks_of(clamp_len(p.seq_lens, i, p.S));
  c = warp_sum_int(c);
  if (lane == 0) sh[warp] = c;
  if (tid == 0) sh[kW] = -1;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kW; ++w) total += sh[w];
  total *= p.kvh;
  const long long avail = p.blocks - (long long)p.b * p.kvh;
  const int quota = (int)max(1ll, (total + avail - 1) / avail);
  __syncthreads();
  int carry = 0;
  for (int base = 0; base < p.b; base += threads) {
    const int i = base + tid;
    const int nb = i < p.b ? min(kMaxSplits,
                                 max(1, (chunks_of(clamp_len(p.seq_lens, i, p.S)) + quota - 1) /
                                            quota))
                           : 0;
    const int v = nb * p.kvh;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) sh[warp] = incl;
    __syncthreads();
    int start = carry + incl - v, tile = 0;
    for (int w = 0; w < kW; ++w) {
      if (w < warp) start += sh[w];
      tile += sh[w];
    }
    if (i < p.b && want_block >= start && want_block < start + v) {
      sh[kW] = i;
      sh[kW + 1] = start;
      sh[kW + 2] = nb;
    }
    carry += tile;
    __syncthreads();
  }
}

// Chunks [c0, c0 + nc) of block `split` of `splits` over `len` keys.
__device__ __forceinline__ void block_range(int len, int split, int splits, int& c0, int& nc) {
  const int chunks = (len + kChunk - 1) / kChunk;
  const int base = chunks / splits, rem = chunks % splits;
  c0 = split * base + min(split, rem);
  nc = base + (split < rem ? 1 : 0);
}

// One query row's merged state (a the acc of column d, m in the log2
// domain, l) to the outputs: acc / l, or with STATE (acc, m in natural
// units, l).
template <bool STATE>
__device__ __forceinline__ void write_row(const Args& p, size_t row, int d, float a, float m,
                                          float l) {
  if constexpr (STATE) {
    p.out[row * kHD + d] = a;
    if (d == 0) {
      p.m_out[row] = m / kLog2e;
      p.l_out[row] = l;
    }
  } else {
    p.out[row * kHD + d] = dga::finalize(a, l);
  }
}

// Writes the new token's row of (batch, kv head) bh into the cache: every
// block that reads this cache has read it (the row itself came from
// k_new / v_new), so nothing races with these stores.
__device__ __forceinline__ void write_new_row(const Args& p, int bh, int len) {
  const size_t row = (size_t)bh * p.S + len - 1;
  for (int i = threadIdx.x; i < kHD; i += blockDim.x) {
    p.kq[row * kHD + i] = p.k_new[(size_t)bh * kHD + i];
    p.vq[row * kHD + i] = p.v_new[(size_t)bh * kHD + i];
  }
  if (threadIdx.x == 0) {
    p.ks[row] = p.ks_new[bh];
    p.vs[row] = p.vs_new[bh];
  }
}

// Grid (blocks). Each block with keys leaves its unnormalized state, per
// query row [acc (kHD), m, l], at part[blockIdx.x]; the last block of a
// (batch, kv head) to finish (an arrival count that it resets) merges the
// states into out and, with WRITE (K2), writes the new row.
// WRITE = false (K5a, K5b): the caches are only read, and row seq_len - 1
// comes through the ring like every other row (k_new .. vs_new are null
// and never read). STATE (K5b): the outputs are (acc, m, l) (write_row).
template <int G, bool WRITE, bool STATE>
__global__ void __launch_bounds__(kThreads, 3)
    live_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                Args p) {
  static_assert(G <= 16, "the query rows fill one m16 fragment");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = s9::aligned_smem(smem_raw);
  float* scales = reinterpret_cast<float*>(ring + kStages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(scales + kStages * kScales);
  uint64_t* empty = full + kStages;
  uint4* qsm = reinterpret_cast<uint4*>(empty + kStages);   // [8 k steps][32 lanes]
  __shared__ int sh[kThreads / 32 + 3];
  plan_scan(p, sh, blockIdx.x);
  constexpr int kW = kThreads / 32;
  if (sh[kW] < 0) return;   // past the plan's blocks
  const int b = sh[kW], first = sh[kW + 1], nb = sh[kW + 2];
  const int h = (blockIdx.x - first) / nb, split = (blockIdx.x - first) % nb;
  const int bh = b * p.kvh + h;
  const int len = clamp_len(p.seq_lens, b, p.S);
  int c0, nc;
  block_range(len, split, nb, c0, nc);
  if (nc == 0) {
    // An empty sequence (its one block) attends nothing: zeros, with STATE
    // the state (0, -1e30, 0).
    for (int i = threadIdx.x; i < G * kHD; i += kThreads) p.out[(size_t)bh * G * kHD + i] = 0.f;
    if constexpr (STATE) {
      if (threadIdx.x < G) {
        p.m_out[(size_t)bh * G + threadIdx.x] = dga::kNegInf;
        p.l_out[(size_t)bh * G + threadIdx.x] = 0.f;
      }
    }
    return;
  }
  const int pos = WRITE ? len - 1 : -1;   // the row taken from k_new .. (none: -1)
  const int t_end = min(len, (c0 + nc) * kChunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      s9::mbar_init(&full[i], 33);   // the producer's expect_tx, each lane's scale copies
      s9::mbar_init(&empty[i], kWarps);
    }
    s9::fence_barrier_init();
  }
  __syncthreads();

  // acc of rows gid (v = 0, 1) and gid + 8 (v = 2, 3), head dim
  // 16 * (2t + (v & 1)) + j; the running max and sum of both rows.
  float o[16][4];
  float m_run[2] = {dga::kNegInf, dga::kNegInf}, l_run[2] = {0.f, 0.f};
  if (warp == kWarps) {
    const float* ks = p.ks + (size_t)bh * p.S;
    const float* vs = p.vs + (size_t)bh * p.S;
    for (int j = 0; j < nc; ++j) {
      const int s = j % kStages;
      const int key0 = (c0 + j) * kChunk;
      if (lane == 0) {
        s9::mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        s9::mbar_expect_tx(&full[s], kStage);
        uint8_t* st = ring + s * kStage;
        s9::tma_load(st, &tk, &full[s], 0, key0, bh);
        s9::tma_load(st + kKV, &tv, &full[s], 0, key0, bh);
      }
      __syncwarp();
      float* ss = scales + s * kScales;
#pragma unroll
      for (int i = 0; i < kScales / 32; ++i) {
        const int idx = lane + 32 * i;
        const int key = key0 + (idx & (kChunk - 1));
        const bool in = key < p.S;
        s9::copy4_async(ss + idx, (idx < kChunk ? ks : vs) + (in ? key : 0), in);
      }
      s9::arrive_after_copies(&full[s]);
    }
  } else {
    // Q's A fragments (k step ks: slots 2t, 2t+1 hold head dims
    // 32t + 4ks + {0, 2}, slots 2t+8, 2t+9 hold 32t + 4ks + {1, 3}), built
    // once by warp 0 into shared memory, where each lane reads its own.
    if (warp == 0) {
      uint32_t w[2][16];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = gid + 8 * half;
        const uint4* src =
            reinterpret_cast<const uint4*>(p.q + ((size_t)bh * G + r) * kHD + 32 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint4 v = r < G ? src[i] : make_uint4(0u, 0u, 0u, 0u);
          w[half][4 * i] = v.x;
          w[half][4 * i + 1] = v.y;
          w[half][4 * i + 2] = v.z;
          w[half][4 * i + 3] = v.w;
        }
      }
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        qsm[ks * 32 + lane] = make_uint4(__byte_perm(w[0][2 * ks], w[0][2 * ks + 1], 0x5410),
                                         __byte_perm(w[1][2 * ks], w[1][2 * ks + 1], 0x5410),
                                         __byte_perm(w[0][2 * ks], w[0][2 * ks + 1], 0x7632),
                                         __byte_perm(w[1][2 * ks], w[1][2 * ks + 1], 0x7632));
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int v = 0; v < 4; ++v) o[jj][v] = 0.f;
    const int8_t* kn = WRITE ? p.k_new + (size_t)bh * kHD : nullptr;
    const int8_t* vn = WRITE ? p.v_new + (size_t)bh * kHD : nullptr;
    const float k_snew = WRITE ? p.ks_new[bh] : 0.f, v_snew = WRITE ? p.vs_new[bh] : 0.f;
    const float scale2 = p.scale * kLog2e;

    for (int j = 0; j < nc; ++j) {
      const int s = j % kStages;
      s9::mbar_wait(&full[s], (j / kStages) & 1);
      const int kb = (c0 + j) * kChunk + 16 * warp;   // the warp's first key
      if (kb >= t_end) {
        __syncwarp();
        if (lane == 0) s9::mbar_arrive(&empty[s]);
        continue;
      }
      const uint8_t* kt = ring + s * kStage;
      const uint8_t* vt = kt + kKV;
      const float* ss = scales + s * kScales + 16 * warp;
      // The scales of keys kb + 8nt + 2t + e (row pos: the new token's).
      float kscale[2][2], vscale[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rel = 8 * nt + 2 * t + e;
          const bool cur = WRITE && kb + rel == pos;
          kscale[nt][e] = cur ? k_snew : ss[rel];
          vscale[nt][e] = cur ? v_snew : ss[kChunk + rel];
        }
      // Scores of the warp's 16 keys (n-tile nt: keys 8nt .. 8nt + 7), in
      // the log2 domain: s * log2(e).
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int rel = 8 * nt + gid;
        uint4 k0, k1;
        if (WRITE && kb + rel == pos) {
          k0 = reinterpret_cast<const uint4*>(kn)[2 * t];
          k1 = reinterpret_cast<const uint4*>(kn)[2 * t + 1];
        } else {
          k0 = ld_tile(kt, 16 * warp + rel, 2 * t);
          k1 = ld_tile(kt, 16 * warp + rel, 2 * t + 1);
        }
        const uint32_t wk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
        // Two chains of four k steps, summed: half the dependent latency.
        float odd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int v = 0; v < 4; ++v) sc[nt][v] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 8; ks += 2) {
          const uint4 qe = qsm[ks * 32 + lane], qo = qsm[(ks + 1) * 32 + lane];
          const uint32_t ae[4] = {qe.x, qe.y, qe.z, qe.w}, ao[4] = {qo.x, qo.y, qo.z, qo.w};
          mma_bf16(sc[nt], ae, s8x2_to_bf16x2(wk[ks]), s8x2_to_bf16x2(wk[ks] >> 8));
          mma_bf16(odd, ao, s8x2_to_bf16x2(wk[ks + 1]), s8x2_to_bf16x2(wk[ks + 1] >> 8));
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) sc[nt][v] += odd[v];
      }
      // V's words (rows 2t, 2t+1, 2t+8, 2t+9 of the warp's keys, head dims
      // 16 gid .. 16 gid + 15), then the slot back to the producer.
      uint4 vw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rel = 2 * t + (i & 1) + 8 * (i >> 1);
        vw[i] = WRITE && kb + rel == pos ? reinterpret_cast<const uint4*>(vn)[gid]
                                         : ld_tile(vt, 16 * warp + rel, gid);
      }
      __syncwarp();
      if (lane == 0) s9::mbar_arrive(&empty[s]);

      // Online softmax: c[v] is row gid + 8 (v >> 1), key kb + 8nt + 2t + (v & 1).
      float mx[2] = {dga::kNegInf, dga::kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int key = kb + 8 * nt + 2 * t + (v & 1);
          sc[nt][v] = key < t_end ? sc[nt][v] * (kscale[nt][v & 1] * scale2) : dga::kNegInf;
          mx[v >> 1] = fmaxf(mx[v >> 1], sc[nt][v]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
      bool live[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m_run[hh], quad_max(mx[hh]));
        alpha[hh] = ex2(m_run[hh] - m_new);
        live[hh] = m_new > dga::kNegInf * 0.5f;
        m_run[hh] = m_new;
      }
      float wv[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int hh = v >> 1;
          const float pv = live[hh] ? ex2(sc[nt][v] - m_run[hh]) : 0.f;
          sum[hh] += pv;
          const int key = kb + 8 * nt + 2 * t + (v & 1);
          wv[nt][v] = key < t_end ? dga::round_bf16(pv * vscale[nt][v & 1]) : 0.f;
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + quad_sum(sum[hh]);
      const uint32_t wa[4] = {pack_bf16x2(wv[0][0], wv[0][1]), pack_bf16x2(wv[0][2], wv[0][3]),
                              pack_bf16x2(wv[1][0], wv[1][1]), pack_bf16x2(wv[1][2], wv[1][3])};
      // acc *= alpha, skipped where no row's max moved (most chunks).
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          o[jj][0] *= alpha[0];
          o[jj][1] *= alpha[0];
          o[jj][2] *= alpha[1];
          o[jj][3] *= alpha[1];
        }
      }
      // PV: n-tile jj, column gid is head dim 16 gid + jj.
      const uint32_t* x0 = reinterpret_cast<const uint32_t*>(&vw[0]);
      const uint32_t* x1 = reinterpret_cast<const uint32_t*>(&vw[1]);
      const uint32_t* x2 = reinterpret_cast<const uint32_t*>(&vw[2]);
      const uint32_t* x3 = reinterpret_cast<const uint32_t*>(&vw[3]);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const uint32_t sel = (jj & 3) | ((4 + (jj & 3)) << 8);
        mma_bf16(o[jj], wa, s8x2_to_bf16x2(__byte_perm(x0[jj >> 2], x1[jj >> 2], sel)),
                 s8x2_to_bf16x2(__byte_perm(x2[jj >> 2], x3[jj >> 2], sel)));
      }
    }
  }

  // Every stage has been read: the ring takes the warps' states
  // [warp][16 rows][acc (kHD), m, l], which thread d then merges for
  // column d of each query row.
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  if (warp < kWarps) {
    float* mine = red + warp * 16 * (kHD + 2);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        mine[(gid + 8 * (v >> 1)) * (kHD + 2) + 16 * (2 * t + (v & 1)) + jj] = o[jj][v];
    if (t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mine[(gid + 8 * hh) * (kHD + 2) + kHD] = m_run[hh];
        mine[(gid + 8 * hh) * (kHD + 2) + kHD + 1] = l_run[hh];
      }
    }
  }
  __syncthreads();
  // A (batch, kv head) with this one block: its state is the whole.
  const bool alone = nb == 1;
  if (threadIdx.x < kHD) {
    const int d = threadIdx.x;
    float* out = p.part + (size_t)blockIdx.x * G * (kHD + 2);
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float mm = dga::kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red[(w * 16 + r) * (kHD + 2) + kHD]);
      float a = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* st = red + (w * 16 + r) * (kHD + 2);
        const float e = ex2(st[kHD] - mm);
        a += st[d] * e;
        l += st[kHD + 1] * e;
      }
      if (alone) {
        write_row<STATE>(p, (size_t)bh * G + r, d, a, mm, l);
        continue;
      }
      out[r * (kHD + 2) + d] = a;
      if (d == 0) {
        out[r * (kHD + 2) + kHD] = mm;
        out[r * (kHD + 2) + kHD + 1] = l;
      }
    }
  }
  if (alone) {
    if constexpr (WRITE) write_new_row(p, bh, len);
    return;
  }

  // Arrive; the last block of this (batch, kv head) goes on.
  __shared__ int last;
  const int n_live = nb;   // every block of a non-empty sequence holds keys
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&p.arrivals[bh], 1) == n_live - 1;
    if (last) p.arrivals[bh] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The merge, all threads at once: the blocks' (m, l) into shared
  // memory, each row's max M and sum L, each block's weight e^(m - M),
  // then out[r][d] = sum_s acc_s[r][d] * w_s / L over the blocks in order.
  const float* base = p.part + ((size_t)first + (size_t)h * nb) * G * (kHD + 2);
  float* sm = red;                        // [n_live * G]
  float* sl = sm + kMaxSplits * G;        // [n_live * G]
  float* srow = sl + kMaxSplits * G;      // M then L, [G] each
  for (int i = threadIdx.x; i < n_live * G; i += kThreads) {
    sm[i] = __ldcg(base + i * (kHD + 2) + kHD);
    sl[i] = __ldcg(base + i * (kHD + 2) + kHD + 1);
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int r = threadIdx.x;
    float mm = dga::kNegInf;
    for (int s = 0; s < n_live; ++s) mm = fmaxf(mm, sm[s * G + r]);
    float l = 0.f;
    for (int s = 0; s < n_live; ++s) l += sl[s * G + r] * ex2(sm[s * G + r] - mm);
    srow[r] = mm;
    srow[G + r] = l;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_live * G; i += kThreads) sm[i] = ex2(sm[i] - srow[i % G]);
  __syncthreads();
  for (int i = threadIdx.x; i < G * kHD; i += kThreads) {
    const int r = i / kHD, d = i % kHD;
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) a += __ldcg(base + (s * G + r) * (kHD + 2) + d) * sm[s * G + r];
    write_row<STATE>(p, (size_t)bh * G + r, d, a, srow[r], srow[G + r]);
  }
  if constexpr (WRITE) write_new_row(p, bh, len);
}

}  // namespace live

struct Args {
  const void* q;
  void *kq, *ks, *vq, *vs;
  const void *k_new, *v_new, *ks_new, *vs_new, *seq_lens;
  void *part, *out, *m, *l;
  int b, kvh, S, split_len;
  float scale;
};

template <int G, bool WRITE, bool STATE, int HD>
void launch(const Args& a, cudaStream_t stream) {
  const int n_split = (a.S + a.split_len - 1) / a.split_len;
  flash_decode_span_kernel<G, WRITE, HD><<<dim3(a.kvh, a.b, n_split), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<int8_t*>(a.kq),
      static_cast<float*>(a.ks), static_cast<int8_t*>(a.vq), static_cast<float*>(a.vs),
      static_cast<const int8_t*>(a.k_new), static_cast<const int8_t*>(a.v_new),
      static_cast<const float*>(a.ks_new), static_cast<const float*>(a.vs_new),
      static_cast<const int*>(a.seq_lens), static_cast<float*>(a.part), a.kvh, a.S,
      a.split_len, a.scale);
  flash_decode_merge_kernel<G, STATE, HD><<<dim3(a.kvh, a.b), kThreads, 0, stream>>>(
      static_cast<const float*>(a.part), static_cast<float*>(a.out),
      static_cast<float*>(a.m), static_cast<float*>(a.l), n_split);
}

// Route "live" (K2: WRITE; K5a; K5b: STATE): maps of the K and V caches
// ((b * kvh) x S rows of kHD bytes, boxes of kChunk rows), then the
// launch.
template <int G, bool WRITE, bool STATE>
int launch_live(const Args& a, int blocks, void* arrivals, cudaStream_t s) {
  namespace s9 = dga::sm90;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t heads = (uint64_t)a.b * a.kvh;
  CUtensorMap tk, tv;
  int rc = s9::make_map(&tk, u8, 1, a.kq, kHD, a.S, heads, kHD, (uint64_t)a.S * kHD, kHD,
                        live::kChunk, sw);
  if (rc) return rc;
  rc = s9::make_map(&tv, u8, 1, a.vq, kHD, a.S, heads, kHD, (uint64_t)a.S * kHD, kHD,
                    live::kChunk, sw);
  if (rc) return rc;
  const live::Args p{static_cast<const __nv_bfloat16*>(a.q), static_cast<int8_t*>(a.kq),
                     static_cast<float*>(a.ks), static_cast<int8_t*>(a.vq),
                     static_cast<float*>(a.vs), static_cast<const int8_t*>(a.k_new),
                     static_cast<const int8_t*>(a.v_new), static_cast<const float*>(a.ks_new),
                     static_cast<const float*>(a.vs_new), static_cast<const int*>(a.seq_lens),
                     static_cast<float*>(a.part), static_cast<float*>(a.out),
                     static_cast<int*>(arrivals), a.b, a.kvh, a.S, blocks, a.scale,
                     static_cast<float*>(a.m), static_cast<float*>(a.l)};
  return s9::launch<live::live_kernel<G, WRITE, STATE>>(dim3(blocks), live::kThreads, live::kSmem,
                                                        s, tk, tv, p);
}

template <bool WRITE, bool STATE>
int dispatch_live(const Args& a, int g, int hd, int blocks, void* arrivals, void* stream) {
  if (hd != kHD || a.b <= 0 || a.b > 65535 || a.kvh <= 0 || a.kvh > 65535 || a.S <= 0 ||
      blocks <= (long long)a.b * a.kvh || !arrivals || (STATE && (!a.m || !a.l)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1: return launch_live<1, WRITE, STATE>(a, blocks, arrivals, s);
    case 2: return launch_live<2, WRITE, STATE>(a, blocks, arrivals, s);
    case 4: return launch_live<4, WRITE, STATE>(a, blocks, arrivals, s);
    case 8: return launch_live<8, WRITE, STATE>(a, blocks, arrivals, s);
    case 16: return launch_live<16, WRITE, STATE>(a, blocks, arrivals, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool WRITE, bool STATE, int HD>
int dispatch_group(const Args& a, int g, cudaStream_t s) {
  switch (g) {
    case 1: launch<1, WRITE, STATE, HD>(a, s); break;
    case 2: launch<2, WRITE, STATE, HD>(a, s); break;
    case 4: launch<4, WRITE, STATE, HD>(a, s); break;
    case 8: launch<8, WRITE, STATE, HD>(a, s); break;
    case 16: launch<16, WRITE, STATE, HD>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Route "span", for head sizes 64 and 128.
template <bool WRITE, bool STATE>
int dispatch(const Args& a, int g, int hd, void* stream) {
  if (a.b <= 0 || a.kvh <= 0 || a.S <= 0 || a.split_len <= 0 || a.split_len % kChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128) return dispatch_group<WRITE, STATE, 128>(a, g, s);
  if (hd == 64) return dispatch_group<WRITE, STATE, 64>(a, g, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every entry takes a route: 0, "span", where `split` is the span's keys
// and part holds b * kvh * ceil(S / split) * g * (hd + 2) floats; or 1,
// "live" (head size 128), where `split` is the grid's blocks (more than
// b * kvh), part holds split * g * (hd + 2) floats, `arrivals` b * kvh ints
// that are zero, that the launch leaves zero and that no launch running
// beside it uses (the wrappers keep one buffer per stream), and the caches
// must be 16-byte aligned (TMA; the map refuses a cache that is not).
// K2: out (b, kvh, g, hd) f32; writes the new rows into the caches; on
// route "live" k_new / v_new must be 16-byte aligned too (16-byte loads).
extern "C" int dga_flash_decode_inplace(
    const void* q, void* kq, void* ks, void* vq, void* vs, const void* k_new,
    const void* v_new, const void* ks_new, const void* vs_new,
    const void* seq_lens, void* part, void* out, void* arrivals, int b, int kvh,
    int g, int S, int hd, int route, int split, float scale, void* stream) {
  const Args a{q, kq, ks, vq, vs, k_new, v_new, ks_new, vs_new, seq_lens,
               part, out, nullptr, nullptr, b, kvh, S, split, scale};
  if (route == 1) return dispatch_live<true, false>(a, g, hd, split, arrivals, stream);
  if (route != 0) return (int)cudaErrorInvalidValue;
  return dispatch<true, false>(a, g, hd, stream);
}

// K5a: out (b, kvh, g, hd) f32; the caches are only read.
extern "C" int dga_flash_decode_read(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* seq_lens, void* part, void* out, void* arrivals, int b, int kvh, int g, int S,
    int hd, int route, int split, float scale, void* stream) {
  const Args a{q, const_cast<void*>(kq), const_cast<void*>(ks), const_cast<void*>(vq),
               const_cast<void*>(vs), nullptr, nullptr, nullptr, nullptr, seq_lens,
               part, out, nullptr, nullptr, b, kvh, S, split, scale};
  if (route == 1) return dispatch_live<false, false>(a, g, hd, split, arrivals, stream);
  if (route != 0) return (int)cudaErrorInvalidValue;
  return dispatch<false, false>(a, g, hd, stream);
}

// K5b: acc (b, kvh, g, hd), m and l (b, kvh, g), all f32; read only.
extern "C" int dga_flash_decode_state(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* seq_lens, void* part, void* acc, void* m, void* l, void* arrivals, int b,
    int kvh, int g, int S, int hd, int route, int split, float scale, void* stream) {
  const Args a{q, const_cast<void*>(kq), const_cast<void*>(ks), const_cast<void*>(vq),
               const_cast<void*>(vs), nullptr, nullptr, nullptr, nullptr, seq_lens,
               part, acc, m, l, b, kvh, S, split, scale};
  if (route == 1) return dispatch_live<false, true>(a, g, hd, split, arrivals, stream);
  if (route != 0) return (int)cudaErrorInvalidValue;
  return dispatch<false, true>(a, g, hd, stream);
}
