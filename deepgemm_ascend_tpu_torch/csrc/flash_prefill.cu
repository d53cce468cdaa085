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
// Design (head size 128; at head size 64 the kernel of namespace cores
// below takes over). A block takes kRows = 16 x kWarps (192) query rows of one (batch, kv
// head): BQ = kRows / G consecutive positions of all G heads of the group
// (the TPU kernel's g*bq collapse), row r = gi * BQ + qi holding head gi at
// position q0 + qi, so each K/V chunk is loaded and converted once for the
// whole group. It needs the keys [0, min(seq_len, last position + 1)), in
// chunks of 64; a block whose rows see no key loads nothing and writes the
// empty state. Per chunk:
//   * warp 0 keeps kStages int8 chunks in flight by TMA (boxes of 64 K rows
//     and 64 V rows, 128-byte swizzle, from 3-D maps with batch = (batch,
//     kv head)); its lanes copy the chunk's k and v scales beside them by
//     cp.async;
//   * every thread converts its share of the chunk exactly to bf16
//     (s8x2_to_bf16x2: every int8 value is exact in bf16) into one of two
//     bf16 buffers, laid out as wgmma reads them: per 64 head dims a panel
//     of 64 keys x 128 bytes, 128-byte swizzled. Converting once per block
//     and not once per warp is what the tensor cores need: converted in
//     each warp's registers for mma.sync, the conversions took most of the
//     time (PERF.md);
//   * each warpgroup (64 rows) runs both products on wgmma, bf16 with f32
//     sums, the reference's arithmetic (JAX casts the int8 K and V to bf16
//     and runs bf16 dots into f32): each product is exact and only the
//     order of the f32 sums differs from the plain version.
//       scores  S (64 rows x 64 keys) = Q . K^T, m64n64k16: Q and K both
//               K-major from shared memory (Q staged once per block, as
//               the buffers are laid out);
//       softmax per row over the chunk, in the log2 domain (s * log2 e, so
//               e^(s - m) is one ex2), in the registers that hold the
//               scores: scaled by (k_s * 1/sqrt(hd)) * log2 e, the row's
//               max across the four threads that hold it (two shuffles),
//               p = e^(s - m), l += p unrounded, and w = bf16(p * v_s)
//               against that running max (the rounding point of
//               flash_common.cuh). Keys past a row's position or the length
//               are masked only in a chunk that crosses the warp's first
//               position or the length; masked keys give w = 0; acc is
//               rescaled only where a row's max moved;
//       PV      acc (64 rows x 128) += W . V, m64n128k16: the score
//               registers, rounded, are W's A fragments as they stand; V
//               MN-major from the buffer (the transpose bit). It runs on
//               while the next chunk is converted.
//     Each warp owns 16 rows across every key, so it keeps their whole
//     online softmax in registers and writes them itself: no merge.
//   * q is read and out (and m, l) written in the public layouts (b, s,
//     heads, hd) and (b, s, heads): no permute before or after.
//   * Heaviest blocks first: grid block i takes q block nq - 1 - i / (b *
//     kvh) of (batch, kv head) i % (b * kvh), so that the blocks with the
//     most keys (the last positions, at equal starts) start first and the
//     short ones fill the tail (ops/flash_prefill.py: block_order).
//
// Bound on the card: tensor-core work at long prompts, cache bytes at short
// ones; what holds it back is the instructions of each chunk (conversion
// and softmax) and their serial chain (conversion, barrier, scores,
// softmax) with one block an SM (PERF.md). DGA_K4_WARPS (12: 192 rows, as
// built; 8: 128 rows, or 4: 64), DGA_K4_STAGES and DGA_K4_HEAVY_FIRST
// exist for scripts/prefill_sweep.py, which builds the variants; the
// package builds the defaults.
#include <climits>

#include "flash_common.cuh"
#include "sm90_gemm.cuh"

#ifndef DGA_K4_WARPS
#define DGA_K4_WARPS 12
#endif
#ifndef DGA_K4_STAGES
#define DGA_K4_STAGES 2
#endif
#ifndef DGA_K4_HEAVY_FIRST
#define DGA_K4_HEAVY_FIRST 1
#endif

namespace {

namespace s9 = dga::sm90;
using dga::ex2;
using dga::ld_tile;
using dga::pack_bf16x2;
using dga::quad_max;
using dga::quad_sum;
using dga::s8x2_to_bf16x2;

constexpr int kHD = 128;
constexpr int kWarps = DGA_K4_WARPS;        // warps, 16 query rows each
constexpr int kRows = 16 * kWarps;          // query rows a block: G heads x BQ positions
constexpr int kStages = DGA_K4_STAGES;      // int8 chunks in flight
constexpr int kChunk = 64;                  // keys a stage
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = kWarps <= 4 ? 2 : 1;   // blocks an SM the registers are cut for
constexpr int kKV = kChunk * kHD;           // bytes of int8 K (and of V) a stage
constexpr int kStage = 2 * kKV;
constexpr int kScales = 2 * kChunk;         // a chunk's k scales, then its v scales
constexpr int kWideKV = kChunk * kHD * 2;  // bytes of bf16 K (and of V) a buffer
constexpr int kWide = 2 * kWideKV;
constexpr int kWGQ = 64 * kHD * 2;          // bytes of a warpgroup's Q
constexpr int kSmem = kRows / 64 * kWGQ + kStages * kStage + 2 * kWide +
                      (kStages + 2) * kScales * 4 + kStages * 8 + 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kWarps % 4 == 0 && kWarps <= 12, "64, 128 or 192 rows a block");
static_assert(kStages >= 1 && kStages <= 6, "");

using s9::fence_acc;
using s9::kPanel;

// d (64 x 128, the warpgroup's) += A . B: A (64 x 16) from registers, each
// warp's 16 rows as mma.sync's A fragment; B (16 x 128) MN-major from
// shared memory at descriptor db.
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DGA_WGMMA_REGS_N128
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
               : DGA_WGMMA_OUTS_N128("f")
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

struct Params {
  const __nv_bfloat16* q;   // (b, s, heads, hd)
  const float* ks;          // (b, kvh, S)
  const float* vs;
  const int* start;         // (b,)
  const int* seq_lens;      // (b,)
  float* out;               // (b, s, heads, hd)
  float* m;                 // (b, s, heads), STATS only
  float* l;
  int b, kvh, s, S;
  float scale;
};

template <int G, bool STATS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_prefill_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, Params p) {
  constexpr int BQ = kRows / G;
  extern __shared__ uint8_t smem_raw[];
  const int heads = p.kvh * G;
  const int pairs = p.b * p.kvh;
  const int nq = (p.s + BQ - 1) / BQ;
  const int rank = blockIdx.x / pairs;
  const int bh = blockIdx.x % pairs;
  const int qb = DGA_K4_HEAVY_FIRST ? nq - 1 - rank : rank;
  const int b = bh / p.kvh, h = bh % p.kvh;
  const int q0 = qb * BQ;
  const int st = p.start[b];
  const int limit = min(max(p.seq_lens[b], 0), p.S);
  // The block's keys: [0, kv_end), kv_end = min(limit, last position + 1).
  const long long q_hi = (long long)st + min(q0 + BQ, p.s) - 1;
  const int kv_end = (int)max(0ll, min((long long)limit, q_hi + 1));
  const int nc = (kv_end + kChunk - 1) / kChunk;

  if (nc == 0) {
    // No row of the block sees a key: the empty state (acc or out 0, m
    // -1e30, l 0) for every row that exists.
    for (int i = threadIdx.x; i < kRows * (kHD / 4); i += kThreads) {
      const int r = i / (kHD / 4), c = i % (kHD / 4);
      const int qpos = q0 + r % BQ;
      if (qpos >= p.s) continue;
      const size_t row = ((size_t)b * p.s + qpos) * heads + h * G + r / BQ;
      reinterpret_cast<float4*>(p.out + row * kHD)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (STATS && c == 0) {
        p.m[row] = dga::kNegInf;
        p.l[row] = 0.f;
      }
    }
    return;
  }

  uint8_t* qs = s9::aligned_smem(smem_raw);                    // Q, bf16
  uint8_t* ring = qs + kRows / 64 * kWGQ;                      // int8 stages
  uint8_t* wide = ring + kStages * kStage;                     // the 2 bf16 buffers
  float* scales = reinterpret_cast<float*>(wide + 2 * kWide);  // [stage][k, v]
  float* wscales = scales + kStages * kScales;                 // [buffer][k, v]
  uint64_t* full = reinterpret_cast<uint64_t*>(wscales + 2 * kScales);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i)
      s9::mbar_init(&full[i], 33);   // warp 0's expect_tx, each lane's scale copies
    s9::fence_barrier_init();
  }
  __syncthreads();

  // Chunk j into int8 stage j % kStages, by warp 0: lane 0's two TMA boxes,
  // every lane's share of the scales by cp.async.
  const float* ks_g = p.ks + (size_t)bh * p.S;
  const float* vs_g = p.vs + (size_t)bh * p.S;
  auto load = [&](int j) {
    const int s = j % kStages;
    const int key0 = j * kChunk;
    if (lane == 0) {
      s9::mbar_expect_tx(&full[s], kStage);
      uint8_t* stg = ring + s * kStage;
      s9::tma_load(stg, &tk, &full[s], 0, key0, bh);
      s9::tma_load(stg + kKV, &tv, &full[s], 0, key0, bh);
    }
    __syncwarp();
    float* ss = scales + s * kScales;
#pragma unroll
    for (int i = 0; i < kScales / 32; ++i) {
      const int idx = lane + 32 * i;
      const int key = key0 + (idx & (kChunk - 1));
      const bool in = key < p.S;
      s9::copy4_async(ss + idx, (idx < kChunk ? ks_g : vs_g) + (in ? key : 0), in);
    }
    s9::arrive_after_copies(&full[s]);
  };
  if (warp == 0)
    for (int j = 0; j < min(nc, kStages); ++j) load(j);

  // This thread's two rows, r = 16 warp + gid + 8 hh: their position, and
  // their row in (b, s, heads) where they exist (qpos < s).
  int pos[2];
  bool valid[2];
  size_t row[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + gid + 8 * hh;
    const int qpos = q0 + r % BQ;
    valid[hh] = qpos < p.s;
    pos[hh] = st + qpos;
    row[hh] = ((size_t)b * p.s + min(qpos, p.s - 1)) * heads + h * G + r / BQ;
  }
  // The warp's first position among its rows that exist.
  const int lo = __reduce_min_sync(0xffffffffu, min(valid[0] ? pos[0] : INT_MAX,
                                                    valid[1] ? pos[1] : INT_MAX));
  // The last key each row sees.
  const int kmax[2] = {min(pos[0], limit - 1), min(pos[1], limit - 1)};

  // Q into shared memory as wgmma reads A: per warpgroup two 64-dim
  // panels of its 64 rows x 128 bytes, 128-byte swizzled; zeros for rows
  // that do not exist. Made visible to wgmma by the first chunk's fence and
  // barrier.
  for (int i = threadIdx.x; i < kRows * 16; i += kThreads) {
    const int r = i >> 4, c16 = i & 15, rr = r & 63;
    const int qpos = q0 + r % BQ;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (qpos < p.s)
      v = reinterpret_cast<const uint4*>(
          p.q + (((size_t)b * p.s + qpos) * heads + h * G + r / BQ) * kHD)[c16];
    *reinterpret_cast<uint4*>(qs + (r >> 6) * kWGQ + (c16 >> 3) * kPanel + rr * 128 +
                              (((c16 & 7) ^ (rr & 7)) << 4)) = v;
  }
  const uint32_t qaddr = s9::smem_u32(qs + (warp >> 2) * kWGQ);

  // acc of rows gid (v = 0, 1) and gid + 8 (v = 2, 3), head dims
  // 8jj + 2t + (v & 1), at o[4jj + v] (wgmma's accumulator layout); the
  // running max (log2 domain) and sum.
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_run[2] = {dga::kNegInf, dga::kNegInf}, l_run[2] = {0.f, 0.f};

  // This thread's share of a chunk's conversion: 16-byte int8 chunk c of
  // key r of K or V, from its swizzled place in the stage to head dims
  // 16c .. 16c + 15 of the bf16 buffer (panel c / 4, chunks 2 (c % 4) and
  // + 1, at c ^ (r & 7)).
  constexpr int kAll = 2 * kChunk * 8;   // 2 tensors x 64 keys x 8 chunks
  constexpr int kItems = (kAll + kThreads - 1) / kThreads;
  int src_off[kItems], dst_off[kItems][2];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = min(threadIdx.x + kThreads * i, kAll - 1);
    const int tv_ = idx >> 9, r = (idx >> 3) & (kChunk - 1), c = idx & 7;
    src_off[i] = tv_ * kKV + r * dga::kTileRow + ((c ^ (r & 7)) << 4);
    const int row = tv_ * kWideKV + (c >> 2) * kPanel + r * 128, cc = 2 * (c & 3);
    dst_off[i][0] = row + ((cc ^ (r & 7)) << 4);
    dst_off[i][1] = row + (((cc + 1) ^ (r & 7)) << 4);
  }

  for (int j = 0; j < nc; ++j) {
    const int s = j % kStages, buf = j & 1;
    const int key0 = j * kChunk;
    s9::mbar_wait(&full[s], (j / kStages) & 1);
    // The chunk's K and V into bf16 buffer buf, a share by every thread,
    // while chunk j - 1's PV product may still run: each as two 64-dim
    // panels of 64 keys x 128 bytes, 16-byte chunk c of key r at c ^ (r & 7)
    // (the 128-byte swizzle wgmma reads), with their scales.
    {
      const uint8_t* src = ring + s * kStage;
      uint8_t* dst = wide + buf * kWide;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (kAll % kThreads && threadIdx.x + kThreads * i >= kAll) break;
        const uint4 w = *reinterpret_cast<const uint4*>(src + src_off[i]);
        const uint32_t x[4] = {w.x, w.y, w.z, w.w};
        uint32_t y[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          y[2 * u] = s8x2_to_bf16x2(__byte_perm(x[u], 0u, 0x0100));
          y[2 * u + 1] = s8x2_to_bf16x2(__byte_perm(x[u], 0u, 0x0302));
        }
        *reinterpret_cast<uint4*>(dst + dst_off[i][0]) = make_uint4(y[0], y[1], y[2], y[3]);
        *reinterpret_cast<uint4*>(dst + dst_off[i][1]) = make_uint4(y[4], y[5], y[6], y[7]);
      }
      // The k scales times 1/sqrt(hd), then log2 e, once a key.
      if (threadIdx.x < kScales) {
        const float x = scales[s * kScales + threadIdx.x];
        wscales[buf * kScales + threadIdx.x] = threadIdx.x < kChunk ? (x * p.scale) * kLog2e : x;
      }
    }
    // Chunk j - 1's PV product done (it read buffer buf ^ 1; buffer buf's
    // last reader, chunk j - 2, finished before the barrier of j - 1), the
    // stores made visible to wgmma; then every thread has converted its
    // share: the int8 stage takes chunk j + kStages.
    s9::wgmma_wait<0>();
    fence_acc(o);
    s9::fence_proxy_async();
    __syncthreads();
    if (warp == 0 && j + kStages < nc) load(j + kStages);
    const uint32_t kaddr = s9::smem_u32(wide + buf * kWide);
    const uint32_t vaddr = kaddr + kWideKV;
    const float* ss = wscales + buf * kScales;
    // Scores S (the warpgroup's 64 rows x 64 keys) = Q . K^T on wgmma, Q
    // from registers; sc[4nt + v] is row gid + 8 (v >> 1), key
    // key0 + 8nt + 2t + (v & 1).
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_acc(sc);
    s9::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      s9::wgmma<__nv_bfloat16, 64, 0, 0>(sc, s9::desc(qaddr + (ks >> 2) * kPanel + (ks & 3) * 32, 16),
                                         s9::desc(kaddr + (ks >> 2) * kPanel + (ks & 3) * 32, 16));
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    fence_acc(sc);
    // Scale (k_s * 1/sqrt(hd), then log2 e); mask where the chunk crosses
    // the warp's first position or the length (key past kmax); each row's
    // max.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 kk = *reinterpret_cast<const float2*>(ss + 8 * nt + 2 * t);
      const float f[2] = {kk.x, kk.y};
#pragma unroll
      for (int v = 0; v < 4; ++v) sc[4 * nt + v] *= f[v & 1];
    }
    const bool edge = key0 + kChunk - 1 > lo || key0 + kChunk > limit;
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (key0 + 8 * nt + 2 * t + (v & 1) > kmax[v >> 1]) sc[4 * nt + v] = dga::kNegInf;
    }
    float mx[2] = {dga::kNegInf, dga::kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    // m_use: the row's max, or 0 while it has seen no key (its scores are
    // all -1e30 then, so p = 0: the empty-row guard).
    float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m_run[hh], quad_max(mx[hh]));
      alpha[hh] = ex2(m_run[hh] - m_new);
      m_use[hh] = m_new > dga::kNegInf * 0.5f ? m_new : 0.f;
      m_run[hh] = m_new;
    }
    // p, and P's A fragments for the four 16-key steps of the PV product.
    uint32_t wa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 vv = *reinterpret_cast<const float2*>(ss + kChunk + 8 * nt + 2 * t);
      float w4[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int hh = v >> 1;
        const float pv = ex2(sc[4 * nt + v] - m_use[hh]);
        sum[hh] += pv;
        w4[v] = pv * ((v & 1) ? vv.y : vv.x);
      }
      if (edge) {
        // Masked keys: w = 0 (their v scale may be anything).
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (key0 + 8 * nt + 2 * t + (v & 1) > kmax[v >> 1]) w4[v] = 0.f;
      }
      wa[nt >> 1][(nt & 1) * 2] = pack_bf16x2(w4[0], w4[1]);
      wa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(w4[2], w4[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + quad_sum(sum[hh]);
    // acc *= alpha, skipped where no row's max moved.
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
    // PV on wgmma, 16 keys a step: acc (64 rows x 128) += P . V, P from
    // registers, V MN-major (its two 64-dim panels one kPanel apart). Left
    // running: the next chunk's conversion overlaps it.
    fence_acc(o);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv(o, wa[kk], s9::desc(vaddr + kk * 16 * 128, kPanel));
    s9::wgmma_commit();
    fence_acc(o);
  }
  s9::wgmma_wait<0>();
  fence_acc(o);

  // Each thread writes head dims 8jj + 2t, +1 of its rows that exist.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!valid[hh]) continue;
    const float l = l_run[hh];
    float* dst = p.out + row[hh] * kHD + 2 * t;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      float2 x = make_float2(o[4 * jj + 2 * hh], o[4 * jj + 2 * hh + 1]);
      if (!STATS) {
        x.x = dga::finalize(x.x, l);
        x.y = dga::finalize(x.y, l);
      }
      *reinterpret_cast<float2*>(dst + 8 * jj) = x;
    }
    if (STATS && t == 0) {
      p.m[row[hh]] = l > 0.f ? m_run[hh] * kLn2 : dga::kNegInf;
      p.l[row[hh]] = l;
    }
  }
}

// ------------------------------------------------ head size 64: CUDA cores
//
// K4 and K4-stats at head size 64, which the wgmma kernel above is not
// built for: the decode kernels' route "span" (flash_decode.cu) applied to
// a q block. A block of 128 threads takes kRows = 16 query rows of one
// (batch, kv head), the G heads at 16 / G positions (row r = gi * BQ + qi,
// as above), and walks their keys [0, kv_end) in chunks of 128, twice:
// thread j scores key j against the 16 rows (NEG_INF past a row's
// position), and one warp a row takes the chunk's max (first pass), then
// runs the softmax against the row's final max (second pass:
// flash_common.cuh's softmax_row_step with alpha 1), so that w =
// bf16(p * v_s) is rounded where the plain version rounds it; thread
// (d, part) accumulates head dim d of the part-th group of 16 / (128 /
// HD) rows, reading V a byte a thread. Nothing overlaps loads with math:
// the route covers the geometry; it is not tuned.
namespace cores {

constexpr int kThreads = 128;
constexpr int kRows = 16;
constexpr int kChunk = 128;   // keys a step; one a thread when scoring

struct Params {
  const __nv_bfloat16* q;   // (b, s, heads, hd)
  const int8_t* kq;         // (b, kvh, S, hd)
  const float* ks;          // (b, kvh, S)
  const int8_t* vq;
  const float* vs;
  const int* start;         // (b,)
  const int* seq_lens;      // (b,)
  float* out;               // (b, s, heads, hd)
  float* m;                 // (b, s, heads), STATS only
  float* l;
  int b, kvh, s, S;
  float scale;
};

template <int G, int HD, bool STATS>
__global__ void __launch_bounds__(kThreads) prefill_kernel(Params p) {
  static_assert(HD % 16 == 0 && kThreads % HD == 0 && kRows % (kThreads / HD) == 0, "");
  constexpr int BQ = kRows / G;
  constexpr int kMine = kRows / (kThreads / HD);   // rows a thread accumulates
  __shared__ float sq[kRows][HD];
  __shared__ float sp[kRows][kChunk + 1];
  __shared__ float svs[kChunk];
  __shared__ float sm[kRows], sl[kRows];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int heads = p.kvh * G;
  const int pairs = p.b * p.kvh;
  const int bh = blockIdx.x % pairs;
  const int b = bh / p.kvh, h = bh % p.kvh;
  const int q0 = (blockIdx.x / pairs) * BQ;
  const int st = p.start[b];
  const int limit = min(max(p.seq_lens[b], 0), p.S);
  // The block's keys: [0, kv_end), kv_end = min(limit, last position + 1).
  const long long q_hi = (long long)st + min(q0 + BQ, p.s) - 1;
  const int kv_end = (int)max(0ll, min((long long)limit, q_hi + 1));

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, qpos = q0 + r % BQ;
    sq[r][i % HD] = qpos < p.s ? __bfloat162float(
        p.q[(((size_t)b * p.s + qpos) * heads + h * G + r / BQ) * HD + i % HD]) : 0.f;
  }
  if (tid < kRows) {
    sm[tid] = dga::kNegInf;
    sl[tid] = 0.f;
  }
  const int d = tid % HD, r0 = (tid / HD) * kMine;
  float acc[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) acc[i] = 0.f;
  __syncthreads();

  const int8_t* kc = p.kq + (size_t)bh * p.S * HD;
  const int8_t* vc = p.vq + (size_t)bh * p.S * HD;
  const float* ks = p.ks + (size_t)bh * p.S;
  const float* vs = p.vs + (size_t)bh * p.S;
  // The chunk from key t0 into sp (scores, NEG_INF where masked) and svs.
  auto score = [&](int t0) {
    const int t = t0 + tid;
    if (t < kv_end) {
      float sc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
#pragma unroll 2
      for (int c = 0; c < HD; c += 16) {
        const int4 w = *reinterpret_cast<const int4*>(kc + (size_t)t * HD + c);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const float kv = static_cast<float>(kb[u]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) sc[r] = fmaf(sq[r][c + u], kv, sc[r]);
        }
      }
      const float f = ks[t] * p.scale;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int qpos = q0 + r % BQ;
        sp[r][tid] = (qpos < p.s && t <= st + qpos) ? sc[r] * f : dga::kNegInf;
      }
      svs[tid] = vs[t];
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) sp[r][tid] = dga::kNegInf;
      svs[tid] = 0.f;
    }
  };

  // First pass: each row's max over its keys.
  for (int t0 = 0; t0 < kv_end; t0 += kChunk) {
    score(t0);
    __syncthreads();
    const int n = min(kChunk, kv_end - t0);
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float mx = dga::kNegInf;
      for (int j = tid & 31; j < n; j += 32) mx = fmaxf(mx, sp[r][j]);
      mx = dga::warp_max(mx);
      if ((tid & 31) == 0) sm[r] = fmaxf(sm[r], mx);
    }
    __syncthreads();
  }

  // Second pass: p = e^(s - max), l, and acc += bf16(p * v_s) * v.
  for (int t0 = 0; t0 < kv_end; t0 += kChunk) {
    score(t0);
    __syncthreads();
    const int n = min(kChunk, kv_end - t0);
    for (int r = warp; r < kRows; r += kThreads / 32)
      dga::softmax_row_step(sp[r], svs, n, &sm[r], &sl[r]);   // alpha 1
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float v = static_cast<float>(vc[(size_t)(t0 + j) * HD + d]);
#pragma unroll
      for (int i = 0; i < kMine; ++i) acc[i] = fmaf(sp[r0 + i][j], v, acc[i]);
    }
    __syncthreads();
  }

  // A row with no key keeps (acc 0, m -1e30, l 0): out 0.
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int r = r0 + i, qpos = q0 + r % BQ;
    if (qpos >= p.s) continue;
    const size_t row = ((size_t)b * p.s + qpos) * heads + h * G + r / BQ;
    p.out[row * HD + d] = STATS ? acc[i] : dga::finalize(acc[i], sl[r]);
    if (STATS && d == 0) {
      p.m[row] = sm[r];
      p.l[row] = sl[r];
    }
  }
}

}  // namespace cores

struct Args {
  const void *q, *kq, *ks, *vq, *vs, *start, *seq_lens;
  void *out, *m, *l;
  int b, kvh, s, S;
  float scale;
};

// Maps of the K and V caches ((b * kvh) x S rows of kHD bytes, boxes of
// kChunk rows), then the launch on nq * b * kvh blocks.
template <int G, bool STATS>
int launch(const Args& a, cudaStream_t stream) {
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t pairs = (uint64_t)a.b * a.kvh;
  CUtensorMap tk, tv;
  int rc = s9::make_map(&tk, u8, 1, a.kq, kHD, a.S, pairs, kHD, (uint64_t)a.S * kHD, kHD,
                        kChunk, sw);
  if (rc) return rc;
  rc = s9::make_map(&tv, u8, 1, a.vq, kHD, a.S, pairs, kHD, (uint64_t)a.S * kHD, kHD, kChunk,
                    sw);
  if (rc) return rc;
  constexpr int BQ = kRows / G;
  const long long blocks = (long long)((a.s + BQ - 1) / BQ) * (long long)pairs;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(a.q), static_cast<const float*>(a.ks),
                 static_cast<const float*>(a.vs), static_cast<const int*>(a.start),
                 static_cast<const int*>(a.seq_lens), static_cast<float*>(a.out),
                 static_cast<float*>(a.m), static_cast<float*>(a.l), a.b, a.kvh, a.s, a.S,
                 a.scale};
  return s9::launch<flash_prefill_kernel<G, STATS>>(dim3((unsigned)blocks), kThreads, kSmem,
                                                    stream, tk, tv, p);
}

// Head size 64: the kernel on the CUDA cores, on nq * b * kvh blocks.
template <int G, bool STATS>
int launch_cores(const Args& a, cudaStream_t stream) {
  constexpr int BQ = cores::kRows / G;
  const long long blocks = (long long)((a.s + BQ - 1) / BQ) * a.b * a.kvh;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const cores::Params p{static_cast<const __nv_bfloat16*>(a.q), static_cast<const int8_t*>(a.kq),
                        static_cast<const float*>(a.ks), static_cast<const int8_t*>(a.vq),
                        static_cast<const float*>(a.vs), static_cast<const int*>(a.start),
                        static_cast<const int*>(a.seq_lens), static_cast<float*>(a.out),
                        static_cast<float*>(a.m), static_cast<float*>(a.l), a.b, a.kvh, a.s,
                        a.S, a.scale};
  cores::prefill_kernel<G, 64, STATS><<<(unsigned)blocks, cores::kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool STATS>
int dispatch(const Args& a, int g, int hd, void* stream) {
  if ((hd != kHD && hd != 64) || a.b <= 0 || a.kvh <= 0 || a.s <= 0 || a.S <= 0 ||
      (reinterpret_cast<uintptr_t>(a.q) & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) {
    switch (g) {
      case 1: return launch_cores<1, STATS>(a, st);
      case 2: return launch_cores<2, STATS>(a, st);
      case 4: return launch_cores<4, STATS>(a, st);
      case 8: return launch_cores<8, STATS>(a, st);
      case 16: return launch_cores<16, STATS>(a, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
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

// K4: q (b, s, heads, hd) bf16 -> out (b, s, heads, hd) f32 = acc / l;
// hd 128 on wgmma, hd 64 on the CUDA cores (namespace cores). q, kq and
// vq must start on 16-byte boundaries (16-byte loads, TMA): the entry
// refuses an offset q, the tensor map an offset cache.
extern "C" int dga_flash_prefill(const void* q, const void* kq, const void* ks,
                                 const void* vq, const void* vs, const void* start,
                                 const void* seq_lens, void* out, int b, int kvh,
                                 int g, int s, int S, int hd, float scale,
                                 void* stream) {
  const Args a{q, kq, ks, vq, vs, start, seq_lens, out, nullptr, nullptr, b, kvh, s, S, scale};
  return dispatch<false>(a, g, hd, stream);
}

// K4-stats: acc (b, s, heads, hd), m and l (b, s, heads), all f32.
extern "C" int dga_flash_prefill_stats(const void* q, const void* kq, const void* ks,
                                       const void* vq, const void* vs, const void* start,
                                       const void* seq_lens, void* acc, void* m, void* l,
                                       int b, int kvh, int g, int s, int S, int hd,
                                       float scale, void* stream) {
  const Args a{q, kq, ks, vq, vs, start, seq_lens, acc, m, l, b, kvh, s, S, scale};
  return dispatch<true>(a, g, hd, stream);
}
