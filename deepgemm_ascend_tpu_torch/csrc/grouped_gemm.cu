// K3 and K8: masked and contiguous grouped FP8 GEMMs for Hopper (sm_90a).
//
// Replaces two kernels of deepgemm_ascend_tpu/ops/grouped_gemm.py:
//   K3 _masked_kernel (:282, call :407)  -> dga_grouped_gemm_masked
//   K8 _grouped_kernel (:70, call :183)  -> dga_grouped_gemm_contiguous
// Both keep K1's arithmetic for one element (fp8_gemm.cuh): e4m3 -> f16
// exact, m16n8k16 group partials, acc += (p * a_s) * b_s in group order,
// so a valid row gets the same bits whichever kernel or route computes it.
// B's block scales stay compact and are addressed through strides; B is
// stored (E, K, N) or K-major (E, N, K).
//
// K3: per expert e, C_e = A_e (M_max, K) x B_e; grid dimension z walks the
// experts. Two routes, chosen by the wrapper (ops/grouped_gemm.py: route,
// ring_tile) and refused here where they cannot run:
//   * "ring" (B K-major, b_layout='t', the layout of the port's expert
//     weights; TMA-describable pointers and pitches): fp8_gemm.cuh's
//     ring_kernel over 3-D maps whose batch is the expert, so that no box
//     reads the next expert's rows; 16-row tiles where an expert is
//     expected to hold a few rows (decode), and m16 fragments past
//     masked_m[e] skipped inside the larger tiles. K3 never splits its
//     groups: it stays bit-equal to K8;
//   * "tile" (b_layout='n', unaligned operands): gemm_tile's 64 x 64 grid.
// Either way a tile whose first row is at or past masked_m[e] loads
// nothing and writes zeros, as the TPU kernel's inactive tiles do; rows
// past masked_m[e] inside an active tile are unspecified (as in the TPU
// kernel). The MoE block sizes every expert for T*top_k rows, so at
// prefill almost every tile is idle, and those zero stores are the floor
// of the kernel while zeros stay in the contract (at 12288 rows, 32
// experts, n = 2816: 2.2 GB, ~0.66 ms at 3.35 TB/s).
//
// Bound on the card: the expert weight bytes at decode, which the ring
// streams with several groups in flight per SM; tensor-core work (f16
// mma.sync) and the zero stores at prefill.
//
// K8: one flat (M_total, K) activation matrix whose rows are grouped by
// expert in spans of block_m rows (the layout's m-tiles); tile_gids[t] is
// the expert of m-tile t, -1 for a padding tile. The grid walks the layout
// tiles times their 64-row kernel sub-tiles (K9's grid, int8_gemm.cu), so a
// kernel tile never spans two experts whatever block_m is: gemm_tile sees
// the sub-tile's end as its row limit. A padding tile stores zeros and
// loads nothing, as the TPU kernel's inactive tiles do (:117). Bound on the
// card: tensor-core work at prefill (the layout carries the routed rows and
// their padding, not T*top_k rows per expert as K3's buffer does).
#include "fp8_gemm.cuh"

namespace {

struct GroupStrides {
  long long a_e, as_e, b_e, bs_e;
};

template <bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(dga::kThreads)
masked_gemm_kernel(dga::GemmArgs p, GroupStrides gs, const int* masked_m, OutT* c) {
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * dga::kBM, n0 = blockIdx.x * dga::kBN;
  OutT* ce = c + (size_t)e * p.m * p.n;
  if (m0 >= masked_m[e]) {
    dga::zero_tile(ce, p.m, p.n, m0, n0);
    return;
  }
  dga::GemmArgs q = p;
  q.a += (size_t)e * gs.a_e;
  q.a_s += (size_t)e * gs.as_e;
  q.b += (size_t)e * gs.b_e;
  q.b_s += (size_t)e * gs.bs_e;
  dga::gemm_tile<B_KMAJOR, OutT>(q, ce, m0, n0);
}

template <bool B_KMAJOR, typename OutT>
void launch(const dga::GemmArgs& p, const GroupStrides& gs, int e,
            const int* masked_m, void* c, cudaStream_t stream) {
  dim3 grid(p.n / dga::kBN, (p.m + dga::kBM - 1) / dga::kBM, e);
  masked_gemm_kernel<B_KMAJOR, OutT><<<grid, dga::kThreads, 0, stream>>>(
      p, gs, masked_m, static_cast<OutT*>(c));
}

template <bool B_KMAJOR, typename OutT>
__global__ void __launch_bounds__(dga::kThreads)
contiguous_gemm_kernel(dga::GemmArgs p, const int* tile_gids, int block_m, long long b_e,
                       long long bs_e, OutT* c) {
  const int sub = (block_m + dga::kBM - 1) / dga::kBM;   // kernel tiles per layout tile
  const int tile = blockIdx.y / sub;
  const int m0 = tile * block_m + (blockIdx.y % sub) * dga::kBM;
  const int m_end = min(m0 + dga::kBM, (tile + 1) * block_m);
  const int n0 = blockIdx.x * dga::kBN;
  const int e = tile_gids[tile];
  if (e < 0) {
    dga::zero_tile(c, m_end, p.n, m0, n0);
    return;
  }
  dga::GemmArgs q = p;
  q.m = m_end;
  q.b += (size_t)e * b_e;
  q.b_s += (size_t)e * bs_e;
  dga::gemm_tile<B_KMAJOR, OutT>(q, c, m0, n0);
}

template <bool B_KMAJOR, typename OutT>
void launch_contiguous(const dga::GemmArgs& p, const int* gids, int n_tiles, int block_m,
                       long long b_e, long long bs_e, void* c, cudaStream_t stream) {
  dim3 grid(p.n / dga::kBN, n_tiles * ((block_m + dga::kBM - 1) / dga::kBM));
  contiguous_gemm_kernel<B_KMAJOR, OutT><<<grid, dga::kThreads, 0, stream>>>(
      p, gids, block_m, b_e, bs_e, static_cast<OutT*>(c));
}

}  // namespace

// route: 0 tile, 1 ring (dga::Route); tile: the ring's tile index
// (dga::ring::launch), not read on the tile route.
extern "C" int dga_grouped_gemm_masked(
    const void* a, const void* a_s, const void* b, const void* b_s,
    const void* masked_m, void* c, int e, int m_max, int n, int k,
    long long b_e, long long sbk, long long sbn, long long bs_e,
    long long bs_g, long long bs_n, int bs_shift, int out_f32, int route,
    int tile, void* stream) {
  if (e <= 0 || m_max <= 0 || n % dga::kBN || k % dga::kGroup)
    return (int)cudaErrorInvalidValue;
  if (route == dga::kRouteRing) {
    // TMA reads B as (E, n, k) rows of k bytes: K-major and dense rows.
    if (sbk != 1 || sbn != k) return (int)cudaErrorInvalidValue;
    const dga::ring::RingArgs p{static_cast<const float*>(a_s), static_cast<const float*>(b_s),
                                static_cast<const int*>(masked_m), c, m_max, n, k, bs_e, bs_g,
                                bs_n, bs_shift, 1};
    return dga::ring::launch(tile, out_f32, a, b, b_e, e, p, static_cast<cudaStream_t>(stream));
  }
  if (route != dga::kRouteTile) return (int)cudaErrorInvalidValue;
  dga::GemmArgs p{static_cast<const uint8_t*>(a), static_cast<const float*>(a_s),
                  static_cast<const uint8_t*>(b), static_cast<const float*>(b_s),
                  m_max, n, k, sbk, sbn, bs_g, bs_n, bs_shift};
  GroupStrides gs{(long long)m_max * k, (long long)m_max * (k / dga::kGroup), b_e, bs_e};
  const int* mm = static_cast<const int*>(masked_m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kmajor = sbk == 1;
  if (kmajor && out_f32) launch<true, float>(p, gs, e, mm, c, s);
  else if (kmajor) launch<true, __nv_bfloat16>(p, gs, e, mm, c, s);
  else if (out_f32) launch<false, float>(p, gs, e, mm, c, s);
  else launch<false, __nv_bfloat16>(p, gs, e, mm, c, s);
  return (int)cudaGetLastError();
}

extern "C" int dga_grouped_gemm_contiguous(
    const void* a, const void* a_s, const void* b, const void* b_s,
    const void* tile_gids, void* c, int m, int n, int k, int block_m,
    long long b_e, long long sbk, long long sbn, long long bs_e,
    long long bs_g, long long bs_n, int bs_shift, int out_f32, void* stream) {
  if (m <= 0 || block_m <= 0 || m % block_m || n <= 0 || n % dga::kBN || k <= 0 ||
      k % dga::kGroup)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = m / block_m;
  if ((long long)n_tiles * ((block_m + dga::kBM - 1) / dga::kBM) > 65535)
    return (int)cudaErrorInvalidValue;
  dga::GemmArgs p{static_cast<const uint8_t*>(a), static_cast<const float*>(a_s),
                  static_cast<const uint8_t*>(b), static_cast<const float*>(b_s),
                  m, n, k, sbk, sbn, bs_g, bs_n, bs_shift};
  const int* gids = static_cast<const int*>(tile_gids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kmajor = sbk == 1;
  if (kmajor && out_f32) launch_contiguous<true, float>(p, gids, n_tiles, block_m, b_e, bs_e, c, s);
  else if (kmajor) launch_contiguous<true, __nv_bfloat16>(p, gids, n_tiles, block_m, b_e, bs_e, c, s);
  else if (out_f32) launch_contiguous<false, float>(p, gids, n_tiles, block_m, b_e, bs_e, c, s);
  else launch_contiguous<false, __nv_bfloat16>(p, gids, n_tiles, block_m, b_e, bs_e, c, s);
  return (int)cudaGetLastError();
}
