// P0: the dispatch-floor probe — one block copies a small f32 tensor.
//
// Replaces the Pallas copy kernel of deepgemm_ascend_tpu's
// scripts/straggler_probe.py (_copy_kernel, :75; pallas_call :81), which
// times what one Pallas dispatch costs on the TPU. Here it prices one
// launch through the port's path: the Python wrapper, ctypes and
// cudaLaunchKernel. The work is trivial on purpose (an (8, 128) f32 tile,
// 4 KiB in and 4 KiB out): its bound, 8 KiB over 3.35 TB/s, is ~2.4 ns, so
// what any timing of it shows is launch overhead.
//
// One block of 256 threads; thread t copies elements t, t + 256, ... (the
// wrapper accepts at most 1024 elements, four per thread), each warp on
// neighbouring addresses.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void copy_probe_kernel(const float* __restrict__ x,
                                  float* __restrict__ o, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) o[i] = x[i];
}

}  // namespace

extern "C" int dga_copy_probe(const void* x, void* o, int n, void* stream) {
  copy_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return static_cast<int>(cudaGetLastError());
}
