// The div3 helper of div3.cuh applied elementwise, so that it can be held
// against the IEEE division x / 3.0f bit for bit: chip_smoke.py runs it over
// all 2^32 binary32 bit patterns, tests/test_torch_cuda.py over a binade and
// the subnormals. No kernel of the main path calls this entry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "div3.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void div3_kernel(const float* __restrict__ x, float* __restrict__ out,
                            int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = div3(x[i]);
}

}  // namespace

// x, out: n fp32 values on CUDA device `device`. Launches on `stream` and
// returns the cudaError_t of the launch (0 = success).
extern "C" int div3_f32(const float* x, float* out, int64_t n, int device, void* stream) {
  if (n == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  div3_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}
