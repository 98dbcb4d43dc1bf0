// Kernel A: bilinear warp of a data image at normalized sample coordinates
// (align_corners=True, zeros padding), forward only.
//
// Replaces the TPU kernel unsupervised_pseuso_lidar_tpu/ops/pallas/warp.py
// (grid_sample_mxu_fused :472 -> _run_kernel :505 -> pallas_call :535,
// kernel body _fwd_kernel :75) in its primal form (with_taps=False).
//
// The TPU kernel turns the gather into banded one-hot matmuls over bf16
// image planes because the TPU has no fast gather. Hopper gathers from L2
// well, so this kernel is the exact 4-tap gather: one thread per output
// pixel reads its (x, y) sample, the four neighbouring pixels of each of
// the 3 channels, and writes the 3 channels. It is exact in fp32 and has
// no band or column window, so it equals ops/resample.grid_sample (the
// 'gather' semantics), not the banded bf16 approximation.
//
// Bound: bytes. Per pixel it must read 8 B of grid and write 12 B of
// output; the 12 B of taps come mostly from L1/L2 because neighbouring
// threads sample neighbouring pixels. Nothing here is compute-heavy.
//
// Arithmetic mirrors ops/resample.grid_sample op for op, and the file is
// compiled with --fmad=false, so the kernel and the plain version agree to
// the last bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 3;

__global__ void warp_bilinear_fwd_kernel(const float* __restrict__ img,
                                         const float* __restrict__ grid,
                                         float* __restrict__ out,
                                         int64_t jobs, int height, int width) {
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= jobs * plane) return;
  const int64_t job = idx / plane;
  const int64_t pix = idx - job * plane;

  const float gx = grid[2 * idx];
  const float gy = grid[2 * idx + 1];
  // pixel coordinates, clamped to [-2, size+1]: beyond that all four taps
  // are outside the image anyway, and the clamp keeps huge coordinates
  // from overflowing the integer conversion below
  float x = (gx + 1.0f) * 0.5f * static_cast<float>(width - 1);
  float y = (gy + 1.0f) * 0.5f * static_cast<float>(height - 1);
  x = fminf(fmaxf(x, -2.0f), static_cast<float>(width) + 1.0f);
  y = fminf(fmaxf(y, -2.0f), static_cast<float>(height) + 1.0f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx1 = x - x0f;
  const float wy1 = y - y0f;
  const float wx0 = 1.0f - wx1;
  const float wy0 = 1.0f - wy1;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  const bool in_x0 = x0 >= 0 && x0 <= width - 1;
  const bool in_x1 = x1 >= 0 && x1 <= width - 1;
  const bool in_y0 = y0 >= 0 && y0 <= height - 1;
  const bool in_y1 = y1 >= 0 && y1 <= height - 1;

  const float* src = img + job * kChannels * plane;
  float* dst = out + job * kChannels * plane + pix;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const float* p = src + c * plane;
    const float v00 = (in_x0 && in_y0) ? __ldg(p + static_cast<int64_t>(y0) * width + x0) : 0.0f;
    const float v10 = (in_x1 && in_y0) ? __ldg(p + static_cast<int64_t>(y0) * width + x1) : 0.0f;
    const float v01 = (in_x0 && in_y1) ? __ldg(p + static_cast<int64_t>(y1) * width + x0) : 0.0f;
    const float v11 = (in_x1 && in_y1) ? __ldg(p + static_cast<int64_t>(y1) * width + x1) : 0.0f;
    dst[c * plane] = v00 * wx0 * wy0 + v10 * wx1 * wy0 + v01 * wx0 * wy1 + v11 * wx1 * wy1;
  }
}

}  // namespace

// img: [jobs, 3, height, width] fp32 contiguous; grid: [jobs, height,
// width, 2] fp32 contiguous; out: like img, all on CUDA device `device`.
// Launches on `stream` and returns the cudaError_t of the launch (0 =
// success). The library links its own CUDA runtime, so it selects the
// device itself.
extern "C" int warp_bilinear_fwd(const float* img, const float* grid, float* out,
                                 int64_t jobs, int height, int width, int device,
                                 void* stream) {
  const int64_t total = jobs * static_cast<int64_t>(height) * width;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  warp_bilinear_fwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(img, grid, out, jobs,
                                                                   height, width);
  return static_cast<int>(cudaGetLastError());
}
