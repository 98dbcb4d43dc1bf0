// Kernel A: bilinear warp of a data image at normalized sample coordinates
// (align_corners=True, zeros padding), and its gradient w.r.t. the
// coordinates (warp_bilinear_bwd_grid).
//
// Replaces the TPU kernel unsupervised_pseuso_lidar_tpu/ops/pallas/warp.py
// (grid_sample_mxu_fused :472 -> _run_kernel :505 -> pallas_call :535,
// kernel body _fwd_kernel :75): the primal (with_taps=False) by
// warp_bilinear_fwd, and the gradient variant (with_taps=True, _fwd :551,
// then the elementwise _bwd :569) by warp_bilinear_bwd_grid.
//
// The TPU kernel turns the gather into banded one-hot matmuls over bf16
// image planes because the TPU has no fast gather. Hopper gathers from L2
// well, so this kernel is the exact 4-tap gather: one thread per output
// pixel reads its (x, y) sample, the four neighbouring pixels of each of
// the 3 channels, and writes the 3 channels. It is exact in fp32 and has
// no band or column window, so it equals ops/resample.grid_sample (the
// 'gather' semantics), not the banded bf16 approximation.
//
// The TPU's gradient variant writes 6 tap planes (24 B/pixel) in the
// forward so that its backward needs no kernel. Here the backward is a
// kernel that RECOMPUTES the four taps from img and grid: it reads grid
// (8 B) and g (12 B) per pixel, the taps mostly from L1/L2, and writes
// d_grid (8 B) — less traffic than writing and reading back tap planes.
// There is no img gradient: the warp samples data frames (the caller
// enforces that, ops/cuda/kernels.py WarpBilinear).
//
// The grid, and so the output, may have other rows and columns than the
// image (out_h x out_w): under a mesh's "spatial" axis a rank's grid is
// its band of the target's rows while the source is the whole image. The
// sampling arithmetic reads the image's height and width only; out_h and
// out_w span the output index space.
//
// Bound: bytes. Per pixel the forward must read 8 B of grid and write
// 12 B of output; the 12 B of taps come mostly from L1/L2 because
// neighbouring threads sample neighbouring pixels. Nothing here is
// compute-heavy.
//
// Arithmetic mirrors ops/resample.grid_sample / grid_sample_grad_grid op
// for op, and the file is compiled with --fmad=false, so the kernels and
// the plain versions agree to the last bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 3;

// The bilinear taps of one sample: weights, and for each channel the four
// neighbouring pixels (0 outside the image).
struct Taps {
  float wx0, wx1, wy0, wy1;
  float v00[kChannels], v10[kChannels], v01[kChannels], v11[kChannels];
};

__device__ __forceinline__ Taps sample_taps(const float* __restrict__ src, float gx,
                                            float gy, int height, int width) {
  const int64_t plane = static_cast<int64_t>(height) * width;
  // pixel coordinates, clamped to [-2, size+1]: beyond that all four taps
  // are outside the image anyway, and the clamp keeps huge coordinates
  // from overflowing the integer conversion below
  float x = (gx + 1.0f) * 0.5f * static_cast<float>(width - 1);
  float y = (gy + 1.0f) * 0.5f * static_cast<float>(height - 1);
  x = fminf(fmaxf(x, -2.0f), static_cast<float>(width) + 1.0f);
  y = fminf(fmaxf(y, -2.0f), static_cast<float>(height) + 1.0f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  Taps t;
  t.wx1 = x - x0f;
  t.wy1 = y - y0f;
  t.wx0 = 1.0f - t.wx1;
  t.wy0 = 1.0f - t.wy1;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  const bool in_x0 = x0 >= 0 && x0 <= width - 1;
  const bool in_x1 = x1 >= 0 && x1 <= width - 1;
  const bool in_y0 = y0 >= 0 && y0 <= height - 1;
  const bool in_y1 = y1 >= 0 && y1 <= height - 1;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const float* p = src + c * plane;
    t.v00[c] = (in_x0 && in_y0) ? __ldg(p + static_cast<int64_t>(y0) * width + x0) : 0.0f;
    t.v10[c] = (in_x1 && in_y0) ? __ldg(p + static_cast<int64_t>(y0) * width + x1) : 0.0f;
    t.v01[c] = (in_x0 && in_y1) ? __ldg(p + static_cast<int64_t>(y1) * width + x0) : 0.0f;
    t.v11[c] = (in_x1 && in_y1) ? __ldg(p + static_cast<int64_t>(y1) * width + x1) : 0.0f;
  }
  return t;
}

__global__ void warp_bilinear_fwd_kernel(const float* __restrict__ img,
                                         const float* __restrict__ grid,
                                         float* __restrict__ out,
                                         int64_t jobs, int height, int width,
                                         int out_h, int out_w) {
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t out_plane = static_cast<int64_t>(out_h) * out_w;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= jobs * out_plane) return;
  const int64_t job = idx / out_plane;
  const int64_t pix = idx - job * out_plane;

  const Taps t = sample_taps(img + job * kChannels * plane, grid[2 * idx],
                             grid[2 * idx + 1], height, width);
  float* dst = out + job * kChannels * out_plane + pix;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    dst[c * out_plane] = t.v00[c] * t.wx0 * t.wy0 + t.v10[c] * t.wx1 * t.wy0 +
                     t.v01[c] * t.wx0 * t.wy1 + t.v11[c] * t.wx1 * t.wy1;
  }
}

__global__ void warp_bilinear_bwd_grid_kernel(const float* __restrict__ img,
                                              const float* __restrict__ grid,
                                              const float* __restrict__ g,
                                              float* __restrict__ d_grid,
                                              int64_t jobs, int height, int width,
                                              int out_h, int out_w) {
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t out_plane = static_cast<int64_t>(out_h) * out_w;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= jobs * out_plane) return;
  const int64_t job = idx / out_plane;
  const int64_t pix = idx - job * out_plane;

  const Taps t = sample_taps(img + job * kChannels * plane, grid[2 * idx],
                             grid[2 * idx + 1], height, width);
  const float* gp = g + job * kChannels * out_plane + pix;
  float sum_x = 0.0f;
  float sum_y = 0.0f;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    // d(out)/dx and d(out)/dy of channel c, contracted with its cotangent
    const float d_x = t.wy0 * (t.v10[c] - t.v00[c]) + t.wy1 * (t.v11[c] - t.v01[c]);
    const float d_y = t.wx0 * (t.v01[c] - t.v00[c]) + t.wx1 * (t.v11[c] - t.v10[c]);
    const float gc = gp[c * out_plane];
    sum_x = c == 0 ? gc * d_x : sum_x + gc * d_x;
    sum_y = c == 0 ? gc * d_y : sum_y + gc * d_y;
  }
  // d(pixel)/d(normalized coordinate)
  d_grid[2 * idx] = sum_x * (0.5f * static_cast<float>(width - 1));
  d_grid[2 * idx + 1] = sum_y * (0.5f * static_cast<float>(height - 1));
}

}  // namespace

// img: [jobs, 3, height, width] fp32 contiguous; grid: [jobs, out_h,
// out_w, 2] fp32 contiguous; out: [jobs, 3, out_h, out_w], all on CUDA
// device `device`. Launches on `stream` and returns the cudaError_t of the
// launch (0 = success). The library links its own CUDA runtime, so it
// selects the device itself.
extern "C" int warp_bilinear_fwd(const float* img, const float* grid, float* out,
                                 int64_t jobs, int height, int width, int out_h,
                                 int out_w, int device, void* stream) {
  const int64_t total = jobs * static_cast<int64_t>(out_h) * out_w;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  warp_bilinear_fwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      img, grid, out, jobs, height, width, out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}

// The gradient of sum(g * warp(img, grid)) w.r.t. grid: img and grid as for
// warp_bilinear_fwd, g like out, d_grid like grid. Same launch contract.
extern "C" int warp_bilinear_bwd_grid(const float* img, const float* grid,
                                      const float* g, float* d_grid, int64_t jobs,
                                      int height, int width, int out_h, int out_w,
                                      int device, void* stream) {
  const int64_t total = jobs * static_cast<int64_t>(out_h) * out_w;
  if (total == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  warp_bilinear_bwd_grid_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      img, grid, g, d_grid, jobs, height, width, out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}
