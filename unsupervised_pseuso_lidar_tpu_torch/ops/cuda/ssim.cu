// Kernel B: per-pixel SSIM distance clamp((1 - SSIM(x, y)) / 2, 0, 1) from
// five 3x3 reflect-padded box moments (C1, C2 from the caller), optionally
// blended as w * ssim + w1 * |y - x|.
//
// Replaces the TPU kernel unsupervised_pseuso_lidar_tpu/ops/pallas/photometric.py
// (ssim_distance_pallas :91 and photometric_map_pallas :104 -> _call :61 ->
// pallas_call :76, kernel body _photometric_kernel :36).
//
// The TPU kernel holds one whole (H, W) plane in VMEM per grid cell. An SM
// has far less fast memory, so here a block owns a 32x32 tile of one plane:
// it loads the tile plus a one-pixel halo of x and y into shared memory,
// with REFLECT indexing at the image border (-1 -> 1, H -> H-2; a size-1
// dimension repeats its only pixel), computes the horizontal 3-tap sums of
// x, y, x*x, y*y, x*y for the tile rows plus halo rows into shared memory,
// then each thread finishes the vertical sums and the SSIM for 4 pixels of
// its column. One read of x and y (plus the 6% halo), one write.
//
// Bound: bytes (8 B read + 4 B written per pixel against ~60 flops).
//
// Arithmetic mirrors ops/ssim.photometric_map op for op — box sums as
// (a + b + c) / 3, a true division as in JAX and in the plain version on
// every device (utils/numerics.div), horizontal first — and the file is
// compiled with --fmad=false: the two agree bit for bit. The order
// matters: in flat regions sigma is far below C2, so the SSIM ratio
// amplifies any rounding difference in the moments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = kTileH / kThreadsY;

__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  // size-1 dims, and halo rows past the last row a valid output reads
  return min(max(i, 0), n - 1);
}

__global__ void ssim_fwd_kernel(const float* __restrict__ xs,
                                const float* __restrict__ ys,
                                float* __restrict__ out, int height, int width,
                                float c1, float c2, float w, float w1, int blend) {
  __shared__ float sx[kTileH + 2][kTileW + 2];
  __shared__ float sy[kTileH + 2][kTileW + 2];
  __shared__ float hx[kTileH + 2][kTileW];
  __shared__ float hy[kTileH + 2][kTileW];
  __shared__ float hxx[kTileH + 2][kTileW];
  __shared__ float hyy[kTileH + 2][kTileW];
  __shared__ float hxy[kTileH + 2][kTileW];

  const int64_t plane = static_cast<int64_t>(height) * width;
  const float* xp = xs + static_cast<int64_t>(blockIdx.z) * plane;
  const float* yp = ys + static_cast<int64_t>(blockIdx.z) * plane;
  float* op = out + static_cast<int64_t>(blockIdx.z) * plane;
  const int tile_x0 = blockIdx.x * kTileW;
  const int tile_y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int nthreads = kTileW * kThreadsY;

  // 1. tile + one-pixel reflect halo of x and y
  for (int i = tid; i < (kTileH + 2) * (kTileW + 2); i += nthreads) {
    const int r = i / (kTileW + 2);
    const int c = i - r * (kTileW + 2);
    const int gy = reflect_index(tile_y0 + r - 1, height);
    const int gx = reflect_index(tile_x0 + c - 1, width);
    const int64_t off = static_cast<int64_t>(gy) * width + gx;
    sx[r][c] = __ldg(xp + off);
    sy[r][c] = __ldg(yp + off);
  }
  __syncthreads();

  // 2. horizontal 3-tap means of the five moment inputs
  for (int i = tid; i < (kTileH + 2) * kTileW; i += nthreads) {
    const int r = i / kTileW;
    const int c = i - r * kTileW;
    const float xa = sx[r][c], xb = sx[r][c + 1], xc = sx[r][c + 2];
    const float ya = sy[r][c], yb = sy[r][c + 1], yc = sy[r][c + 2];
    hx[r][c] = (xa + xb + xc) / 3.0f;
    hy[r][c] = (ya + yb + yc) / 3.0f;
    hxx[r][c] = (xa * xa + xb * xb + xc * xc) / 3.0f;
    hyy[r][c] = (ya * ya + yb * yb + yc * yc) / 3.0f;
    hxy[r][c] = (xa * ya + xb * yb + xc * yc) / 3.0f;
  }
  __syncthreads();

  // 3. vertical means + SSIM, 4 rows of one column per thread
  const int c = threadIdx.x;
  const int gx = tile_x0 + c;
  if (gx >= width) return;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = threadIdx.y + k * kThreadsY;
    const int gy = tile_y0 + r;
    if (gy >= height) break;
    const float mu_x = (hx[r][c] + hx[r + 1][c] + hx[r + 2][c]) / 3.0f;
    const float mu_y = (hy[r][c] + hy[r + 1][c] + hy[r + 2][c]) / 3.0f;
    const float mu_xy = mu_x * mu_y;
    const float mu_xx = mu_x * mu_x;
    const float mu_yy = mu_y * mu_y;
    const float sigma_x = (hxx[r][c] + hxx[r + 1][c] + hxx[r + 2][c]) / 3.0f - mu_xx;
    const float sigma_y = (hyy[r][c] + hyy[r + 1][c] + hyy[r + 2][c]) / 3.0f - mu_yy;
    const float sigma_xy = (hxy[r][c] + hxy[r + 1][c] + hxy[r + 2][c]) / 3.0f - mu_xy;
    const float num = (2.0f * mu_xy + c1) * (2.0f * sigma_xy + c2);
    const float den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2);
    const float ssim = num / den;
    float d = fminf(fmaxf((1.0f - ssim) * 0.5f, 0.0f), 1.0f);
    if (blend) d = w * d + w1 * fabsf(sy[r + 1][c + 1] - sx[r + 1][c + 1]);
    op[static_cast<int64_t>(gy) * width + gx] = d;
  }
}

}  // namespace

// x, y, out: [planes, height, width] fp32 contiguous (an NCHW tensor is
// N*C planes) on CUDA device `device`. blend != 0 returns w * ssim + w1 *
// |y - x|. Launches on `stream` and returns the cudaError_t of the launch
// (0 = success). The library links its own CUDA runtime, so it selects
// the device itself.
extern "C" int ssim_fwd(const float* x, const float* y, float* out, int planes,
                        int height, int width, float c1, float c2, float w,
                        float w1, int blend, int device, void* stream) {
  if (planes == 0 || height == 0 || width == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 block(kTileW, kThreadsY);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, planes);
  ssim_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, height, width, c1, c2, w, w1, blend);
  return static_cast<int>(cudaGetLastError());
}
