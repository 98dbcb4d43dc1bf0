// Kernel C: the gradient of kernel B's per-pixel photometric map
// w * clamp((1 - SSIM(x, y)) / 2, 0, 1) + w1 * |y - x| (the L1 term only
// when blend != 0) w.r.t. x and/or y, given its cotangent g.
//
// Replaces the TPU kernel unsupervised_pseuso_lidar_tpu/ops/pallas/photometric.py
// (ssim_bwd_pallas :214 -> pallas_call :235, kernel body _ssim_bwd_kernel
// :169), and fuses the L1 term of the blend, which the JAX package
// differentiates outside its kernel.
//
// The TPU kernel holds a whole (H, W) plane in VMEM. Here a block owns a
// 32x32 output tile of one plane, like kernel B, with a wider halo: dx at
// a pixel reads the adjoint box of the g-derived planes at +-1 pixel, and
// those planes are built from the moments, which read x and y at a
// further +-1. So the block loads x and y with a 2-pixel REFLECT halo
// (36x36; -1 -> 1, L -> L-2), builds the four g-derived planes (g_m1,
// g_m2, g_d, 2 g_b) on the 34x34 tile + 1-pixel halo — zero outside the
// image, as the adjoint's zero padding wants — reading g there from
// device memory, runs the W adjoint over those 34 rows, then the H
// adjoint and the output combination, 4 rows of one column per thread.
// The reflect folds of the adjoint (g at 0 and L-1 also lands at 1 and
// L-2; both at 0 when L == 1) need no further halo.
//
// Shared memory: x, y 2 x 36 x 36 floats (10,368 B), four planes
// 4 x 34 x 34 (18,496 B), their W adjoints 4 x 34 x 32 (17,408 B):
// 46,272 B a block, under the 48 KB of static shared memory.
//
// Bound: bytes (x, y, g read and dx written: 16 B per element; 20 B with
// dy) against ~200 flops and 4 divisions per element.
//
// Arithmetic mirrors ops/ssim.photometric_map_bwd op for op (box sums as
// (a + b + c) / 3, a true division as in JAX and in the plain version,
// rows before columns; the adjoint as mean + fold / 3, W before H), and
// the file is compiled with --fmad=false. The SSIM ratio amplifies
// one-ulp differences in flat windows, so the order matters.
//
// Tie rules (the JAX ones): the clamp passes the cotangent only where
// 0 < raw < 1; d|z|/dz is +1 at z = y - x >= 0 and -1 below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = kTile / kThreadsY;
constexpr int kXY = kTile + 4;     // x, y: tile + 2-pixel halo
constexpr int kPlane = kTile + 2;  // g-derived planes: tile + 1-pixel halo
constexpr int kPlanes = 4;         // g_m1, g_m2, g_d, 2 g_b

__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  // size-1 dims, and halo entries no valid output reads
  return min(max(i, 0), n - 1);
}

__global__ void ssim_bwd_kernel(const float* __restrict__ xs,
                                const float* __restrict__ ys,
                                const float* __restrict__ gs,
                                float* __restrict__ dxs, float* __restrict__ dys,
                                int height, int width, float c1, float c2, float w,
                                float w1, int blend) {
  __shared__ float sx[kXY][kXY];
  __shared__ float sy[kXY][kXY];
  __shared__ float planes[kPlanes][kPlane][kPlane];
  __shared__ float wadj[kPlanes][kPlane][kTile];

  const bool need_dx = dxs != nullptr;
  const bool need_dy = dys != nullptr;
  const int64_t plane_size = static_cast<int64_t>(height) * width;
  const int64_t base = static_cast<int64_t>(blockIdx.z) * plane_size;
  const float* xp = xs + base;
  const float* yp = ys + base;
  const float* gp = gs + base;
  const int tile_x0 = blockIdx.x * kTile;
  const int tile_y0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kThreadsY;

  // 1. tile + 2-pixel reflect halo of x and y
  for (int i = tid; i < kXY * kXY; i += nthreads) {
    const int r = i / kXY;
    const int c = i - r * kXY;
    const int64_t off = static_cast<int64_t>(reflect_index(tile_y0 + r - 2, height)) * width +
                        reflect_index(tile_x0 + c - 2, width);
    sx[r][c] = __ldg(xp + off);
    sy[r][c] = __ldg(yp + off);
  }
  __syncthreads();

  // 2. the g-derived planes on tile + 1-pixel halo (0 outside the image)
  for (int i = tid; i < kPlane * kPlane; i += nthreads) {
    const int r = i / kPlane;
    const int c = i - r * kPlane;
    const int py = tile_y0 + r - 1;
    const int px = tile_x0 + c - 1;
    float p_m1 = 0.0f, p_m2 = 0.0f, p_d = 0.0f, p_b2 = 0.0f;
    if (py >= 0 && py < height && px >= 0 && px < width) {
      // moments: 3-tap row means of rows r..r+2 of the x/y tile (centre at
      // r+1, c+1), then their column mean
      float hx[3], hy[3], hxx[3], hyy[3], hxy[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float xa = sx[r + k][c], xb = sx[r + k][c + 1], xc = sx[r + k][c + 2];
        const float ya = sy[r + k][c], yb = sy[r + k][c + 1], yc = sy[r + k][c + 2];
        hx[k] = (xa + xb + xc) / 3.0f;
        hy[k] = (ya + yb + yc) / 3.0f;
        hxx[k] = (xa * xa + xb * xb + xc * xc) / 3.0f;
        hyy[k] = (ya * ya + yb * yb + yc * yc) / 3.0f;
        hxy[k] = (xa * ya + xb * yb + xc * yc) / 3.0f;
      }
      const float m1 = (hx[0] + hx[1] + hx[2]) / 3.0f;
      const float m2 = (hy[0] + hy[1] + hy[2]) / 3.0f;
      const float p1 = (hxx[0] + hxx[1] + hxx[2]) / 3.0f;
      const float p2 = (hyy[0] + hyy[1] + hyy[2]) / 3.0f;
      const float p3 = (hxy[0] + hxy[1] + hxy[2]) / 3.0f;
      const float mu_xy = m1 * m2;
      const float a = 2.0f * mu_xy + c1;
      const float b = 2.0f * (p3 - mu_xy) + c2;
      const float cc = m1 * m1 + m2 * m2 + c1;
      const float d = p1 + p2 - m1 * m1 - m2 * m2 + c2;
      const float s = (a * b) / (cc * d);
      const float raw = (1.0f - s) * 0.5f;
      const float gv = __ldg(gp + static_cast<int64_t>(py) * width + px);
      const float g_ssim = blend ? w * gv : gv;
      const float g_s = ((raw > 0.0f && raw < 1.0f) ? g_ssim : 0.0f) * -0.5f;
      const float inv_cd = 1.0f / (cc * d);
      const float g_a = g_s * b * inv_cd;
      const float g_b = g_s * a * inv_cd;
      const float g_c = -g_s * s / cc;
      const float g_d = -g_s * s / d;
      const float g_ab = g_a - g_b;
      const float g_cd = g_c - g_d;
      if (need_dx) p_m1 = 2.0f * (m2 * g_ab + m1 * g_cd);
      if (need_dy) p_m2 = 2.0f * (m1 * g_ab + m2 * g_cd);
      p_d = g_d;
      p_b2 = 2.0f * g_b;
    }
    planes[0][r][c] = p_m1;
    planes[1][r][c] = p_m2;
    planes[2][r][c] = p_d;
    planes[3][r][c] = p_b2;
  }
  __syncthreads();

  // 3. W adjoint of each plane over the 34 rows, for the 32 tile columns:
  // zero-padded mean + reflect folds (plane column j holds image column
  // tile_x0 + j - 1)
  const int lo_w = min(1, width - 1);
  const int hi_w = max(width - 2, 0);
  for (int i = tid; i < kPlane * kTile; i += nthreads) {
    const int r = i / kTile;
    const int c = i - r * kTile;
    const int ox = tile_x0 + c;
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      float v = (planes[k][r][c] + planes[k][r][c + 1] + planes[k][r][c + 2]) / 3.0f;
      float f = 0.0f;
      if (ox == lo_w) f = f + planes[k][r][1 - tile_x0];
      if (ox == hi_w) f = f + planes[k][r][width - tile_x0];
      wadj[k][r][c] = v + f / 3.0f;
    }
  }
  __syncthreads();

  // 4. H adjoint + the output, 4 rows of one column per thread (wadj row
  // i holds image row tile_y0 + i - 1)
  const int c = threadIdx.x;
  const int ox = tile_x0 + c;
  if (ox >= width) return;
  const int lo_h = min(1, height - 1);
  const int hi_h = max(height - 2, 0);
#pragma unroll
  for (int kr = 0; kr < kRowsPerThread; ++kr) {
    const int r = threadIdx.y + kr * kThreadsY;
    const int oy = tile_y0 + r;
    if (oy >= height) break;
    float t[kPlanes];
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      const float v = (wadj[k][r][c] + wadj[k][r + 1][c] + wadj[k][r + 2][c]) / 3.0f;
      float f = 0.0f;
      if (oy == lo_h) f = f + wadj[k][1 - tile_y0][c];
      if (oy == hi_h) f = f + wadj[k][height - tile_y0][c];
      t[k] = v + f / 3.0f;
    }
    const float xv = sx[r + 2][c + 2];
    const float yv = sy[r + 2][c + 2];
    const int64_t off = static_cast<int64_t>(oy) * width + ox;
    float g_z = 0.0f;
    if (blend) {
      const float g_l1 = w1 * __ldg(gp + off);
      g_z = (yv - xv >= 0.0f) ? g_l1 : -g_l1;
    }
    if (need_dx) {
      float dx = t[0] + 2.0f * xv * t[2] + yv * t[3];
      if (blend) dx = dx - g_z;
      dxs[base + off] = dx;
    }
    if (need_dy) {
      float dy = t[1] + 2.0f * yv * t[2] + xv * t[3];
      if (blend) dy = dy + g_z;
      dys[base + off] = dy;
    }
  }
}

}  // namespace

// x, y, g: [planes, height, width] fp32 contiguous (an NCHW tensor is N*C
// planes) on CUDA device `device`; dx, dy: like x, or null for a gradient
// not wanted (at least one is given). blend != 0 differentiates w * ssim +
// w1 * |y - x|, else the SSIM distance alone. Launches on `stream` and
// returns the cudaError_t of the launch (0 = success). The library links
// its own CUDA runtime, so it selects the device itself.
extern "C" int ssim_bwd(const float* x, const float* y, const float* g, float* dx,
                        float* dy, int planes, int height, int width, float c1,
                        float c2, float w, float w1, int blend, int device,
                        void* stream) {
  if (planes == 0 || height == 0 || width == 0 || (dx == nullptr && dy == nullptr)) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 block(kTile, kThreadsY);
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile, planes);
  ssim_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, g, dx, dy, height, width, c1, c2, w, w1, blend);
  return static_cast<int>(cudaGetLastError());
}
