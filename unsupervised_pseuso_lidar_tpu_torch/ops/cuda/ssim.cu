// Kernel B: per-pixel SSIM distance clamp((1 - SSIM(x, y)) / 2, 0, 1) from
// five 3x3 reflect-padded box moments (C1, C2 from the caller), optionally
// blended as w * ssim + w1 * |y - x|.
//
// Replaces the TPU kernel unsupervised_pseuso_lidar_tpu/ops/pallas/photometric.py
// (ssim_distance_pallas :91 and photometric_map_pallas :104 -> _call :61 ->
// pallas_call :76, kernel body _photometric_kernel :36).
//
// The TPU kernel holds one whole (H, W) plane in VMEM per grid cell. Here,
// as in kernel C (ssim_bwd.cu), each warp owns a strip of columns of one
// plane and walks down a segment of kSegment = 48 of its rows, one image
// row per step, with no shared memory and no block barrier. Lane l holds
// the two adjacent columns strip * kOut - 1 + 2l and the next; the warp
// loads 64 columns of x and y (REFLECT index at the border: -1 -> 1,
// L -> L-2; a size-1 dimension repeats its only pixel) and writes the
// middle kOut = 62. The 3-tap row means of x, y, x*x, y*y, x*y take the
// lane's outer neighbours by warp shuffle; the column means run down the
// lane's own columns over a ring of 3 rows of row means in registers (slot
// = row mod 3, unrolled three steps at a time, so a step moves no
// register). Step i loads row i (prefetched a step ahead), pushes its row
// means and writes output row i-1: a segment of S rows takes S + 2 steps.
// x and y are read once plus a halo of 1/31 across and 2/S down; out is
// written once.
//
// Bound: bytes (8 B read + 4 B written per pixel: 0.079 ms a training
// step for its two calls) against about 130 issued instructions per pixel
// (ten divisions by 3 at 4 instructions, one IEEE division, the moments,
// the SSIM ratio, clamp and blend, 4 shuffles a row step for 2 pixels a
// lane). 64 registers (launch bounds: 8 blocks of 128 threads an SM); one
// column a lane ran 7 % slower, and four columns (16-byte loads) took
// 128-141 registers and ran 44 % slower (ops/cuda/tune.py, PERF.md).
//
// Arithmetic mirrors ops/ssim.photometric_map op for op — box sums as
// (a + b + c) / 3, horizontal first — and the file is compiled with
// --fmad=false. Every division by 3 goes through div3 (div3.cuh), which
// returns the bits of the IEEE division x / 3.0f (the plain version's
// utils/numerics.div, as in JAX) for every input, from a reciprocal
// multiply and an explicit FMA correction: the kernel and the plain version
// agree bit for bit. The order matters: in flat regions sigma is far below
// C2, so the SSIM ratio amplifies any rounding difference in the moments.

#include <cuda_runtime.h>
#include <stdint.h>

#include "div3.cuh"
#include "warp_strip.cuh"

namespace {

using warp_strip::neighbours;
using warp_strip::Phase;
using warp_strip::reflect_index;

constexpr int kWarps = 4;          // warps per block, each its own strip
constexpr int kSegment = 48;       // output rows one warp walks
constexpr int kCols = 2;           // adjacent columns per lane
constexpr int kSpan = 32 * kCols;  // columns a warp loads
constexpr int kOut = kSpan - 2;    // columns it writes
constexpr int kMinBlocks = 8;      // blocks per SM: at most 64 registers a thread

template <bool kBlend>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    ssim_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                    float* __restrict__ out, int height, int width, int strips,
                    int segments, float c1, float c2, float w, float w1) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= strips * segments) return;  // the whole warp: no shuffle waits on it
  const int strip = warp % strips;
  const int r0 = (warp / strips) * kSegment;
  const int r1 = min(r0 + kSegment, height);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * height * width;
  xs += base;
  ys += base;
  out += base;
  // 32-bit offsets inside the plane (the wrapper refuses H * W >= 2^31)

  int col[kCols], xcol[kCols];
  bool writes[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int k = lane * kCols + j;
    col[j] = strip * kOut - 1 + k;
    xcol[j] = reflect_index(col[j], width);
    writes[j] = col[j] >= 0 && col[j] < width && k >= 1 && k < kSpan - 1;
  }

  // rings of 3 rows in registers, indexed by row mod 3 so that a step
  // moves nothing: the row means and x, y of rows i-2..i
  float hx[3][kCols], hy[3][kCols], hxx[3][kCols], hyy[3][kCols], hxy[3][kCols];
  float xv[3][kCols], yv[3][kCols];

  auto load_xy = [&](int i, float (&x)[kCols], float (&y)[kCols]) {
    const int off = reflect_index(i, height) * width;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      x[j] = __ldg(xs + off + xcol[j]);
      y[j] = __ldg(ys + off + xcol[j]);
    }
  };

  // One row step. Phase P = (i - first row) mod 3 is the ring slot of row
  // i; slots S0 and S1 hold the two rows before.
  float nx[kCols], ny[kCols];  // the prefetched next row
  auto step = [&](auto phase, int i) {
    constexpr int P = decltype(phase)::value;
    constexpr int S0 = (P + 1) % 3;
    constexpr int S1 = (P + 2) % 3;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      xv[P][j] = nx[j];
      yv[P][j] = ny[j];
    }
    load_xy(i + 1, nx, ny);

    // the 3-tap row means of the five moment inputs of row i
    float xl[kCols], xr[kCols], yl[kCols], yr[kCols];
    neighbours(xv[P], xl, xr);
    neighbours(yv[P], yl, yr);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float x = xv[P][j], y = yv[P][j];
      hx[P][j] = div3(xl[j] + x + xr[j]);
      hy[P][j] = div3(yl[j] + y + yr[j]);
      hxx[P][j] = div3(xl[j] * xl[j] + x * x + xr[j] * xr[j]);
      hyy[P][j] = div3(yl[j] * yl[j] + y * y + yr[j] * yr[j]);
      hxy[P][j] = div3(xl[j] * yl[j] + x * y + xr[j] * yr[j]);
    }
    if (i < r0 + 1) return;  // rows r0-1, r0: row means only

    // output row o = i-1: the column means of rows o-1..o+1 and the SSIM
    const int o = i - 1;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float mu_x = div3(hx[S0][j] + hx[S1][j] + hx[P][j]);
      const float mu_y = div3(hy[S0][j] + hy[S1][j] + hy[P][j]);
      const float mu_xy = mu_x * mu_y;
      const float mu_xx = mu_x * mu_x;
      const float mu_yy = mu_y * mu_y;
      const float sigma_x = div3(hxx[S0][j] + hxx[S1][j] + hxx[P][j]) - mu_xx;
      const float sigma_y = div3(hyy[S0][j] + hyy[S1][j] + hyy[P][j]) - mu_yy;
      const float sigma_xy = div3(hxy[S0][j] + hxy[S1][j] + hxy[P][j]) - mu_xy;
      const float num = (2.0f * mu_xy + c1) * (2.0f * sigma_xy + c2);
      const float den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2);
      const float ssim = num / den;
      float d = fminf(fmaxf((1.0f - ssim) * 0.5f, 0.0f), 1.0f);
      if (kBlend) d = w * d + w1 * fabsf(yv[S1][j] - xv[S1][j]);
      if (writes[j]) out[o * width + col[j]] = d;
    }
  };

  // rows r0-1 .. r1, three steps per iteration so that the ring slots are
  // compile-time constants
  int i = r0 - 1;
  load_xy(i, nx, ny);
  for (; i + 2 <= r1; i += 3) {
    step(Phase<0>(), i);
    step(Phase<1>(), i + 1);
    step(Phase<2>(), i + 2);
  }
  if (i <= r1) step(Phase<0>(), i);
  if (i + 1 <= r1) step(Phase<1>(), i + 1);
}

}  // namespace

// x, y, out: [planes, height, width] fp32 contiguous (an NCHW tensor is
// N*C planes) on CUDA device `device`, height * width < 2^31. blend != 0
// returns w * ssim + w1 * |y - x|. Launches on `stream` and returns the
// cudaError_t of the launch (0 = success). The library links its own CUDA
// runtime, so it selects the device itself.
extern "C" int ssim_fwd(const float* x, const float* y, float* out, int planes,
                        int height, int width, float c1, float c2, float w,
                        float w1, int blend, int device, void* stream) {
  if (planes == 0 || height == 0 || width == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int strips = (width + kOut - 1) / kOut;
  const int segments = (height + kSegment - 1) / kSegment;
  const dim3 grid((strips * segments + kWarps - 1) / kWarps, planes);
  const dim3 block(kWarps * 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blend) {
    ssim_fwd_kernel<true><<<grid, block, 0, s>>>(x, y, out, height, width, strips,
                                                 segments, c1, c2, w, w1);
  } else {
    ssim_fwd_kernel<false><<<grid, block, 0, s>>>(x, y, out, height, width, strips,
                                                  segments, c1, c2, w, w1);
  }
  return static_cast<int>(cudaGetLastError());
}
