// Kernel C: the gradient of kernel B's per-pixel photometric map
// w * clamp((1 - SSIM(x, y)) / 2, 0, 1) + w1 * |y - x| (the L1 term only
// when blend != 0) w.r.t. x and/or y, given its cotangent g.
//
// Replaces the TPU kernel unsupervised_pseuso_lidar_tpu/ops/pallas/photometric.py
// (ssim_bwd_pallas :214 -> pallas_call :235, kernel body _ssim_bwd_kernel
// :169), and fuses the L1 term of the blend, which the JAX package
// differentiates outside its kernel.
//
// dx at a pixel reads the adjoint box of the g-derived planes (g_m1 or
// g_m2, g_d, 2 g_b) at +-1 pixel, and those planes are built from the five
// box moments, which read x and y at a further +-1. The TPU kernel holds a
// whole (H, W) plane in VMEM. Here each warp owns a strip of columns of one
// plane and walks down a segment of kSegment = 32 of its rows, one image
// row per step, with no shared memory and no block barrier:
//
//   * lane l holds column strip * kOut - 2 + l; the warp loads 32 columns
//     of x, y and g (REFLECT index for x, y at the border: -1 -> 1,
//     L -> L-2) and writes the middle kOut = 28, so the 2-column halo on
//     each side costs 1/7 of the loads (neighbouring warps' halos mostly
//     hit L2);
//   * the horizontal passes (the moments' row means, the W adjoint) take a
//     lane's neighbours with two warp shuffles per value;
//   * the vertical passes (the moments' column means, the H adjoint) run
//     down the lane's own column over rings of 3 rows in registers: row
//     means and x, y of rows i-2..i, g and the W adjoints of plane rows
//     i-3..i-1. A ring slot is the row mod 3, unrolled three steps at a
//     time, so a step moves no register.
//
// Step i loads x, y of row i (prefetched a step ahead), pushes the row
// means of row i, builds plane row i-1 (zero outside the image, as the
// adjoint's zero padding wants) and its W adjoint, and writes output row
// i-2. A segment of S output rows takes S + 4 steps (rows r0-2 .. r1+1);
// the first two only push row means, the next two write nothing. The
// reflect folds of the adjoint (g at 0 and L-1 also lands at 1 and L-2;
// both at 0 when L == 1) read a neighbour or the lane itself, so they need
// no further halo.
//
// The planes are only those the call needs: the kernel is instantiated for
// dx only (the main path: the target is data), dy only, or both — 3, 3 or
// 4 planes — and for blend on or off.
//
// Bound: bytes (x, y, g read and dx written: 16 B per element; 20 B with
// dy: 0.063 ms at the main path's [36, 3, 192, 640]) against the
// instructions a lane issues each row step for its one output: 16
// divisions by 3 at 4 instructions each, 4 IEEE divisions, 10 shuffles,
// the means, the SSIM terms and the output, with 4 of 32 lanes and 4 of
// 36 steps spent on the halo. The kernel is bound by instruction issue,
// at about 3x its bytes bound. 64 registers
// (launch bounds: 8 blocks of 128 threads an SM; uncapped it took 88 and
// ran 16 % slower); two columns a lane halved the halo but took 128-141
// registers and ran 45 % slower; segments of 24 to 64 rows were within
// 7 % of each other (ops/cuda/tune.py, PERF.md).
//
// Arithmetic mirrors ops/ssim.photometric_map_bwd op for op: box sums as
// (a + b + c) / 3, rows before columns; the adjoint as mean + fold / 3, W
// before H; products and the SSIM terms in the plain version's order. The
// file is compiled with --fmad=false, so no multiply-add is contracted.
// Every division by 3 goes through div3 (div3.cuh), which returns the bits
// of the IEEE division x / 3.0f — the plain version's utils/numerics.div —
// from a reciprocal multiply and an explicit FMA correction, for every
// input (chip_smoke.py checks all 2^32). The divisions by c·d, c and d
// stay IEEE divisions, as in the plain version. The SSIM ratio amplifies
// one-ulp differences in flat windows, so the order matters.
//
// Tie rules (the JAX ones): the clamp passes the cotangent only where
// 0 < raw < 1; d|z|/dz is +1 at z = y - x >= 0 and -1 below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "div3.cuh"
#include "warp_strip.cuh"

namespace {

using warp_strip::neighbours;
using warp_strip::Phase;
using warp_strip::reflect_index;

constexpr int kWarps = 4;          // warps per block, each its own strip
constexpr int kSegment = 32;       // output rows one warp walks
constexpr int kCols = 1;           // adjacent columns per lane
constexpr int kSpan = 32 * kCols;  // columns a warp loads
constexpr int kOut = kSpan - 4;    // columns it writes
constexpr int kMinBlocks = 8;      // blocks per SM: at most 64 registers a thread

template <bool kDx, bool kDy, bool kBlend>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    ssim_bwd_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                    const float* __restrict__ gs, float* __restrict__ dxs,
                    float* __restrict__ dys, int height, int width, int strips,
                    int segments, float c1, float c2, float w, float w1) {
  // plane slots: the m-plane of dx (g_m1) and/or of dy (g_m2), g_d, 2 g_b
  constexpr int kPlanes = (kDx && kDy) ? 4 : 3;
  constexpr int kM1 = 0;
  constexpr int kM2 = kDx ? 1 : 0;
  constexpr int kD = kPlanes - 2;
  constexpr int kB = kPlanes - 1;

  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= strips * segments) return;  // the whole warp: no shuffle waits on it
  const int strip = warp % strips;
  const int r0 = (warp / strips) * kSegment;
  const int r1 = min(r0 + kSegment, height);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * height * width;
  xs += base;
  ys += base;
  gs += base;
  if (kDx) dxs += base;
  if (kDy) dys += base;
  // 32-bit offsets inside the plane (the wrapper refuses H * W >= 2^31)

  const int lo_w = min(1, width - 1);
  const int hi_w = max(width - 2, 0);
  const int lo_h = min(1, height - 1);
  const int hi_h = max(height - 2, 0);
  int col[kCols], xcol[kCols], gcol[kCols];
  bool inside[kCols], writes[kCols];
  bool folds = false;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int k = lane * kCols + j;
    col[j] = strip * kOut - 2 + k;
    xcol[j] = reflect_index(col[j], width);
    gcol[j] = min(max(col[j], 0), width - 1);
    inside[j] = col[j] >= 0 && col[j] < width;
    writes[j] = inside[j] && k >= 2 && k < kSpan - 2;
    folds = folds || col[j] == lo_w || col[j] == hi_w;
  }
  // whether any column of this warp takes a W reflect fold (uniform)
  const bool warp_folds = __any_sync(warp_strip::kFullMask, folds);

  // rings of 3 rows in registers, indexed by row mod 3 so that a step
  // moves nothing: the row means and x, y of rows i-2..i, g of plane rows
  // i-3..i-1, and the W adjoints of plane rows i-3..i-1
  float hx[3][kCols], hy[3][kCols], hxx[3][kCols], hyy[3][kCols], hxy[3][kCols];
  float xv[3][kCols], yv[3][kCols], gv[3][kCols];
  float wa[3][kPlanes][kCols];

  auto load_xy = [&](int i, float (&x)[kCols], float (&y)[kCols]) {
    const int off = reflect_index(i, height) * width;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      x[j] = __ldg(xs + off + xcol[j]);
      y[j] = __ldg(ys + off + xcol[j]);
    }
  };
  auto load_g = [&](int p, float (&g)[kCols]) {
    const int off = min(max(p, 0), height - 1) * width;
#pragma unroll
    for (int j = 0; j < kCols; ++j) g[j] = __ldg(gs + off + gcol[j]);
  };

  // One row step. Phase P = (i - first row) mod 3 is the ring slot of row
  // i (and of plane row i-1); slots S0 and S1 hold the two rows before.
  float nx[kCols], ny[kCols], ng[kCols];  // the prefetched next row
  auto step = [&](auto phase, int i) {
    constexpr int P = decltype(phase)::value;
    constexpr int S0 = (P + 1) % 3;
    constexpr int S1 = (P + 2) % 3;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      xv[P][j] = nx[j];
      yv[P][j] = ny[j];
      gv[P][j] = ng[j];
    }
    load_xy(i + 1, nx, ny);
    load_g(i, ng);

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
    if (i < r0) return;  // rows r0-2, r0-1: row means only

    // plane row p = i-1 (the moments of rows p-1..p+1), then its W
    // adjoint: zero-padded mean + reflect folds
    const int p = i - 1;
    const bool row_in = p >= 0 && p < height;
    float pl[kPlanes][kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) pl[k][j] = 0.0f;
      if (row_in && inside[j]) {
        const float m1 = div3(hx[S0][j] + hx[S1][j] + hx[P][j]);
        const float m2 = div3(hy[S0][j] + hy[S1][j] + hy[P][j]);
        const float p1 = div3(hxx[S0][j] + hxx[S1][j] + hxx[P][j]);
        const float p2 = div3(hyy[S0][j] + hyy[S1][j] + hyy[P][j]);
        const float p3 = div3(hxy[S0][j] + hxy[S1][j] + hxy[P][j]);
        const float mu_xy = m1 * m2;
        const float a = 2.0f * mu_xy + c1;
        const float b = 2.0f * (p3 - mu_xy) + c2;
        const float cc = m1 * m1 + m2 * m2 + c1;
        const float d = p1 + p2 - m1 * m1 - m2 * m2 + c2;
        const float s = (a * b) / (cc * d);
        const float raw = (1.0f - s) * 0.5f;
        const float g_ssim = kBlend ? w * gv[P][j] : gv[P][j];
        const float g_s = ((raw > 0.0f && raw < 1.0f) ? g_ssim : 0.0f) * -0.5f;
        const float inv_cd = 1.0f / (cc * d);
        const float g_a = g_s * b * inv_cd;
        const float g_b = g_s * a * inv_cd;
        const float g_c = -g_s * s / cc;
        const float g_d = -g_s * s / d;
        const float g_ab = g_a - g_b;
        const float g_cd = g_c - g_d;
        if (kDx) pl[kM1][j] = 2.0f * (m2 * g_ab + m1 * g_cd);
        if (kDy) pl[kM2][j] = 2.0f * (m1 * g_ab + m2 * g_cd);
        pl[kD][j] = g_d;
        pl[kB][j] = 2.0f * g_b;
      }
    }
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      float l[kCols], r[kCols];
      neighbours(pl[k], l, r);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float v = div3(l[j] + pl[k][j] + r[j]);
        // + fold / 3; the fold is 0 but at columns lo_w and hi_w (v + 0
        // keeps the plain version's bits for v = -0)
        float t = v + 0.0f;
        if (warp_folds) {
          float f = 0.0f;
          if (col[j] == lo_w) f = f + (col[j] == 0 ? pl[k][j] : l[j]);
          if (col[j] == hi_w) f = f + (width == 1 ? pl[k][j] : r[j]);
          t = v + div3(f);
        }
        wa[P][k][j] = t;
      }
    }
    if (i < r0 + 2) return;  // no output row yet

    // output row o = i-2: the H adjoint of the W adjoints of rows
    // o-1..o+1, and the output combination with the L1 term
    const int o = i - 2;
    const bool fold_lo = o == lo_h;
    const bool fold_hi = o == hi_h;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float t[kPlanes];
#pragma unroll
      for (int k = 0; k < kPlanes; ++k) {
        const float v = div3(wa[S0][k][j] + wa[S1][k][j] + wa[P][k][j]);
        t[k] = v + 0.0f;
        if (fold_lo || fold_hi) {
          float f = 0.0f;
          if (fold_lo) f = f + (o == 0 ? wa[S1][k][j] : wa[S0][k][j]);
          if (fold_hi) f = f + (height == 1 ? wa[S1][k][j] : wa[P][k][j]);
          t[k] = v + div3(f);
        }
      }
      if (!writes[j]) continue;
      const float xo = xv[S0][j];
      const float yo = yv[S0][j];
      const int off = o * width + col[j];
      float g_z = 0.0f;
      if (kBlend) {
        const float g_l1 = w1 * gv[S1][j];
        g_z = (yo - xo >= 0.0f) ? g_l1 : -g_l1;
      }
      if (kDx) {
        float dx = t[kM1] + 2.0f * xo * t[kD] + yo * t[kB];
        if (kBlend) dx = dx - g_z;
        dxs[off] = dx;
      }
      if (kDy) {
        float dy = t[kM2] + 2.0f * yo * t[kD] + xo * t[kB];
        if (kBlend) dy = dy + g_z;
        dys[off] = dy;
      }
    }
  };

  // rows r0-2 .. r1+1, three steps per iteration so that the ring slots
  // are compile-time constants
  const int last = r1 + 1;
  int i = r0 - 2;
  load_xy(i, nx, ny);
  load_g(i - 1, ng);
  for (; i + 2 <= last; i += 3) {
    step(Phase<0>(), i);
    step(Phase<1>(), i + 1);
    step(Phase<2>(), i + 2);
  }
  if (i <= last) step(Phase<0>(), i);
  if (i + 1 <= last) step(Phase<1>(), i + 1);
}

template <bool kDx, bool kDy>
cudaError_t launch(const float* x, const float* y, const float* g, float* dx, float* dy,
                   int planes, int height, int width, float c1, float c2, float w,
                   float w1, int blend, cudaStream_t stream) {
  const int strips = (width + kOut - 1) / kOut;
  const int segments = (height + kSegment - 1) / kSegment;
  const dim3 grid((strips * segments + kWarps - 1) / kWarps, planes);
  const dim3 block(kWarps * 32);
  if (blend) {
    ssim_bwd_kernel<kDx, kDy, true><<<grid, block, 0, stream>>>(
        x, y, g, dx, dy, height, width, strips, segments, c1, c2, w, w1);
  } else {
    ssim_bwd_kernel<kDx, kDy, false><<<grid, block, 0, stream>>>(
        x, y, g, dx, dy, height, width, strips, segments, c1, c2, w, w1);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y, g: [planes, height, width] fp32 contiguous (an NCHW tensor is N*C
// planes) on CUDA device `device`, height * width < 2^31; dx, dy: like x,
// or null for a gradient not wanted (at least one is given). blend != 0
// differentiates w * ssim + w1 * |y - x|, else the SSIM distance alone.
// Launches on `stream` and returns the cudaError_t of the launch (0 =
// success). The library links its own CUDA runtime, so it selects the
// device itself.
extern "C" int ssim_bwd(const float* x, const float* y, const float* g, float* dx,
                        float* dy, int planes, int height, int width, float c1,
                        float c2, float w, float w1, int blend, int device,
                        void* stream) {
  if (planes == 0 || height == 0 || width == 0 || (dx == nullptr && dy == nullptr)) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dx != nullptr && dy != nullptr) {
    err = launch<true, true>(x, y, g, dx, dy, planes, height, width, c1, c2, w, w1, blend, s);
  } else if (dx != nullptr) {
    err = launch<true, false>(x, y, g, dx, dy, planes, height, width, c1, c2, w, w1, blend, s);
  } else {
    err = launch<false, true>(x, y, g, dx, dy, planes, height, width, c1, c2, w, w1, blend, s);
  }
  return static_cast<int>(err);
}
