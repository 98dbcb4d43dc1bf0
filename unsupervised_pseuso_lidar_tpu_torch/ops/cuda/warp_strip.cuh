// Helpers of the warp-strip kernels B (ssim.cu) and C (ssim_bwd.cu): a warp
// owns a strip of adjacent columns of one plane, kCols columns a lane, and
// walks down the rows; neighbours across the strip come by warp shuffle,
// rows down it sit in rings of registers.

#pragma once

#include <cuda_runtime.h>

namespace warp_strip {

constexpr unsigned kFullMask = 0xffffffffu;

// REFLECT padding index: -1 -> 1, n -> n-2; a size-1 dimension repeats its
// only entry, and halo entries that no valid output reads are clamped
__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

// the values of the columns left and right of each of this lane's kCols
// columns (lanes 0 and 31 get their own value for the missing side: they
// are halo lanes, whose results no output reads)
template <int kCols>
__device__ __forceinline__ void neighbours(const float (&v)[kCols], float (&left)[kCols],
                                           float (&right)[kCols]) {
  const float from_left = __shfl_up_sync(kFullMask, v[kCols - 1], 1);
  const float from_right = __shfl_down_sync(kFullMask, v[0], 1);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    left[j] = j == 0 ? from_left : v[j - 1];
    right[j] = j == kCols - 1 ? from_right : v[j + 1];
  }
}

// a ring phase as a type: the ring slot of the newest row, so that a row
// step's slots are compile-time constants and a step moves no register
template <int N>
struct Phase {
  static constexpr int value = N;
};

}  // namespace warp_strip
