// x / 3 in binary32, correctly rounded (the bits of an IEEE division by
// 3.0f), without the multi-instruction div.rn sequence: a reciprocal
// multiply and one Markstein correction,
//
//   q  = RN(x * R3)             R3 = RN(1/3) = 0x3eaaaaab
//   r  = RN(3 q - x)            exact: one fused multiply-add
//   q' = RN(q - r * R3)         one fused multiply-add
//
// q is within an ulp of x/3, so the residual 3q - x is a small multiple of
// q's ulp (or of 2^-149) and the first FMA computes it exactly; the second
// rounds q + (x - 3q) R3 once, and the error of R3 cannot move that value
// across a rounding boundary of x/3. The residual is taken as 3q - x (not
// x - 3q) so that both zeros keep their sign: -0 gives r = +0 and
// q' = -0 + -0 = -0. At x = +-inf the residual is inf - inf = NaN; there
// q = RN(x * R3) is itself exact, so the helper selects q where |x| is not
// finite (NaN stays NaN either way). No IEEE division is needed anywhere.
//
// chip_smoke.py's div3 phase compares this helper with the IEEE division
// over all 2^32 bit patterns on the card (0 mismatches, NaN by class);
// tests/test_torch_numerics.py replays the sequence in exact rational
// arithmetic on the CPU.
//
// Compile with --fmad=false: the FMAs here are explicit, and no other
// multiply-add in a caller may be contracted.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float div3(float x) {
  const float kR3 = __uint_as_float(0x3eaaaaabu);
  const float q = x * kR3;
  const float r = __fmaf_rn(q, 3.0f, -x);
  const float corrected = __fmaf_rn(-r, kR3, q);
  return fabsf(x) < __uint_as_float(0x7f800000u) ? corrected : q;
}
