"""The division by 3 of kernels B and C (ops/cuda/div3.cuh), replayed on the
CPU in exact arithmetic.

The helper computes x / 3 as q = RN(x·R3), r = RN(3q − x) (one FMA, exact),
q' = RN(q − r·R3) (one FMA), with R3 = RN(1/3), and returns q where |x| is
not finite. The kernels rely on it giving the bits of the IEEE division
x / 3.0f — what the plain versions compute through utils/numerics.div — for
every input. There is no card here, so these tests replay each rounding
step with Fractions (round to nearest even to binary32, subnormals and
signed zeros written out, not through Python floats), and one binade
exhaustively in integer arithmetic. chip_smoke.py checks the compiled
helper over all 2^32 bit patterns on the card.
"""

from fractions import Fraction

import numpy as np
import torch

from unsupervised_pseuso_lidar_tpu_torch.ops.cuda import kernels
from unsupervised_pseuso_lidar_tpu_torch.utils.numerics import div

torch.set_num_threads(1)

R3_BITS = 0x3EAAAAAB
MIN_EXP = -126  # binary32: normal exponents -126..127, 23 fraction bits
MAX_FINITE = Fraction(2**24 - 1) * Fraction(2) ** 104
INF = "inf"
NAN = "nan"


def rn(value: Fraction, neg_if_zero: bool):
    """Round an exact value to binary32, to nearest even: (magnitude or
    INF, negative?). A nonzero value that rounds to 0 keeps its sign; an
    exact zero takes neg_if_zero (IEEE's rule for sums)."""
    neg = value < 0 if value != 0 else neg_if_zero
    mag = abs(value)
    if mag == 0:
        return Fraction(0), neg
    exp = mag.numerator.bit_length() - mag.denominator.bit_length()
    if Fraction(2) ** exp > mag:
        exp -= 1
    ulp = Fraction(2) ** (max(exp, MIN_EXP) - 23)
    units = mag / ulp
    whole = units.numerator // units.denominator
    rest = units - whole
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and whole % 2 == 1):
        whole += 1
    mag = whole * ulp
    return (INF if mag > MAX_FINITE else mag), neg


def decode(bits: int):
    """binary32 bits -> (magnitude Fraction, INF or NAN, negative?)."""
    neg = bool(bits >> 31)
    exp = (bits >> 23) & 0xFF
    frac = bits & 0x7FFFFF
    if exp == 0xFF:
        return (NAN if frac else INF), neg
    if exp == 0:
        return Fraction(frac) * Fraction(2) ** (MIN_EXP - 23), neg
    return Fraction(frac | 1 << 23) * Fraction(2) ** (exp - 127 - 23), neg


def signed(mag, neg):
    return -mag if neg else mag


def fma(a, b, c):
    """RN(a·b + c) of (magnitude, negative?) operands, computed exactly."""
    prod = signed(a[0], a[1]) * signed(b[0], b[1])
    total = prod + signed(c[0], c[1])
    # an exact zero sum: -0 only when both addends are -0
    return rn(total, (a[1] != b[1]) and c[1] and prod == 0 and c[0] == 0)


def sequence(bits: int):
    """The helper's three roundings without its select: q = RN(x·R3),
    r = RN(3q - x), q' = RN(q - r·R3)."""
    x = decode(bits)
    if x[0] == NAN:
        return x
    if x[0] == INF:
        # q = ±inf; 3q - x adds infinities of opposite signs: NaN
        return NAN, False
    r3 = decode(R3_BITS)
    q = rn(signed(x[0], x[1]) * r3[0], x[1])
    r = fma(q, (Fraction(3), False), (x[0], not x[1]))
    return fma((r[0], not r[1]), r3, q)


def helper(bits: int):
    """The div3 helper of ops/cuda/div3.cuh: the sequence where |x| < inf,
    else q = RN(x·R3), which is x itself (±inf, NaN)."""
    x = decode(bits)
    return sequence(bits) if x[0] not in (INF, NAN) else x


def ieee_div3(bits: int):
    x = decode(bits)
    if x[0] in (INF, NAN):
        return x
    return rn(signed(x[0], x[1]) / 3, x[1])


def samples(n_per_binade=70, seed=0):
    """~20,000 bit patterns: every binade of both signs (subnormals as one
    binade per exponent bit), each binade's edges, ±0, the subnormal and
    normal limits, FLT_MAX, ±inf and a NaN."""
    rng = np.random.default_rng(seed)
    out = set()
    for sign in (0, 1 << 31):
        for exp in range(0, 255):
            base = sign | exp << 23
            out.update(base | int(m) for m in rng.integers(0, 1 << 23, n_per_binade // 2))
            out.update((base, base | 0x7FFFFF, base | 1, base | 0x400000))
        for bit in range(23):  # subnormals: one binade per leading bit
            lo = 1 << bit
            out.update(sign | int(m) for m in rng.integers(lo, 2 * lo, 8))
            out.update((sign | lo, sign | (2 * lo - 1)))
        out.update((sign | 0x7F800000, sign | 0x7F7FFFFF))
    out.add(0x7FC00000)
    return sorted(out)


def test_helper_is_the_ieee_division_on_every_sampled_binade():
    bits = samples()
    assert len(bits) > 19_000
    bad = [hex(b) for b in bits if helper(b) != ieee_div3(b)]
    assert not bad, bad[:10]


def test_the_select_is_needed_only_at_infinity():
    """The sequence alone is exact for every finite x, subnormals and both
    zeros included, and fails only at ±inf, where inf - inf makes the
    residual NaN: the range of the helper's predicate |x| < inf."""
    for bits in samples(n_per_binade=6, seed=1):
        x = decode(bits)
        if x[0] == INF:
            assert sequence(bits)[0] == NAN and helper(bits) == ieee_div3(bits) == x
        elif x[0] != NAN:
            assert sequence(bits) == ieee_div3(bits), hex(bits)


def test_residual_orientation_keeps_the_sign_of_zero():
    # x - 3q instead of 3q - x would turn -0 into +0: -0 - (-0) = +0, and
    # RN(-0 + (+0)·R3) = +0
    neg_zero = 0x80000000
    assert helper(neg_zero) == (Fraction(0), True) == ieee_div3(neg_zero)
    q = (Fraction(0), True)
    e = fma((Fraction(3), True), q, (Fraction(0), True))  # -3q + x
    assert fma(e, decode(R3_BITS), q) == (Fraction(0), False)


def _round_units(n: np.ndarray, shift: int) -> np.ndarray:
    """n / 2^shift rounded to nearest even, n >= 0 (int64)."""
    whole = n >> shift
    rest = n - (whole << shift)
    half = 1 << (shift - 1)
    return whole + ((rest > half) | ((rest == half) & (whole & 1 == 1)))


def test_helper_is_exact_on_a_whole_binade():
    """All 2^23 x in [1, 2), in integer arithmetic (units of 2^-25 for q,
    whose binade is [1/4, 1/2) or [1/2, 1)). Scaling x by a power of two
    scales every step alike while nothing is subnormal or infinite, so
    this covers every binade whose quotient and residual are normal."""
    big_x = np.arange(1 << 23, 1 << 24, dtype=np.int64)  # x = X·2^-23
    r3 = 11184811  # R3 = r3·2^-25
    prod = big_x * r3  # x·R3 = prod·2^-48
    q = np.where(prod >= 1 << 47, 2 * _round_units(prod, 24), _round_units(prod, 23))
    resid = 3 * q - 4 * big_x  # 3q - x in units of 2^-25, exact
    assert np.abs(resid).max() <= 4
    exact = (q << 25) - resid * r3  # q - r·R3 in units of 2^-50
    got = np.where(exact >= 1 << 49, 2 * _round_units(exact, 26), _round_units(exact, 25))
    # RN(x/3): x/3 = 4X/3 units of 2^-25; no ties, (n + 1) // 3 rounds n/3
    want = np.where(4 * big_x >= 3 << 24, 2 * ((2 * big_x + 1) // 3), (4 * big_x + 1) // 3)
    np.testing.assert_array_equal(got, want)


def encode(mag, neg) -> int:
    sign = 1 << 31 if neg else 0
    if mag == INF:
        return sign | 0x7F800000
    if mag < Fraction(2) ** MIN_EXP:
        return sign | int(mag / Fraction(2) ** (MIN_EXP - 23))
    exp = mag.numerator.bit_length() - mag.denominator.bit_length()
    if Fraction(2) ** exp > mag:
        exp -= 1
    return sign | (exp + 127) << 23 | int(mag / Fraction(2) ** (exp - 23)) - (1 << 23)


def test_div3_wrapper_on_the_cpu_is_the_modelled_division():
    """On CPU tensors the wrapper runs the plain version, the IEEE division
    of utils/numerics.div; its bits are the model's RN(x/3)."""
    bits = [b for b in samples(n_per_binade=4, seed=2) if decode(b)[0] != NAN]
    x = torch.from_numpy(np.array(bits, dtype=np.uint32).view(np.float32))
    got = kernels.div3(x)
    assert torch.equal(got.view(torch.int32), div(x, 3.0).view(torch.int32))
    want = np.array([encode(*ieee_div3(b)) for b in bits], dtype=np.uint32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
