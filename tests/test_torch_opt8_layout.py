"""A model of the 8-bit AdamW kernel's layout and arithmetic tricks, on the CPU.

The kernel (``src/repro_torch/kernels/csrc/adamw8bit.cu``) runs only on the
card. What surrounds its arithmetic is modelled here in Python, line for
line with the source, and checked:

- the walk: a persistent grid of 8-warp thread blocks, each warp taking
  units (a quantization block, or two rows of 16 lanes each where n <=
  128) a grid apart, a lane 8 elements of its unit: every element is
  covered once, no unit straddles a row or a block, and the slots that
  fall past a row are the reference's zero padding of that block;
- the arithmetic that replaces IEEE division, rintf and the int8
  conversions: a reciprocal rounded to nearest with one Markstein
  correction gives the IEEE quotient on the divisors and dividends the
  update meets
  (emulated exactly: an FMA in float64, with a midpoint rounded again
  from fractions), adding 1.5 * 2^23 rounds half to even, a code's float
  comes from its byte, and the ordered ints of redux.sync sort as floats.
"""

from fractions import Fraction

import numpy as np
import pytest

QBLOCK, PER_LANE, WARPS = 256, 8, 8
f32 = np.float32


# ------------------------------------------------------------------ the walk
def lanes_per_unit(n: int) -> int:
    return 16 if n <= QBLOCK // 2 else 32  # dispatch()


def n_units(rows: int, n: int) -> int:
    nblk = -(-n // QBLOCK)
    return (rows + 1) // 2 if n <= QBLOCK // 2 else rows * nblk  # repro_adamw8bit_update


def walk(rows: int, n: int, vec: bool, resident: int):
    """Yield (block, warp, lane, iteration, slot, row, b, col) for every
    slot the kernel's lanes visit: first_unit, advance and col_of of
    adamw8bit.cu, with the grid launch() gives."""
    lanes = lanes_per_unit(n)
    nblk = -(-n // QBLOCK)
    units = n_units(rows, n)
    grid = min(-(-units // WARPS), resident)
    stride = grid * WARPS
    for block in range(grid):
        for warp in range(WARPS):
            for lane in range(32):
                sub = lane % lanes
                unit = block * WARPS + warp
                if lanes == 32:
                    row, b = unit // nblk, unit % nblk
                else:
                    row, b = 2 * unit + (lane >> 4), 0
                it = 0
                while unit < units:
                    for k in range(PER_LANE):
                        col = b * QBLOCK + (sub * PER_LANE + k if vec else sub + lanes * k)
                        yield block, warp, lane, it, k, row, b, col
                    unit += stride
                    if lanes == 32:
                        row += stride // nblk
                        b += stride % nblk
                        if b >= nblk:
                            b -= nblk
                            row += 1
                    else:
                        row += 2 * stride
                    it += 1


LEAVES = [  # (rows, n, vec): yi-6b's trailing dims and the kernel's edges
    (6, 128, True), (3, 128, True), (5, 64, True), (7, 100, False), (1, 77, False),
    (4, 136, True), (5, 300, False), (3, 4096, True), (2, 11008, True), (3, 520, True),
]


@pytest.mark.parametrize("resident", [1, 3, 396])
@pytest.mark.parametrize("rows,n,vec", LEAVES)
def test_walk_covers_every_element_once_and_pads_as_the_reference(rows, n, vec, resident):
    lanes = lanes_per_unit(n)
    seen = {}
    units = {}  # (block, warp, iteration, segment) -> the (row, b) of its slots
    past = {}  # (row, b) -> columns of slots past the row
    for block, warp, lane, it, k, row, b, col in walk(rows, n, vec, resident):
        seg = (block, warp, it, lane // lanes)
        units.setdefault(seg, set()).add((row, b))
        if row >= rows:  # the empty half of an odd last pair: nothing is read or written
            assert lanes == 16 and rows % 2 == 1 and row == rows
            continue
        assert b * QBLOCK <= col < (b + 1) * QBLOCK  # inside its block
        if col < n:
            assert (row, col) not in seen, (row, col)
            seen[(row, col)] = (block, warp, lane, it, k)
        else:
            past.setdefault((row, b), set()).add(col)
    assert len(seen) == rows * n
    assert all(len(rb) == 1 for rb in units.values())  # a unit lies in one row and one block
    npad = -(-n // QBLOCK) * QBLOCK
    for row in range(rows):
        for b in range(npad // QBLOCK):
            lo, hi = b * QBLOCK, min((b + 1) * QBLOCK, npad)
            reach = set(range(lo, lo + lanes * PER_LANE))
            padded = set(range(max(lo, n), hi))  # the reference's zero padding of this block
            assert past.get((row, b), set()) == padded & reach
            # columns no lane reaches are padding, entered as log2(1e-16) (16 lanes a unit)
            assert set(range(lo, hi)) - reach <= padded
            if reach != set(range(lo, hi)):
                assert lanes == 16 and n <= QBLOCK // 2


@pytest.mark.parametrize("vec", [True, False])
def test_walk_segments_read_neighbouring_addresses(vec):
    """VEC: a lane's 8 neighbouring elements (one 16-byte copy of bf16);
    else lane l takes l, l + 32, ...: each access of a warp one run."""
    rows, n = 2, 4096
    by_slot = {}
    for block, warp, lane, it, k, row, b, col in walk(rows, n, vec, 1):
        by_slot.setdefault((block, warp, it, k), []).append((lane, row * n + col))
    for slot, hits in by_slot.items():
        hits.sort()
        cols = [c for _, c in hits]
        if vec:
            assert cols == [cols[0] + PER_LANE * i for i in range(32)]
        else:
            assert cols == list(range(cols[0], cols[0] + 32))


# ------------------------------------------------------------- the arithmetic
def _round_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest f32, half to even."""
    f = f32(float(x))  # within an ulp; pick the nearest of it and its neighbours
    cands = [f, np.nextafter(f, f32(-np.inf)), np.nextafter(f, f32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x), int(np.asarray(c).view(np.uint32)) & 1))


def fma32(a, b, c):
    """RN_f32(a b + c), elementwise and exact: the product is exact in
    float64, the sum rounds once there; the f32 rounding of that can
    differ from one rounding only where it lands on an f32 midpoint,
    which is redone in fractions."""
    a, b, c = (np.asarray(x, f32) for x in (a, b, c))
    s = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
    r = s.astype(f32)
    lo = np.nextafter(r, f32(-np.inf)).astype(np.float64)
    hi = np.nextafter(r, f32(np.inf)).astype(np.float64)
    mid = (s == (r + lo) / 2) | (s == (r + hi) / 2)
    for i in np.flatnonzero(mid):
        r.flat[i] = _round_f32(Fraction(float(a.flat[i])) * Fraction(float(b.flat[i])) + Fraction(float(c.flat[i])))
    return r


def div_rcp(x, b):
    """adamw8bit.cu's div_rcp with r = __frcp_rn(b): q = x r, then
    q + (x - b q) r, each rounded once."""
    x, b = np.asarray(x, f32), np.asarray(b, f32)
    r = (f32(1) / b).astype(f32)
    q = (x * r).astype(f32)
    return fma32(fma32(-b, q, x), r, q)


def _dividends(rng, n, lo=-100, hi=100):
    """Magnitudes log-uniform over [2^lo, 2^hi], either sign."""
    return (np.exp2(rng.uniform(lo, hi, n)) * rng.choice([-1, 1], n)).astype(f32)


def test_hoisted_reciprocal_division_is_ieee_on_the_bias_corrections():
    """m / bc1 and v / bc2: bc = 1 - b^step for the betas in use and
    steps 1-20000, dividends anywhere in [2^-100, 2^100] (div_uniform's
    fast range)."""
    rng = np.random.default_rng(0)
    for beta in (0.9, 0.95, 0.99, 0.999):
        steps = rng.integers(1, 20001, 40000).astype(f32)
        bc = (f32(1) - f32(beta) ** steps).astype(f32)
        x = _dividends(rng, steps.size)
        assert np.array_equal(div_rcp(x, bc).view(np.uint32), (x / bc).astype(f32).view(np.uint32))


def test_reciprocal_division_is_ieee_on_the_update_quotient():
    """(m / bc1) / (sqrt(v / bc2) + eps) in the kernel's branch-free form:
    the reciprocal of each element's denominator rounded to nearest, then
    div_rcp, on the ranges the kernel's vote allows (a dividend in [2^-60,
    2^80], a denominator in [2^-27, 2^60]); the denominators include eps
    = 1e-8 plus tiny roots and exact powers of two."""
    rng = np.random.default_rng(5)
    n = 80000
    x = _dividends(rng, n, -60, 80)
    d = np.exp2(rng.uniform(-27, 60, n)).astype(f32)
    d[: n // 8] = (np.sqrt(np.exp2(rng.uniform(-100, -60, n // 8))) + 1e-8).astype(f32)
    d[n // 8: n // 4] = np.exp2(rng.integers(-27, 60, n // 8)).astype(f32)
    assert np.array_equal(div_rcp(x, d).view(np.uint32), (x / d).astype(f32).view(np.uint32))


def test_hoisted_reciprocal_division_is_ieee_on_the_block_scales():
    """m / safe (safe = absmax / 127 of the block) and (l - lo) / step
    (step = max(range / 254, 1e-8)): the IEEE quotient for dividends of at
    least a quarter of the divisor (where rounding to an integer can meet
    a half), and the same integer below that."""
    rng = np.random.default_rng(1)
    n = 60000
    amax = np.exp2(rng.uniform(-100, 100, n)).astype(f32)
    safe = (amax / f32(127)).astype(f32)
    m = (amax * rng.uniform(-1, 1, n).astype(f32)).astype(f32)
    span = rng.uniform(0, 180, n).astype(f32)
    step = np.maximum((span / f32(254)).astype(f32), f32(1e-8))
    d = (span * rng.uniform(0, 1, n).astype(f32)).astype(f32)
    # dividends near a half-integer multiple of the divisor, the hard case for rounding
    k = rng.integers(-127, 127, n).astype(f32) + f32(0.5)
    near = (k * safe).astype(f32)
    for x, b in ((m, safe), (d, step), (near, safe)):
        big = np.abs(x) >= b / 4
        got, want = div_rcp(x, b), (x / b).astype(f32)
        assert np.array_equal(got[big].view(np.uint32), want[big].view(np.uint32))
        assert np.array_equal(np.rint(got), np.rint(want))
    # dividends far below the divisor, down to the denormals: the integer is 0 either way
    tiny = _dividends(rng, n, -149, -101)
    assert not np.rint(div_rcp(tiny, np.full(n, f32(2.0 ** -100)))).any()


def test_adding_one_and_a_half_times_two_to_the_23_rounds_half_to_even():
    """fl(x + 1.5 * 2^23) - 1.5 * 2^23 = rint(x) on the clipped ranges, and
    the sum's low byte is the code (m: x in [-127, 127]; v: y in [0, 254],
    the byte plus 129 is the code y - 127)."""
    magic = f32(12582912.0)
    x = np.concatenate([np.arange(-127, 127.5, 0.5), np.random.default_rng(2).uniform(-127, 127, 20000)]).astype(f32)
    s = (x + magic).astype(f32)
    assert np.array_equal((s - magic).astype(f32), np.rint(x).astype(f32))
    assert np.array_equal((s.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8), np.rint(x).astype(np.int8))
    y = np.concatenate([np.arange(0, 254.5, 0.5), np.random.default_rng(3).uniform(0, 254, 20000)]).astype(f32)
    vb = ((y + magic).astype(f32).view(np.uint32) + np.uint32(129)) & 0xFF
    assert np.array_equal(vb.astype(np.uint8).view(np.int8), (np.rint(y) - 127).astype(np.int8))


def test_a_code_becomes_its_float_through_its_byte():
    """code_f32: the byte flipped to c + 128 under the exponent of 2^23,
    less 2^23 + 128 (m), or less 2^23 + 1 (v: c + 127), exactly."""
    c = np.arange(-128, 128, dtype=np.int32)
    u = (c.astype(np.int8).view(np.uint8) ^ 0x80).astype(np.uint32)
    f = (u | np.uint32(0x4B000000)).view(f32)
    assert np.array_equal((f - f32(8388736.0)).astype(f32), c.astype(f32))
    assert np.array_equal((f - f32(8388609.0)).astype(f32), (c + 127).astype(f32))


def test_ordered_ints_sort_as_the_floats():
    """ordered() of adamw8bit.cu: the max and min of redux.sync on the
    ints are the floats' max and min, and unordered() inverts it."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.standard_normal(5000) * 60, [-53.15, 0.0, 1e-30, -1e-30, 128.0]]).astype(f32)
    i = x.view(np.int32)
    o = i ^ ((i >> 31) & 0x7FFFFFFF)
    assert np.array_equal(np.argsort(o, kind="stable"), np.argsort(x, kind="stable"))
    back = (o ^ ((o >> 31) & 0x7FFFFFFF)).view(f32)
    assert np.array_equal(back.view(np.int32), i)
    for chunk in np.split(x[:5000], 50):
        oc = chunk.view(np.int32) ^ ((chunk.view(np.int32) >> 31) & 0x7FFFFFFF)
        assert chunk[np.argmax(oc)] == chunk.max() and chunk[np.argmin(oc)] == chunk.min()
