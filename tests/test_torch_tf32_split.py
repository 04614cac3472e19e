"""Why the tensor-core backward kernels pay for three TF32 products.

``csrc/tile_mm.cuh`` (tf32x3) splits each f32 operand x into hi =
cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) and accumulates a_lo·b_hi +
a_hi·b_lo + a_hi·b_hi in f32.  Emulated here in numpy (round to nearest,
ties away from zero, to a 10-bit mantissa; products of two TF32 values are
exact in f32, sums in f32), at the depths the kernels take: K = 128 (a
layer's product over its 128 inputs) and K = 4096 (a weight gradient summed
over edges).  Against float64:

* the split product lies well inside ``chip_smoke.py``'s backward
  tolerances (``BWD_RTOL``, ``BWD_ATOL_REL``, ``BWD_L2``) and far inside the
  band of 1e-5 of a layer's RMS in which its relu-tie guard treats a
  pre-activation as a tie, as close to float64 as a plain f32 product;
* a single TF32 product does not: it leaves elements outside the
  elementwise bound and errors 100x the tie band.

The emulation is this test's, not code of the package.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import chip_smoke  # noqa: E402

TIE_BAND = 1e-5  # chip_smoke.tie_receivers: |z| < 1e-5 * RMS of the layer


def tf32(x):
    """cvt.rna.tf32.f32: the nearest value with a 10-bit mantissa, ties
    away from zero (f32 bits: add half of the dropped 13 bits' range to
    the magnitude, then clear them)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32((x - hi).astype(np.float32))


def three_products(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    acc = (al @ bh).astype(np.float32) + (ah @ bl).astype(np.float32)
    return (acc + ah @ bh).astype(np.float32)


def one_product(a, b):
    return (tf32(a) @ tf32(b)).astype(np.float32)


def operands(k, seed):
    """(a, b) for a product of depth k at the kernels' scales: k = 128,
    relu activations times a 0.3-scaled weight (a layer); k = 4096, an
    activation's transpose times a gradient over 4096 edges (a dW)."""
    rng = np.random.default_rng(seed)
    if k == 128:
        a = np.maximum(rng.standard_normal((2048, k)), 0) * 0.3
        b = rng.standard_normal((k, 128)) * 0.3
    else:
        a = np.maximum(rng.standard_normal((128, k)), 0)
        b = rng.standard_normal((k, 128)) * 1e-2
    return a.astype(np.float32), b.astype(np.float32)


def errors(got, want):
    err = np.abs(got.astype(np.float64) - want)
    top = np.abs(want).max()
    outside = err > chip_smoke.BWD_RTOL * np.abs(want) + (
        chip_smoke.BWD_ATOL_REL * top)
    return {"rel_l2": float(np.linalg.norm(err) / np.linalg.norm(want)),
            "n_outside": int(outside.sum()),
            "max_over_rms": float(err.max() / np.sqrt((want ** 2).mean()))}


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                  1 + 3 * 2.0 ** -12, 3.0], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one + ulp, -(one + ulp), one, one + ulp, 3.0],
                          np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_keeps_22_bits(seed):
    x = np.random.default_rng(seed).standard_normal(100_000).astype(np.float32)
    hi, lo = split(x)
    assert (tf32(hi) == hi).all() and (tf32(lo) == lo).all()
    rest = np.abs(x.astype(np.float64) - hi - lo)
    assert (rest <= 2.0 ** -21 * np.abs(x)).all()


@pytest.mark.parametrize("k", [128, 4096])
def test_three_tf32_products_lie_inside_the_backward_tolerances(k):
    a, b = operands(k, seed=k)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = errors(three_products(a, b), want)
    f32 = errors((a @ b).astype(np.float32), want)
    assert got["n_outside"] == 0, got
    assert got["rel_l2"] <= 1e-3 * chip_smoke.BWD_L2, got
    assert got["max_over_rms"] <= TIE_BAND / 4, got
    # as close to float64 as f32 itself
    assert got["rel_l2"] <= 3 * f32["rel_l2"], (got, f32)


@pytest.mark.parametrize("k", [128, 4096])
def test_one_tf32_product_does_not(k):
    a, b = operands(k, seed=k)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = errors(one_product(a, b), want)
    assert got["n_outside"] > 0, got
    assert got["max_over_rms"] > 10 * TIE_BAND, got
    assert got["rel_l2"] > chip_smoke.BWD_L2 / 10, got
