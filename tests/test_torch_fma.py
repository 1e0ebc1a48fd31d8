"""The port's XLA:CPU rounding primitives (``patchworkpp_tpu_torch.ops``).

``ops.fma`` is a correctly rounded float32 fused multiply-add built from
float64 tensor ops; it is held here against exact rational arithmetic
(``fractions.Fraction``) on seeded triples, on exact ties and on sums that
fall a hair beside a float32 midpoint (where rounding the float64 sum
directly would round twice). ``ops.sq_sum`` and ``ops.plane_dist`` are the
contractions XLA:CPU makes of ``x*x + y*y`` and ``((x*a + y*b) + z*c) + d``,
and ``ops.row_sum`` is XLA:CPU's order for a 128-lane sum; each must give
the jitted JAX expression's bits.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from patchworkpp_tpu_torch.ops import fma, plane_dist, row_sum, sq_sum


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest to q, ties to even (finite, in range)."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - q),
                                     int(np.array(x).view(np.int32)) & 1))


def _triples(case: str, n: int = 3000):
    rng = np.random.default_rng({"random": 1, "cancel": 2, "ties": 3}[case])
    if case == "ties":
        # a*b exactly halfway between two float32 values, c = 0 (a true tie)
        # or +-2^-60 * a*b (a hair beside it: rounding the float64 sum
        # directly lands on the midpoint and rounds to even)
        k = rng.integers(1, 2048, n)
        m = rng.integers(1, 2048, n)
        a = (1.0 + k * 2.0**-12) * 2.0 ** rng.integers(-20, 20, n)
        b = (1.0 + m * 2.0**-12) * 2.0 ** rng.integers(-20, 20, n)
        ab = a * b
        c = np.where(rng.uniform(size=n) < 0.3, 0.0,
                     ab * 2.0**-60 * rng.choice([-1.0, 1.0], n))
        return a.astype(np.float32), b.astype(np.float32), c.astype(np.float32)
    a = (rng.normal(size=n) * np.exp(rng.uniform(-30, 30, n))).astype(np.float32)
    b = (rng.normal(size=n) * np.exp(rng.uniform(-30, 30, n))).astype(np.float32)
    if case == "cancel":  # c within a few ulp of -a*b
        c = -(a.astype(np.float64) * b) * (1.0 + rng.normal(size=n) * 1e-6)
    else:
        c = rng.normal(size=n) * np.exp(rng.uniform(-30, 30, n))
    return a, b, c.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "cancel", "ties"])
def test_fma_matches_exact_rational(case):
    a, b, c = _triples(case)
    got = fma(*map(torch.from_numpy, (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # separate rounding would differ somewhere: the cases do test the fusion
    assert (got != (a * b + c)).any()


def test_sq_sum_and_plane_dist_match_xla_contraction():
    rng = np.random.default_rng(7)
    x, y, z, nx, ny, nz, d = (
        (rng.normal(size=65536) * s).astype(np.float32)
        for s in (30.0, 30.0, 2.0, 0.3, 0.3, 1.0, 2.0)
    )
    want = np.asarray(jax.jit(lambda u, v: u * u + v * v)(x, y))
    np.testing.assert_array_equal(sq_sum(torch.from_numpy(x), torch.from_numpy(y)).numpy(), want)
    want = np.asarray(jax.jit(lambda *t: ((t[0] * t[3] + t[1] * t[4]) + t[2] * t[5]) + t[6])(
        x, y, z, nx, ny, nz, d))
    got = plane_dist(*map(torch.from_numpy, (x, y, z, nx, ny, nz, d))).numpy()
    np.testing.assert_array_equal(got, want)


def test_row_sum_matches_xla_row_sum():
    """A tile's 128-lane sum as the JAX package's jnp.sum(axis=1) rounds it
    (and not as a pairwise tree does)."""
    rng = np.random.default_rng(9)
    v = (rng.normal(size=(1532, 128)) * np.exp(rng.uniform(-8, 8, (1532, 1)))
         * (rng.uniform(size=(1532, 128)) < 0.7)).astype(np.float32)
    want = np.asarray(jax.jit(lambda t: jnp.sum(t, axis=1))(v))
    got = row_sum(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != v.sum(axis=1, dtype=np.float32)).any()
