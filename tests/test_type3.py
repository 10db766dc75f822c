"""Type-3 NUFFT tests against the dense ``nudft_type3`` oracle.

The reference enumerates type-3 but never implements it
(cc/kernels/nufft_plan.cc:175-177), so there is no reference test to
mirror; the strategy follows the repo's type-1/2 oracle-sweep pattern
(tests/test_nufft.py) plus type-3-specific cases: arbitrary coordinate
ranges (no [-pi, pi] restriction), degenerate extents, plan reuse and
tolerance conformance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tensorflow_nufft_tpu as tfft
from tests.conftest import random_complex


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) or 1.0)


def _random_sets(rng, rank, m, k, dtype, x_span=(-3.0, 7.0),
                 t_span=(-20.0, 50.0)):
    x = rng.uniform(*x_span, (m, rank)).astype(dtype)
    t = rng.uniform(*t_span, (k, rank)).astype(dtype)
    return x, t


@pytest.mark.parametrize("rank", [1, 2, 3])
@pytest.mark.parametrize("fft_direction", ["forward", "backward"])
def test_type3_accuracy(rng, rank, fft_direction):
    tol = 1e-6
    x, t = _random_sets(rng, rank, 300, 250, np.float64)
    c = random_complex(rng, (300,), np.complex128)
    got = tfft.nufft_type3(c, x, t, fft_direction=fft_direction, tol=tol)
    want = tfft.nudft_type3(c, x, t, fft_direction=fft_direction)
    assert got.shape == (250,)
    assert _rel_err(got, want) <= 10 * tol


@pytest.mark.parametrize("tol", [1e-2, 1e-4, 1e-6, 1e-9, 1e-12])
def test_type3_tolerance_sweep(rng, tol):
    x, t = _random_sets(rng, 2, 400, 300, np.float64)
    c = random_complex(rng, (400,), np.complex128)
    got = tfft.nufft_type3(c, x, t, tol=tol)
    want = tfft.nudft_type3(c, x, t)
    assert _rel_err(got, want) <= 10 * tol


def test_type3_float32(rng):
    x, t = _random_sets(rng, 2, 300, 200, np.float32)
    c = random_complex(rng, (300,), np.complex64)
    got = tfft.nufft_type3(c, x, t, tol=1e-5)
    want = tfft.nudft_type3(
        c.astype(np.complex128), x.astype(np.float64),
        t.astype(np.float64))
    assert got.dtype == np.complex64
    # f32 floor: kernel evaluation + phase rounding.
    assert _rel_err(got, want) <= 1e-4


def test_type3_batched_strengths(rng):
    x, t = _random_sets(rng, 2, 200, 150, np.float64)
    c = random_complex(rng, (2, 3, 200), np.complex128)
    got = tfft.nufft_type3(c, x, t, tol=1e-8)
    want = tfft.nudft_type3(c, x, t)
    assert got.shape == (2, 3, 150)
    assert _rel_err(got, want) <= 1e-7


def test_type3_plan_reuse_and_jit(rng):
    x, t = _random_sets(rng, 1, 150, 120, np.float64)
    plan = tfft.Type3Plan(x, t, tol=1e-9)
    apply_jit = jax.jit(plan)
    for seed in (0, 1):
        c = random_complex(np.random.default_rng(seed), (150,),
                           np.complex128)
        want = tfft.nudft_type3(c, x, t)
        assert _rel_err(apply_jit(c), want) <= 1e-8
        assert _rel_err(plan(c), want) <= 1e-8


def test_type3_linearity_in_strengths(rng):
    x, t = _random_sets(rng, 2, 100, 80, np.float64)
    plan = tfft.Type3Plan(x, t, tol=1e-10)
    c1 = random_complex(rng, (100,), np.complex128)
    c2 = random_complex(rng, (100,), np.complex128)
    lhs = plan(2.5 * c1 + 1j * c2)
    rhs = 2.5 * plan(c1) + 1j * plan(c2)
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs),
                               rtol=1e-9, atol=1e-9)


def test_type3_gradient_wrt_source(rng):
    x, t = _random_sets(rng, 1, 60, 50, np.float64)
    plan = tfft.Type3Plan(x, t, tol=1e-10)
    ct = random_complex(rng, (50,), np.complex128)
    c = random_complex(rng, (60,), np.complex128)

    def loss(src, op):
        return jnp.real(jnp.vdot(ct, op(src)))

    g_fast = jax.grad(loss)(c, plan)
    g_ref = jax.grad(loss)(
        c, lambda s: tfft.nudft_type3(s, x, t))
    assert _rel_err(g_fast, g_ref) <= 1e-8


def test_type3_degenerate_extents(rng):
    # All source points identical (X = 0): f_k = exp(-i t_k.x0) * sum(c).
    t = rng.uniform(-5, 5, (40, 2))
    x = np.tile(np.array([[0.7, -1.3]]), (25, 1))
    c = random_complex(rng, (25,), np.complex128)
    got = tfft.nufft_type3(c, x, t, tol=1e-9)
    want = tfft.nudft_type3(c, x, t)
    assert _rel_err(got, want) <= 1e-8
    # All targets identical (S = 0).
    x2 = rng.uniform(-5, 5, (25, 2))
    t2 = np.tile(np.array([[2.0, 3.5]]), (40, 1))
    got2 = tfft.nufft_type3(c, x2, t2, tol=1e-9)
    want2 = tfft.nudft_type3(c, x2, t2)
    assert _rel_err(got2, want2) <= 1e-8


def test_type3_far_offset_ranges(rng):
    # Centering must handle point sets far from the origin.
    x = rng.uniform(1000.0, 1010.0, (200, 1))
    t = rng.uniform(-500.0, -480.0, (150, 1))
    c = random_complex(rng, (200,), np.complex128)
    got = tfft.nufft_type3(c, x, t, tol=1e-9)
    want = tfft.nudft_type3(c, x, t)
    assert _rel_err(got, want) <= 1e-8


def test_type3_matches_type2_on_integer_modes(rng):
    # With integer target frequencies and points in [-pi, pi), type-3
    # reduces to (the adjoint view of) type-2's dense definition.
    n = 16
    x = rng.uniform(-np.pi, np.pi, (100, 1))
    t = (np.arange(n) - n // 2).astype(np.float64)[:, None]
    c = random_complex(rng, (100,), np.complex128)
    got = tfft.nufft_type3(c, x, t, fft_direction="forward", tol=1e-10)
    want = tfft.nufft(c, x, grid_shape=(n,), transform_type="type_1",
                      fft_direction="forward", tol=1e-10)
    assert _rel_err(got, want) <= 1e-9


class TestType3Errors:
    def test_traced_points_raise(self, rng):
        x, t = _random_sets(rng, 1, 20, 20, np.float64)
        c = random_complex(rng, (20,), np.complex128)

        def f(xx):
            return tfft.nufft_type3(c, xx, t)

        with pytest.raises(ValueError, match="concrete"):
            jax.jit(f)(x)

    def test_rank_mismatch(self, rng):
        with pytest.raises(ValueError, match="rank"):
            tfft.Type3Plan(np.zeros((5, 2)), np.zeros((5, 3)))

    def test_bad_shapes(self):
        with pytest.raises(ValueError, match="shape"):
            tfft.Type3Plan(np.zeros((5,)), np.zeros((5, 1)))

    def test_dtype_mismatch(self):
        with pytest.raises(TypeError, match="dtype"):
            tfft.Type3Plan(np.zeros((5, 1), np.float32),
                           np.zeros((5, 1), np.float64))

    def test_source_dtype_checked(self, rng):
        x, t = _random_sets(rng, 1, 10, 10, np.float64)
        plan = tfft.Type3Plan(x, t)
        with pytest.raises(TypeError, match="complex128"):
            plan(np.zeros((10,), np.complex64))

    def test_source_points_count(self, rng):
        x, t = _random_sets(rng, 1, 10, 10, np.float64)
        plan = tfft.Type3Plan(x, t)
        with pytest.raises(ValueError, match="shape"):
            plan(np.zeros((11,), np.complex128))

    def test_nufft_type3_redirects(self, rng):
        x = np.zeros((4, 1), np.float32)
        c = np.zeros((4,), np.complex64)
        with pytest.raises(NotImplementedError, match="nufft_type3"):
            tfft.nufft(c, x, grid_shape=(8,), transform_type="type_3")

    def test_bad_direction(self):
        with pytest.raises(ValueError, match="fft_direction"):
            tfft.Type3Plan(np.zeros((5, 1)), np.zeros((5, 1)),
                           fft_direction="sideways")


# ---------------------------------------------------------------------------
# Planar type-3.
# ---------------------------------------------------------------------------


from tensorflow_nufft_tpu.planar import from_planar, to_planar


def test_planar_type3_accuracy(rng):
    x, t = _random_sets(rng, 2, 300, 250, np.float32)
    c = random_complex(rng, (300,), np.complex64)
    got = tfft.planar.nufft_type3(to_planar(c)[None], x, t, tol=1e-5)
    want = tfft.nudft_type3(c.astype(np.complex128),
                            x.astype(np.float64), t.astype(np.float64))
    assert got.shape == (1, 250, 2)
    assert _rel_err(from_planar(got[0]), want) <= 1e-4


@pytest.mark.parametrize("rank", [1, 3])
def test_planar_type3_ranks(rng, rank):
    x, t = _random_sets(rng, rank, 200, 150, np.float32)
    c = random_complex(rng, (2, 200), np.complex64)
    plan = tfft.planar.Type3Plan(x, t, fft_direction="backward",
                                 tol=1e-5)
    got = plan(to_planar(c))
    want = tfft.nudft_type3(c.astype(np.complex128),
                            x.astype(np.float64), t.astype(np.float64),
                            fft_direction="backward")
    assert _rel_err(from_planar(got), want) <= 1e-4


def test_planar_type3_matches_complex_path(rng):
    x, t = _random_sets(rng, 2, 150, 120, np.float32)
    c = random_complex(rng, (150,), np.complex64)
    got_p = tfft.planar.nufft_type3(to_planar(c)[None], x, t, tol=1e-5)
    got_c = tfft.nufft_type3(c, x, t, tol=1e-5)
    assert _rel_err(from_planar(got_p[0]), np.asarray(got_c)) <= 2e-5


def test_planar_type3_adjoint_consistency(rng):
    # <A c, f> == <c, A^H f> (complex inner products via planar parts).
    x, t = _random_sets(rng, 2, 100, 80, np.float32)
    plan = tfft.planar.Type3Plan(x, t, tol=1e-6)
    c = random_complex(rng, (100,), np.complex64)
    f = random_complex(rng, (80,), np.complex64)
    ac = from_planar(plan(to_planar(c)[None])[0])
    ahf = from_planar(plan.adjoint()(to_planar(f)[None])[0])
    lhs = np.vdot(np.asarray(f), ac)
    rhs = np.vdot(ahf, np.asarray(c))
    # The adjoint plan is an independent discretization; agreement is
    # bounded by the two plans' accuracy (f32 floor ~1e-5, not exact).
    assert abs(lhs - rhs) / abs(lhs) <= 1e-4


def test_planar_type3_grad(rng):
    x, t = _random_sets(rng, 1, 60, 50, np.float32)
    plan = tfft.planar.Type3Plan(x, t, tol=1e-6)
    ct = to_planar(random_complex(rng, (50,), np.complex64))[None]
    c = to_planar(random_complex(rng, (60,), np.complex64))[None]

    def loss(src):
        return jnp.sum(plan(src) * ct)

    g = jax.grad(loss)(jnp.asarray(c))
    # Finite-difference check along a few random directions.
    v = np.asarray(to_planar(random_complex(
        np.random.default_rng(3), (60,), np.complex64)))[None]
    eps = 1e-3
    fd = (loss(c + eps * v) - loss(c - eps * v)) / (2 * eps)
    an = jnp.sum(g * v)
    assert abs(float(fd) - float(an)) / max(abs(float(fd)), 1e-12) <= 1e-2


def test_planar_type3_errors(rng):
    x, t = _random_sets(rng, 1, 20, 20, np.float32)
    plan = tfft.planar.Type3Plan(x, t)
    with pytest.raises(ValueError, match="shape"):
        plan(np.zeros((20, 2), np.float32))          # missing batch dim
    with pytest.raises(TypeError, match="float32"):
        tfft.planar.Type3Plan(x.astype(np.float64),
                              t.astype(np.float64))


@pytest.mark.parametrize("rank", [2, 3])
def test_planar_type3_pallas_spread_path(rng, rank):
    # Force the planned spread-kernel branch (interpreted on CPU) and
    # check it against the XLA-spread branch.
    x, t = _random_sets(rng, rank, 300, 200, np.float32)
    c = to_planar(random_complex(rng, (300,), np.complex64))[None]
    plan_p = tfft.planar.Type3Plan(
        x, t, tol=1e-5, options=tfft.Options(backend="pallas"))
    assert plan_p._spread_planned
    plan_x = tfft.planar.Type3Plan(
        x, t, tol=1e-5, options=tfft.Options(backend="xla"))
    assert not plan_x._spread_planned
    got_p = np.asarray(plan_p(c))
    got_x = np.asarray(plan_x(c))
    np.testing.assert_allclose(got_p, got_x, rtol=1e-5,
                               atol=1e-5 * np.abs(got_x).max())


def test_type3_f32_tol_below_floor_clamps(rng):
    # Regression: tolerances below the f32 floor must clamp consistently
    # between the statics (geometry + kernel-FT deconvolution) and the
    # spread/inner-t2 plans. A width mismatch silently deconvolved with
    # the wrong kernel (planar) or crashed at construction (complex).
    x, t = _random_sets(rng, 2, 200, 150, np.float32)
    c = random_complex(rng, (200,), np.complex64)
    got = tfft.nufft_type3(c, x, t, tol=1e-9)     # clamps to ~6e-8
    want = tfft.nudft_type3(
        c.astype(np.complex128), x.astype(np.float64),
        t.astype(np.float64))
    assert _rel_err(got, want) <= 1e-4

    plan_p = tfft.planar.Type3Plan(x, t, tol=1e-9)
    got_p = plan_p(to_planar(c)[None])
    assert _rel_err(from_planar(got_p[0]), want) <= 1e-4


def test_type3_empty_point_sets_raise():
    with pytest.raises(ValueError, match="non-empty"):
        tfft.Type3Plan(np.zeros((0, 2)), np.zeros((5, 2)))
    with pytest.raises(ValueError, match="non-empty"):
        tfft.Type3Plan(np.zeros((5, 2)), np.zeros((0, 2)))


def test_type3_adversarial_geometries(rng):
    # Outlier-dominated extent: one far point inflates X; centering and
    # the nf margin must still hold (no kernel wrap, error within tol).
    x = np.concatenate([rng.uniform(-1, 1, (150, 2)),
                        np.array([[90.0, -75.0]])])
    t = rng.uniform(-3, 3, (100, 2))
    c = random_complex(rng, (151,), np.complex128)
    got = tfft.nufft_type3(c, x, t, tol=1e-9)
    want = tfft.nudft_type3(c, x, t)
    assert _rel_err(got, want) <= 1e-8

    # Log-spaced one-sided frequencies (heavily skewed centering).
    t2 = np.stack([np.logspace(-2, 1.5, 80),
                   np.logspace(-1, 1.2, 80)], axis=-1)
    x2 = rng.uniform(-2, 2, (120, 2))
    c2 = random_complex(rng, (120,), np.complex128)
    got2 = tfft.nufft_type3(c2, x2, t2, tol=1e-9)
    want2 = tfft.nudft_type3(c2, x2, t2)
    assert _rel_err(got2, want2) <= 1e-8


def test_type3_degenerate_x_grid_stays_small(rng):
    # Regression: a zero-extent points dim with a wide frequency extent
    # must follow the X_safe = 1/S rule — the grid must NOT scale with
    # the frequency extent (it used to inflate to ~2*sigma*S/pi).
    x = np.zeros((100, 1))
    t = rng.uniform(-4000.0, 4000.0, (50, 1))
    plan = tfft.Type3Plan(x, t, tol=1e-9)
    assert plan.fine_shape[0] <= 64
    c = random_complex(rng, (100,), np.complex128)
    got = plan(c)
    want = tfft.nudft_type3(c, x, t)
    assert _rel_err(got, want) <= 1e-8


def test_planar_nudft_type3_matches_complex_oracle(rng):
    x, t = _random_sets(rng, 2, 40, 30, np.float32)
    c = random_complex(rng, (40,), np.complex64)
    got = tfft.planar.nudft_type3(to_planar(c), x, t)
    want = tfft.nudft_type3(c.astype(np.complex128),
                            x.astype(np.float64), t.astype(np.float64))
    assert _rel_err(from_planar(got), want) <= 1e-5
    got_b = tfft.planar.nudft_type3(to_planar(c), x, t,
                                    fft_direction="backward")
    want_b = tfft.nudft_type3(c.astype(np.complex128),
                              x.astype(np.float64),
                              t.astype(np.float64), "backward")
    assert _rel_err(from_planar(got_b), want_b) <= 1e-5


def test_type3_max_batch_size_chunking(rng):
    # The inner batch is chunked to bound fine-grid memory, matching
    # the main API's max_batch_size semantics.
    x, t = _random_sets(rng, 1, 80, 60, np.float64)
    c = random_complex(rng, (5, 80), np.complex128)
    opts = tfft.Options(max_batch_size=2)
    got = tfft.nufft_type3(c, x, t, tol=1e-9, options=opts)
    ref = tfft.nufft_type3(c, x, t, tol=1e-9)
    # Chunked vs unchunked schedules reassociate differently: bitwise
    # equality is not expected, agreement to ~1e-9 is.
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-8, atol=1e-8)


def test_planar_type3_max_batch_size_chunking(rng):
    # The planar twin honors max_batch_size too (same chunked_map path),
    # including through the custom-VJP gradient.
    x, t = _random_sets(rng, 1, 80, 60, np.float32)
    c = to_planar(random_complex(rng, (5, 80), np.complex64))
    opts = tfft.Options(max_batch_size=2)
    plan_chunked = tfft.planar.Type3Plan(x, t, tol=1e-6, options=opts)
    plan_whole = tfft.planar.Type3Plan(x, t, tol=1e-6)
    got = plan_chunked(jnp.asarray(c))
    ref = plan_whole(jnp.asarray(c))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)

    ct = jnp.asarray(to_planar(random_complex(rng, (5, 60),
                                              np.complex64)))
    g_chunked = jax.grad(lambda s: jnp.sum(plan_chunked(s) * ct))(
        jnp.asarray(c))
    g_whole = jax.grad(lambda s: jnp.sum(plan_whole(s) * ct))(
        jnp.asarray(c))
    np.testing.assert_allclose(np.asarray(g_chunked),
                               np.asarray(g_whole),
                               rtol=1e-4, atol=1e-4)


def test_type3_rank3_traced_construction_pallas(rng):
    """One-shot planar type-3 under an OUTER jit builds its inner
    type-2 plan on traced (rescaled) targets: the plan's artifacts are
    tracers of the outer trace and must serve within it."""
    m, k = 1500, 1500
    pts = jnp.asarray(rng.uniform(-np.pi, np.pi, (m, 3)).astype(np.float32))
    tgt = jnp.asarray(rng.uniform(-16, 16, (k, 3)).astype(np.float32))
    z = rng.standard_normal((1, m, 2)).astype(np.float32)

    @jax.jit
    def f(src):
        return tfft.planar.nufft_type3(
            src, pts, tgt, tol=1e-4,
            options=tfft.Options(backend="pallas"))

    out = np.asarray(f(jnp.asarray(z)))[0]
    zc = z[0, :, 0] + 1j * z[0, :, 1]
    ref = np.asarray(tfft.nufft_type3(jnp.asarray(zc), pts, tgt,
                                      tol=1e-4))
    got = out[..., 0] + 1j * out[..., 1]
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < 1e-3, err


class TestPlanarPlan:
    """Planar type-3 plan with both stages planned."""

    def test_planar_plan_matches_oracle(self, rng):
        # Both stages planned (binned outer spread, binned inner
        # type-2) on a tile-friendly fine grid: matches the dense
        # oracle.
        import jax.numpy as jnp
        from tensorflow_nufft_tpu.options.options import Options
        from tensorflow_nufft_tpu.planar import (
            Type3Plan, nudft_type3, to_planar)
        x = rng.uniform(-np.pi, np.pi, (800, 2)).astype(np.float32)
        t = rng.uniform(-32.0, 32.0, (800, 2)).astype(np.float32)
        z = (rng.standard_normal(800)
             + 1j * rng.standard_normal(800)).astype(np.complex64)
        src = jnp.asarray(to_planar(z))[None]
        op = Type3Plan(x, t, options=Options(backend="pallas"))
        assert op._spread_planned and op._inner_t2._planned
        got = np.asarray(op(src))[0]
        want = np.asarray(nudft_type3(src[0], jnp.asarray(x),
                                      jnp.asarray(t)))
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 1e-3, err
