"""Chunk-slot-order apply surface of PlannedNufft.

The planned kernels' native point layout is the chunk-padded slot
stream; ``apply_to_slots``/``apply_from_slots`` expose applies that
skip the per-call point-order permutation gathers, and
``to_slots``/``from_slots`` convert loop-invariant data once. These
tests pin: order round-tripping, equivalence with the point-order
applies, adjointness of the slot-space pair, gradients, and the fused
``normal`` consistency. (No reference counterpart: the reference's
sorted order is internal to nufft_plan.cc and never exposed.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tensorflow_nufft_tpu as tfft


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def random_points(rng, shape):
    return rng.uniform(-np.pi, np.pi, shape).astype(np.float32)


def _plans(rng, rank=2, m=300, grid=None):
    grid = grid or ((16, 16) if rank == 2 else (16, 16, 16))
    pts = random_points(rng, (m, rank))
    opts = tfft.Options(backend="pallas")
    t2 = tfft.planar.PlannedNufft(pts, grid, transform_type="type_2",
                                  options=opts)
    assert t2._planned
    return t2, t2.adjoint(), pts, grid


@pytest.mark.parametrize("rank", [2, 3])
def test_slot_round_trip(rng, rank):
    t2, t1, pts, grid = _plans(rng, rank=rank)
    m = pts.shape[0]
    vals = rng.standard_normal((3, m, 2)).astype(np.float32)
    slots = t2.to_slots(vals)
    assert slots.shape == (3, t2.num_slots, 2)
    back = np.asarray(t2.from_slots(slots))
    np.testing.assert_allclose(back, vals, rtol=0, atol=0)
    # Zeros exactly in padded/unused slots.
    mask = np.asarray(t2.slot_mask)
    dead = np.asarray(slots)[:, mask == 0, :]
    np.testing.assert_array_equal(dead, 0.0)
    assert int(mask.sum()) == m


def test_apply_to_slots_matches_pointorder(rng):
    t2, t1, pts, grid = _plans(rng)
    src = rng.standard_normal((2,) + grid + (2,)).astype(np.float32)
    got = np.asarray(t2.apply_to_slots(src))
    ref = np.asarray(t2.to_slots(t2(src)))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_apply_from_slots_matches_pointorder(rng):
    t2, t1, pts, grid = _plans(rng)
    m = pts.shape[0]
    vals = rng.standard_normal((2, m, 2)).astype(np.float32)
    got = np.asarray(t1.apply_from_slots(t1.to_slots(vals)))
    ref = np.asarray(t1(vals))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_apply_from_slots_ignores_dead_slots(rng):
    """Garbage (even NaN) in padded/unused input slots must not leak."""
    t2, t1, pts, grid = _plans(rng)
    m = pts.shape[0]
    vals = rng.standard_normal((1, m, 2)).astype(np.float32)
    slots = np.asarray(t1.to_slots(vals))
    mask = np.asarray(t1.slot_mask) == 0
    poisoned = slots.copy()
    poisoned[:, mask, :] = np.nan
    got = np.asarray(t1.apply_from_slots(jnp.asarray(poisoned)))
    ref = np.asarray(t1.apply_from_slots(jnp.asarray(slots)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=0)
    assert np.isfinite(got).all()


def test_slot_pair_adjoint(rng):
    """<A_s x, y> == <x, A_s^H y> in the planar-real inner product."""
    t2, t1, pts, grid = _plans(rng)
    x = jnp.asarray(rng.standard_normal((1,) + grid + (2,)),
                    jnp.float32)
    y = t1.to_slots(jnp.asarray(
        rng.standard_normal((1, pts.shape[0], 2)), jnp.float32))
    lhs = jnp.vdot(t2.apply_to_slots(x), y)
    rhs = jnp.vdot(x, t1.apply_from_slots(y))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-4)


def test_slot_apply_gradients(rng):
    t2, t1, pts, grid = _plans(rng)
    src = jnp.asarray(rng.standard_normal((1,) + grid + (2,)),
                      jnp.float32)

    def loss_slots(x):
        return jnp.sum(t2.apply_to_slots(x) ** 2)

    def loss_ref(x):
        return jnp.sum(t2(x) ** 2)

    g1 = np.asarray(jax.grad(loss_slots)(src))
    g2 = np.asarray(jax.grad(loss_ref)(src))
    # Same loss: slot order is a permutation-embedding, sums of squares
    # agree (dead slots are zero).
    np.testing.assert_allclose(g1, g2, rtol=1e-3,
                               atol=1e-3 * np.abs(g2).max())


def test_conversion_gradients(rng):
    t2, t1, pts, grid = _plans(rng)
    m = pts.shape[0]
    vals = jnp.asarray(rng.standard_normal((1, m, 2)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((1, t2.num_slots, 2)),
                    jnp.float32)

    def f(v):
        return jnp.sum(t2.to_slots(v) * w)

    g = np.asarray(jax.grad(f)(vals))
    ref = np.asarray(t2.from_slots(w))
    np.testing.assert_allclose(g, ref, rtol=1e-6, atol=1e-6)


def test_normal_matches_slot_composition(rng):
    t2, t1, pts, grid = _plans(rng)
    src = jnp.asarray(rng.standard_normal((1,) + grid + (2,)),
                      jnp.float32)
    w = jnp.asarray(rng.uniform(0.5, 1.5, (pts.shape[0],)), jnp.float32)
    slot_w = t2.slot_weights(w)
    via_normal = np.asarray(t2.normal(src, slot_w))
    vals = t2.apply_to_slots(src) * slot_w[None, :, None]
    via_slots = np.asarray(t1.apply_from_slots(vals))
    np.testing.assert_allclose(
        via_normal, via_slots, rtol=1e-4,
        atol=1e-4 * np.abs(via_normal).max())


def test_wrong_type_raises(rng):
    t2, t1, pts, grid = _plans(rng)
    src = jnp.zeros((1,) + grid + (2,), jnp.float32)
    vals = jnp.zeros((1, t2.num_slots, 2), jnp.float32)
    with pytest.raises(ValueError, match="type-2"):
        t1.apply_to_slots(src)
    with pytest.raises(ValueError, match="type-1"):
        t2.apply_from_slots(vals)
    with pytest.raises(ValueError, match="expects"):
        t2.apply_to_slots(vals)
    with pytest.raises(ValueError, match="expects"):
        t1.apply_from_slots(src)


def test_unplanned_fallback(rng):
    """Off-Pallas plans degrade to point order (S == M)."""
    pts = random_points(rng, (100, 2))
    op = tfft.planar.PlannedNufft(pts, (16, 16),
                                  transform_type="type_2")
    assert not op._planned
    assert op.num_slots == 100
    src = jnp.asarray(rng.standard_normal((1, 16, 16, 2)), jnp.float32)
    got = np.asarray(op.apply_to_slots(src))
    ref = np.asarray(op(src))
    np.testing.assert_allclose(got, ref)
    vals = jnp.asarray(rng.standard_normal((1, 100, 2)), jnp.float32)
    np.testing.assert_array_equal(np.asarray(op.to_slots(vals)),
                                  np.asarray(vals))


def test_3d_slots(rng):
    """Slot surface of a rank-3 plan (tiles that run past the grid
    edge: 24 is not a multiple of the 8-wide core tile's fine grid)."""
    grid = (24, 16, 16)
    m = 3000
    pts = random_points(rng, (m, 3))
    opts = tfft.Options(backend="pallas")
    t2 = tfft.planar.PlannedNufft(pts, grid, transform_type="type_2",
                                  options=opts)
    t1 = t2.adjoint()
    assert t2._planned
    vals = rng.standard_normal((1, m, 2)).astype(np.float32)
    got = np.asarray(t1.apply_from_slots(t1.to_slots(vals)))
    ref = np.asarray(t1(vals))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    src = rng.standard_normal((1,) + grid + (2,)).astype(np.float32)
    got2 = np.asarray(t2.from_slots(t2.apply_to_slots(src)))
    ref2 = np.asarray(t2(src))
    np.testing.assert_allclose(got2, ref2, rtol=1e-4,
                               atol=1e-4 * np.abs(ref2).max())
