"""Multi-chip sharding on a virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import tensorflow_nufft_tpu as tfft
from tensorflow_nufft_tpu.parallel import sharded_nufft
from tensorflow_nufft_tpu.planar import to_planar
from tests.conftest import random_complex, random_points


def _mesh(shape, names):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) or 1.0)


@pytest.fixture
def problem(rng):
    grid = (16, 16)
    batch, m = 4, 64
    points = random_points(rng, (m, 2), np.float32)
    source_t2 = to_planar(random_complex(rng, (batch,) + grid,
                                         np.complex64))
    strengths = to_planar(random_complex(rng, (batch, m), np.complex64))
    return grid, points, source_t2, strengths


def test_type2_data_and_points_sharded(problem):
    grid, points, source_t2, _ = problem
    mesh = _mesh((2, 4), ("data", "points"))
    out = sharded_nufft(source_t2, jnp.asarray(points), mesh,
                        transform_type="type_2")
    ref = tfft.planar.nufft(source_t2, points, transform_type="type_2")
    assert _relerr(out, ref) < 1e-4


def test_type1_psum_spread(problem):
    grid, points, _, strengths = problem
    mesh = _mesh((2, 4), ("data", "points"))
    out = sharded_nufft(strengths, jnp.asarray(points), mesh,
                        grid_shape=grid, transform_type="type_1")
    ref = tfft.planar.nufft(strengths, points, grid_shape=grid,
                            transform_type="type_1")
    assert _relerr(out, ref) < 1e-4


def test_data_only_mesh(problem):
    grid, points, source_t2, _ = problem
    mesh = _mesh((4,), ("data",))
    out = sharded_nufft(source_t2, jnp.asarray(points), mesh,
                        transform_type="type_2", points_axis=None)
    ref = tfft.planar.nufft(source_t2, points, transform_type="type_2")
    assert _relerr(out, ref) < 1e-4


def test_sharded_grad(problem):
    """Gradients flow through the sharded transform (psum transpose)."""
    grid, points, source_t2, _ = problem
    mesh = _mesh((2, 4), ("data", "points"))
    pts = jnp.asarray(points)

    def loss_sharded(src):
        out = sharded_nufft(src, pts, mesh, transform_type="type_2")
        return jnp.sum(out * out)

    def loss_local(src):
        out = tfft.planar.nufft(src, points, transform_type="type_2")
        return jnp.sum(out * out)

    g_sharded = jax.grad(loss_sharded)(source_t2)
    g_local = jax.grad(loss_local)(source_t2)
    assert _relerr(g_sharded, g_local) < 1e-4


def test_graft_entry_points():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.eval_shape(fn, *args)
    assert out.shape[-1] == 2
    ge.dryrun_multichip(8)


class TestGridSharded:
    """Mode-grid sharding (sharded_nufft_grid): single-large-transform
    scaling with the leading grid dim over a mesh axis."""

    def test_type1_mode_slabs(self, problem):
        from tensorflow_nufft_tpu.parallel import sharded_nufft_grid
        grid, points, _, strengths = problem
        mesh = _mesh((4,), ("grid",))
        out = sharded_nufft_grid(strengths, jnp.asarray(points), mesh,
                                 grid_shape=grid,
                                 transform_type="type_1")
        ref = tfft.planar.nufft(strengths, points, grid_shape=grid,
                                transform_type="type_1")
        assert out.shape == ref.shape
        assert _relerr(out, ref) < 1e-4

    def test_type2_gathered_modes(self, problem):
        from tensorflow_nufft_tpu.parallel import sharded_nufft_grid
        grid, points, source_t2, _ = problem
        mesh = _mesh((4,), ("grid",))
        out = sharded_nufft_grid(source_t2, jnp.asarray(points), mesh,
                                 transform_type="type_2")
        ref = tfft.planar.nufft(source_t2, points,
                                transform_type="type_2")
        assert _relerr(out, ref) < 1e-4

    def test_type1_gradient(self, problem):
        from tensorflow_nufft_tpu.parallel import sharded_nufft_grid
        grid, points, _, strengths = problem
        mesh = _mesh((4,), ("grid",))
        pts = jnp.asarray(points)

        def loss_sharded(src):
            out = sharded_nufft_grid(src, pts, mesh, grid_shape=grid,
                                     transform_type="type_1")
            return jnp.sum(out * out)

        def loss_local(src):
            out = tfft.planar.nufft(src, points, grid_shape=grid,
                                    transform_type="type_1")
            return jnp.sum(out * out)

        g1 = jax.grad(loss_sharded)(strengths)
        g2 = jax.grad(loss_local)(strengths)
        assert _relerr(g1, g2) < 1e-4


class TestShardedType3:
    def _sets(self, rng):
        m, k = 64, 48
        x = rng.uniform(-3, 5, (m, 2)).astype(np.float32)
        t = rng.uniform(-20, 20, (k, 2)).astype(np.float32)
        c = to_planar(random_complex(rng, (4, m), np.complex64))
        return x, t, c

    def test_matches_unsharded(self, rng):
        from tensorflow_nufft_tpu.parallel import sharded_nufft_type3
        x, t, c = self._sets(rng)
        mesh = _mesh((2, 4), ("data", "points"))
        got = sharded_nufft_type3(jnp.asarray(c), x, t, mesh, tol=1e-5)
        ref = tfft.planar.Type3Plan(x, t, tol=1e-5)(jnp.asarray(c))
        assert got.shape == ref.shape == (4, 48, 2)
        assert _relerr(got, ref) <= 1e-5

    def test_points_axis_only(self, rng):
        from tensorflow_nufft_tpu.parallel import sharded_nufft_type3
        x, t, c = self._sets(rng)
        mesh = _mesh((8,), ("points",))
        got = sharded_nufft_type3(jnp.asarray(c), x, t, mesh,
                                  tol=1e-5, data_axis=None)
        ref = tfft.planar.Type3Plan(x, t, tol=1e-5)(jnp.asarray(c))
        assert _relerr(got, ref) <= 1e-5

    def test_gradient(self, rng):
        from tensorflow_nufft_tpu.parallel import sharded_nufft_type3
        x, t, c = self._sets(rng)
        mesh = _mesh((2, 4), ("data", "points"))
        ct = to_planar(random_complex(rng, (4, 48), np.complex64))

        def loss_sharded(src):
            out = sharded_nufft_type3(src, x, t, mesh, tol=1e-5)
            return jnp.sum(out * jnp.asarray(ct))

        plan = tfft.planar.Type3Plan(x, t, tol=1e-5)

        def loss_ref(src):
            return jnp.sum(plan(src) * jnp.asarray(ct))

        g_sharded = jax.grad(loss_sharded)(jnp.asarray(c))
        g_ref = jax.grad(loss_ref)(jnp.asarray(c))
        assert _relerr(g_sharded, g_ref) <= 1e-4

    def test_divisibility_error(self, rng):
        from tensorflow_nufft_tpu.parallel import sharded_nufft_type3
        x = rng.uniform(-1, 1, (63, 2)).astype(np.float32)   # 63 % 4 != 0
        t = rng.uniform(-5, 5, (48, 2)).astype(np.float32)
        c = to_planar(random_complex(rng, (2, 63), np.complex64))
        mesh = _mesh((2, 4), ("data", "points"))
        with pytest.raises(ValueError, match="divide"):
            sharded_nufft_type3(jnp.asarray(c), x, t, mesh)

    def test_max_batch_size_chunking(self, rng):
        # options.max_batch_size chunks the per-device batch shard; the
        # per-chunk psum runs the same static count on every device.
        from tensorflow_nufft_tpu.parallel import sharded_nufft_type3
        x, t, c = self._sets(rng)
        mesh = _mesh((8,), ("points",))   # full batch (4) per device
        opts = tfft.Options(max_batch_size=2)
        got = sharded_nufft_type3(jnp.asarray(c), x, t, mesh, tol=1e-5,
                                  data_axis=None, options=opts)
        ref = sharded_nufft_type3(jnp.asarray(c), x, t, mesh, tol=1e-5,
                                  data_axis=None)
        assert _relerr(got, ref) <= 1e-6


class TestShardedPlanned:
    """ShardedPlannedNufft: the planned (guru) pipeline inside
    shard_map — per-shard plan artifacts stacked on the points axis.
    On the CPU the spread kernel runs interpreted; backend='pallas'
    forces the planned path (otherwise it falls back to sharded_nufft)."""

    OPTS = tfft.Options(backend="pallas")

    def _op(self, points, grid, mesh, **kw):
        from tensorflow_nufft_tpu.parallel import ShardedPlannedNufft
        kw.setdefault("options", self.OPTS)
        return ShardedPlannedNufft(points, grid, mesh, **kw)

    def test_type2_matches_unsharded(self, problem):
        grid, points, source_t2, _ = problem
        mesh = _mesh((2, 4), ("data", "points"))
        op = self._op(points, grid, mesh, transform_type="type_2")
        assert op._planned
        got = op(source_t2)
        ref = tfft.planar.PlannedNufft(points, grid,
                                       transform_type="type_2",
                                       options=self.OPTS)(source_t2)
        assert _relerr(got, ref) < 1e-5

    def test_type1_psum_matches_unsharded(self, problem):
        grid, points, _, strengths = problem
        mesh = _mesh((2, 4), ("data", "points"))
        op = self._op(points, grid, mesh, transform_type="type_1")
        got = op(strengths)
        ref = tfft.planar.PlannedNufft(points, grid,
                                       transform_type="type_1",
                                       options=self.OPTS)(strengths)
        assert got.shape == ref.shape
        assert _relerr(got, ref) < 1e-5

    def test_points_axis_only(self, problem):
        grid, points, source_t2, _ = problem
        mesh = _mesh((8,), ("points",))
        op = self._op(points, grid, mesh, transform_type="type_2",
                      data_axis=None)
        got = op(source_t2)
        ref = tfft.planar.PlannedNufft(points, grid,
                                       transform_type="type_2",
                                       options=self.OPTS)(source_t2)
        assert _relerr(got, ref) < 1e-5

    def test_gradient(self, problem):
        grid, points, source_t2, _ = problem
        mesh = _mesh((2, 4), ("data", "points"))
        op = self._op(points, grid, mesh, transform_type="type_2")
        ref_op = tfft.planar.PlannedNufft(points, grid,
                                          transform_type="type_2",
                                          options=self.OPTS)
        g1 = jax.grad(lambda s: jnp.sum(op(s) ** 2))(source_t2)
        g2 = jax.grad(lambda s: jnp.sum(ref_op(s) ** 2))(source_t2)
        assert _relerr(g1, g2) < 1e-4

    def test_normal_with_weights(self, problem, rng):
        grid, points, source_t2, _ = problem
        mesh = _mesh((2, 4), ("data", "points"))
        op = self._op(points, grid, mesh, transform_type="type_2")
        w = rng.uniform(0.5, 2.0, (points.shape[0],)).astype(np.float32)
        sw = op.slot_weights(w)
        got = np.asarray(op.normal(source_t2, sw))
        ref_op = tfft.planar.PlannedNufft(points, grid,
                                          transform_type="type_2",
                                          options=self.OPTS)
        ref = np.asarray(ref_op.adjoint()(
            ref_op(source_t2) * jnp.asarray(w)[None, :, None]))
        assert _relerr(got, ref) < 1e-5

    def test_normal_gradient_self_adjoint(self, problem):
        grid, points, source_t2, _ = problem
        mesh = _mesh((2, 4), ("data", "points"))
        op = self._op(points, grid, mesh, transform_type="type_2")
        ct = jnp.ones_like(op.normal(source_t2))

        def loss(s):
            return jnp.sum(op.normal(s) * ct)

        g = jax.grad(loss)(source_t2)
        # d/ds <N s, ct> = N^H ct = N ct (self-adjoint real operator).
        ref = op.normal(ct)
        assert _relerr(g, ref) < 1e-4

    def test_fallback_unplanned(self, problem):
        # Without backend='pallas' the CPU planned path is not served;
        # __call__ must fall back to sharded_nufft with same numerics.
        grid, points, source_t2, _ = problem
        mesh = _mesh((2, 4), ("data", "points"))
        op = self._op(points, grid, mesh, transform_type="type_2",
                      options=None)
        assert not op._planned
        got = op(source_t2)
        ref = tfft.planar.nufft(source_t2, points,
                                transform_type="type_2")
        assert _relerr(got, ref) < 1e-4

    def test_divisibility_errors(self, problem, rng):
        grid, points, source_t2, _ = problem
        mesh = _mesh((2, 4), ("data", "points"))
        bad_pts = random_points(rng, (63, 2), np.float32)  # 63 % 4
        with pytest.raises(ValueError, match="divide"):
            self._op(bad_pts, grid, mesh)
        op = self._op(points, grid, mesh, transform_type="type_2")
        bad_src = jnp.zeros((3,) + grid + (2,), np.float32)  # 3 % 2
        with pytest.raises(ValueError, match="divide"):
            op(bad_src)

    def test_shape_validation(self, problem):
        grid, points, source_t2, _ = problem
        mesh = _mesh((2, 4), ("data", "points"))
        op = self._op(points, grid, mesh, transform_type="type_1")
        with pytest.raises(ValueError, match="expects a"):
            op(source_t2)   # grid-shaped input to a type-1

    def test_mats_level_type1(self, rng):
        # A per-shard point count that fills many chunks per tile (the
        # small `problem` fixtures leave most tiles with one or none).
        m, grid = 4096, (32, 32)
        points = random_points(rng, (m, 2), np.float32)
        mesh = _mesh((2, 4), ("data", "points"))
        op = self._op(points, grid, mesh, transform_type="type_1")
        assert op._planned
        src = jnp.asarray(rng.standard_normal((2, m, 2)),
                          dtype=jnp.float32)
        got = op(src)
        ref = tfft.planar.PlannedNufft(points, grid,
                                       transform_type="type_1",
                                       options=self.OPTS)(src)
        assert _relerr(got, ref) < 1e-5

    def test_3d_binned_level(self, rng):
        m, grid = 256, (12, 12, 12)
        points = random_points(rng, (m, 3), np.float32)
        mesh = _mesh((2, 4), ("data", "points"))
        op = self._op(points, grid, mesh, transform_type="type_1")
        assert op._planned
        src = jnp.asarray(rng.standard_normal((2, m, 2)),
                          dtype=jnp.float32)
        got = op(src)
        ref = tfft.planar.PlannedNufft(points, grid,
                                       transform_type="type_1",
                                       options=self.OPTS)(src)
        assert _relerr(got, ref) < 1e-5


def test_sharded_inactive_axis(rng, ):
    # A mesh axis not assigned to data/points must stay replicated:
    # passing data_axis=None on a two-axis mesh used to trip shard_map's
    # varying/replication check.
    grid = (16, 16)
    m = 64
    points = random_points(rng, (m, 2), np.float32)
    src = to_planar(random_complex(rng, (4,) + grid, np.complex64))
    mesh = _mesh((2, 4), ("data", "points"))
    got = sharded_nufft(jnp.asarray(src), jnp.asarray(points), mesh,
                        transform_type="type_2", data_axis=None)
    ref = tfft.planar.nufft(src, points, transform_type="type_2")
    assert _relerr(got, ref) <= 1e-5


class TestShardedSlots:
    """Shard-major chunk-slot-order apply surface of
    ShardedPlannedNufft: round-tripping, equivalence with point-order
    applies, adjointness, gradients (mirrors tests/test_slots.py for
    the single-device surface)."""

    OPTS = tfft.Options(backend="pallas")

    def _ops(self, rng, grid=(16, 16), m=64):
        from tensorflow_nufft_tpu.parallel import ShardedPlannedNufft
        points = random_points(rng, (m, 2), np.float32)
        mesh = _mesh((2, 4), ("data", "points"))
        t2 = ShardedPlannedNufft(points, grid, mesh,
                                 transform_type="type_2",
                                 options=self.OPTS)
        assert t2._planned
        return t2, t2.adjoint(), points, grid

    def test_round_trip_and_mask(self, rng):
        t2, t1, points, grid = self._ops(rng)
        m = points.shape[0]
        vals = jnp.asarray(rng.standard_normal((4, m, 2)), jnp.float32)
        slots = t2.to_slots(vals)
        assert slots.shape == (4, t2.num_slots, 2)
        back = np.asarray(t2.from_slots(slots))
        np.testing.assert_allclose(back, np.asarray(vals), atol=0)
        mask = np.asarray(t2.slot_mask)
        assert int(mask.sum()) == m
        np.testing.assert_array_equal(
            np.asarray(slots)[:, mask == 0, :], 0.0)

    def test_apply_matches_pointorder(self, problem):
        grid, points, source_t2, strengths = problem
        from tensorflow_nufft_tpu.parallel import ShardedPlannedNufft
        mesh = _mesh((2, 4), ("data", "points"))
        t2 = ShardedPlannedNufft(points, grid, mesh,
                                 transform_type="type_2",
                                 options=self.OPTS)
        t1 = t2.adjoint()
        got = np.asarray(t2.from_slots(t2.apply_to_slots(source_t2)))
        ref = np.asarray(t2(source_t2))
        assert _relerr(got, ref) < 1e-5
        got1 = np.asarray(t1.apply_from_slots(t1.to_slots(strengths)))
        ref1 = np.asarray(t1(strengths))
        assert _relerr(got1, ref1) < 1e-4

    def test_adjoint_pairing(self, rng):
        t2, t1, points, grid = self._ops(rng)
        x = jnp.asarray(rng.standard_normal((2,) + grid + (2,)),
                        jnp.float32)
        y = t1.to_slots(jnp.asarray(
            rng.standard_normal((2, points.shape[0], 2)), jnp.float32))
        lhs = float(jnp.vdot(t2.apply_to_slots(x), y))
        rhs = float(jnp.vdot(x, t1.apply_from_slots(y)))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-4)

    def test_gradients(self, rng):
        t2, t1, points, grid = self._ops(rng)
        src = jnp.asarray(rng.standard_normal((2,) + grid + (2,)),
                          jnp.float32)
        y = t2.apply_to_slots(src) * 0.5

        def loss_slots(x):
            r = t2.apply_to_slots(x) - y
            return jnp.sum(r * r)

        g = jax.jit(jax.grad(loss_slots))(src)
        # d/dx sum((Ax - y)^2) = 2 A^H (Ax - y)
        ref = 2.0 * t1.apply_from_slots(t2.apply_to_slots(src) - y)
        assert _relerr(g, ref) < 1e-4
