"""Multi-chip sharded NUFFT via shard_map over a jax.sharding.Mesh.

The reference has no distributed layer at all (SURVEY.md section 2:
device placement is delegated to TF's runtime). This module is an
extension: transforms scale over a device mesh along two orthogonal
axes:

  - **data axis**: independent transforms (batch/coils) are sharded;
    no communication at all.
  - **points axis**: one transform's nonuniform points are sharded;
    type-2 needs no collectives (each device evaluates its own points
    from a replicated grid); type-1 spreads locally and reduces the fine
    grid with a single ``psum`` (NVLink between GPUs) — the collective
    equivalent of the reference's atomic adds into shared memory.

The mesh follows the algorithm's axes only: every device reaches every
other at the same rate. Everything is planar-real (see
``tensorflow_nufft_tpu.planar``).
Gradients work through ``shard_map`` (psum transposes automatically).
"""

from __future__ import annotations

import functools as _functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as _np
from jax.sharding import Mesh, PartitionSpec as P

from tensorflow_nufft_tpu.ops.planar_core import nufft_core_planar
from tensorflow_nufft_tpu.options.options import Options
from tensorflow_nufft_tpu.plan.plan import PlanSpec
from tensorflow_nufft_tpu.utils.batching import chunked_map


def _make_spec(transform_type, fft_direction, rank, grid_shape, dtype,
               tol, options: Options) -> PlanSpec:
    import numpy as np
    dtype_name = "complex64" if np.dtype(dtype) == np.float32 \
        else "complex128"
    return PlanSpec(
        transform_type=transform_type,
        fft_direction=fft_direction,
        rank=rank,
        grid_shape=tuple(int(d) for d in grid_shape),
        dtype_name=dtype_name,
        tol=float(tol),
        points_range=int(options.points_range),
        spread_only=False,
        upsampling_factor=options.upsampling_factor,
        backend=options.backend,
        kernel_evaluation_method=options.kernel_evaluation_method,
    )


# shard_map's varying-manual-axes check is off wherever a body may run
# the spread kernel: a Pallas kernel's values carry no mesh-axis
# annotation, and the interpreter's slicing of its refs fails the check.
_CHECK_VMA = False


def sharded_nufft(source: jax.Array,
                  points: jax.Array,
                  mesh: Mesh,
                  grid_shape: Optional[Tuple[int, ...]] = None,
                  transform_type: str = "type_2",
                  fft_direction: str = "forward",
                  tol: float = 1e-6,
                  options: Optional[Options] = None,
                  data_axis: Optional[str] = "data",
                  points_axis: Optional[str] = "points"):
    """Planar NUFFT sharded over a device mesh.

    Args:
        source: planar complex. Type-2: ``[B, *grid, 2]``; type-1:
            ``[B, M, 2]``. ``B`` is sharded over ``data_axis``; ``M`` over
            ``points_axis``. Both axes optional (pass None to skip).
        points: ``[M, rank]``, sharded over ``points_axis``, replicated
            over ``data_axis``.
        mesh: the device mesh; axis sizes must divide B and M.
        grid_shape: required for type-1.

    Returns:
        Type-2: ``[B, M, 2]`` sharded (data, points). Type-1:
        ``[B, *grid, 2]`` sharded over data, replicated over points.
    """
    options = options or Options()
    rank = int(points.shape[-1])
    if transform_type == "type_1":
        if grid_shape is None:
            raise ValueError(
                "grid_shape must be provided for type-1 transforms")
    else:
        grid_shape = tuple(int(d) for d in source.shape[-rank - 1:-1])
    spec = _make_spec(transform_type, fft_direction, rank, grid_shape,
                      points.dtype, tol, options)

    da = data_axis if data_axis and data_axis in mesh.axis_names else None
    pa = points_axis if points_axis and points_axis in mesh.axis_names \
        else None

    grid_dims = (None,) * (rank + 1)        # grid elem dims + channel
    if transform_type == "type_2":
        src_spec = P(da, *grid_dims)
        out_spec = P(da, pa, None)
    else:
        src_spec = P(da, pa, None)
        out_spec = P(da, *grid_dims)
    pts_spec = P(pa, None)

    def local_fn(src, pts):
        out = nufft_core_planar(src, pts, spec)
        if transform_type == "type_1" and pa is not None:
            # Each device spread only its local points; reduce fine-grid
            # contributions (already deconvolved: the pipeline is linear,
            # so reducing mode outputs is equivalent and smaller).
            out = jax.lax.psum(out, pa)
        return out

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(src_spec, pts_spec),
        out_specs=out_spec, check_vma=_CHECK_VMA)
    return fn(source, points)


def sharded_nufft_grid(source: jax.Array,
                       points: jax.Array,
                       mesh: Mesh,
                       grid_shape: Optional[Tuple[int, ...]] = None,
                       transform_type: str = "type_2",
                       fft_direction: str = "forward",
                       tol: float = 1e-6,
                       options: Optional[Options] = None,
                       grid_axis: str = "grid"):
    """NUFFT with the MODE GRID sharded over the mesh (single-large-
    transform scaling; no reference counterpart — the reference has no
    distributed layer at all).

    The leading grid dimension is sharded over ``grid_axis``:

      - type-1: points are replicated; each device spreads all points
        and computes only ITS slab of the mode grid (the mode-DFT
        contraction row-block), then a reduce_scatter-free local
        truncation applies — communication is zero beyond the implicit
        input replication, and the big mode output is born sharded.
      - type-2: each device holds its mode slab; slabs are all_gathered
        (modes are the SMALL object) and each device evaluates its own
        share of the points — compute and output scale with the mesh.

    Memory: the [*grid] mode tensor is sharded; the oversampled fine
    grid remains per-device (it is points-sharding's job to shard the
    spread; combine both axes for full scaling).

    Args:
        source: type-1: [B, M, 2] replicated; type-2: [B, *grid, 2]
            sharded on grid dim 0.
        points: [M, rank]; replicated for type-1, sharded over
            ``grid_axis`` for type-2.

    Returns:
        type-1: [B, *grid, 2] sharded on grid dim 0; type-2: [B, M, 2]
        with M sharded over ``grid_axis``.
    """
    options = options or Options()
    rank = int(points.shape[-1])
    ndev = mesh.shape[grid_axis]
    if transform_type == "type_1":
        if grid_shape is None:
            raise ValueError(
                "grid_shape must be provided for type-1 transforms")
        grid_shape = tuple(int(d) for d in grid_shape)
    else:
        # source is the GLOBAL array (shard_map shards it on entry)
        grid_shape = tuple(int(d) for d in source.shape[-rank - 1:-1])

    if grid_shape[0] % ndev != 0:
        raise ValueError(
            f"the '{grid_axis}' mesh axis size {ndev} must divide the "
            f"leading grid dim {grid_shape[0]}")
    spec = _make_spec(transform_type, fft_direction, rank, grid_shape,
                      points.dtype, tol, options)
    grid_dims = (None,) * rank

    if transform_type == "type_1":
        import numpy as np
        from tensorflow_nufft_tpu.fft.planar_fft import (
            _contract_planar, _mode_twiddles)
        from tensorflow_nufft_tpu.kernels import dispatch
        from tensorflow_nufft_tpu.kernels.xla_ops import (
            fold_and_rescale_split)
        from tensorflow_nufft_tpu.plan.plan import make_plan

        plan = make_plan(spec)
        sign = -1.0 if fft_direction == "forward" else 1.0
        slab = grid_shape[0] // ndev
        # Per-device row-pruned twiddles for the leading grid axis: a
        # [ndev, nf, slab] stack, dynamic-sliced by axis_index inside
        # the shard_map body. Each device computes ONLY its slab of the
        # fused DFT + truncate + deconvolve contraction.
        c0, s0 = _mode_twiddles(plan.fine_shape[0], grid_shape[0], sign,
                                plan.deconv_weights(0), truncating=True)
        # Shard the leading-axis twiddles over the mesh as operands
        # ([ndev, nf, slab] with in_spec P(grid_axis, ...)): each device
        # holds only ITS [nf, slab] block — replicating the full stack
        # (or inlining it as a jit literal) would defeat the memory
        # scaling at large grids.
        rdt = np.float32 if points.dtype == np.float32 else np.float64
        c0 = jnp.asarray(np.stack(np.split(c0, ndev, axis=1)), rdt)
        s0 = jnp.asarray(np.stack(np.split(s0, ndev, axis=1)), rdt)

        def local_fn(src, pts, cd, sd):
            cd, sd = cd[0], sd[0]
            batch = src.shape[0]
            pr = fold_and_rescale_split(pts, plan.fine_shape,
                                        spec.points_range)
            folded = jnp.moveaxis(src, -1, 1).reshape(
                (2 * batch,) + src.shape[1:-1])
            fine = dispatch.spread(folded, pr, plan)  # [2B, *fine]
            fine = jnp.moveaxis(
                fine.reshape((batch, 2) + fine.shape[1:]), 1, -1)
            xr, xi = fine[..., 0], fine[..., 1]
            xr, xi = _contract_planar(xr, xi, cd, sd, 1, precision)
            for d in range(1, rank):
                c_np, s_np = _mode_twiddles(
                    plan.fine_shape[d], grid_shape[d], sign,
                    plan.deconv_weights(d), truncating=True)
                xr, xi = _contract_planar(
                    xr, xi, jnp.asarray(c_np, xr.dtype),
                    jnp.asarray(s_np, xr.dtype), 1 + d, precision)
            return jnp.stack([xr, xi], axis=-1)       # [B, slab, .., 2]

        precision = jax.lax.Precision.HIGHEST
        fn = jax.shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(None, None, None), P(None, None),
                      P(grid_axis, None, None), P(grid_axis, None, None)),
            out_specs=P(None, grid_axis, *grid_dims[1:], None),
            check_vma=_CHECK_VMA)
        return fn(source, points, c0, s0)

    def local_fn(src, pts):
        full_modes = jax.lax.all_gather(
            src, grid_axis, axis=1, tiled=True)       # [B, *grid, 2]
        return nufft_core_planar(full_modes, pts, spec)

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(None, grid_axis, *grid_dims), P(grid_axis, None)),
        out_specs=P(None, grid_axis, None))
    return fn(source, points)


def sharded_nufft_type3(source: jax.Array,
                        points,
                        target_points,
                        mesh: Mesh,
                        fft_direction: str = "forward",
                        tol: float = 1e-6,
                        options: Optional[Options] = None,
                        data_axis: Optional[str] = "data",
                        points_axis: Optional[str] = "points"):
    """Planar type-3 NUFFT sharded over a device mesh.

    One ``points_axis`` scales BOTH nonuniform sides: each device
    prephases and spreads its shard of the source points onto the
    type-3 fine grid (one ``psum`` reduces the grid — the collective
    analog of scatter-add), then evaluates its shard of the target
    frequencies with a local inner type-2 (no communication at all on
    the target side). ``data_axis`` shards the strength batch with no
    communication. No reference counterpart on either axis: the
    reference has neither type-3 nor a distributed layer.

    Args:
        source: planar strengths ``[B, M, 2]`` (float32). ``B`` shards
            over ``data_axis``, ``M`` over ``points_axis``.
        points: ``[M, rank]`` float32, concrete (plan statics).
            ``M`` must divide the ``points_axis`` size.
        target_points: ``[K, rank]`` float32, concrete. ``K`` must
            divide the ``points_axis`` size.
        mesh: the device mesh.

    Returns:
        ``[B, K, 2]`` planar values, sharded (data, points).
    """
    import numpy as np

    from tensorflow_nufft_tpu.kernels import dispatch
    from tensorflow_nufft_tpu.kernels.xla_ops import (
        fold_and_rescale_split)
    from tensorflow_nufft_tpu.ops.planar_core import nufft_core_planar
    from tensorflow_nufft_tpu.ops.type3 import (
        compute_type3_statics, validate_type3_point_sets)
    from tensorflow_nufft_tpu.plan.plan import make_plan

    options = options or Options()
    x, t = validate_type3_point_sets(points, target_points,
                                     allowed_dtypes=(np.float32,))
    st = compute_type3_statics(
        np.asarray(x, np.float64), np.asarray(t, np.float64),
        fft_direction, tol, real_dt=np.float32)

    da = data_axis if data_axis and data_axis in mesh.axis_names else None
    pa = points_axis if points_axis and points_axis in mesh.axis_names \
        else None
    npts = mesh.shape[pa] if pa else 1
    if st.num_points % npts or st.num_targets % npts:
        raise ValueError(
            f"the '{points_axis}' mesh axis size {npts} must divide "
            f"both M={st.num_points} and K={st.num_targets}")

    xi = jnp.asarray(st.xi.astype(np.float32))
    theta = jnp.asarray(st.theta.astype(np.float32))
    pre = jnp.asarray(
        np.stack([st.prephase.real, st.prephase.imag], -1)
        .astype(np.float32))                               # [M, 2]
    post = jnp.asarray(
        np.stack([st.postphase.real, st.postphase.imag], -1)
        .astype(np.float32))                               # [K, 2]

    spread_spec = PlanSpec(
        transform_type="type_1", fft_direction=fft_direction,
        rank=st.rank, grid_shape=st.fine_shape, dtype_name="complex64",
        tol=float(tol), points_range=0, spread_only=True,
        backend=options.backend,
        kernel_evaluation_method=options.kernel_evaluation_method)
    spread_plan = make_plan(spread_spec)
    if (spread_plan.width != st.width
            or spread_plan.fine_shape != st.fine_shape):
        raise AssertionError(
            "type-3 spread plan geometry mismatch (statics vs plan); "
            "see ops/type3.py compute_type3_statics tol clamping")
    t2_spec = PlanSpec(
        transform_type="type_2", fft_direction=fft_direction,
        rank=st.rank, grid_shape=st.fine_shape, dtype_name="complex64",
        tol=float(tol), points_range=0, backend=options.backend,
        kernel_evaluation_method=options.kernel_evaluation_method)

    from tensorflow_nufft_tpu.planar import pmul

    def local_fn(src, xi_l, pre_l, theta_l, post_l):
        m_local = src.shape[1]

        def one_chunk(src_c):
            batch = src_c.shape[0]
            s = pmul(src_c, pre_l[None])            # [Bc, M_l, 2]
            resc = fold_and_rescale_split(xi_l, st.fine_shape, 0)
            cm = jnp.moveaxis(s, -1, 1).reshape(2 * batch, m_local)
            fine = dispatch.spread(cm, resc, spread_plan)
            if pa is not None:
                # Each device spread only its local points: reduce the
                # fine grid over the points axis (linear, so reducing
                # the raw spread is exact).
                fine = jax.lax.psum(fine, pa)
            grid = jnp.moveaxis(
                fine.reshape((batch, 2) + st.fine_shape), 1, -1)
            vals = nufft_core_planar(grid, theta_l,
                                     t2_spec)       # [Bc, K_l, 2]
            return pmul(vals, post_l[None])

        # Honor the user's max_batch_size on the per-device batch shard
        # (fine-grid memory bound, like the plan APIs). Only when set
        # explicitly: every device runs the same static chunk count, so
        # the per-chunk psum stays collective-safe.
        max_bs = options.max_batch_size
        if max_bs is not None:
            return chunked_map(one_chunk, src, max_bs)
        return one_chunk(src)

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(da, pa, None), P(pa, None), P(pa, None),
                  P(pa, None), P(pa, None)),
        out_specs=P(da, pa, None), check_vma=_CHECK_VMA)
    return fn(source, xi, pre, theta, post)


# ---------------------------------------------------------------------------
# Planned + sharded: the production iterative-recon path.
# ---------------------------------------------------------------------------



@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _sharded_planned_call(source, op):
    return op._apply(source)


def _sharded_planned_fwd(source, op):
    return _sharded_planned_call(source, op), None


def _sharded_planned_bwd(op, _, cotangent):
    # Real transpose == adjoint: swap type AND direction; the adjoint
    # shares every points-side artifact (see planar._planned_bwd).
    return (_sharded_planned_call(cotangent, op.adjoint()),)


_sharded_planned_call.defvjp(_sharded_planned_fwd, _sharded_planned_bwd)


@_functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _sharded_normal_call(source, slot_w, op):
    return op._apply_normal(source, slot_w)


def _sharded_normal_fwd(source, slot_w, op):
    return _sharded_normal_call(source, slot_w, op), slot_w


def _sharded_normal_bwd(op, slot_w, cotangent):
    # A^H W A with real W is self-adjoint (planar._planned_normal_bwd).
    return (_sharded_normal_call(cotangent, slot_w, op),
            None if slot_w is None else jnp.zeros_like(slot_w))


_sharded_normal_call.defvjp(_sharded_normal_fwd, _sharded_normal_bwd)


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _sharded_slots_call(source, op):
    return op._apply_slots(source)


def _sharded_slots_fwd(source, op):
    return _sharded_slots_call(source, op), None


def _sharded_slots_bwd(op, _, cotangent):
    # Slot-space operator = point-space operator conjugated by the slot
    # embedding; planar-real transpose = the adjoint plan's slot apply
    # (see planar._planned_slots_bwd).
    return (_sharded_slots_call(cotangent, op.adjoint()),)


_sharded_slots_call.defvjp(_sharded_slots_fwd, _sharded_slots_bwd)


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _sharded_to_slots_call(values, op):
    return op._to_slots(values)


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _sharded_from_slots_call(slot_values, op):
    return op._from_slots(slot_values)


def _sharded_to_slots_fwd(values, op):
    return _sharded_to_slots_call(values, op), None


def _sharded_to_slots_bwd(op, _, cotangent):
    return (_sharded_from_slots_call(cotangent, op),)


def _sharded_from_slots_fwd(slot_values, op):
    return _sharded_from_slots_call(slot_values, op), None


def _sharded_from_slots_bwd(op, _, cotangent):
    return (_sharded_to_slots_call(cotangent, op),)


_sharded_to_slots_call.defvjp(_sharded_to_slots_fwd,
                              _sharded_to_slots_bwd)
_sharded_from_slots_call.defvjp(_sharded_from_slots_fwd,
                                _sharded_from_slots_bwd)


class ShardedPlannedNufft:
    """Planned planar NUFFT over a device mesh.

    Combines the planned (guru) pipeline — fold, tile binning and
    slot-order kernel coordinates hoisted to plan time
    (``planar.PlannedNufft``) — with SPMD execution: the batch/coil axis
    shards over ``data_axis`` and the point set over ``points_axis``.
    Each device owns one point shard's planned artifacts, built per
    shard and stacked on a leading shard axis that ``shard_map`` splits
    over the mesh; the planned stages then run unchanged on
    device-local data. Type-1 psums the (deconvolved) mode outputs over
    the points axis — the collective dual of the reference's atomic
    adds; type-2 needs no collectives. No reference counterpart (it has
    no distributed layer, SURVEY.md section 2).

    Differentiable w.r.t. ``source`` via the shared-artifact adjoint.
    Falls back to the unplanned ``sharded_nufft`` where the spread
    kernel does not serve the configuration.

    Args:
        points: concrete ``[M, rank]`` radians in ``[-pi, pi]``. ``M``
            must divide evenly by the points-axis size.
        grid_shape: the mode grid.
        mesh: the device mesh.
        data_axis / points_axis: mesh axis names (pass None to skip an
            axis; absent names are ignored like ``sharded_nufft``).

    Apply: type-2 ``[B, *grid, 2] -> [B, M, 2]``; type-1
    ``[B, M, 2] -> [B, *grid, 2]``. ``B`` must divide evenly by the
    data-axis size.
    """

    def __init__(self, points, grid_shape, mesh: Mesh,
                 transform_type: str = "type_2",
                 fft_direction: str = "forward", tol: float = 1e-6,
                 options: Optional[Options] = None,
                 data_axis: Optional[str] = "data",
                 points_axis: Optional[str] = "points"):
        from tensorflow_nufft_tpu.planar import PlannedNufft

        pts = _np.asarray(points)
        if pts.ndim != 2:
            raise ValueError(
                f"planned transforms take a single [M, rank] point "
                f"set, got shape {pts.shape}")
        self.mesh = mesh
        self.data_axis = (data_axis if data_axis
                          and data_axis in mesh.axis_names else None)
        self.points_axis = (points_axis if points_axis
                            and points_axis in mesh.axis_names else None)
        s = (mesh.shape[self.points_axis] if self.points_axis else 1)
        m = pts.shape[0]
        if m % s:
            raise ValueError(
                f"num_points {m} must divide evenly over the "
                f"points axis (size {s})")
        self.points = pts
        self.num_points = m
        self._num_shards = s
        shard_pts = pts.reshape(s, m // s, pts.shape[-1])
        # One vmapped prep for all shards (plan-build wall time ~flat
        # in shard count) instead of s sequential PlannedNufft preps.
        self._shards = PlannedNufft.batch_build(
            shard_pts, grid_shape, transform_type=transform_type,
            fft_direction=fft_direction, tol=tol, options=options)
        p0 = self._shards[0]
        self.grid_shape = p0.grid_shape
        self.transform_type = transform_type
        self.fft_direction = fft_direction
        self.tol = p0.tol
        self.options = p0.options
        self._adjoint = None
        # Equal shard sizes -> identical static geometry across shards
        # (choose_geometry is a pure function of (fine_shape, width, m)).
        self._planned = p0._planned
        if not self._planned:
            return
        self.plan = p0.plan
        self.geom = p0.geom
        self._arts = jax.tree.map(
            lambda *xs: jnp.stack(xs),
            *[(sh.points_resc, sh.binned, sh.coords)
              for sh in self._shards])
        # [s, S] per-shard slot masks (1 where the slot holds a real
        # point) for the slot-order apply surface; eager, plan time.
        self._masks = jnp.stack([sh.slot_mask for sh in self._shards])

    # -- plumbing -----------------------------------------------------

    def adjoint(self) -> "ShardedPlannedNufft":
        """The adjoint planned transform (swapped type and direction),
        sharing all per-shard points-side artifacts."""
        if self._adjoint is None:
            adj = object.__new__(ShardedPlannedNufft)
            adj.__dict__.update(self.__dict__)
            adj.transform_type = ("type_2"
                                  if self.transform_type == "type_1"
                                  else "type_1")
            adj.fft_direction = ("backward"
                                 if self.fft_direction == "forward"
                                 else "forward")
            adj._shards = [sh.adjoint() for sh in self._shards]
            if self._planned:
                adj.plan = adj._shards[0].plan
            adj._adjoint = self
            self._adjoint = adj
        return self._adjoint

    def _shard_map(self, local_fn, in_specs, out_spec, *args):
        """shard_map over (args..., artifacts): ``local_fn`` receives the
        device-local arguments and the shard's (points_resc, binned,
        coords) with the leading shard axis stripped."""
        pa = self.points_axis
        arts_spec = jax.tree.map(
            lambda x: P(pa, *(None,) * (x.ndim - 1)), self._arts)

        def wrapped(*xs):
            *xs, arts = xs
            return local_fn(*xs, jax.tree.map(lambda x: x[0], arts))

        fn = jax.shard_map(wrapped, mesh=self.mesh,
                           in_specs=tuple(in_specs) + (arts_spec,),
                           out_specs=out_spec, check_vma=_CHECK_VMA)
        return fn(*args, self._arts)

    def _grid_spec(self):
        return P(self.data_axis, *(None,) * (len(self.grid_shape) + 1))

    def _points_spec(self):
        return P(self.data_axis, self.points_axis, None)

    def _reduce_modes(self, out):
        if self.points_axis:
            out = jax.lax.psum(out, self.points_axis)
        return out

    # -- applies ------------------------------------------------------

    def __call__(self, source):
        """Applies the transform to planar ``source`` (see class doc)."""
        source = jnp.asarray(source)
        rank = len(self.grid_shape)
        if self.transform_type == "type_1":
            ok = (source.ndim == 3 and source.shape[1] == self.num_points
                  and source.shape[-1] == 2)
            expect = f"[B, {self.num_points}, 2]"
        else:
            ok = (source.ndim == rank + 2
                  and tuple(source.shape[1:-1]) == self.grid_shape
                  and source.shape[-1] == 2)
            expect = "[B, {}, 2]".format(
                ", ".join(str(g) for g in self.grid_shape))
        if not ok:
            raise ValueError(
                f"sharded planned {self.transform_type} expects a "
                f"source of shape {expect}; got {source.shape}")
        if self.data_axis and source.shape[0] % \
                self.mesh.shape[self.data_axis]:
            raise ValueError(
                f"batch {source.shape[0]} must divide evenly over the "
                f"data axis (size {self.mesh.shape[self.data_axis]})")
        if not self._planned:
            return sharded_nufft(
                source, jnp.asarray(self.points), self.mesh,
                grid_shape=self.grid_shape,
                transform_type=self.transform_type,
                fft_direction=self.fft_direction, tol=self.tol,
                options=self.options, data_axis=self.data_axis,
                points_axis=self.points_axis)
        return _sharded_planned_call(source, self)

    def _apply(self, source):
        from tensorflow_nufft_tpu.kernels import binning
        from tensorflow_nufft_tpu.planar import (
            _channel_major, _planar_rows, planned_interp,
            planned_spread_modes)
        plan, geom = self.plan, self.geom

        if self.transform_type == "type_1":
            def local_fn(src, arts):
                _, binned, coords = arts
                vals = binning.to_slots(
                    _channel_major(src).astype(jnp.float32), binned)
                out = planned_spread_modes(vals, coords,
                                           binned.tile_bounds, plan, geom,
                                           src.shape[0])
                return self._reduce_modes(out).astype(src.dtype)
            return self._shard_map(local_fn, (self._points_spec(),),
                                   self._grid_spec(), source)

        def local_fn(src, arts):
            points_resc, _, _ = arts
            values = planned_interp(src, points_resc, plan)
            return _planar_rows(values, src.shape[0]).astype(src.dtype)
        return self._shard_map(local_fn, (self._grid_spec(),),
                               self._points_spec(), source)

    # -- normal operator ----------------------------------------------

    def slot_weights(self, weights) -> jax.Array:
        """Per-point real weights [M] -> per-shard chunk-slot order
        ([s, S]) for ``normal``; point order must match the
        constructor's ``points``."""
        w = _np.asarray(weights)
        if w.shape != (self.num_points,):
            raise ValueError(
                f"weights must have shape [{self.num_points}], got "
                f"{w.shape}")
        if not self._planned:
            return jnp.asarray(w)
        ws = w.reshape(self._num_shards, -1)
        return jnp.stack([sh.slot_weights(ws[i])
                          for i, sh in enumerate(self._shards)])

    def normal(self, source, slot_w=None):
        """Normal operator ``A^H W A`` over the mesh: the type-2 forward
        and type-1 adjoint run back-to-back on each device with the
        intermediate point values weighted in slot order, then ONE psum
        of the mode outputs over the points axis per apply. ``slot_w``
        comes from ``slot_weights`` (treated as non-differentiable plan
        data).

        [B, *grid, 2] -> [B, *grid, 2]; self-adjoint custom VJP.
        """
        source = jnp.asarray(source)
        if not self._planned:
            t2 = self if self.transform_type == "type_2" \
                else self.adjoint()
            vals = t2(source)
            if slot_w is not None:
                vals = vals * jax.lax.stop_gradient(
                    jnp.asarray(slot_w))[None, :, None]
            return t2.adjoint()(vals)
        return _sharded_normal_call(source, slot_w, self)

    def _apply_normal(self, source, slot_w=None):
        from tensorflow_nufft_tpu.kernels import binning
        from tensorflow_nufft_tpu.planar import (
            planned_interp, planned_spread_modes)
        t2 = self if self.transform_type == "type_2" else self.adjoint()
        t2_plan, t1_plan, geom = t2.plan, t2.adjoint().plan, self.geom
        weights = (jnp.ones_like(self._masks) if slot_w is None
                   else jax.lax.stop_gradient(slot_w))

        def local_fn(src, sw, arts):
            points_resc, binned, coords = arts
            vals = planned_interp(src, points_resc, t2_plan)
            flat = binning.to_slots(vals.astype(jnp.float32), binned)
            flat = flat * sw[0][None, :]
            out = planned_spread_modes(flat, coords, binned.tile_bounds,
                                       t1_plan, geom, src.shape[0])
            return self._reduce_modes(out).astype(src.dtype)

        return self._shard_map(
            local_fn, (self._grid_spec(), P(self.points_axis, None)),
            self._grid_spec(), source, weights)

    # -- chunk-slot-order apply surface -------------------------------
    # Sharded dual of planar.PlannedNufft's slot surface: per-point
    # vectors live in shard-major chunk-slot order ([B, s*S, 2], each
    # shard's S slots device-local over the points axis), so iterative
    # pipelines skip the per-call point-order permutation gather on
    # every device. Convert loop-invariant data once with ``to_slots``.

    @property
    def num_slots(self) -> int:
        """Global slot-axis length (shard-major: ``s * S_shard``)."""
        if not self._planned:
            return int(self.num_points)
        return self._num_shards * self._shards[0].num_slots

    @property
    def slot_mask(self) -> jax.Array:
        """[s*S] float32; 1 where the slot holds a real point."""
        if not self._planned:
            return jnp.ones((self.num_points,), jnp.float32)
        return self._masks.reshape(-1)

    def _check_slot_shape(self, x, what):
        s = self.num_slots
        if not (x.ndim == 3 and x.shape[1] == s and x.shape[-1] == 2):
            raise ValueError(
                f"{what} expects [B, {s}, 2] shard-major slot-order "
                f"values, got shape {x.shape}")

    def to_slots(self, values) -> jax.Array:
        """Point-order planar values [B, M, 2] -> shard-major slot
        order [B, s*S, 2] (zeros in padded/unused slots); point order
        must match the constructor's ``points``."""
        values = jnp.asarray(values)
        m = int(self.num_points)
        if not (values.ndim == 3 and values.shape[1] == m
                and values.shape[-1] == 2):
            raise ValueError(
                f"to_slots expects [B, {m}, 2] planar values, got "
                f"shape {values.shape}")
        if not self._planned:
            return values
        return _sharded_to_slots_call(values, self)

    def from_slots(self, slot_values) -> jax.Array:
        """Shard-major slot order [B, s*S, 2] -> point order
        [B, M, 2] (the inverse of ``to_slots``)."""
        slot_values = jnp.asarray(slot_values)
        if not self._planned:
            return slot_values
        self._check_slot_shape(slot_values, "from_slots")
        return _sharded_from_slots_call(slot_values, self)

    def _permute(self, values, to_slots: bool):
        from tensorflow_nufft_tpu.kernels import binning
        from tensorflow_nufft_tpu.planar import _channel_major, _planar_rows
        move = binning.to_slots if to_slots else binning.from_slots

        def local_fn(vals, arts):
            _, binned, _ = arts
            flat = move(_channel_major(vals), binned)
            return _planar_rows(flat, vals.shape[0])

        spec = self._points_spec()
        return self._shard_map(local_fn, (spec,), spec, values)

    def _to_slots(self, values):
        return self._permute(values, to_slots=True)

    def _from_slots(self, slot_values):
        return self._permute(slot_values, to_slots=False)

    def apply_to_slots(self, source) -> jax.Array:
        """Type-2 apply producing shard-major SLOT-ORDER values
        [B, s*S, 2]. Differentiable w.r.t. ``source``."""
        if self.transform_type != "type_2":
            raise ValueError(
                "apply_to_slots is the type-2 (grid -> points) apply; "
                "this plan is type_1 (use adjoint(), or "
                "apply_from_slots)")
        source = jnp.asarray(source)
        rank = len(self.grid_shape)
        if not (source.ndim == rank + 2
                and tuple(source.shape[1:-1]) == self.grid_shape
                and source.shape[-1] == 2):
            raise ValueError(
                f"apply_to_slots expects [B, "
                f"{', '.join(str(g) for g in self.grid_shape)}, 2], "
                f"got shape {source.shape}")
        if not self._planned:
            return self(source)
        return _sharded_slots_call(source, self)

    def apply_from_slots(self, slot_values) -> jax.Array:
        """Type-1 apply consuming shard-major SLOT-ORDER values
        [B, s*S, 2] -> grid [B, *grid, 2] (one psum over the points
        axis; padded/unused slots masked out). Differentiable."""
        if self.transform_type != "type_1":
            raise ValueError(
                "apply_from_slots is the type-1 (points -> grid) "
                "apply; this plan is type_2 (use adjoint(), or "
                "apply_to_slots)")
        slot_values = jnp.asarray(slot_values)
        if not self._planned:
            return self(slot_values)
        self._check_slot_shape(slot_values, "apply_from_slots")
        return _sharded_slots_call(slot_values, self)

    def _apply_slots(self, source):
        from tensorflow_nufft_tpu.kernels import binning
        from tensorflow_nufft_tpu.planar import (
            _channel_major, _planar_rows, planned_interp,
            planned_spread_modes)
        plan, geom = self.plan, self.geom
        mask_spec = P(self.points_axis, None)

        if self.transform_type == "type_1":
            def local_fn(src, mask, arts):
                _, binned, coords = arts
                vals = jnp.where(mask[0][None, :] > 0,
                                 _channel_major(src).astype(jnp.float32),
                                 0.0)
                out = planned_spread_modes(vals, coords,
                                           binned.tile_bounds, plan, geom,
                                           src.shape[0])
                return self._reduce_modes(out).astype(src.dtype)
            return self._shard_map(
                local_fn, (self._points_spec(), mask_spec),
                self._grid_spec(), source, self._masks)

        def local_fn(src, arts):
            points_resc, binned, _ = arts
            values = planned_interp(src, points_resc, plan)
            flat = binning.to_slots(values, binned)
            return _planar_rows(flat, src.shape[0]).astype(src.dtype)
        return self._shard_map(local_fn, (self._grid_spec(),),
                               self._points_spec(), source)
