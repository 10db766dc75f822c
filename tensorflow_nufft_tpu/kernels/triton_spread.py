"""Tile-exclusive spread kernel for NVIDIA GPUs (Pallas -> Triton).

Type-1 step 1, the stage cuFINUFFT spreads with shared-memory
subproblems (its SUBPROBLEM method, arXiv:2102.08463). Points arrive
binned by tile (``binning.bin_points``): a padded slot stream in which
tile t owns chunks [bounds[t], bounds[t+1]). One program per (tile,
channel group) walks its tile's chunks and accumulates the tile's
halo-padded block in registers, so no two programs write the same
element — no atomics, and the result is deterministic. Halos are
combined afterwards by an overlap-add (``binning.overlap_add``).

Per chunk of C points the kernel evaluates the separable ES kernel rows
in registers and accumulates, per channel,

    2D:  acc[E0, E1]     += (A_0 * s)^T  A_1        A_d: [C, E_d]
    3D:  acc[E0*E1, E2]  += (A_0 (x) A_1 * s)^T  A_2

as one tensor-core product (``pl.dot``); 1D is a plain weighted sum.
The kernel argument keeps full coordinate precision through the
two-float (hi, lo) coordinates of ``xla_ops.fold_and_rescale_split``.

On the CPU the same kernel runs in the Pallas interpreter (tests); on a
GPU it is always compiled.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tensorflow_nufft_tpu.kernels import binning
from tensorflow_nufft_tpu.kernels.xla_ops import es_kernel_for
from tensorflow_nufft_tpu.plan.plan import NufftPlan

# A float32 pl.dot at default precision lowers to one-pass TF32 (about
# three decimal digits), far short of tol 1e-6. Both float32-accurate
# choices meet tol 1e-6 on an H100: IEEE float32 (HIGHEST) and the
# three-pass TF32 split (DotAlgorithmPreset.TF32_TF32_F32_X3). IEEE
# measured as fast or faster at every benchmark shape (the products are
# small next to the kernel evaluation), so it is kept; it is also what
# the CPU interpreter runs.
PRECISION = jax.lax.Precision.HIGHEST

# Channels accumulated by one program (a power of two dividing 2B).
MAX_GROUP = {1: 8, 2: 8, 3: 2}


def supports(plan: NufftPlan) -> bool:
    """Ranks 1-3 at float32 precision (complex64 / planar float32)."""
    return plan.rank in (1, 2, 3) and plan.spec.dtype_name == "complex64"


def platform() -> str:
    """Platform new computations run on: that of the default device
    where one is set (``jax.default_device``), else the default
    backend's."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def interpret_mode() -> bool:
    """The Pallas interpreter serves the kernel on the CPU platform only;
    every other platform compiles it."""
    return platform() == "cpu"


def channel_group(rank: int, batch2: int) -> int:
    """Largest power of two dividing ``batch2``, capped per rank."""
    g = 1
    while g < MAX_GROUP[rank] and batch2 % (2 * g) == 0:
        g *= 2
    return g


def _kernel_rows(offsets, centers, lows, plan):
    """ES kernel phi(offset - center) with the two-float center."""
    return es_kernel_for((offsets - centers) - lows, plan)


def _spread_kernel(bounds_ref, coords_ref, values_ref, out_ref, *,
                   geom: binning.TileGeometry, plan: NufftPlan,
                   group: int, precision):
    rank = geom.rank
    c = geom.chunk
    slots = geom.num_slots
    ext = geom.ext
    t = pl.program_id(0)
    g = pl.program_id(1)

    origins = [None] * rank
    rem = t
    for d in range(rank - 1, -1, -1):
        origins[d] = ((rem % geom.tiles[d]) * geom.tile[d]
                      - geom.pad).astype(jnp.float32)
        rem = rem // geom.tiles[d]

    def centers(d, base, column):
        hi = coords_ref[pl.ds(d * slots + base, c)] - origins[d]
        lo = coords_ref[pl.ds((rank + d) * slots + base, c)]
        if column:
            return hi[:, None], lo[:, None]
        return hi[None, :], lo[None, :]

    if rank == 1:
        acc_shape = (ext[0],)
    else:
        lead = 1
        for e in ext[:-1]:
            lead *= e
        acc_shape = (lead, ext[-1])

    def body(k, accs):
        base = k * c
        vals = [values_ref[pl.ds((g * group + j) * slots + base, c)]
                for j in range(group)]
        e_last = jnp.arange(ext[-1], dtype=jnp.int32).astype(
            jnp.float32)[None, :]
        hi, lo = centers(rank - 1, base, column=True)
        a_last = _kernel_rows(e_last, hi, lo, plan)          # [C, E_last]
        if rank == 1:
            return tuple(acc + jnp.sum(a_last * v[:, None], axis=0)
                         for acc, v in zip(accs, vals))
        # Leading axes as one [E_0 * ... * E_{r-2}, C] operand: row l
        # holds offsets (l // E_1, l % E_1) in 3D.
        rows = jnp.arange(acc_shape[0], dtype=jnp.int32)[:, None]
        lead = None
        for d in range(rank - 1):
            stride = 1
            for e in ext[d + 1:rank - 1]:
                stride *= e
            off = ((rows // stride) % ext[d]).astype(jnp.float32)
            hi, lo = centers(d, base, column=False)
            a = _kernel_rows(off, hi, lo, plan)              # [L, C]
            lead = a if lead is None else lead * a
        return tuple(
            acc + pl.dot(lead * v[None, :], a_last, precision=precision)
            for acc, v in zip(accs, vals))

    zeros = tuple(jnp.zeros(acc_shape, jnp.float32) for _ in range(group))
    # Arithmetic inside the kernel carries no shard_map axis annotation
    # while ref loads do; the "+ 0" gives the loop bounds the same type
    # as the loop counter, so the loop also traces under shard_map.
    lo = bounds_ref[t] + 0
    hi = bounds_ref[t + 1] + 0
    accs = jax.lax.fori_loop(lo, hi, body, zeros)
    for j in range(group):
        out_ref[j] = accs[j]


def spread_tiles(values_slots: jax.Array, coords: jax.Array,
                 tile_bounds: jax.Array, plan: NufftPlan,
                 geom: binning.TileGeometry) -> jax.Array:
    """Spreads slot-order values onto per-tile extended blocks.

    Args:
        values_slots: [B2, num_slots] float32 channel-major values in slot
            order (zero in padded slots).
        coords: [2 * rank, num_slots] ``binning.slot_coords`` output.
        tile_bounds: [num_tiles + 1] ``BinnedPoints.tile_bounds``.

    Returns:
        [*tiles, B2, *ext] float32 blocks (no overlap-add).
    """
    rank = geom.rank
    batch2 = values_slots.shape[0]
    group = channel_group(rank, batch2)
    if rank == 1:
        block = (geom.ext[0],)
    else:
        lead = 1
        for e in geom.ext[:-1]:
            lead *= e
        block = (lead, geom.ext[-1])
    kernel = functools.partial(_spread_kernel, geom=geom, plan=plan,
                               group=group, precision=PRECISION)
    zero_idx = (0,) * len(block)
    # Inside shard_map the output varies over the mesh axes the inputs
    # vary over.
    vma = frozenset().union(*(jax.typeof(x).vma for x in
                              (values_slots, coords, tile_bounds)))
    out = pl.pallas_call(
        kernel,
        grid=(geom.num_tiles, batch2 // group),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=pl.BlockSpec((None, group) + block,
                               lambda t, g: (t, g) + zero_idx),
        out_shape=jax.ShapeDtypeStruct(
            (geom.num_tiles, batch2) + block, jnp.float32, vma=vma),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret_mode(),
        name="nufft_spread_tiles",
    )(tile_bounds.astype(jnp.int32),
      coords.astype(jnp.float32).reshape(-1),
      values_slots.astype(jnp.float32).reshape(-1))
    return out.reshape(geom.tiles + (batch2,) + geom.ext)


def spread(values_cm: jax.Array, points_resc, plan: NufftPlan):
    """Unplanned spread: channel-major values [B2, M] + rescaled points
    -> ([*tiles, B2, *ext] blocks, geometry), binning on the fly."""
    geom = binning.choose_geometry(plan.fine_shape, plan.width,
                                   values_cm.shape[1])
    binned = binning.bin_points(points_resc, geom)
    tiles = spread_tiles(
        binning.to_slots(values_cm.astype(jnp.float32), binned),
        binning.slot_coords(binned), binned.tile_bounds, plan, geom)
    return tiles, geom
