"""Tile binning for the tile-exclusive spread kernel (XLA preprocessing).

The spread kernel (``kernels/triton_spread.py``) gives each fine-grid
tile to exactly one program, which accumulates the tile's halo-padded
("extended") block with no atomics. Points are therefore grouped by
tile first: a stable sort by tile id, then a per-tile padding of the
point stream up to a multiple of the chunk size, giving at most
``M // chunk + num_tiles`` chunks — a static bound that holds for any
point distribution. Halos are combined afterwards by a deterministic
overlap-add with periodic wrap.

This is the design of the reference's GPU SUBPROBLEM spreader (counting
sort into bins, bins split into bounded subproblems,
cc/kernels/nufft_plan.cu.cc:159-320,2896-3032), with each tile's chunks
walked by one program instead of one block per subproblem.

Extended tile dims are powers of two (what the kernel's block shapes
need); the core tile is ``ext - 2 * pad`` and need not divide the fine
grid: the last tile along an axis runs past the grid edge and its
excess wraps periodically like any halo.

Supports ranks 1, 2 and 3.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Sentinel coordinate for padded slots: far outside any tile, so kernel
# weights evaluate to exactly zero.
SENTINEL = -1.0e6

# Default extended tile dims and chunk sizes per rank. 2D: a 32 x 32
# block (a 24^2 core at the tol-1e-6 halo of 4) and chunks of 64 points
# keep the [E, C] x [C, E] product on tensor-core shapes; 3D: 16x16x32
# blocks and 32-point chunks keep the [E0*E1, E2] accumulator at 256 x
# 32 per channel in registers. On an H100 at the benchmark shapes these
# beat both smaller blocks (more halo to overlap-add: 16^3 cost 0.6 ms
# more at 128^3/800k) and larger ones (64^2 and 32^3 spill registers and
# run ten times slower).
_DEFAULT_EXT = {1: (64,), 2: (32, 32), 3: (16, 16, 32)}
_DEFAULT_CHUNK = {1: 64, 2: 64, 3: 32}


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """Static tiling parameters (any rank)."""
    fine_shape: Tuple[int, ...]
    ext: Tuple[int, ...]           # extended (halo-padded) tile dims
    pad: int                       # halo on each side
    chunk: int                     # points per kernel loop step
    num_chunks: int                # static chunk-count bound

    @property
    def rank(self) -> int:
        return len(self.fine_shape)

    @property
    def tile(self) -> Tuple[int, ...]:
        """Core tile dims (the points a tile owns)."""
        return tuple(e - 2 * self.pad for e in self.ext)

    @property
    def tiles(self) -> Tuple[int, ...]:
        return tuple(-(-nf // t) for nf, t in zip(self.fine_shape,
                                                   self.tile))

    @property
    def num_tiles(self) -> int:
        return int(np.prod(self.tiles))

    @property
    def num_slots(self) -> int:
        return self.num_chunks * self.chunk


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def choose_geometry(fine_shape: Sequence[int], width: int,
                    num_points: int, ext: Sequence[int] = (),
                    chunk: int = 0) -> TileGeometry:
    """Tile geometry for a fine grid, kernel width and point count.

    The halo must cover the kernel footprint: a point owned by a tile
    touches indices from ceil(s - w/2) >= tile_start - w//2 up to
    < tile_end + w/2, so pad = w//2 + 1. Each extended dim is the rank's
    default, grown to the next power of two where the halo would leave
    a core tile narrower than 8.
    """
    fine_shape = tuple(int(n) for n in fine_shape)
    rank = len(fine_shape)
    pad = width // 2 + 1
    if not ext:
        ext = tuple(max(e, _pow2_at_least(2 * pad + 8))
                    for e in _DEFAULT_EXT[rank])
    ext = tuple(int(e) for e in ext)
    if len(ext) != rank or any(e & (e - 1) or e <= 2 * pad for e in ext):
        raise ValueError(
            f"extended tile dims {ext} must be {rank} powers of two "
            f"larger than twice the halo {pad}")
    chunk = int(chunk or _DEFAULT_CHUNK[rank])
    tiles = [-(-nf // (e - 2 * pad)) for nf, e in zip(fine_shape, ext)]
    num_chunks = int(num_points) // chunk + int(np.prod(tiles))
    return TileGeometry(fine_shape, ext, pad, chunk, num_chunks)


class BinnedPoints(NamedTuple):
    """Tile-ordered, chunk-padded point metadata (a pytree)."""
    points_hi: jax.Array    # [M, rank] coordinate high words
    points_lo: jax.Array    # [M, rank] coordinate low words
    padpos: jax.Array       # [M] slot of each point in the padded stream
    invpos: jax.Array       # [num_slots] point index of each slot (M for
    #                         padded slots): the inverse of padpos
    tile_bounds: jax.Array  # [num_tiles + 1] chunk range of each tile:
    #                         tile t owns chunks [b[t], b[t+1])


def tile_ids(points_hi: jax.Array, geom: TileGeometry) -> jax.Array:
    """[M] linear (row-major) id of the tile owning each point."""
    tid = None
    for d in range(geom.rank):
        td = jnp.clip((points_hi[:, d] // geom.tile[d]).astype(jnp.int32),
                      0, geom.tiles[d] - 1)
        tid = td if tid is None else tid * geom.tiles[d] + td
    return tid


def bin_points(points_resc, geom: TileGeometry) -> BinnedPoints:
    """Groups points by tile and builds the padded chunk stream.

    Args:
        points_resc: coordinates in fine-grid units ([0, nf)): a
            [M, rank] array or a two-float (hi, lo) pair (see
            ``xla_ops.fold_and_rescale_split``).
        geom: static tiling.

    Returns:
        BinnedPoints with static shapes independent of the distribution.
        Points keep their arrival order within a tile (stable sort).
    """
    if isinstance(points_resc, tuple):
        points_hi, points_lo = points_resc
    else:
        points_hi = points_resc
        points_lo = jnp.zeros_like(points_resc)
    m = points_hi.shape[0]
    chunk = geom.chunk
    tid = tile_ids(points_hi, geom)
    order = jnp.argsort(tid, stable=True)                # sorted -> point
    counts = jnp.zeros((geom.num_tiles,), jnp.int32).at[tid].add(1)
    first = jnp.cumsum(counts) - counts                  # [T] sorted start
    rounds = (counts + chunk - 1) // chunk
    chunk_start = jnp.cumsum(rounds) - rounds            # [T]
    tid_sorted = tid[order]
    slot_sorted = (chunk_start[tid_sorted] * chunk
                   + jnp.arange(m, dtype=jnp.int32) - first[tid_sorted])
    padpos = jnp.zeros((m,), jnp.int32).at[order].set(
        slot_sorted, unique_indices=True)
    invpos = jnp.full((geom.num_slots,), m, jnp.int32).at[padpos].set(
        jnp.arange(m, dtype=jnp.int32), unique_indices=True)
    tile_bounds = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(rounds)]).astype(jnp.int32)
    return BinnedPoints(points_hi=points_hi, points_lo=points_lo,
                        padpos=padpos, invpos=invpos,
                        tile_bounds=tile_bounds)


def to_slots(rows: jax.Array, binned: BinnedPoints,
             fill: float = 0.0) -> jax.Array:
    """Point-order rows [R, M] -> slot order [R, num_slots]; padded
    slots read ``fill`` (one gather through ``invpos``)."""
    r, _ = rows.shape
    src = jnp.concatenate(
        [rows, jnp.full((r, 1), fill, rows.dtype)], axis=1)
    return src[:, binned.invpos]


def from_slots(slot_rows: jax.Array, binned: BinnedPoints) -> jax.Array:
    """Slot order [R, num_slots] -> point order [R, M] (the inverse of
    ``to_slots``; one gather through ``padpos``)."""
    return slot_rows[:, binned.padpos]


def slot_coords(binned: BinnedPoints) -> jax.Array:
    """[2 * rank, num_slots] float32 kernel coordinates: rows 0..rank-1
    the high words (SENTINEL in padded slots, so their kernel weights
    are exactly zero), rows rank..2rank-1 the low words. Depends only on
    the points: planned transforms build it once."""
    hi = to_slots(jnp.swapaxes(binned.points_hi, 0, 1).astype(jnp.float32),
                  binned, SENTINEL)
    lo = to_slots(jnp.swapaxes(binned.points_lo, 0, 1).astype(jnp.float32),
                  binned)
    return jnp.concatenate([hi, lo], axis=0)


def _fold_axis(x: jax.Array, ax: int, tile: int, pad: int,
               nf: int) -> jax.Array:
    """Overlap-adds the (nt, E) axis pair at (ax, ax + 1) into one fine
    axis of length nf. Block i covers fine indices
    [i*tile - pad, i*tile - pad + E) modulo nf."""
    nt, e = x.shape[ax], x.shape[ax + 1]
    k = -(-e // tile)                                  # tile-wide pieces
    widths = [(0, 0)] * x.ndim
    widths[ax + 1] = (0, k * tile - e)
    x = jnp.pad(x, widths)
    lin_len = (nt + k - 1) * tile
    lin = None
    for j in range(k):
        piece = jax.lax.slice_in_dim(x, j * tile, (j + 1) * tile,
                                     axis=ax + 1)
        piece = piece.reshape(x.shape[:ax] + (nt * tile,)
                              + x.shape[ax + 2:])
        widths = [(0, 0)] * piece.ndim
        widths[ax] = (j * tile, lin_len - nt * tile - j * tile)
        piece = jnp.pad(piece, widths)
        lin = piece if lin is None else lin + piece
    # lin[p] holds fine index (p - pad) mod nf: fold whole periods.
    reps = -(-lin_len // nf)
    widths = [(0, 0)] * lin.ndim
    widths[ax] = (0, reps * nf - lin_len)
    lin = jnp.pad(lin, widths)
    folded = lin.reshape(lin.shape[:ax] + (reps, nf)
                         + lin.shape[ax + 1:]).sum(axis=ax)
    return jnp.roll(folded, -pad, axis=ax)


def overlap_add(tiles: jax.Array, geom: TileGeometry) -> jax.Array:
    """Combines per-tile extended blocks into the full fine grid.

    Args:
        tiles: [*tiles, B, *ext] per-tile extended outputs.

    Returns:
        [B, *fine_shape] with halos wrapped periodically (the role of the
        reference's add_wrapped_subgrid, nufft_plan.cc:1638-1734, with
        slicing and sums instead of atomics).
    """
    rank = geom.rank
    perm = [rank]
    for d in range(rank):
        perm.extend([d, rank + 1 + d])
    x = jnp.transpose(tiles, perm)          # [B, nt_0, E_0, nt_1, ...]
    for d in range(rank):
        x = _fold_axis(x, 1 + d, geom.tile[d], geom.pad,
                       geom.fine_shape[d])
    return x


def extend_tiles(fine: jax.Array, geom: TileGeometry) -> jax.Array:
    """Full fine grid [B, *fine] -> per-tile extended blocks
    [*tiles, B, *ext] with periodic halos: the adjoint of
    ``overlap_add``. Block i reads fine indices
    [i*tile - pad, i*tile - pad + E) modulo nf."""
    rank = geom.rank
    x = fine
    for d in range(rank):
        ax = 1 + 2 * d          # axis d's position in [B, nt_0, E_0, ...]
        nt, t, e = geom.tiles[d], geom.tile[d], geom.ext[d]
        nf = geom.fine_shape[d]
        k = -(-e // t)
        lin_len = (nt + k - 1) * t
        reps = -(-lin_len // nf)
        lin = jnp.concatenate([jnp.roll(x, geom.pad, axis=ax)] * reps,
                              axis=ax)
        pieces = []
        for j in range(k):
            piece = jax.lax.slice_in_dim(lin, j * t, j * t + nt * t,
                                         axis=ax)
            pieces.append(piece.reshape(piece.shape[:ax] + (nt, t)
                                        + piece.shape[ax + 1:]))
        x = jax.lax.slice_in_dim(jnp.concatenate(pieces, axis=ax + 1),
                                 0, e, axis=ax + 1)
    perm = [1 + 2 * d for d in range(rank)] + [0] + \
        [2 + 2 * d for d in range(rank)]
    return jnp.transpose(x, perm)
