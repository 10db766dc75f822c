"""Tile binning and halo bookkeeping (kernels/binning.py): geometry,
the padded slot stream, slot-order payloads, overlap-add and its
adjoint."""

import jax.numpy as jnp
import numpy as np
import pytest

from tensorflow_nufft_tpu.kernels import binning

_FINE = {1: (256,), 2: (64, 48), 3: (32, 24, 40)}


def _points(rng, m, fine):
    return rng.uniform(0, np.array(fine) - 1e-3,
                       (m, len(fine))).astype(np.float32)


@pytest.mark.parametrize("fine,width", [
    ((512, 512), 7), ((128,), 5), ((64, 64, 64), 7), ((250,), 9),
    ((96, 160), 4), ((256, 256, 256), 9), ((6,), 2)])
def test_geometry(fine, width):
    g = binning.choose_geometry(fine, width, 10000)
    assert g.pad == width // 2 + 1        # covers the kernel footprint
    for nf, e, t, nt in zip(g.fine_shape, g.ext, g.tile, g.tiles):
        assert e & (e - 1) == 0           # power of two
        assert t == e - 2 * g.pad and t >= 8
        assert nt * t >= nf > (nt - 1) * t
    assert g.num_chunks == 10000 // g.chunk + g.num_tiles


def test_geometry_rejects_bad_ext():
    with pytest.raises(ValueError, match="powers of two"):
        binning.choose_geometry((64, 64), 7, 100, ext=(24, 32))
    with pytest.raises(ValueError, match="halo"):
        binning.choose_geometry((64, 64), 7, 100, ext=(8, 32))


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_every_point_has_slot(rng, rank):
    m = 500
    fine = _FINE[rank]
    pts = _points(rng, m, fine)
    geom = binning.choose_geometry(fine, 5, m, chunk=16)
    b = binning.bin_points(jnp.asarray(pts), geom)
    padpos = np.asarray(b.padpos)
    assert len(np.unique(padpos)) == m          # injective
    assert padpos.max() < geom.num_slots
    # Each point's chunk lies in its own tile's chunk range.
    tid = np.asarray(binning.tile_ids(jnp.asarray(pts), geom))
    bounds = np.asarray(b.tile_bounds)
    chunk_of = padpos // geom.chunk
    assert np.all(bounds[tid] <= chunk_of)
    assert np.all(chunk_of < bounds[tid + 1])


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_invpos_inverse_of_padpos(rng, rank):
    m = 700
    fine = _FINE[rank]
    geom = binning.choose_geometry(fine, 5, m, chunk=64)
    b = binning.bin_points(jnp.asarray(_points(rng, m, fine)), geom)
    padpos = np.asarray(b.padpos)
    invpos = np.asarray(b.invpos)
    np.testing.assert_array_equal(invpos[padpos], np.arange(m))
    pad_mask = np.ones(geom.num_slots, bool)
    pad_mask[padpos] = False
    assert np.all(invpos[pad_mask] == m)


@pytest.mark.parametrize("tiles_per_axis", [2, 5])
def test_padpos_matches_oracle(rng, tiles_per_axis):
    """Stable grouping by tile, tiles padded to whole chunks, empty
    tiles owning no chunk: against a numpy counting oracle."""
    geom = binning.choose_geometry((24 * tiles_per_axis,) * 2, 7, 3000,
                                   chunk=32)
    assert geom.tiles == (tiles_per_axis,) * 2
    m = 3000
    pts = _points(rng, m, geom.fine_shape)
    pts[:, 0] = np.minimum(pts[:, 0], 30.0)     # leaves tiles empty
    b = binning.bin_points(jnp.asarray(pts), geom)

    t = geom.tile[0]
    tid = ((pts[:, 0] // t).astype(int) * tiles_per_axis
           + (pts[:, 1] // t).astype(int))
    counts = np.bincount(tid, minlength=geom.num_tiles)
    rounds = -(-counts // geom.chunk)
    starts = np.cumsum(rounds) - rounds
    seen = np.zeros(geom.num_tiles, int)
    expect = np.empty(m, int)
    for i in range(m):
        expect[i] = starts[tid[i]] * geom.chunk + seen[tid[i]]
        seen[tid[i]] += 1
    np.testing.assert_array_equal(np.asarray(b.padpos), expect)
    np.testing.assert_array_equal(np.asarray(b.tile_bounds),
                                  np.concatenate([[0], np.cumsum(rounds)]))


def test_slot_values_and_back(rng):
    m, b2 = 300, 4
    geom = binning.choose_geometry((64, 64), 5, m)
    pts = _points(rng, m, (64, 64))
    b = binning.bin_points(jnp.asarray(pts), geom)
    vals = rng.standard_normal((b2, m)).astype(np.float32)
    slots = np.asarray(binning.to_slots(jnp.asarray(vals), b))
    ref = np.zeros((b2, geom.num_slots), np.float32)
    ref[:, np.asarray(b.padpos)] = vals
    np.testing.assert_array_equal(slots, ref)
    back = np.asarray(binning.from_slots(jnp.asarray(slots), b))
    np.testing.assert_array_equal(back, vals)


def test_slot_coords_sentinels(rng):
    m = 200
    geom = binning.choose_geometry((64, 64), 5, m)
    pts = _points(rng, m, (64, 64))
    lo = (rng.standard_normal((m, 2)) * 1e-6).astype(np.float32)
    b = binning.bin_points((jnp.asarray(pts), jnp.asarray(lo)), geom)
    coords = np.asarray(binning.slot_coords(b))
    assert coords.shape == (4, geom.num_slots)
    padpos = np.asarray(b.padpos)
    np.testing.assert_array_equal(coords[:2, padpos], pts.T)
    np.testing.assert_array_equal(coords[2:, padpos], lo.T)
    pad_mask = np.ones(geom.num_slots, bool)
    pad_mask[padpos] = False
    assert np.all(coords[:2, pad_mask] == binning.SENTINEL)
    assert np.all(coords[2:, pad_mask] == 0.0)


@pytest.mark.parametrize("fine", [(64, 64), (50, 36), (40,), (20, 12, 28),
                                  (6,)])
def test_overlap_add_core_roundtrip(rng, fine):
    """extend_tiles then overlap_add with the halos zeroed (cores only)
    is the identity, including tiles that run past the grid edge."""
    geom = binning.choose_geometry(fine, 7, 100)
    x = jnp.asarray(rng.standard_normal((2,) + fine).astype(np.float32))
    ext = np.asarray(binning.extend_tiles(x, geom))
    pad, rank = geom.pad, geom.rank
    core = np.zeros_like(ext)
    idx = (Ellipsis,) + tuple(slice(pad, pad + t) for t in geom.tile)
    core[idx] = ext[idx]
    # Cores of edge tiles past the grid alias wrapped points: keep only
    # the grid's own cells once (zero the overhang).
    for d in range(rank):
        over = geom.tiles[d] * geom.tile[d] - fine[d]
        if over:
            sl = [slice(None)] * core.ndim
            sl[d] = geom.tiles[d] - 1
            sl[rank + 1 + d] = slice(pad + geom.tile[d] - over,
                                     pad + geom.tile[d])
            core[tuple(sl)] = 0.0
    back = binning.overlap_add(jnp.asarray(core), geom)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), rtol=1e-6)


@pytest.mark.parametrize("fine", [(64, 64), (50, 36), (20, 12, 28)])
def test_overlap_add_is_adjoint_of_extend(rng, fine):
    geom = binning.choose_geometry(fine, 7, 100)
    x = rng.standard_normal((2,) + fine)
    t = rng.standard_normal(geom.tiles + (2,) + geom.ext)
    lhs = np.vdot(np.asarray(binning.overlap_add(jnp.asarray(t), geom)), x)
    rhs = np.vdot(t, np.asarray(binning.extend_tiles(jnp.asarray(x), geom)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_extend_tiles_halo_wrap():
    geom = binning.choose_geometry((64, 64), 7, 100)
    x = jnp.asarray(np.arange(64 * 64, dtype=np.float32).reshape(1, 64, 64))
    ext = np.asarray(binning.extend_tiles(x, geom))
    pad = geom.pad
    # Tile (0, 0)'s top halo rows wrap to the grid's bottom rows.
    np.testing.assert_array_equal(
        ext[0, 0, 0, :pad, pad:pad + geom.tile[1]],
        np.asarray(x)[0, -pad:, :geom.tile[1]])
