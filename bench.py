"""Headline benchmark: 2D type-1 NUFFT throughput on one GPU.

Config: 256x256 mode grid, 65536 uniform-random points, eps=1e-6,
planar complex64, through the planned transform (``PlannedNufft``).

Accuracy gate (full 256^2 mode census):
  - err_impl: max |GPU - CPU float64 NUFFT at the same tol| — the
    implementation error; gated at < tol.
  - err_total: max |GPU - exact dense NUDFT| — includes the plan's
    aliasing error, which is ~2.4*tol at tol=1e-6 *in float64 too*
    (inherent to the reference's width formula, nufft_plan.h:739-780).
    Gated at 10*tol.

The float64 references are computed in a forced-CPU subprocess (which
never opens the card) and cached in build/.

Timing: the median, on the host clock around ``block_until_ready``, of
TIMING_RUNS applies after a warm-up apply.

``python bench.py --spread-compare`` instead times type-1 with the
spread kernel (backend='pallas') against the XLA scatter
(backend='xla'), unplanned (``tfft.planar.nufft``) and planned, at the
reference harness's shapes, alternating the two in one process.

Fails when JAX finds no GPU. Prints the card (name, power limit) and
the device on every result line; the headline's last line is one JSON
object.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np

from bench_suite import log, median_time, require_gpu, use_compile_cache

GRID = 256
NUM_POINTS = 65536
TOL = 1e-6
SEED = 42
REF_PATH = pathlib.Path(__file__).parent / "build" / \
    f"bench_ref_{GRID}_{NUM_POINTS}_{SEED}_{TOL:g}.npz"

# (name, grid, points, batch) of the spread comparison.
COMPARE_SHAPES = (
    ("2d_t1_256_200k", (256, 256), 200_000, 1),
    ("2d_t1_256_200k_b16", (256, 256), 200_000, 16),
    ("3d_t1_128_800k", (128, 128, 128), 800_000, 1),
)


def _inputs():
    rng = np.random.default_rng(SEED)
    points = rng.uniform(-np.pi, np.pi,
                         (NUM_POINTS, 2)).astype(np.float32)
    z = (rng.standard_normal(NUM_POINTS)
         + 1j * rng.standard_normal(NUM_POINTS)).astype(np.complex64)
    return points, z


def make_ref():
    """Forced-CPU subprocess entry: float64 same-tol NUFFT + exact NUDFT."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import tensorflow_nufft_tpu as tfft

    points, z = _inputs()
    p64 = points.astype(np.float64)
    c128 = z.astype(np.complex128)
    cpu_ref = np.asarray(tfft.nufft(
        c128, p64, grid_shape=(GRID, GRID), transform_type="type_1",
        tol=TOL))
    k = np.arange(GRID) - GRID // 2
    ax = np.exp(-1j * np.outer(p64[:, 0], k))
    ay = np.exp(-1j * np.outer(p64[:, 1], k))
    oracle = (ax * c128[:, None]).T @ ay
    REF_PATH.parent.mkdir(parents=True, exist_ok=True)
    np.savez(REF_PATH, cpu_ref=cpu_ref, oracle=oracle)
    log(f"wrote {REF_PATH}")


def ensure_refs():
    if not REF_PATH.exists():
        log("computing float64 CPU references in a subprocess ...")
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--make-ref"],
            check=True, env=env,
            cwd=pathlib.Path(__file__).parent)
    data = np.load(REF_PATH)
    return data["cpu_ref"], data["oracle"]


def main():
    import jax
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.planar import to_planar

    use_compile_cache()
    device = require_gpu()
    log(f"device: {device}")
    points, z = _inputs()
    strengths = to_planar(z)
    cpu_ref, oracle = ensure_refs()

    op = tfft.planar.PlannedNufft(points, (GRID, GRID),
                                  transform_type="type_1", tol=TOL)
    log(f"planned (spread kernel): {op._planned}")

    # Accuracy gate: full mode census on the planned output (the thing
    # timed); the unplanned API is cross-checked too.
    out = np.asarray(op(strengths[None]))[0]
    out_unplanned = np.asarray(
        tfft.planar.nufft(strengths, points, grid_shape=(GRID, GRID),
                          transform_type="type_1", tol=TOL))
    log(f"planned vs unplanned max abs diff: "
        f"{np.max(np.abs(out - out_unplanned)):.2e}")
    got = out[..., 0] + 1j * out[..., 1]
    scale = np.max(np.abs(oracle))
    err_impl = np.max(np.abs(got - cpu_ref)) / scale
    err_total = np.max(np.abs(got - oracle)) / scale
    log(f"err_impl  (vs CPU f64 NUFFT, same tol): {err_impl:.2e} "
        f"(gate: < {TOL:g})")
    log(f"err_total (vs exact NUDFT):             {err_total:.2e} "
        f"(gate: < {10 * TOL:g})")
    if not (err_impl < TOL and err_total < 10 * TOL):
        sys.exit("accuracy gate failed")

    per = median_time(jax.jit(op), jax.numpy.asarray(strengths)[None])
    print(json.dumps({
        "metric": "nufft_2d_type1_256_65k_eps1e-6_c64_throughput",
        "value": NUM_POINTS / per,
        "unit": "points/s",
        "ms_per_transform": per * 1e3,
        "err_impl": float(err_impl),
        "err_total": float(err_total),
        "device": device,
    }))


def spread_compare():
    """Type-1 with the spread kernel vs the XLA scatter, end to end."""
    import jax
    import jax.numpy as jnp
    import tensorflow_nufft_tpu as tfft

    use_compile_cache()
    device = require_gpu()
    backends = ("pallas", "xla")
    for name, grid, m, batch in COMPARE_SHAPES:
        rng = np.random.default_rng(SEED)
        pts = jnp.asarray(rng.uniform(-np.pi, np.pi, (m, len(grid)))
                          .astype(np.float32))
        src = jnp.asarray(rng.standard_normal((batch, m, 2))
                          .astype(np.float32))
        fns = {}
        for be in backends:
            opts = tfft.Options(backend=be)
            fns[("nufft", be)] = jax.jit(
                lambda s, p, o=opts: tfft.planar.nufft(
                    s, p, grid_shape=grid, transform_type="type_1",
                    options=o))
            op = tfft.planar.PlannedNufft(pts, grid,
                                          transform_type="type_1",
                                          options=opts)
            fns[("planned", be)] = jax.jit(lambda s, p, op=op: op(s))
        outs = {k: np.asarray(f(src, pts)) for k, f in fns.items()}
        ref = outs[("nufft", "xla")]
        scale = np.max(np.abs(ref))
        times = {k: [] for k in fns}
        for _ in range(2):          # alternate: pallas, xla, xla, pallas
            for be in backends + backends[::-1]:
                for surface in ("nufft", "planned"):
                    times[(surface, be)].append(
                        median_time(fns[(surface, be)], src, pts))
        for (surface, be), ts in times.items():
            print(json.dumps({
                "metric": f"{name}_{surface}_{be}",
                "ms_median": float(np.median(ts)) * 1e3,
                "ms_runs": [t * 1e3 for t in ts],
                "points_per_s": batch * m / float(np.median(ts)),
                "max_rel_diff_vs_xla": float(
                    np.max(np.abs(outs[(surface, be)] - ref)) / scale),
                "device": device,
            }), flush=True)


if __name__ == "__main__":
    if "--make-ref" in sys.argv:
        make_ref()
    elif "--spread-compare" in sys.argv:
        spread_compare()
    else:
        main()
