"""Full benchmark suite on one GPU: the reference's 8 cases plus the
radial multicoil, type-3 and CG-SENSE workloads.

Reference harness (nufft_ops_test.py:728-809): 2D 256^2 type-1/2 with
200k points (single / batch-16 shared points / batch-16 per-batch
points), 3D 128^3 type-1/2 with 800k points.

Run: python bench_suite.py [--quick] [--case NAME] [--timeout SECS]
Prints one JSON line per case to stdout, each with the device it ran on
(platform, device kind, count, the card's name and power limit). Fails
when JAX finds no GPU. Each case runs in its own subprocess, one after
another (one process on the card at a time); ``--case NAME`` runs a
single case in-process. Times are the median, on the host clock around
``block_until_ready``, of TIMING_RUNS applies after a warm-up apply.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TIMING_RUNS = 20


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def use_compile_cache():
    """JAX's persistent compile cache: JAX_COMPILATION_CACHE_DIR where
    set, else a fixed directory under build/."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "jax_cache"))


def card_info():
    """(name, power limit) of the first card, as nvidia-smi reports
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    name, limit = out.strip().splitlines()[0].split(",")
    return name.strip(), limit.strip()


def require_gpu():
    """Device fields for every result line; exits when JAX finds no
    GPU (a CPU time is never reported as a device time)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: JAX platform is {dev.platform!r}")
    name, limit = card_info()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": name,
            "power_limit": limit}


def median_time(fn, *args, runs=TIMING_RUNS):
    """Median seconds per call of a jitted ``fn`` after one warm-up
    call, on the host clock around ``block_until_ready``."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def peak_bytes():
    """Best-effort device peak-memory counter (the reference harness
    records memory via run_op_benchmark, nufft_ops_test.py:728-809).
    None where the backend does not expose allocator stats."""
    import jax
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        return stats.get("peak_bytes_in_use")
    except Exception:
        return None


def attach_peak(result, base):
    """Adds peak_bytes to a case result — only when this case raised
    the process-cumulative peak past ``base`` (the value at case start),
    so --inprocess runs never report an earlier, larger case's peak as
    their own. In the default one-subprocess-per-case mode the baseline
    is just this case's setup."""
    p = peak_bytes()
    if p is not None and (base is None or p > base):
        result["peak_bytes"] = p
    return result


# --- Device accuracy gates ------------------------------------------------
# Every throughput row checks one device apply against a cached
# forced-CPU f32 reference at GATE_MULT * tol before timing (the
# reference's own harness asserts accuracy in every test,
# nufft_ops_test.py:812; device-only code paths exist that CPU tests
# cannot reach).
# References are keyed by TRANSFORM CONFIG (not row name), so e.g. the
# slot rows share the base row's reference. Generation runs in a
# forced-CPU subprocess (`--make-case-ref ROW`) and is cached in build/.

CASE_TOL = 1e-6
GATE_MULT = 10.0
_REF_MODE = False          # set by --make-case-ref: compute CPU refs


def _ref_path(key):
    import pathlib
    return (pathlib.Path(__file__).parent / "build"
            / f"caseref_{key}.npz")


def _case_key(grid_shape, num_points, transform_type, batch,
              shared_points, radial):
    g = "x".join(str(d) for d in grid_shape)
    b = f"b{batch}" if batch else "b1"
    s = "shared" if (shared_points or batch is None) else "perbatch"
    r = "radial" if radial else "uniform"
    return f"{g}_{num_points}_{transform_type}_{b}_{s}_{r}"


def _write_case_ref(key, src_np, pts_np, transform_type, grid_shape):
    """Forced-CPU f32 reference via the unplanned planar pipeline with
    the native (C++/OpenMP) spread/interp engine — a code path disjoint
    from the device kernels being gated."""
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.options.options import Options
    kwargs = (dict(grid_shape=grid_shape)
              if transform_type == "type_1" else {})
    # The native OpenMP engine can deadlock when invoked from JAX's
    # CPU-backend callback thread at large fine grids (XLA's spinning
    # worker threads starve the OpenMP team — observed on the radial
    # 512^2 and 3D 128^3 type-2 refs, fine arrays >= ~16M elements).
    # Route those through the XLA scan kernels; BENCH_REF_BACKEND
    # overrides either way.
    fine_elems = int(np.prod([2 * g for g in grid_shape]))
    elem_rank = 2 if transform_type == "type_1" else len(grid_shape) + 1
    chans = 2 * int(np.prod(src_np.shape[:src_np.ndim - elem_rank],
                            dtype=np.int64) or 1)
    big = chans * fine_elems >= (1 << 24)
    backend = os.environ.get("BENCH_REF_BACKEND",
                             "xla" if big else "native")
    try:
        opts = Options(backend=backend)
        ref = np.asarray(tfft.planar.nufft(
            src_np, pts_np, transform_type=transform_type,
            tol=CASE_TOL, options=opts, **kwargs))
    except Exception as e:  # engine unavailable: default path
        log(f"{backend} backend failed ({e}); using default CPU path")
        ref = np.asarray(tfft.planar.nufft(
            src_np, pts_np, transform_type=transform_type,
            tol=CASE_TOL, **kwargs))
    p = _ref_path(key)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, ref=ref, scale=float(np.max(np.abs(ref))))
    log(f"wrote {p}")
    return {"metric": key, "ref": "written"}


def _ensure_case_ref(row_name, key):
    """Loads the cached CPU reference for ``key``, generating it via a
    forced-CPU `--make-case-ref row_name` subprocess (which never opens
    the card) on first use. Raises when generation fails."""
    p = _ref_path(key)
    if not p.exists():
        log(f"computing CPU reference for {row_name} (key {key}) ...")
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--make-case-ref", row_name],
            env=env, check=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    return np.load(p)


def _acc_fields(row_name, key, out_np):
    """err/pass fields for one device output vs the cached CPU
    reference (max abs err normalized by the reference's own scale)."""
    data = _ensure_case_ref(row_name, key)
    ref = data["ref"]
    scale = float(data["scale"]) or 1.0
    if out_np.shape != ref.shape:
        log(f"{row_name}: output shape {out_np.shape} != reference "
            f"{ref.shape}")
        return {"acc_err": float("inf"), "acc_gate": GATE_MULT * CASE_TOL,
                "pass": False}
    err = float(np.max(np.abs(out_np - ref)) / scale)
    gate = GATE_MULT * CASE_TOL
    ok = bool(err < gate)
    log(f"{row_name}: acc_err={err:.3e} (gate < {gate:g}) pass={ok}")
    return {"acc_err": err, "acc_gate": gate, "pass": ok}


def nufft_case(name, grid_shape, num_points, transform_type,
               batch=None, shared_points=True, points_arr=None,
               slots=False, check=True):
    import jax
    import jax.numpy as jnp
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.planar import to_planar

    mem_base = peak_bytes()

    rng = np.random.default_rng(7)
    rank = len(grid_shape)
    pts_batch = () if (shared_points or batch is None) else (batch,)
    src_batch = () if batch is None else (batch,)
    if points_arr is not None:
        points = np.broadcast_to(
            points_arr.astype(np.float32),
            pts_batch + points_arr.shape).copy()
        num_points = points.shape[-2]
    else:
        points = rng.uniform(-np.pi, np.pi,
                             pts_batch + (num_points, rank)).astype(
            np.float32)
    if transform_type == "type_1":
        z = (rng.standard_normal(src_batch + (num_points,))
             + 1j * rng.standard_normal(src_batch + (num_points,)))
        kwargs = dict(grid_shape=grid_shape)
    else:
        z = (rng.standard_normal(src_batch + grid_shape)
             + 1j * rng.standard_normal(src_batch + grid_shape))
        kwargs = {}
    key = _case_key(grid_shape, num_points, transform_type, batch,
                    shared_points, points_arr is not None)
    src_np = to_planar(z.astype(np.complex64))
    if _REF_MODE:
        return _write_case_ref(key, src_np, points, transform_type,
                               grid_shape)
    src = jnp.asarray(src_np)
    pts = jnp.asarray(points)

    # Shared fixed points: time the planned transform (the repeated-
    # transform regime; falls back internally where unsupported).
    # Per-batch trajectories: the batched planned op (one planned
    # transform per trajectory, one vmapped prep; reference analog: the outer points-batch loop,
    # cc/kernels/nufft_kernels.cc:491).
    op = None
    bop = None
    if shared_points:
        op = tfft.planar.PlannedNufft(
            pts, grid_shape, transform_type=transform_type)
        src_b = src if batch is not None else src[None]
    elif batch is not None:
        bop = tfft.planar.BatchedPlannedNufft(
            pts, grid_shape, transform_type=transform_type)
    if slots:
        # Slot-order apply surface: the iterative-
        # pipeline regime where per-point vectors stay in the plan's
        # chunk-slot layout — skips the per-call point-order
        # permutation gather. Loop-invariant conversion done once here.
        assert op is not None and op._planned, name
        if transform_type == "type_1":
            src_b = op.to_slots(src_b)

    acc = {}
    if check:
        # One unperturbed apply, gated vs the cached CPU reference.
        # Slot rows convert back to point/grid order (one extra gather)
        # so the SAME reference serves slot and point-order rows.
        def once():
            if slots and transform_type == "type_1":
                return op.apply_from_slots(src_b)
            if slots:
                return op.from_slots(op.apply_to_slots(src_b))
            if op is not None:
                return op(src_b)
            if bop is not None:
                return bop(src)
            return tfft.planar.nufft(
                src, pts, transform_type=transform_type, **kwargs)
        out_np = np.asarray(jax.jit(once)())
        if op is not None and batch is None:
            out_np = out_np[0]
        acc = _acc_fields(name, key, out_np)

    def apply(x, p):
        if slots and transform_type == "type_1":
            return op.apply_from_slots(x)
        if slots:
            return op.apply_to_slots(x)
        if op is not None:
            return op(x)
        if bop is not None:
            return bop(x)
        return tfft.planar.nufft(x, p, transform_type=transform_type,
                                 **kwargs)

    per = median_time(jax.jit(apply), src_b if op is not None else src,
                      pts)
    total_pts = num_points * (batch or 1)
    result = {
        "metric": name,
        "value": round(total_pts / per, 1),
        "unit": "points/s",
        "ms_per_transform": round(per * 1e3, 3),
        "planned": bool(op is not None and op._planned
                        or bop is not None and bop._planned),
    }
    result.update(acc)
    return attach_peak(result, mem_base)


def _write_t3_ref(key, src_np, x, t):
    """Forced-CPU f32 type-3 reference (XLA pipeline — disjoint from
    the spread kernel being gated)."""
    import tensorflow_nufft_tpu as tfft
    ref = np.asarray(tfft.planar.nufft_type3(src_np, x, t,
                                             tol=CASE_TOL))
    p = _ref_path(key)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, ref=ref, scale=float(np.max(np.abs(ref))))
    log(f"wrote {p}")
    return {"metric": key, "ref": "written"}


def type3_case(name="2d_t3_200k_200k", rank=2, m=200_000,
               k_targets=200_000, t_range=64.0, planned=True,
               check=True):
    """Type-3 (nonuniform -> nonuniform): m source points -> k_targets
    target frequencies, planned (Type3Plan) or unplanned (the
    functional nufft_type3, re-planning statics every call inside the
    jit). No reference counterpart (the reference never implemented
    type-3); throughput counts source + target points per second."""
    import jax
    import jax.numpy as jnp
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.planar import to_planar

    mem_base = peak_bytes()
    rng = np.random.default_rng(7)
    x = rng.uniform(-np.pi, np.pi, (m, rank)).astype(np.float32)
    t = rng.uniform(-t_range, t_range,
                    (k_targets, rank)).astype(np.float32)
    z = (rng.standard_normal(m) + 1j * rng.standard_normal(m))
    src_np = to_planar(z.astype(np.complex64))[None]
    key = f"t3_{rank}d_{m}_{k_targets}_{t_range:g}"
    if _REF_MODE:
        return _write_t3_ref(key, src_np, x, t)
    src = jnp.asarray(src_np)
    op = tfft.planar.Type3Plan(x, t)
    xj, tj = jnp.asarray(x), jnp.asarray(t)

    acc = {}
    if check:
        # One unperturbed apply vs the cached CPU reference (both the
        # planned and unplanned rows gate the same transform).
        fn = (lambda s: op(s)) if planned else (
            lambda s: tfft.planar.nufft_type3(s, xj, tj))
        out_np = np.asarray(jax.jit(fn)(src))
        acc = _acc_fields(name, key, out_np)

    fn = (lambda s: op(s)) if planned else (
        lambda s: tfft.planar.nufft_type3(s, xj, tj))
    per = median_time(jax.jit(fn), src)
    result = {
        "metric": name,
        "value": round((m + k_targets) / per, 1),
        "unit": "points/s",
        "ms_per_transform": round(per * 1e3, 3),
        "fine_shape": list(op.fine_shape),
        "planned": planned,
        "planned_spread": bool(planned and op._spread_planned),
    }
    result.update(acc)
    return attach_peak(result, mem_base)


def census_3d_case(grid=128, m=800_000, tol=1e-6, seed=42):
    """3D accuracy census on the device: the planned type-1 path at
    128^3/800k vs a float64 CPU NUFFT
    at the same tol (err_impl, full mode census) and an exact f64 NUDFT
    on a 4096-mode subset (err_total). The f64 references are computed
    in a forced-CPU x64 subprocess and cached in build/.

    Gate: unlike the 2D headline (f32 floor 2.5e-7 << tol), the rank-3
    f32 precision floor at this scale is ~3.6e-6 — already above
    tol=1e-6 on the CPU float32 pipeline — so "err_impl < tol" is not
    an implementation property at rank 3. The census therefore gates
    err_impl < max(tol, 4 * floor_f32) (parity with the measured f32
    floor; 4x allows for another summation order on the device) plus
    the same err_total < 10*tol total-error bar as 2D."""
    import pathlib
    import jax
    import jax.numpy as jnp
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.planar import to_planar

    ref_path = (pathlib.Path(__file__).parent / "build"
                / f"census3d_{grid}_{m}_{seed}_{tol:g}.npz")
    if ref_path.exists() and "floor_f32" not in np.load(ref_path):
        # Stale ref from before the floor was recorded: gating at bare
        # tol would be a guaranteed-false failure at rank 3 (the f32
        # floor sits above tol) — regenerate instead.
        log(f"census ref {ref_path.name} predates floor_f32; "
            f"regenerating")
        ref_path.unlink()
    if not ref_path.exists():
        log("computing 3D float64 CPU references in a subprocess ...")
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--make-census-ref", str(grid), str(m), str(tol),
             str(seed)],
            check=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    data = np.load(ref_path)

    rng = np.random.default_rng(seed)
    gs = (grid,) * 3
    pts = rng.uniform(-np.pi, np.pi, (m, 3)).astype(np.float32)
    z = (rng.standard_normal(m)
         + 1j * rng.standard_normal(m)).astype(np.complex64)
    src = jnp.asarray(to_planar(z))[None]
    op = tfft.planar.PlannedNufft(jnp.asarray(pts), gs,
                                  transform_type="type_1", tol=tol)
    out = np.asarray(op(src))[0]
    got = out[..., 0] + 1j * out[..., 1]
    scale = float(data["scale"])
    err_impl = float(np.max(np.abs(got - data["cpu_ref"])) / scale)
    idx = data["subset_idx"]
    sub = got.reshape(-1)[idx]
    err_total = float(np.max(np.abs(sub - data["subset_oracle"]))
                      / scale)
    floor = float(data["floor_f32"]) if "floor_f32" in data else None
    gate_impl = max(tol, 4 * floor) if floor is not None else tol
    log(f"3d census: err_impl={err_impl:.3e} (gate < {gate_impl:g}; "
        f"f32 floor {floor if floor is not None else float('nan'):.3e}), "
        f"err_total={err_total:.3e} (gate < {10 * tol:g})")
    return {
        "metric": f"3d_census_{grid}_{m // 1000}k",
        "value": err_impl,
        "unit": "err_impl",
        "err_total_subset": err_total,
        "tol": tol,
        "floor_f32": floor,
        "gate_impl": gate_impl,
        "planned": bool(op._planned),
        "pass": bool(err_impl < gate_impl and err_total < 10 * tol),
    }


def make_census_ref(grid, m, tol, seed):
    """Forced-CPU x64 subprocess: f64 same-tol NUFFT (full census) +
    exact NUDFT on a 4096-mode subset (chunked; the full 128^3 dense
    oracle is infeasible)."""
    import pathlib
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import tensorflow_nufft_tpu as tfft

    rng = np.random.default_rng(seed)
    gs = (grid,) * 3
    pts = rng.uniform(-np.pi, np.pi, (m, 3)).astype(np.float64)
    z = (rng.standard_normal(m)
         + 1j * rng.standard_normal(m)).astype(np.complex128)
    cpu_ref = np.asarray(tfft.nufft(z, pts, grid_shape=gs,
                                    transform_type="type_1", tol=tol))
    scale = float(np.abs(cpu_ref).max())

    # f32 precision floor of the same transform: the CPU float32
    # planar pipeline vs the f64 reference. At 128^3/800k this is
    # ~3.6e-6 — ABOVE tol=1e-6 — so "err_impl < tol" is unachievable
    # in f32 for ANY implementation; the census gates the device path
    # against a small multiple of this floor instead (matching the
    # reference's own f32 positioning: its c64 CI bar is 1e-3,
    # nufft_ops_test.py:198-202).
    from tensorflow_nufft_tpu.planar import to_planar
    import jax.numpy as jnp
    pf = np.asarray(tfft.planar.nufft(
        jnp.asarray(to_planar(z.astype(np.complex64))),
        jnp.asarray(pts.astype(np.float32)), grid_shape=gs,
        transform_type="type_1", tol=tol))
    got32 = pf[..., 0] + 1j * pf[..., 1]
    floor_f32 = float(np.max(np.abs(got32 - cpu_ref)) / scale)

    sub_rng = np.random.default_rng(seed + 1)
    idx = np.sort(sub_rng.choice(grid ** 3, 4096, replace=False))
    kk = np.stack(np.unravel_index(idx, gs), axis=-1) - grid // 2
    oracle = np.empty(len(idx), np.complex128)
    for lo in range(0, len(idx), 256):
        k = kk[lo:lo + 256]
        phase = pts @ k.T                     # [m, <=256]
        oracle[lo:lo + k.shape[0]] = (
            np.exp(-1j * phase) * z[:, None]).sum(axis=0)
    ref_path = (pathlib.Path(__file__).parent / "build"
                / f"census3d_{grid}_{m}_{seed}_{tol:g}.npz")
    ref_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(ref_path, cpu_ref=cpu_ref, scale=scale, subset_idx=idx,
             subset_oracle=oracle, floor_f32=floor_f32)
    log(f"wrote {ref_path}")


def bigm_case(name="2d_t1_512_20m_bigm", grid_shape=(512, 512),
              num_points=20_000_000, check=True):
    """Big-M regime: 20M points at 512^2, timed as the points-side prep
    (fold + binning + slot coordinates) and the apply (values
    permutation + spread + mode contraction), each jitted on its own;
    the row reports their sum — the work an unplanned call does."""
    import functools
    import jax
    import jax.numpy as jnp
    from tensorflow_nufft_tpu.planar import (
        to_planar, _planned_prep, planned_spread_modes)
    from tensorflow_nufft_tpu.kernels import binning
    from tensorflow_nufft_tpu.plan.plan import PlanSpec, make_plan

    mem_base = peak_bytes()
    rng = np.random.default_rng(7)
    rank = len(grid_shape)
    points = rng.uniform(-np.pi, np.pi,
                         (num_points, rank)).astype(np.float32)
    z = (rng.standard_normal(num_points)
         + 1j * rng.standard_normal(num_points))
    src_np = to_planar(z.astype(np.complex64))
    key = _case_key(grid_shape, num_points, "type_1", None, False,
                    False)
    if _REF_MODE:
        return _write_case_ref(key, src_np, points, "type_1",
                               grid_shape)
    src = jnp.asarray(src_np)
    pts = jnp.asarray(points)

    spec = PlanSpec(
        transform_type="type_1", fft_direction="forward", rank=rank,
        grid_shape=grid_shape, dtype_name="complex64", tol=CASE_TOL,
        points_range=0, spread_only=False)
    plan = make_plan(spec)
    geom = binning.choose_geometry(plan.fine_shape, plan.width,
                                   num_points)
    log(f"bigm: geom ext={geom.ext} chunk={geom.chunk} "
        f"slots={geom.num_slots}")

    stage_a = jax.jit(functools.partial(
        _planned_prep, geom=geom, fine_shape=plan.fine_shape,
        points_range=0))

    @jax.jit
    def stage_b(s, arts):
        _, binned, coords = arts
        cm = jnp.moveaxis(s, -1, 0).astype(jnp.float32)     # [2, M]
        vals = binning.to_slots(cm, binned)
        return planned_spread_modes(vals, coords, binned.tile_bounds,
                                    plan, geom, 1)

    arts = stage_a(pts)
    acc = {}
    if check:
        out_np = np.asarray(stage_b(src, arts))[0]
        acc = _acc_fields(name, key, out_np)

    per_a = median_time(stage_a, pts)
    per_b = median_time(stage_b, src, arts)
    per = per_a + per_b
    result = {
        "metric": name,
        "value": round(num_points / per, 1),
        "unit": "points/s",
        "ms_per_transform": round(per * 1e3, 3),
        "ms_prep": round(per_a * 1e3, 3),
        "ms_apply": round(per_b * 1e3, 3),
    }
    result.update(acc)
    return attach_peak(result, mem_base)


def cg_sense_case(toeplitz=False):
    import jax
    import jax.numpy as jnp
    from tensorflow_nufft_tpu.models import mri

    mem_base = peak_bytes()
    grid = (128, 128)
    coils = 8
    spokes, samples = 128, 256
    pts = jnp.asarray(mri.radial_trajectory(spokes, samples))
    maps = jnp.asarray(mri.birdcage_maps(coils, grid))
    phantom = jnp.asarray(mri.shepp_logan(grid))
    density = jnp.asarray(mri.radial_density(spokes, samples))
    op = mri.SenseNufft(pts, maps, grid, density=density,
                        toeplitz=toeplitz)
    kspace = jax.jit(op.forward)(phantom)

    per = median_time(jax.jit(lambda k: mri.cg_sense(k, op,
                                                      num_iters=10)),
                      kspace)
    suffix = "_toeplitz" if toeplitz else ""
    result = {
        "metric": f"cg_sense_10iter_128_8coil_radial{suffix}",
        "value": round(per * 1e3, 2),
        "unit": "ms/recon",
    }
    return attach_peak(result, mem_base)


def _case_registry(quick: bool):
    """Ordered {name: thunk} of all suite cases."""
    cases = [
        ("2d_t2_256_200k", (256, 256), 200_000, "type_2", None, True),
        ("2d_t1_256_200k", (256, 256), 200_000, "type_1", None, True),
        ("2d_t1_256_65k", (256, 256), 65_536, "type_1", None, True),
        ("2d_t2_256_200k_b16_shared", (256, 256), 200_000, "type_2",
         16, True),
        ("2d_t1_256_200k_b16_shared", (256, 256), 200_000, "type_1",
         16, True),
    ]
    if not quick:
        cases += [
            ("2d_t2_256_200k_b16_perbatch", (256, 256), 200_000,
             "type_2", 16, False),
            ("3d_t2_128_800k", (128, 128, 128), 800_000, "type_2",
             None, True),
            ("3d_t1_128_800k", (128, 128, 128), 800_000, "type_1",
             None, True),
            ("3d_t1_128_1m", (128, 128, 128), 1_000_000, "type_1",
             None, True),
        ]
    reg = {}
    for name, gs, m, tt, batch, shared in cases:
        reg[name] = (lambda n=name, g=gs, mm=m, t=tt, b=batch, s=shared:
                     nufft_case(n, g, mm, t, b, s))

    if not quick:
        def radial_case():
            # 512^2 grid, radial MRI trajectory, 8 coils sharing
            # points, type-2.
            from tensorflow_nufft_tpu.models import mri
            radial = np.asarray(mri.radial_trajectory(512, 1024))
            return nufft_case("2d_t2_512_radial_b8", (512, 512), 0,
                              "type_2", batch=8, shared_points=True,
                              points_arr=radial)
        reg["2d_t2_512_radial_b8"] = radial_case
        # Slot-order apply rows: same transforms with per-point
        # vectors kept in the plan's chunk-slot layout.
        reg["2d_t1_256_65k_slots"] = (
            lambda: nufft_case("2d_t1_256_65k_slots", (256, 256),
                               65_536, "type_1", None, True,
                               slots=True))
        reg["2d_t1_256_200k_slots"] = (
            lambda: nufft_case("2d_t1_256_200k_slots", (256, 256),
                               200_000, "type_1", None, True,
                               slots=True))
        reg["3d_t1_128_800k_slots"] = (
            lambda: nufft_case("3d_t1_128_800k_slots",
                               (128, 128, 128), 800_000, "type_1",
                               None, True, slots=True))
        reg["3d_t2_128_800k_slots"] = (
            lambda: nufft_case("3d_t2_128_800k_slots",
                               (128, 128, 128), 800_000, "type_2",
                               None, True, slots=True))

        def radial_slots_case():
            from tensorflow_nufft_tpu.models import mri
            radial = np.asarray(mri.radial_trajectory(512, 1024))
            return nufft_case("2d_t2_512_radial_b8_slots", (512, 512),
                              0, "type_2", batch=8, shared_points=True,
                              points_arr=radial, slots=True)
        reg["2d_t2_512_radial_b8_slots"] = radial_slots_case
        reg["2d_t3_200k_200k"] = type3_case
        # 3D type-3 at MRI field-map scale: planned vs
        # unplanned on the same 500k->500k problem. t_range 16 keeps
        # the internal fine grid ~64^3 (nf ~ 2*sigma*X*S/pi + w).
        reg["3d_t3_500k_500k"] = (
            lambda: type3_case("3d_t3_500k_500k", rank=3, m=500_000,
                               k_targets=500_000, t_range=16.0))
        reg["3d_t3_500k_500k_unplanned"] = (
            lambda: type3_case("3d_t3_500k_500k_unplanned", rank=3,
                               m=500_000, k_targets=500_000,
                               t_range=16.0, planned=False))
        reg["cg_sense"] = cg_sense_case
        reg["cg_sense_toeplitz"] = (
            lambda: cg_sense_case(toeplitz=True))
        reg["3d_census_128_800k"] = census_3d_case
        # Big-M regime: 20M points at 512^2 (see bigm_case).
        reg["2d_t1_512_20m_bigm"] = bigm_case
    return reg


def _run_subprocess(name: str, timeout: float):
    """Runs one case as `bench_suite.py --case name`, returns its JSON
    result (or an error record on timeout / crash)."""
    cmd = [sys.executable, os.path.abspath(__file__), "--case", name]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired:
        return {"metric": name, "error": f"timeout after {timeout:.0f}s"}
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                pass
    tail = (proc.stderr or proc.stdout or "")[-300:]
    return {"metric": name, "error": f"rc={proc.returncode}: {tail}"}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--case", default=None,
                        help="run one case in-process")
    parser.add_argument("--timeout", type=float, default=900.0,
                        help="per-case wall clock in seconds")
    parser.add_argument("--inprocess", action="store_true",
                        help="run all cases in this process (no "
                             "isolation; old behavior)")
    parser.add_argument("--make-census-ref", nargs=4, default=None,
                        metavar=("GRID", "M", "TOL", "SEED"),
                        help="internal: build the 3D census f64 "
                             "references (forced-CPU subprocess)")
    parser.add_argument("--make-case-ref", default=None, metavar="ROW",
                        help="internal: build one row's CPU f32 "
                             "accuracy reference (forced-CPU "
                             "subprocess; refs are keyed by transform "
                             "config and cached in build/)")
    args = parser.parse_args()

    if args.make_census_ref is not None:
        g, m, tol, seed = args.make_census_ref
        make_census_ref(int(g), int(m), float(tol), int(seed))
        return

    if args.make_case_ref is not None:
        # FORCE the CPU backend in-process: a reference computed on the
        # card, through the pipeline it is meant to gate, is vacuous
        # (and a second process on the card fails for want of memory).
        import jax
        jax.config.update("jax_platforms", "cpu")
        assert jax.default_backend() == "cpu", jax.default_backend()
        global _REF_MODE
        _REF_MODE = True
        # Writes the reference file and logs to stderr only: this child
        # shares its parent case's stdout, whose one JSON line is the
        # case result.
        _case_registry(quick=False)[args.make_case_ref]()
        return

    reg = _case_registry(args.quick)

    if args.case is not None:
        use_compile_cache()
        device = require_gpu()
        res = reg[args.case]()
        res["device"] = device
        print(json.dumps(res), flush=True)
        return

    if args.inprocess:
        use_compile_cache()
        device = require_gpu()
        for name, thunk in reg.items():
            res = thunk()
            res["device"] = device
            print(json.dumps(res), flush=True)
        return

    # One case per subprocess, one at a time: this parent never imports
    # JAX, so exactly one process holds the card.
    failed = False
    for name in reg:
        res = _run_subprocess(name, args.timeout)
        failed = failed or "error" in res
        print(json.dumps(res), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
