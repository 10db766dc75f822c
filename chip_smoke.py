"""End-to-end smoke test of the NUFFT on one GPU (or four, sharded).

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Runs the public entry points at the reference harness's sizes, with the
spread kernel compiled for the card (never interpreted), and compares
every phase with a plain reference that shares no code with the library:
a float64 NumPy dense NUDFT on the host, over a seeded random subset of
modes (type-1) or points (type-2/3). A phase passes when its relative
max error against max|oracle| is below 10 * tol. Where a float64 run of
the same plan fits on the CPU device, its error (err_impl) is printed
too.

Fails at once when JAX finds no GPU; any failing phase exits non-zero
with no result line. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.

Phases (one card): the spread kernel against the XLA scatter; 2D
type-1; 2D type-2 (batched and radial multicoil); 3D type-1/2; the MRI
model (SENSE + CG, composed and Toeplitz); gradients; type-3 and
complex128. Times are host-clock seconds around ``block_until_ready``;
the first call (compile + run) is printed apart from a warm call.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 1234
SUBSET = 512                         # oracle modes / points per phase
REPO = os.path.dirname(os.path.abspath(__file__))


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


CARD = None


def say(msg):
    print(msg, flush=True)


def timed(fn, *args):
    """(result, first-call seconds, warm-call seconds)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return out, first, time.perf_counter() - t0


def report(phase, err, tol, first=None, warm=None, gate=None, **extra):
    """Prints one phase line and fails the run if err exceeds the gate."""
    gate = 10 * tol if gate is None else gate
    ok = bool(np.isfinite(err) and err < gate)
    times = ""
    if first is not None:
        times = (f" first_call_s={first:.3f} warm_s={warm:.5f}"
                 f" [{CARD}]")
    more = "".join(f" {k}={v}" for k, v in extra.items())
    say(f"{phase}: err={err:.3e} gate={gate:.1e} "
        f"{'PASS' if ok else 'FAIL'}{times}{more}")
    if not ok:
        raise SystemExit(f"phase failed: {phase}")


# ---------------------------------------------------------------------------
# Plain float64 references (NumPy, host).


def _modes(grid):
    return [np.arange(n) - n // 2 for n in grid]


def oracle_type1(c, x, grid, sign, idx):
    """f[k] = sum_j c_j exp(sign i k.x_j) at flat mode indices ``idx``.
    c: [B, M] complex, x: [M, d]."""
    k = np.stack(np.unravel_index(idx, grid), -1) - np.array(grid) // 2
    out = np.empty((c.shape[0], len(idx)), np.complex128)
    for lo in range(0, len(idx), 64):
        ph = np.exp(sign * 1j * (x.astype(np.float64)
                                 @ k[lo:lo + 64].T.astype(np.float64)))
        out[:, lo:lo + 64] = c.astype(np.complex128) @ ph
    return out


def oracle_type2(f, x, sign):
    """c_j = sum_k f[k] exp(sign i k.x_j) for the points x [P, d];
    f: [B, *grid] complex. Separable contraction per axis."""
    grid = f.shape[1:]
    e = [np.exp(sign * 1j * np.outer(k, x[:, d].astype(np.float64)))
         for d, k in enumerate(_modes(grid))]           # [n_d, P]
    t = f.astype(np.complex128)
    if len(grid) == 1:
        return t @ e[0]
    if len(grid) == 2:
        return np.einsum("bij,ip,jp->bp", t, e[0], e[1], optimize=True)
    t = np.einsum("bijk,kp->bijp", t, e[2], optimize=True)
    t = np.einsum("bijp,jp->bip", t, e[1], optimize=True)
    return np.einsum("bip,ip->bp", t, e[0], optimize=True)


def rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def cplx(p):
    p = np.asarray(p, np.float64)
    return p[..., 0] + 1j * p[..., 1]


def cpu_device():
    import jax
    return jax.devices("cpu")[0]


# ---------------------------------------------------------------------------
# Checks shared with tests/test_gpu.py.


def check_spread_kernel(grid=(256, 256), m=200_000, tol=1e-6):
    """The compiled spread kernel (overlap-added) against the XLA scatter
    spread on the same rescaled points. Returns the relative error."""
    import jax
    import jax.numpy as jnp
    from tensorflow_nufft_tpu.kernels import (binning, dispatch,
                                              triton_spread, xla_ops)
    from tensorflow_nufft_tpu.plan.plan import PlanSpec, make_plan

    assert not triton_spread.interpret_mode(), "kernel would interpret"
    plan = make_plan(PlanSpec(
        transform_type="type_1", fft_direction="forward",
        rank=len(grid), grid_shape=grid, dtype_name="complex64", tol=tol,
        points_range=0, spread_only=False))
    assert dispatch.spread_kernel_active(plan, np.float32)
    rng = np.random.default_rng(SEED)
    pts = jnp.asarray(rng.uniform(-np.pi, np.pi, (m, len(grid)))
                      .astype(np.float32))
    vals = jnp.asarray(rng.standard_normal((2, m)).astype(np.float32))

    @jax.jit
    def kernel(v, p):
        pr = xla_ops.fold_and_rescale_split(p, plan.fine_shape, 0)
        tiles, geom = triton_spread.spread(v, pr, plan)
        return binning.overlap_add(tiles, geom)

    @jax.jit
    def scatter(v, p):
        pr = xla_ops.fold_and_rescale_split(p, plan.fine_shape, 0)
        idx, ker = xla_ops.spread_geometry(pr, plan)
        return xla_ops.spread_xla(v, idx, ker, plan)

    got, first, warm = timed(kernel, vals, pts)
    ref, _, warm_x = timed(scatter, vals, pts)
    return rel(np.asarray(got), np.asarray(ref)), first, warm, warm_x


def check_type1_2d(m=200_000, grid=(256, 256), tol=1e-6):
    """Planar type-1 (spread kernel) against the dense oracle on a mode
    subset; returns (err, err_impl, first, warm)."""
    import jax
    import jax.numpy as jnp
    import tensorflow_nufft_tpu as tfft

    rng = np.random.default_rng(SEED)
    x = rng.uniform(-np.pi, np.pi, (m, 2)).astype(np.float32)
    c = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(
        np.complex64)
    src = jnp.asarray(np.stack([c.real, c.imag], -1)[None])
    fn = jax.jit(lambda s, p: tfft.planar.nufft(
        s, p, grid_shape=grid, transform_type="type_1", tol=tol))
    out, first, warm = timed(fn, src, jnp.asarray(x))
    got = cplx(out)[0].reshape(-1)
    idx = np.random.default_rng(SEED + 1).choice(
        got.size, SUBSET, replace=False)
    ref = oracle_type1(c[None], x, grid, -1, idx)[0]
    with jax.default_device(cpu_device()):
        impl = np.asarray(tfft.nufft(
            c.astype(np.complex128), x.astype(np.float64),
            grid_shape=grid, transform_type="type_1", tol=tol))
    err_impl = rel(cplx(out)[0], impl)
    return rel(got[idx], ref), err_impl, first, warm


# ---------------------------------------------------------------------------
# Phases (one card).


def phase_kernel():
    for grid, m in (((256, 256), 200_000), ((128, 128, 128), 800_000)):
        err, first, warm, warm_x = check_spread_kernel(grid, m)
        report(f"spread_kernel {grid} m={m} (compiled) vs xla scatter",
               err, 1e-6, first, warm, gate=1e-5,
               xla_scatter_warm_s=f"{warm_x:.5f}")


def phase_2d_type1():
    import jax
    import jax.numpy as jnp
    import tensorflow_nufft_tpu as tfft

    err, err_impl, first, warm = check_type1_2d()
    report("2d_t1 256^2 m=200000 planar.nufft", err, 1e-6, first, warm,
           err_impl=f"{err_impl:.3e}")
    rng = np.random.default_rng(SEED)
    for m in (200_000, 65_536):
        x = rng.uniform(-np.pi, np.pi, (m, 2)).astype(np.float32)
        c = (rng.standard_normal(m)
             + 1j * rng.standard_normal(m)).astype(np.complex64)
        idx = rng.choice(256 * 256, SUBSET, replace=False)
        ref = oracle_type1(c[None], x, (256, 256), -1, idx)[0]
        xj = jnp.asarray(x)
        # Complex path (XLA scatter + FFT).
        fn = jax.jit(lambda s, p: tfft.nufft(
            s, p, grid_shape=(256, 256), transform_type="type_1"))
        out, first, warm = timed(fn, jnp.asarray(c), xj)
        report(f"2d_t1 256^2 m={m} nufft complex64",
               rel(np.asarray(out).reshape(-1)[idx], ref), 1e-6,
               first, warm)
        # Planned planar path (hoisted binning + spread kernel).
        op = tfft.planar.PlannedNufft(xj, (256, 256),
                                      transform_type="type_1")
        src = jnp.asarray(np.stack([c.real, c.imag], -1)[None])
        out, first, warm = timed(jax.jit(lambda s: op(s)), src)
        report(f"2d_t1 256^2 m={m} PlannedNufft",
               rel(cplx(out)[0].reshape(-1)[idx], ref), 1e-6, first,
               warm, planned=op._planned)


def phase_2d_type2():
    import jax
    import jax.numpy as jnp
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.models import mri

    rng = np.random.default_rng(SEED)
    m, b = 200_000, 16
    x = rng.uniform(-np.pi, np.pi, (m, 2)).astype(np.float32)
    f = (rng.standard_normal((b, 256, 256))
         + 1j * rng.standard_normal((b, 256, 256))).astype(np.complex64)
    sel = rng.choice(m, SUBSET, replace=False)
    ref = oracle_type2(f[:4], x[sel], -1)
    fn = jax.jit(lambda s, p: tfft.nufft(s, p, transform_type="type_2"))
    out, first, warm = timed(fn, jnp.asarray(f), jnp.asarray(x))
    report("2d_t2 256^2 m=200000 b=16 nufft complex64",
           rel(np.asarray(out)[:4, sel], ref), 1e-6, first, warm)
    fp = jnp.asarray(np.stack([f.real, f.imag], -1))
    fn = jax.jit(lambda s, p: tfft.planar.nufft(s, p))
    out, first, warm = timed(fn, fp, jnp.asarray(x))
    report("2d_t2 256^2 m=200000 b=16 planar.nufft",
           rel(cplx(out)[:4, sel], ref), 1e-6, first, warm)
    with jax.default_device(cpu_device()):
        impl = np.asarray(tfft.nufft(
            f[:1].astype(np.complex128), x.astype(np.float64)))
    report("2d_t2 256^2 err_impl vs f64 CPU-device run",
           rel(cplx(out)[:1], impl), 1e-6)

    # Radial multicoil, planned.
    rad = mri.radial_trajectory(512, 1024)
    coils = (rng.standard_normal((8, 512, 512))
             + 1j * rng.standard_normal((8, 512, 512))).astype(
        np.complex64)
    op = tfft.planar.PlannedNufft(jnp.asarray(rad), (512, 512))
    cp = jnp.asarray(np.stack([coils.real, coils.imag], -1))
    out, first, warm = timed(jax.jit(lambda s: op(s)), cp)
    sel = rng.choice(rad.shape[0], SUBSET, replace=False)
    ref = oracle_type2(coils[:2], rad[sel], -1)
    report("2d_t2 512^2 radial 512x1024 8 coils PlannedNufft",
           rel(cplx(out)[:2, sel], ref), 1e-6, first, warm)


def phase_3d():
    import jax
    import jax.numpy as jnp
    import tensorflow_nufft_tpu as tfft

    rng = np.random.default_rng(SEED)
    m, grid = 800_000, (128, 128, 128)
    x = rng.uniform(-np.pi, np.pi, (m, 3)).astype(np.float32)
    c = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(
        np.complex64)
    xj = jnp.asarray(x)
    src = jnp.asarray(np.stack([c.real, c.imag], -1)[None])
    idx = rng.choice(int(np.prod(grid)), 256, replace=False)
    ref = oracle_type1(c[None], x, grid, -1, idx)[0]
    fn = jax.jit(lambda s, p: tfft.planar.nufft(
        s, p, grid_shape=grid, transform_type="type_1"))
    out, first, warm = timed(fn, src, xj)
    report("3d_t1 128^3 m=800000 planar.nufft",
           rel(cplx(out)[0].reshape(-1)[idx], ref), 1e-6, first, warm)
    op = tfft.planar.PlannedNufft(xj, grid, transform_type="type_1")
    out, first, warm = timed(jax.jit(lambda s: op(s)), src)
    report("3d_t1 128^3 m=800000 PlannedNufft",
           rel(cplx(out)[0].reshape(-1)[idx], ref), 1e-6, first, warm)

    f = (rng.standard_normal(grid)
         + 1j * rng.standard_normal(grid)).astype(np.complex64)
    fp = jnp.asarray(np.stack([f.real, f.imag], -1)[None])
    sel = rng.choice(m, 256, replace=False)
    ref = oracle_type2(f[None], x[sel], -1)[0]
    out, first, warm = timed(jax.jit(lambda s, p: tfft.planar.nufft(
        s, p)), fp, xj)
    report("3d_t2 128^3 m=800000 planar.nufft",
           rel(cplx(out)[0, sel], ref), 1e-6, first, warm)
    t2 = op.adjoint()
    out, first, warm = timed(jax.jit(lambda s: t2(s)), fp)
    ref_b = oracle_type2(f[None], x[sel], +1)[0]
    report("3d_t2 128^3 m=800000 PlannedNufft (adjoint of the type-1)",
           rel(cplx(out)[0, sel], ref_b), 1e-6, first, warm)


def _sense_problem(grid=(128, 128), coils=8, spokes=128, samples=256):
    import jax.numpy as jnp
    from tensorflow_nufft_tpu.models import mri
    pts = jnp.asarray(mri.radial_trajectory(spokes, samples))
    maps = jnp.asarray(mri.birdcage_maps(coils, grid))
    phantom = jnp.asarray(mri.shepp_logan(grid))
    density = jnp.asarray(mri.radial_density(spokes, samples))
    return pts, maps, phantom, density


def phase_mri():
    import jax
    from tensorflow_nufft_tpu.models import mri

    pts, maps, phantom, density = _sense_problem()
    for toeplitz in (False, True):
        op = mri.SenseNufft(pts, maps, (128, 128), density=density,
                            toeplitz=toeplitz)
        ksp = jax.jit(op.forward)(phantom)
        recon = jax.jit(lambda k: mri.cg_sense(k, op, num_iters=10))
        x, first, warm = timed(recon, ksp)
        rhs = op.adjoint(ksp)
        r0 = float(np.linalg.norm(np.asarray(rhs)))
        r10 = float(np.linalg.norm(np.asarray(rhs - op.normal(x))))
        with jax.default_device(cpu_device()):
            cpu = [jax.device_put(a, cpu_device())
                   for a in (pts, maps, density)]
            op_c = mri.SenseNufft(cpu[0], cpu[1], (128, 128),
                                  density=cpu[2], toeplitz=toeplitz)
            x_cpu = np.asarray(jax.jit(
                lambda k: mri.cg_sense(k, op_c, num_iters=10))(
                    jax.device_put(ksp, cpu_device())))
        name = "toeplitz" if toeplitz else "composed"
        report(f"mri cg_sense 10 it 128^2 8 coils radial ({name}) "
               f"vs CPU-device run", rel(np.asarray(x), x_cpu), 1e-4,
               first, warm, gate=1e-3,
               residual=f"{r0:.3e}->{r10:.3e}")
        if not r10 < 0.1 * r0:
            raise SystemExit(f"CG residual did not fall ({name})")


def _dc_loss(op_fn, y):
    import jax.numpy as jnp
    from tensorflow_nufft_tpu.models import mri

    def loss(img, pts, maps):
        pred = op_fn(mri.pmul(maps, img[None]), pts)
        r = pred - y
        return jnp.sum(r * r)
    return loss


def phase_gradients():
    import jax
    import jax.numpy as jnp
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.models import mri

    rng = np.random.default_rng(SEED)
    grid = (512, 512)
    pts = jnp.asarray(mri.radial_trajectory(512, 1024) * 0.99)
    maps = jnp.asarray(mri.birdcage_maps(8, grid))
    img = jnp.asarray(rng.standard_normal(grid + (2,)).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((8, pts.shape[0], 2))
                    .astype(np.float32))

    def fwd(s, p):
        return tfft.planar.nufft(s, p)

    vg = jax.jit(jax.value_and_grad(_dc_loss(fwd, y), argnums=(0, 1)))
    (val, (g_img, g_pts)), first, warm = timed(vg, img, pts, maps)
    finite = bool(np.isfinite(float(val))
                  and np.isfinite(np.asarray(g_img)).all()
                  and np.isfinite(np.asarray(g_pts)).all())
    report("grad value_and_grad 512^2 radial 8 coils (image, points)",
           0.0 if finite else np.inf, 1e-6, first, warm)

    # Dot test <A x, y> = <x, A^H y> at the same shape.
    x = jnp.asarray(rng.standard_normal((8,) + grid + (2,))
                    .astype(np.float32))
    ax = fwd(x, pts)
    ahy = tfft.planar.nufft(y, pts, grid_shape=grid,
                            transform_type="type_1",
                            fft_direction="backward")
    lhs = float(jnp.vdot(ax.astype(jnp.float64), y.astype(jnp.float64)))
    rhs = float(jnp.vdot(x.astype(jnp.float64), ahy.astype(jnp.float64)))
    # Relative to the Cauchy-Schwarz bound |<Ax, y>| <= |Ax| |y|.
    scale = float(jnp.linalg.norm(ax) * jnp.linalg.norm(y))
    report("grad dot test <Ax,y> = <x,A^H y>", abs(lhs - rhs) / scale,
           1e-6)

    # Image and points gradients against the CPU device, reduced size.
    small = (64, 64)
    pts_s = jnp.asarray(mri.radial_trajectory(64, 128) * 0.99)
    maps_s = jnp.asarray(mri.birdcage_maps(4, small))
    img_s = jnp.asarray(rng.standard_normal(small + (2,))
                        .astype(np.float32))
    y_s = jnp.asarray(rng.standard_normal((4, pts_s.shape[0], 2))
                      .astype(np.float32))
    grad = jax.grad(_dc_loss(fwd, y_s), argnums=(0, 1))
    g_gpu = jax.jit(grad)(img_s, pts_s, maps_s)
    cpu_args = [jax.device_put(a, cpu_device())
                for a in (img_s, pts_s, maps_s)]
    with jax.default_device(cpu_device()):
        grad_c = jax.grad(_dc_loss(fwd, jax.device_put(y_s, cpu_device())),
                          argnums=(0, 1))
        g_cpu = jax.jit(grad_c)(*cpu_args)
    report("grad image 64^2 4 coils vs CPU-device run",
           rel(np.asarray(g_gpu[0]), np.asarray(g_cpu[0])), 1e-5,
           gate=1e-4)
    report("grad points 64^2 4 coils vs CPU-device run",
           rel(np.asarray(g_gpu[1]), np.asarray(g_cpu[1])), 1e-4,
           gate=1e-3)


def phase_type3_and_f64():
    import jax
    import jax.numpy as jnp
    import tensorflow_nufft_tpu as tfft

    rng = np.random.default_rng(SEED)
    m = k = 200_000
    x = rng.uniform(-np.pi, np.pi, (m, 2)).astype(np.float32)
    t = rng.uniform(-64.0, 64.0, (k, 2)).astype(np.float32)
    c = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(
        np.complex64)
    src = jnp.asarray(np.stack([c.real, c.imag], -1)[None])
    fn = jax.jit(lambda s: tfft.planar.nufft_type3(s, x, t))
    out, first, warm = timed(fn, src)
    sel = rng.choice(k, SUBSET, replace=False)
    ph = np.exp(-1j * (t[sel].astype(np.float64) @ x.T.astype(np.float64)))
    ref = ph @ c.astype(np.complex128)
    report("type3 2d 200k->200k planar.nufft_type3",
           rel(cplx(out)[0, sel], ref), 1e-6, first, warm)

    m = 200_000
    x = rng.uniform(-np.pi, np.pi, (m, 2))
    c = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    fn = jax.jit(lambda s, p: tfft.nufft(
        s, p, grid_shape=(256, 256), transform_type="type_1", tol=1e-10))
    out, first, warm = timed(fn, jnp.asarray(c), jnp.asarray(x))
    assert out.dtype == np.complex128, out.dtype
    idx = rng.choice(256 * 256, SUBSET, replace=False)
    ref = oracle_type1(c[None], x, (256, 256), -1, idx)[0]
    report("2d_t1 256^2 m=200000 complex128 tol=1e-10",
           rel(np.asarray(out).reshape(-1)[idx], ref), 1e-10, first,
           warm)


PHASES = (phase_kernel, phase_2d_type1, phase_2d_type2, phase_3d,
          phase_mri, phase_gradients, phase_type3_and_f64)


# ---------------------------------------------------------------------------
# Four cards: the sharded paths and the one-device results they match.


def four_cards():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.models import mri
    from tensorflow_nufft_tpu.parallel import (
        ShardedPlannedNufft, sharded_nufft, sharded_nufft_grid)

    devs = np.array(jax.devices()[:4])
    if devs.size != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {devs.size}")
    rng = np.random.default_rng(SEED)

    # 3D type-1, points sharded over 4 cards, one psum over NVLink.
    mesh = Mesh(devs.reshape(1, 4), ("data", "points"))
    m, grid = 800_000, (128, 128, 128)
    x = jnp.asarray(rng.uniform(-np.pi, np.pi, (m, 3)).astype(np.float32))
    src = jnp.asarray(rng.standard_normal((1, m, 2)).astype(np.float32))
    fn = jax.jit(lambda s, p: sharded_nufft(
        s, p, mesh, grid_shape=grid, transform_type="type_1"))
    out, first, warm = timed(fn, src, x)
    one = jax.jit(lambda s, p: tfft.planar.nufft(
        s, p, grid_shape=grid, transform_type="type_1"))(src, x)
    report("4 cards sharded_nufft 3d_t1 128^3 m=800000 points/4 vs 1 card",
           rel(np.asarray(out), np.asarray(one)), 1e-6, first, warm,
           gate=1e-5)

    # Radial 512^2 type-2, 8 coils on 'data'.
    mesh_d = Mesh(devs.reshape(4, 1), ("data", "points"))
    rad = jnp.asarray(mri.radial_trajectory(512, 1024))
    coils = jnp.asarray(rng.standard_normal((8, 512, 512, 2))
                        .astype(np.float32))
    fn = jax.jit(lambda s, p: sharded_nufft(s, p, mesh_d))
    out, first, warm = timed(fn, coils, rad)
    one = jax.jit(lambda s, p: tfft.planar.nufft(s, p))(coils, rad)
    report("4 cards sharded_nufft 2d_t2 512^2 radial 8 coils data/4 "
           "vs 1 card", rel(np.asarray(out), np.asarray(one)), 1e-6,
           first, warm, gate=1e-5)

    # Grid-sharded type-1 (mode slabs over 4 cards).
    mesh_g = Mesh(devs, ("grid",))
    m2 = 200_000
    x2 = jnp.asarray(rng.uniform(-np.pi, np.pi, (m2, 2))
                     .astype(np.float32))
    s2 = jnp.asarray(rng.standard_normal((2, m2, 2)).astype(np.float32))
    fn = jax.jit(lambda s, p: sharded_nufft_grid(
        s, p, mesh_g, grid_shape=(256, 256), transform_type="type_1"))
    out, first, warm = timed(fn, s2, x2)
    one = jax.jit(lambda s, p: tfft.planar.nufft(
        s, p, grid_shape=(256, 256), transform_type="type_1"))(s2, x2)
    report("4 cards sharded_nufft_grid 2d_t1 256^2 m=200000 vs 1 card",
           rel(np.asarray(out), np.asarray(one)), 1e-6, first, warm,
           gate=1e-5)

    # Planned normal operator on a (2, 2) mesh.
    mesh_2 = Mesh(devs.reshape(2, 2), ("data", "points"))
    op = ShardedPlannedNufft(np.asarray(rad), (512, 512), mesh_2)
    w = op.slot_weights(np.asarray(mri.radial_density(512, 1024)))
    fn = jax.jit(lambda s: op.normal(s, w))
    out, first, warm = timed(fn, coils)
    one_op = tfft.planar.PlannedNufft(rad, (512, 512))
    one = jax.jit(lambda s: one_op.normal(
        s, one_op.slot_weights(mri.radial_density(512, 1024))))(coils)
    report("4 cards ShardedPlannedNufft.normal 512^2 radial 8 coils "
           "(2x2 mesh) vs 1 card",
           rel(np.asarray(out), np.asarray(one)), 1e-6, first, warm,
           gate=1e-5, planned=op._planned)

    for d in devs:
        stats = d.memory_stats() or {}
        say(f"memory {d}: peak_bytes_in_use="
            f"{stats.get('peak_bytes_in_use')} bytes_in_use="
            f"{stats.get('bytes_in_use')}")


def main():
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded paths, on four GPUs")
    args = parser.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {dev.platform!r}")
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = os.path.join(REPO, "build", "jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache)
    entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, REPO)
    import tensorflow_nufft_tpu  # noqa: F401  (fails outside the repo)

    CARD = card()
    say(f"card: {CARD}")
    say(f"jax {jax.__version__}: {len(jax.devices())} x "
        f"{dev.device_kind} ({dev.platform})")
    say(f"compile cache {cache}: "
        f"{'hit possible, ' + str(entries) + ' entries' if entries else 'cold (empty)'}")

    t0 = time.perf_counter()
    if args.four_cards:
        four_cards()
    else:
        for phase in PHASES:
            phase()
    after = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    say(f"compile cache: {entries} entries before, {after} after")
    say(f"total {time.perf_counter() - t0:.1f}s [{CARD}]")
    say(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
