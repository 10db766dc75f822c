"""Builds docs/examples/mri_app.ipynb (the notebook-grade MRI example,
parity with the reference's docs/examples/mri_app.ipynb) from the same
cells as mri_walkthrough.md. Run: python docs/examples/make_notebook.py
[--execute] — with --execute, the code cells are also run end-to-end on
CPU as a validation pass before writing."""

import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent

MD = [
    """# Non-Cartesian MRI reconstruction with tensorflow-nufft-tpu

A radial multicoil acquisition, reconstructed two ways: the classic
density-compensated adjoint ("gridding") and iterative CG-SENSE. This is
the notebook counterpart of the reference's `docs/examples/mri_app.ipynb`
(mrphys/tensorflow-nufft), built on the planar API.

An idealized MRI scanner samples the Fourier transform of the object
along a k-space trajectory; non-Cartesian (radial/spiral) sampling lands
between grid points — exactly the type-2 NUFFT:

$$ y_m = \\sum_k x_k\\, e^{-i\\, k \\cdot \\xi_m} $$
""",
    """## 1. Set up a synthetic acquisition

Everything is *planar* (a trailing `(re, im)` axis of size 2) — the
pipeline the spread kernel serves; `from_planar` converts back to complex NumPy
for plotting.""",
    """## 2. The forward model (type-2 NUFFT)

`SenseNufft` bundles coil-sensitivity weighting with the NUFFT: the
forward operator is $y_c = F_{nu}(S_c \\odot x)$ per coil $c$. Under the
hood: one batched `tfft.planar.nufft(..., transform_type="type_2")` over
the coil dimension — an amplify + DFT contraction, then XLA's gather
at the k-space points.""",
    """## 3. Density-compensated adjoint ("gridding")

Radial sampling is densest at the k-space center; re-weighting by the
ramp `density` before the adjoint (type-1) transform gives the classic
gridding reconstruction — fast, but blurry/streaky under
undersampling.""",
    """## 4. Iterative CG-SENSE

Solving $\\arg\\min_x \\lVert F_{nu} S x - y \\rVert^2$ with conjugate
gradients on the normal equations uses the NUFFT *and its adjoint* each
iteration — this is where the custom VJPs earn their keep, and where the
planned-transform API shines (the trajectory is fixed across iterations,
so binning and kernel matrices are computed once).""",
    """## 5. Density compensation for arbitrary trajectories

The analytic ramp only exists for radial sampling. For spirals, rosettes
or measured trajectories, `mri.pipe_menon_density` estimates the weights
iteratively (Pipe & Menon 1999): the fixed point of
$w \\leftarrow w / |C C^H w|$ drives the gridding-kernel-convolved
sampling density flat. The reference's example ships only the analytic
radial weights.""",
    """## 6. Toeplitz-accelerated CG

CG only ever needs the *normal* operator $A^H W A$, which is
shift-invariant on the image grid: it equals convolution with a kernel
computed by ONE type-1 NUFFT of the weights onto the doubled grid. With
`toeplitz=True` each CG iteration is pure FFT-domain multiplication — no
spread/interp at all (its time on the H100: not measured yet; the
composed planned pair is the comparison).""",
    """## 7. Beyond the grid: type-3 transforms

Point scatterers at *continuous* (off-grid) positions measured on an
arbitrary trajectory need a transform with no uniform grid on either
side: $y_k = \\sum_j c_j e^{-i\\,\\xi_k \\cdot x_j}$ — the type-3 NUFFT
(`tfft.nufft_type3`), which the reference enumerates but never
implemented.""",
    """## 8. Scaling notes

- **Fixed trajectory, many applies** (CG, training loops): build a
  `tfft.planar.PlannedNufft(points, grid, ...)` once and call it: the
  fold and the tile binning then run once, not per apply.
- **Many coils / frames**: the coil dimension is an inner-vectorized
  batch — one plan execution, channel-grouped spread kernel.
- **Multi-device**: shard coils over a mesh `data` axis and k-space over a
  `points` axis with `tensorflow_nufft_tpu.parallel.sharded_nufft`, or
  shard the image grid itself with `sharded_nufft_grid`.""",
]

CODE = [
    """import jax, jax.numpy as jnp, numpy as np
from tensorflow_nufft_tpu.models import mri
from tensorflow_nufft_tpu.planar import from_planar

grid = (192, 192)
coils = 8
spokes, samples = 160, 384     # ~1.7x angular undersampling

phantom = jnp.asarray(mri.shepp_logan(grid))            # [*grid, 2]
maps = jnp.asarray(mri.birdcage_maps(coils, grid))      # [C, *grid, 2]
points = jnp.asarray(
    mri.radial_trajectory(spokes, samples, golden_angle=True))  # [M, 2]
density = jnp.asarray(mri.radial_density(spokes, samples))      # [M]
print("k-space samples:", points.shape[0])""",
    """import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

fig, ax = plt.subplots(1, 2, figsize=(8, 4))
ax[0].imshow(np.abs(from_planar(phantom)), cmap="gray")
ax[0].set_title("Shepp-Logan phantom")
ax[1].plot(np.asarray(points[:, 0]), np.asarray(points[:, 1]),
           ".", ms=0.3)
ax[1].set_title(f"radial trajectory ({spokes} spokes)")
ax[1].set_aspect("equal")
fig.savefig("mri_setup.png", dpi=120, bbox_inches="tight")""",
    """op = mri.SenseNufft(points, maps, grid, density=density)
kspace = jax.jit(op.forward)(phantom)       # [C, M, 2]
print("kspace:", kspace.shape)""",
    """recon_adj = jax.jit(op.adjoint)(kspace)    # [*grid, 2]""",
    """recon_cg = jax.jit(lambda y: mri.cg_sense(y, op, num_iters=15))(kspace)

fig, ax = plt.subplots(1, 3, figsize=(12, 4))
for a, (img, title) in zip(ax, [
        (phantom, "ground truth"),
        (recon_adj, "density-comp. adjoint"),
        (recon_cg, "CG-SENSE (15 iters)")]):
    a.imshow(np.abs(from_planar(img)), cmap="gray")
    a.set_title(title)
    a.axis("off")
fig.savefig("mri_recons.png", dpi=120, bbox_inches="tight")

def rel_err(x):
    # scale-invariant (the plain adjoint is unnormalized by construction)
    a = float(jnp.vdot(x.ravel(), phantom.ravel())
              / jnp.vdot(x.ravel(), x.ravel()))
    return float(jnp.linalg.norm(a * x - phantom)
                 / jnp.linalg.norm(phantom))

print(f"rel. error: adjoint {rel_err(recon_adj):.3f}  "
      f"CG-SENSE {rel_err(recon_cg):.3f}")""",
    """pm = mri.pipe_menon_density(points, grid)       # works for ANY trajectory
op_pm = mri.SenseNufft(points, maps, grid, density=pm)
recon_pm = jax.jit(op_pm.adjoint)(kspace)
print(f"adjoint rel. error: ramp {rel_err(recon_adj):.3f}  "
      f"pipe-menon {rel_err(recon_pm):.3f}")""",
    """op_toep = mri.SenseNufft(points, maps, grid, density=density,
                         toeplitz=True)
recon_toep = jax.jit(
    lambda y: mri.cg_sense(y, op_toep, num_iters=15))(kspace)
print(f"CG-SENSE (Toeplitz) rel. error: {rel_err(recon_toep):.3f}")""",
    """import tensorflow_nufft_tpu as tfft

scatterers = np.array([[20.30, -15.70], [0.00, 0.05], [-30.25, 8.50]],
                      np.float32)
amps = np.array([1.0, 0.8, 0.6]).astype(np.complex64)
signal = tfft.nufft_type3(amps, scatterers,
                          np.asarray(points, np.float32), tol=1e-6)
exact = tfft.nudft_type3(amps, scatterers, np.asarray(points, np.float32))
print("type-3 signal at", signal.shape[0], "trajectory frequencies;",
      "max err vs dense:",
      float(jnp.max(jnp.abs(signal - exact))))""",
]

# Interleave markdown sections with their code cells.
ORDER = [("md", 0), ("md", 1), ("code", 0), ("code", 1), ("md", 2),
         ("code", 2), ("md", 3), ("code", 3), ("md", 4), ("code", 4),
         ("md", 5), ("code", 5), ("md", 6), ("code", 6), ("md", 7),
         ("code", 7), ("md", 8)]


def build():
    cells = []
    for kind, i in ORDER:
        src = (MD if kind == "md" else CODE)[i]
        lines = [ln + "\n" for ln in src.split("\n")]
        if lines:
            lines[-1] = lines[-1].rstrip("\n")
        if kind == "md":
            cells.append({"cell_type": "markdown", "metadata": {},
                          "source": lines})
        else:
            cells.append({"cell_type": "code", "metadata": {},
                          "execution_count": None, "outputs": [],
                          "source": lines})
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3",
                           "language": "python", "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def execute():
    import os
    import tempfile
    ns = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        os.chdir(td)
        try:
            for i, src in enumerate(CODE):
                print(f"-- executing cell {i}", file=sys.stderr)
                exec(compile(src, f"<cell {i}>", "exec"), ns)
        finally:
            os.chdir(cwd)


def main():
    if "--execute" in sys.argv:
        sys.path.insert(0, str(HERE.parent.parent))   # repo root
        import jax
        jax.config.update("jax_platforms", "cpu")
        execute()
    out = HERE / "mri_app.ipynb"
    out.write_text(json.dumps(build(), indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
