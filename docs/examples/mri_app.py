"""Non-Cartesian MRI reconstruction with tensorflow-nufft-tpu.

Runnable-script counterpart of the reference's flagship example notebook
(docs/examples/mri_app.ipynb): simulate a radial multicoil acquisition
with the type-2 NUFFT, then reconstruct with (a) the density-compensated
adjoint and (b) iterative CG-SENSE through the operator's gradients.

Run on CPU or GPU:
    python docs/examples/mri_app.py
"""

import pathlib
import sys

# Allow running straight from a source checkout.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import jax
import jax.numpy as jnp

from tensorflow_nufft_tpu.models import mri
from tensorflow_nufft_tpu.planar import from_planar


def main():
    print(f"backend: {jax.default_backend()}")

    # --- 1. Setup: phantom, coil maps, radial trajectory. -------------
    grid = (192, 192)
    coils = 8
    spokes, samples = 160, 384          # ~1.7x angular undersampling
    phantom = jnp.asarray(mri.shepp_logan(grid))
    maps = jnp.asarray(mri.birdcage_maps(coils, grid))
    points = jnp.asarray(
        mri.radial_trajectory(spokes, samples, golden_angle=True))
    density = jnp.asarray(mri.radial_density(spokes, samples))

    # --- 2. Simulate the acquisition: y = F_nu S x (type-2 NUFFT). ----
    op = mri.SenseNufft(points, maps, grid, density=density)
    kspace = jax.jit(op.forward)(phantom)
    print(f"k-space: {kspace.shape}  "
          f"({spokes} spokes x {samples} samples x {coils} coils)")

    # --- 3a. Direct recon: density-compensated adjoint A^H W y. -------
    def rel_err(x):
        # Scale-invariant: the plain adjoint is unnormalized by
        # construction (the density convention sets the global scale).
        a = float(jnp.vdot(x.ravel(), phantom.ravel())
                  / jnp.maximum(jnp.vdot(x.ravel(), x.ravel()), 1e-30))
        return float(jnp.linalg.norm(a * x - phantom)
                     / jnp.linalg.norm(phantom))

    adjoint = jax.jit(op.adjoint)(kspace)
    err_adj = rel_err(adjoint)
    print(f"adjoint recon relative error:  {err_adj:.3f}")

    # --- 3b. Iterative recon: CG on the normal equations. -------------
    recon = jax.jit(
        lambda y: mri.cg_sense(y, op, num_iters=15))(kspace)
    err_cg = rel_err(recon)
    print(f"CG-SENSE recon relative error: {err_cg:.3f}")

    # --- 3c. Pipe-Menon density (any trajectory) + Toeplitz CG. -------
    pm = mri.pipe_menon_density(points, grid)
    op_pm = mri.SenseNufft(points, maps, grid, density=pm)
    err_pm = rel_err(jax.jit(op_pm.adjoint)(kspace))
    print(f"adjoint recon (pipe-menon):    {err_pm:.3f}")

    op_toep = mri.SenseNufft(points, maps, grid, density=density,
                             toeplitz=True)
    recon_t = jax.jit(
        lambda y: mri.cg_sense(y, op_toep, num_iters=15))(kspace)
    err_t = rel_err(recon_t)
    print(f"CG-SENSE (Toeplitz normal):    {err_t:.3f}")

    # --- 4. Gradients through the recon (e.g. for learned methods). ---
    def data_consistency(image_p):
        return jnp.sum((op.forward(image_p) - kspace) ** 2)

    grad = jax.jit(jax.grad(data_consistency))(recon)
    print(f"gradient through forward model: {grad.shape}, "
          f"finite={bool(jnp.all(jnp.isfinite(grad)))}")

    # Save a quick comparison figure if matplotlib is available.
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, (img, title) in zip(axes, [
                (phantom, "phantom"),
                (adjoint, f"adjoint (err {err_adj:.2f})"),
                (recon, f"CG-SENSE (err {err_cg:.2f})")]):
            ax.imshow(np.abs(from_planar(np.asarray(img))), cmap="gray")
            ax.set_title(title)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig("mri_app.png", dpi=120)
        print("saved mri_app.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
