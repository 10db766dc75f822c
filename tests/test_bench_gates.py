"""Benchmark-suite device accuracy gates.

Pins the gate machinery itself: a correct output passes, and a
deliberately perturbed kernel constant (the verdict's bar: "a
deliberate perturbation test fails at least one gate") fails. Runs the
same _write_case_ref / _acc_fields helpers bench_suite uses on the
GPU, on a small case on CPU.
"""

import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import bench_suite as bs  # noqa: E402

import tensorflow_nufft_tpu as tfft  # noqa: E402
from tensorflow_nufft_tpu.options.options import Options  # noqa: E402
from tensorflow_nufft_tpu.planar import (  # noqa: E402
    PlannedNufft, to_planar)


@pytest.fixture
def tiny_case(rng, tmp_path, monkeypatch):
    monkeypatch.setattr(
        bs, "_ref_path",
        lambda key: tmp_path / f"caseref_{key}.npz")
    m, grid = 2000, (32, 32)
    pts = rng.uniform(-np.pi, np.pi, (m, 2)).astype(np.float32)
    z = (rng.standard_normal(m)
         + 1j * rng.standard_normal(m)).astype(np.complex64)
    src = np.asarray(to_planar(z))
    bs._write_case_ref("tiny", src, pts, "type_1", grid)
    monkeypatch.setattr(
        bs, "_ensure_case_ref",
        lambda row, key, **kw: np.load(bs._ref_path(key)))
    return pts, src, grid


def test_gate_passes_on_correct_output(tiny_case):
    pts, src, grid = tiny_case
    op = PlannedNufft(jnp.asarray(pts), grid, transform_type="type_1",
                      tol=bs.CASE_TOL, options=Options(backend="pallas"))
    out = np.asarray(op(jnp.asarray(src)[None]))[0]
    fields = bs._acc_fields("tiny_row", "tiny", out)
    assert fields["pass"] is True
    assert fields["acc_err"] < fields["acc_gate"]


def test_gate_fails_on_perturbed_kernel(tiny_case, monkeypatch):
    # Flip one kernel constant: scale the fitted Horner coefficients of
    # the ES kernel by 1% (the spread/interp evaluation path) while the
    # deconvolution fseries stays exact — a silent wrong answer of the
    # kind a device-only kernel branch could produce. The gate must
    # catch it.
    pts, src, grid = tiny_case
    import dataclasses
    import tensorflow_nufft_tpu.plan.plan as planmod
    orig = planmod.make_plan.__wrapped__ if hasattr(
        planmod.make_plan, "__wrapped__") else planmod.make_plan

    def bad_make_plan(spec):
        p = orig(spec)
        if p.horner is not None:
            p = dataclasses.replace(
                p, horner=tuple(1.01 * a for a in p.horner))
        return p

    monkeypatch.setattr(planmod, "make_plan", bad_make_plan)
    op = PlannedNufft(jnp.asarray(pts), grid, transform_type="type_1",
                      tol=bs.CASE_TOL, options=Options(backend="pallas"))
    assert op.plan.horner is not None
    out = np.asarray(op(jnp.asarray(src)[None]))[0]
    fields = bs._acc_fields("tiny_row", "tiny", out)
    assert fields["pass"] is False, (
        f"1% kernel perturbation slipped through the gate: "
        f"err={fields['acc_err']:.3e} gate={fields['acc_gate']:g}")


def test_gate_reports_shape_mismatch(tiny_case):
    fields = bs._acc_fields("tiny_row", "tiny",
                            np.zeros((3, 3), np.float32))
    assert fields["pass"] is False


def test_gate_degrades_without_reference(monkeypatch, tmp_path):
    """Without a reference the gate fails loudly: a missing reference is
    an error, not an ungated row."""
    monkeypatch.setattr(bs, "_ref_path",
                        lambda key: tmp_path / f"caseref_{key}.npz")
    monkeypatch.setattr(bs.subprocess, "run",
                        lambda *a, **k: (_ for _ in ()).throw(
                            bs.subprocess.CalledProcessError(1, a[0])))
    with pytest.raises(bs.subprocess.CalledProcessError):
        bs._acc_fields("row", "nokey", np.zeros((2, 2)))
