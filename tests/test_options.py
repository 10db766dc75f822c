"""Options model: validation and proto round-trip
(models nufft_options_test.py:24-48)."""

import numpy as np
import pytest

import tensorflow_nufft_tpu as tfft


def test_defaults():
    opts = tfft.Options()
    assert opts.max_batch_size is None
    assert opts.points_range == tfft.PointsRange.EXTENDED
    assert opts.fftw.planning_rigor == tfft.FftwPlanningRigor.AUTO
    assert opts.debugging.check_points_range is False


def test_proto_roundtrip():
    opts = tfft.Options(
        max_batch_size=4,
        points_range=tfft.PointsRange.INFINITE,
        fftw=tfft.FftwOptions(
            planning_rigor=tfft.FftwPlanningRigor.MEASURE),
        debugging=tfft.DebuggingOptions(check_points_range=True),
    )
    pb = opts.to_proto()
    restored = tfft.Options.from_proto(pb)
    assert restored.max_batch_size == 4
    assert restored.points_range == tfft.PointsRange.INFINITE
    assert restored.fftw.planning_rigor == tfft.FftwPlanningRigor.MEASURE
    assert restored.debugging.check_points_range is True


def test_proto_wire_compat():
    """Serialized bytes use the reference's field numbers."""
    opts = tfft.Options(points_range=tfft.PointsRange.EXTENDED)
    data = opts.to_proto().SerializeToString()
    from tensorflow_nufft_tpu.proto import nufft_options_pb2
    pb = nufft_options_pb2.Options()
    pb.ParseFromString(data)
    assert pb.points_range == 1


def test_validation():
    with pytest.raises(ValueError):
        tfft.Options(max_batch_size=0)
    with pytest.raises(ValueError):
        tfft.Options(backend="cuda")
    with pytest.raises(ValueError):
        tfft.Options(upsampling_factor=0.9)


def test_assignment_validation():
    opts = tfft.Options()
    with pytest.raises(ValueError):
        opts.max_batch_size = -1
    opts.max_batch_size = 8
    assert opts.max_batch_size == 8


def test_extension_fields_round_trip():
    """backend/upsampling_factor survive a proto round-trip; payloads
    using only reference fields stay byte-identical (advisor finding)."""
    o = tfft.Options(backend="xla", upsampling_factor=2.5,
                     max_batch_size=3)
    r = tfft.Options.from_proto(o.to_proto())
    assert r == o
    # default extensions add zero bytes to the wire format
    plain = tfft.Options(max_batch_size=3)
    pb = plain.to_proto()
    assert not pb.backend and pb.upsampling_factor == 0.0


def test_show_warnings_on_clamped_tol(rng):
    import warnings as w
    pts = rng.uniform(-3, 3, (8, 1)).astype(np.float32)
    src = (rng.standard_normal(8) + 1j * rng.standard_normal(8)).astype(
        np.complex64)
    with w.catch_warnings(record=True) as rec:
        w.simplefilter("always")
        tfft.nufft(src, pts, grid_shape=(8,), transform_type="type_1",
                   tol=1e-12)
    assert any("clamped" in str(x.message) for x in rec)
    with w.catch_warnings(record=True) as rec:
        w.simplefilter("always")
        tfft.nufft(src, pts, grid_shape=(8,), transform_type="type_1",
                   tol=1e-12,
                   options=tfft.Options(show_warnings=False))
    assert not any("clamped" in str(x.message) for x in rec)


def test_auto_inner_batch_cap():
    """With no max_batch_size, oversized inner batches are chunked
    automatically instead of hitting the allocation guard (the
    reference sizes inner batches automatically, nufft_plan.cc:211-219;
    here the cap is memory-driven)."""
    from tensorflow_nufft_tpu.plan.plan import (
        PlanSpec, auto_max_batch_size)
    spec = PlanSpec("type_1", "forward", 2, (4096, 4096), "complex64",
                    1e-3, 0)
    cap = auto_max_batch_size(spec)
    assert 1 <= cap < 100


def test_kernel_evaluation_method(rng):
    """'direct'/'horner' select the kernel evaluator; both meet the
    accuracy gate, 'auto' == 'horner' for float32 plans (reference:
    KernelEvaluationMethod, nufft_options.h:62-70)."""
    m, n = 400, 32
    pts = rng.uniform(-np.pi, np.pi, (m, 2)).astype(np.float32)
    src = (rng.standard_normal(m)
           + 1j * rng.standard_normal(m)).astype(np.complex64)
    oracle = np.asarray(tfft.nudft(
        src, pts, grid_shape=(n, n), transform_type="type_1"))
    outs = {}
    for kev in ("auto", "direct", "horner"):
        o = tfft.Options(kernel_evaluation_method=kev)
        outs[kev] = np.asarray(tfft.nufft(
            src, pts, grid_shape=(n, n), transform_type="type_1",
            tol=1e-6, options=o))
        err = np.abs(outs[kev] - oracle).max() / np.abs(oracle).max()
        assert err < 1e-3, (kev, err)
    assert np.array_equal(outs["auto"], outs["horner"])
    assert not np.array_equal(outs["direct"], outs["horner"])

    with pytest.raises(ValueError, match="kernel_evaluation_method"):
        tfft.Options(kernel_evaluation_method="bogus")


def test_kernel_evaluation_method_horner_f64_raises(rng):
    pts = rng.uniform(-np.pi, np.pi, (16, 1)).astype(np.float64)
    src = (rng.standard_normal(16)
           + 1j * rng.standard_normal(16)).astype(np.complex128)
    o = tfft.Options(kernel_evaluation_method="horner")
    with pytest.raises(ValueError, match="horner"):
        tfft.nufft(src, pts, grid_shape=(16,), transform_type="type_1",
                   tol=1e-9, options=o)
