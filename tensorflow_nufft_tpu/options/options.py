"""Advanced options for the NUFFT ops.

API parity with the reference's pydantic options model
(reference: python/ops/nufft_options.py:25-273, proto/nufft_options.proto),
as plain validated dataclasses: fields are checked on construction and
on assignment, and an invalid value raises ``ValueError``. The FFTW
options are accepted for drop-in compatibility but have no effect (XLA's
FFT needs no planning); they round-trip through serialization unchanged.
protobuf is imported only by ``to_proto``/``from_proto``.

Extensions beyond the reference live on ``Options`` under clearly-named
fields and default to automatic behavior.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class FftwPlanningRigor(enum.IntEnum):
    """Planning rigor of the FFTW library (compatibility only).

    The FFT is compiled by XLA and there is no planning stage, so this
    option has no effect. It is retained so that code written against
    the reference keeps working (reference: nufft_options.py:25-93).

    - **AUTO**: selects the planning rigor automatically.
    - **ESTIMATE**: use a simple heuristic instead of measurements.
    - **MEASURE**: find an optimized plan by measuring several transforms.
    - **PATIENT**: like MEASURE, with a wider search.
    - **EXHAUSTIVE**: like PATIENT, with an even wider search.
    """
    AUTO = 0
    ESTIMATE = 1
    MEASURE = 2
    PATIENT = 3
    EXHAUSTIVE = 4

    def to_proto(self) -> int:
        return int(self)

    @classmethod
    def from_proto(cls, pb) -> "FftwPlanningRigor":
        return cls(int(pb))


class PointsRange(enum.IntEnum):
    """Supported range of the nonuniform points (reference:
    nufft_options.py:95-158).

    - **STRICT**: only values in ``[-pi, pi]`` are supported.
    - **EXTENDED**: values in ``[-3*pi, 3*pi]`` are supported (default).
    - **INFINITE**: any value is supported.

    Narrower ranges may be faster: STRICT needs no folding, EXTENDED a
    single fold, INFINITE a full modulo reduction.
    """
    STRICT = 0
    EXTENDED = 1
    INFINITE = 2

    def to_proto(self) -> int:
        return int(self)

    @classmethod
    def from_proto(cls, pb) -> "PointsRange":
        return cls(int(pb))


class _Validated:
    """Runs the field's ``_check_<name>`` (if any) on every assignment,
    including the dataclass constructor's."""

    def __setattr__(self, name, value):
        check = getattr(type(self), f"_check_{name}", None)
        if check is not None:
            value = check(value)
        object.__setattr__(self, name, value)


def _check_bool(name):
    def check(v):
        if not isinstance(v, (bool, int)) or v not in (0, 1):
            raise ValueError(f"{name} must be a bool, got {v!r}")
        return bool(v)
    return staticmethod(check)


def _check_enum(enum_cls, name):
    def check(v):
        try:
            return enum_cls(v)
        except ValueError:
            raise ValueError(
                f"{name} must be a {enum_cls.__name__}, got {v!r}"
            ) from None
    return staticmethod(check)


@dataclasses.dataclass
class DebuggingOptions(_Validated):
    """Debugging options (reference: nufft_options.py:160-186).

    Attributes:
        check_points_range: If True, ``nufft`` asserts that the nonuniform
            points lie within the supported range (see
            ``Options.points_range``). Adds a device-side check; outputs
            for out-of-range points become NaN so the violation is
            detectable under jit.
    """
    check_points_range: bool = False

    _check_check_points_range = _check_bool("check_points_range")

    def to_proto(self):
        from tensorflow_nufft_tpu.proto import nufft_options_pb2
        pb = nufft_options_pb2.DebuggingOptions()
        pb.check_points_range = self.check_points_range
        return pb

    @classmethod
    def from_proto(cls, pb) -> "DebuggingOptions":
        return cls(check_points_range=pb.check_points_range)


@dataclasses.dataclass
class FftwOptions(_Validated):
    """FFTW library options, compatibility only (reference:
    nufft_options.py:189-219).

    Attributes:
        planning_rigor: Controls the rigor (and time) of the planning
            process. No effect (XLA plans its own FFTs).
    """
    planning_rigor: FftwPlanningRigor = FftwPlanningRigor.AUTO

    _check_planning_rigor = _check_enum(FftwPlanningRigor, "planning_rigor")

    def to_proto(self):
        from tensorflow_nufft_tpu.proto import nufft_options_pb2
        pb = nufft_options_pb2.FftwOptions()
        pb.planning_rigor = int(self.planning_rigor)
        return pb

    @classmethod
    def from_proto(cls, pb) -> "FftwOptions":
        return cls(planning_rigor=FftwPlanningRigor(int(pb.planning_rigor)))


def _check_one_of(name, allowed):
    def check(v):
        if v not in allowed:
            raise ValueError(
                f"{name} must be one of "
                f"{', '.join(repr(a) for a in allowed)}, got {v!r}")
        return v
    return staticmethod(check)


def _check_instance(name, cls):
    def check(v):
        if not isinstance(v, cls):
            raise ValueError(
                f"{name} must be a {cls.__name__}, got {v!r}")
        return v
    return staticmethod(check)


@dataclasses.dataclass
class Options(_Validated):
    """Advanced options for `nufft` (reference: nufft_options.py:222-273).

    Attributes:
        debugging: Options for debugging. See ``DebuggingOptions``.
        fftw: Options for the FFTW library (no effect).
        max_batch_size: Optional int. Maximum number of transforms computed
            at once; larger batches are processed in chunks of this size to
            bound fine-grid memory.
        points_range: A ``PointsRange``. Supported range of the nonuniform
            points. Defaults to EXTENDED.
        backend: Extension. One of 'auto', 'xla', 'pallas', 'native'.
            Selects the spread/interp kernel implementation. 'pallas'
            runs the tile-exclusive spread kernel (compiled through
            Triton on a GPU, interpreted on the CPU) and raises where it
            cannot serve the transform; 'xla' the portable scatter/gather
            path; 'auto' picks per device and problem. 'native' runs the
            C++/OpenMP host engine via a host callback (CPU only; forward
            pass under jit, gradients via the NUFFT-level custom VJP).
        upsampling_factor: Extension. Optional override of the fine-grid
            oversampling factor sigma (> 1.0); None selects automatically.
        show_warnings: bool. Emit Python warnings for silently adjusted
            parameters (e.g. a requested tolerance below machine
            precision being clamped). Mirrors the reference's
            show_warnings internal option (nufft_options.h:102-103).
        verbosity: int. 0 = silent (default); 1 logs a one-line plan
            summary (sigma, kernel width, fine grid) per transform call
            to stderr. Mirrors the reference's verbosity internal
            option (nufft_options.h:98-100); like the reference's, it
            is internal-only and not serialized to proto.
        kernel_evaluation_method: One of 'auto', 'direct', 'horner'.
            How the ES spreading kernel is evaluated. 'direct' is the
            exact ``exp(beta*sqrt(1-c*z^2))`` form; 'horner' a
            plan-time-fitted Chebyshev/power polynomial (float32 plans
            only — more accurate than direct f32 eval and
            transcendental-free). 'auto' (default) picks 'horner' for
            float32 plans and 'direct' for float64. Mirrors the
            reference's KernelEvaluationMethod internal option
            (nufft_options.h:62-70, dispatched at
            nufft_plan.cc:1291-1307); internal-only, not serialized.
    """
    debugging: DebuggingOptions = dataclasses.field(
        default_factory=DebuggingOptions)
    fftw: FftwOptions = dataclasses.field(default_factory=FftwOptions)
    max_batch_size: Optional[int] = None
    points_range: PointsRange = PointsRange.EXTENDED
    backend: str = "auto"
    upsampling_factor: Optional[float] = None
    show_warnings: bool = True
    verbosity: int = 0
    kernel_evaluation_method: str = "auto"

    _check_debugging = _check_instance("debugging", DebuggingOptions)
    _check_fftw = _check_instance("fftw", FftwOptions)
    _check_points_range = _check_enum(PointsRange, "points_range")
    _check_backend = _check_one_of(
        "backend", ("auto", "xla", "pallas", "native"))
    _check_show_warnings = _check_bool("show_warnings")
    _check_kernel_evaluation_method = _check_one_of(
        "kernel_evaluation_method", ("auto", "direct", "horner"))

    @staticmethod
    def _check_verbosity(v):
        if not isinstance(v, int) or v < 0:
            raise ValueError(f"verbosity must be >= 0, got {v}")
        return v

    @staticmethod
    def _check_max_batch_size(v):
        if v is not None and (not isinstance(v, int) or v < 1):
            raise ValueError(f"max_batch_size must be >= 1, got {v}")
        return v

    @staticmethod
    def _check_upsampling_factor(v):
        if v is not None and v <= 1.0:
            raise ValueError(f"upsampling_factor must be > 1.0, got {v}")
        return None if v is None else float(v)

    def to_proto(self):
        from tensorflow_nufft_tpu.proto import nufft_options_pb2
        pb = nufft_options_pb2.Options()
        pb.debugging.CopyFrom(self.debugging.to_proto())
        pb.fftw.CopyFrom(self.fftw.to_proto())
        if self.max_batch_size is not None:
            pb.max_batch_size = self.max_batch_size
        pb.points_range = int(self.points_range)
        # Extension fields: only set when non-default, so payloads
        # that use only reference options stay byte-identical.
        if self.backend != "auto":
            pb.backend = self.backend
        if self.upsampling_factor is not None:
            pb.upsampling_factor = self.upsampling_factor
        return pb

    @classmethod
    def from_proto(cls, pb) -> "Options":
        return cls(
            debugging=DebuggingOptions.from_proto(pb.debugging),
            fftw=FftwOptions.from_proto(pb.fftw),
            max_batch_size=pb.max_batch_size or None,
            points_range=PointsRange(int(pb.points_range)),
            backend=pb.backend or "auto",
            upsampling_factor=pb.upsampling_factor or None,
        )
