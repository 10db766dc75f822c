"""Profiling, tracing and verbosity utilities.

The reference carries only vestigial FINUFFT knobs here — a ``verbosity``
option gating printfs (reference: cc/kernels/nufft_options.h:98-100,
nufft_plan.cc:1060) and a timing ``flags`` field (nufft_plan.h:163-165) —
and otherwise defers to TensorFlow's profiler. The JAX equivalents
(SURVEY §5) are:

- **Named scopes** (``scope``): every pipeline stage (fold/rescale, spread,
  FFT/DFT, deconvolve, interp) is wrapped in a ``jax.named_scope``, so
  stage names appear in jaxprs, HLO metadata and ``jax.profiler`` traces.
- **Device tracing** (``start_trace``/``stop_trace``/``trace``): thin
  wrappers over ``jax.profiler`` writing TensorBoard-loadable traces.
- **Host annotations** (``annotate``): ``jax.profiler.TraceAnnotation``
  spans for host-side phases (planning, reference builds).
- **Verbosity** (``set_verbosity``/``log``): structured stderr logging,
  level from ``TFFT_VERBOSITY`` (default 0 = silent), the counterpart of
  the reference's verbosity option.
- **Stage timing** (``time_stages``): eager per-stage wall times of a
  transform, for quick roofline checks without a full trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable, Dict

import jax

_verbosity = int(os.environ.get("TFFT_VERBOSITY", "0") or 0)


def set_verbosity(level: int) -> None:
    """Sets the global log verbosity (0 = silent, 1 = stage summaries,
    2 = per-call detail)."""
    global _verbosity
    _verbosity = int(level)


def verbosity() -> int:
    """Current log verbosity."""
    return _verbosity


def log(level: int, msg: str) -> None:
    """Writes ``msg`` to stderr when ``verbosity() >= level``."""
    if _verbosity >= level:
        print(f"[tfft] {msg}", file=sys.stderr, flush=True)


def scope(name: str):
    """Named scope for a pipeline stage: shows up in jaxprs, HLO op
    metadata and profiler traces. Usable as a context manager or
    decorator; safe under jit (purely metadata, no runtime cost)."""
    return jax.named_scope(name)


def annotate(name: str):
    """Host-side trace annotation (a span in ``jax.profiler`` traces).
    Falls back to a no-op when the profiler is unavailable."""
    try:
        return jax.profiler.TraceAnnotation(name)
    except Exception:
        return contextlib.nullcontext()


def start_trace(logdir: str) -> None:
    """Starts a ``jax.profiler`` trace writing to ``logdir``
    (TensorBoard-loadable; includes XLA device timelines with the
    pipeline's named scopes)."""
    jax.profiler.start_trace(logdir)


def stop_trace() -> None:
    """Stops the trace started by ``start_trace``."""
    jax.profiler.stop_trace()


@contextlib.contextmanager
def trace(logdir: str):
    """Context manager: profile the enclosed block to ``logdir``."""
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


def time_stages(stages: Dict[str, Callable[[], object]],
                repeats: int = 3) -> Dict[str, float]:
    """Times named thunks eagerly (best of ``repeats``, seconds).

    Each thunk is called once to warm up (compile), then timed with
    ``jax.block_until_ready`` on its result. Logs a summary at
    verbosity >= 1. Intended for roofline checks of individual pipeline
    stages; for real device timelines use ``trace``.
    """
    out: Dict[str, float] = {}
    for name, thunk in stages.items():
        jax.block_until_ready(thunk())      # warm / compile
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(thunk())
            best = min(best, time.perf_counter() - t0)
        out[name] = best
        log(1, f"stage {name}: {best * 1e3:.3f} ms")
    return out
