"""torch.profiler hooks for the serving hot path.

Two instrumentation layers, split by where they run:

  * ``wrap_root(fn, name)`` -- runs a serving root's step function inside a
    ``torch.profiler.record_function("serving_root.<name>")`` range, so the
    root's host ops (and, on the card, the kernels they launch) sit under
    the root's name in a profiler timeline.  Applied unconditionally, as the
    reference's ``jax.named_scope``: a range only records while a profiler
    is active and never touches the computation, so there is no on/off
    divergence to perturb tokens.
  * ``annotation(name)`` -- a host-side ``record_function`` span for the
    dispatch and sync regions of the engine loop.

``ProfileCapture`` drives a ``torch.profiler.profile`` from the engine's
step hooks: capture begins at the first dispatched step and ends once N
steps have been consumed (so the window holds N complete dispatch -> sync
cycles), then writes a Chrome trace into its directory.  Unlike the
reference's capture it never hides a failure: a profiler that cannot start
or stop leaves its exception in ``error`` (the serve CLI prints it) and
the capture ends."""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch


def wrap_root(fn, name: str):
    """Name a serving root's calls (``serving_root.<name>`` range).  The
    marker attribute ``__obs_name__`` names the wrapped root."""
    label = f"serving_root.{name}"

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    wrapped.__obs_name__ = name
    return wrapped


def annotation(name: str):
    """Host-side profiler span (records only while a profiler is active)."""
    return torch.profiler.record_function(name)


class ProfileCapture:
    """Capture a torch.profiler trace of N engine steps into ``profile_dir``
    (a Chrome trace, ``trace_path``; loads in Perfetto or chrome://tracing).

    The engine's telemetry calls ``tick_dispatch()`` after each root
    dispatch and ``tick_consume()`` after each consumed step; the capture
    starts at the first dispatch and stops once ``n_steps`` steps have been
    consumed (``stop()`` ends it early).  It records the host and, once
    CUDA is initialised (a card engine), the card."""

    def __init__(self, profile_dir: str, n_steps: int = 8):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        self.profile_dir = profile_dir
        self.n_steps = n_steps
        self.started = False
        self.finished = False
        self.error: Optional[BaseException] = None
        self.trace_path: Optional[str] = None
        self._prof = None
        self._consumed = 0

    def tick_dispatch(self) -> None:
        if self.started or self.finished:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.cuda.is_initialized() else [])
        try:
            os.makedirs(self.profile_dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            self.started = True
        except Exception as e:  # kept for the caller, never retried
            self.error = e
            self._prof = None
            self.finished = True

    def tick_consume(self) -> None:
        if not self.started or self.finished:
            return
        self._consumed += 1
        if self._consumed >= self.n_steps:
            self.stop()

    def stop(self) -> None:
        """End the capture and write its trace (no-op once finished)."""
        if self.started and not self.finished:
            self.finished = True
            try:
                self._prof.__exit__(None, None, None)
                path = os.path.join(self.profile_dir,
                                    f"serving_steps.{os.getpid()}.pt.trace.json")
                self._prof.export_chrome_trace(path)
                self.trace_path = path
            except Exception as e:
                self.error = e
            self._prof = None
        self.finished = True
