"""Profiling and debug instrumentation (SURVEY.md §5.1-5.2).

The reference's only instrumentation is a wall-clock print (main.py:152-155)
and per-model render stats (core.py:634-636). Here:

- :class:`FrameTimer` measures steady-state frame rates end to end: each
  frame's output is copied to the host, which is what a caller of
  ``Scene.render`` waits for.
- :func:`orbit_times` times the compiled frame program over a camera orbit,
  one dispatch per frame; :func:`ms_summary` condenses the samples.
- :func:`trace` wraps ``jax.profiler.trace`` for XProf/Perfetto dumps;
  :func:`trace_orbit` traces frames of the compiled frame program and
  :func:`summarize_device_trace` reads the dump back: busy and idle time
  per device stream and the dominant XLA ops per frame.
- :func:`nan_debug` enables jax's NaN checker around a scope — the moral
  equivalent of a sanitizer for the all-masks-no-branches pipeline.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np

__all__ = ["FrameTimer", "orbit_times", "ms_summary", "trace", "nan_debug",
           "trace_orbit", "summarize_device_trace"]


class FrameTimer:
    """Steady-state frame timing: ``with FrameTimer() as t: ... t.frame(x)``."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        return False

    def frame(self, device_output):
        """Record one frame, synchronizing on its output."""
        np.asarray(device_output)
        now = time.perf_counter()
        self.times.append(now - self._t0)
        self._t0 = now

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    def summary(self) -> dict:
        ts = np.asarray(self.times)
        return {"frames": len(ts), "fps": self.fps,
                "ms_mean": float(ts.mean() * 1000) if len(ts) else 0.0,
                "ms_p50": float(np.median(ts) * 1000) if len(ts) else 0.0,
                "ms_max": float(ts.max() * 1000) if len(ts) else 0.0}


def orbit_times(cfg, dyn, positions, to_host=False):
    """Wall seconds per frame of ``render_frame_jit`` as the camera moves
    through ``positions`` ((N, 3)), one dispatch per frame.

    Each frame is synchronized before the next is dispatched: with
    ``block_until_ready`` (device time plus dispatch), or with ``to_host``
    by copying the frame to host memory, which is what a caller of
    ``Scene.render`` waits for. One warm-up frame (compile) is excluded.
    """
    import jax.numpy as jnp

    from tpu_renderer.ops.pipeline import render_frame_jit

    dyns = [dict(dyn, camera=dict(dyn["camera"], position=jnp.asarray(p)))
            for p in positions]
    render_frame_jit(cfg, dyns[0])[0].block_until_ready()
    seconds = []
    for d in dyns:
        t0 = time.perf_counter()
        frame = render_frame_jit(cfg, d)[0]
        if to_host:
            np.asarray(frame)
        else:
            frame.block_until_ready()
        seconds.append(time.perf_counter() - t0)
    return seconds


def ms_summary(seconds) -> dict:
    """Median, quartiles and range in milliseconds, unrounded."""
    ms = np.asarray(seconds, np.float64) * 1e3
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median_ms": float(med), "q1_ms": float(q1), "q3_ms": float(q3),
            "min_ms": float(ms.min()), "max_ms": float(ms.max()),
            "n": int(len(ms))}


@contextlib.contextmanager
def trace(log_dir=None):
    """``jax.profiler`` trace scope; view with XProf/TensorBoard/Perfetto.
    ``log_dir`` defaults to ``tpu_renderer_trace`` in the temp directory."""
    import jax

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "tpu_renderer_trace")

    with jax.profiler.trace(log_dir):
        yield log_dir


@contextlib.contextmanager
def nan_debug():
    """Enable jax_debug_nans within the scope (debug-mode sanitizer)."""
    import jax

    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def trace_orbit(cfg, dyn, positions, log_dir):
    """Trace ``render_frame_jit`` over ``positions`` (compiled first, outside
    the trace) into ``log_dir``; returns :func:`summarize_device_trace` of it
    per frame."""
    import jax
    import jax.numpy as jnp

    from tpu_renderer.ops.pipeline import render_frame_jit

    dyns = [dict(dyn, camera=dict(dyn["camera"], position=jnp.asarray(p)))
            for p in positions]
    render_frame_jit(cfg, dyns[0])[0].block_until_ready()
    with jax.profiler.trace(log_dir):
        for d in dyns:
            render_frame_jit(cfg, d)[0].block_until_ready()
    return summarize_device_trace(log_dir, n_frames=len(dyns))


def summarize_device_trace(log_dir, n_frames=1, plane_prefix="/device:",
                           top=12) -> list:
    """Per-stream busy time and the dominant ops of the newest trace in
    ``log_dir`` (a :func:`trace` / ``jax.profiler`` dump).

    For each line (stream) of each plane whose name starts with
    ``plane_prefix``: its event count, busy milliseconds (union of event
    intervals), window (first start to last end) and busy share, and the
    ``top`` ops as (ms per frame, launches per frame, op name), dividing by
    ``n_frames``. 1 - busy share is the stream's idle share.
    """
    import collections
    import glob

    import jax

    files = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        return []
    rows = []
    for plane in jax.profiler.ProfileData.from_file(files[-1]).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            events = [(e.name, e.start_ns, e.duration_ns) for e in line.events]
            if not events:
                continue
            total = collections.Counter()
            count = collections.Counter()
            for name, _, dur in events:
                total[name] += dur
                count[name] += 1
            busy, end = 0.0, None
            for start, stop in sorted((s, s + d) for _, s, d in events):
                if end is None or start > end:
                    busy += stop - start
                    end = stop
                elif stop > end:
                    busy += stop - end
                    end = stop
            window = max(s + d for _, s, d in events) - min(
                s for _, s, _ in events)
            rows.append({
                "plane": plane.name, "line": line.name, "events": len(events),
                "busy_ms": busy / 1e6, "window_ms": window / 1e6,
                "busy_share": busy / window if window else 1.0,
                "ops": [(ns / 1e6 / n_frames, count[name] / n_frames, name)
                        for name, ns in total.most_common(top)]})
    return rows
