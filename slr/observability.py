"""Tracing, structured logging and roofline accounting (SURVEY.md sec. 7).

The reference has Qt debug prints and manual timing; the build provides:
- stage_timer: wall-clock stage timing with block_until_ready semantics,
  emitted as JSON-lines;
- trace(): jax.profiler wrapper producing TensorBoard-compatible traces;
- roofline(): bytes/flops -> speed-of-light fraction for a kernel against
  the published peaks of the device it ran on (PEAKS, keyed by
  ``device_kind``);
- host-0 gating for multi-process runs (multihost_utils analog).

NaN/debug gates (the race-detector analog for a functional runtime):
tests enable jax_debug_nans per-case; checkify wrappers live with the
pipelines that use them.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import jax

# Published per-device peaks, keyed by jax.devices()[i].device_kind.
# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit: HBM3 3.35 TB/s, f32 (no tensor cores) 67 TFLOP/s,
# bf16 tensor cores 989 TFLOP/s. A card set below 700 W cannot hold
# these clocks: report the power limit beside any share of them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0,
                              "bf16_tflops": 989.0},
}


def device_peaks(device_kind: Optional[str] = None) -> dict:
    """Peak table entry for ``device_kind`` (default: the first JAX
    device). A device without an entry is an error, never a default."""
    kind = device_kind or jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def is_host0() -> bool:
    try:
        return jax.process_index() == 0
    except Exception:
        return True


def log_event(event: str, /, stream=None, **fields) -> None:
    """JSON-lines structured log, emitted from host 0 only."""
    if not is_host0():
        return
    rec = {"event": event, "ts": time.time(), **fields}
    (stream or sys.stderr).write(json.dumps(rec) + "\n")


@dataclass
class StageTimer:
    """Collects per-stage wall times; .summary() feeds the bench."""
    times_ms: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, result_to_block=None):
        t0 = time.perf_counter()
        with jax.named_scope(name):
            yield
        if result_to_block is not None:
            jax.block_until_ready(result_to_block)
        dt = (time.perf_counter() - t0) * 1e3
        self.times_ms[name] = self.times_ms.get(name, 0.0) + dt
        log_event("stage", name=name, ms=dt)

    def summary(self) -> dict:
        return dict(self.times_ms)


def time_fn(fn, *args, iters: int = 5, warmup: int = 1, **kw) -> float:
    """Median wall ms of fn(*args) with block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kw))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def roofline(bytes_accessed: float, flops: float, measured_ms: float,
             device_kind: Optional[str] = None) -> dict:
    """Speed-of-light fractions for a memory/compute-bound f32 kernel
    against the published peaks of ``device_kind``."""
    pk = device_peaks(device_kind)
    t_mem_ms = bytes_accessed / (pk["hbm_gbps"] * 1e9) * 1e3
    t_cmp_ms = flops / (pk["f32_tflops"] * 1e12) * 1e3
    bound = "memory" if t_mem_ms >= t_cmp_ms else "compute"
    sol_ms = max(t_mem_ms, t_cmp_ms)
    return {
        "bound": bound,
        "sol_ms": sol_ms,
        "measured_ms": measured_ms,
        "sol_fraction": sol_ms / measured_ms if measured_ms > 0 else 0.0,
        "achieved_gbps": bytes_accessed / (measured_ms * 1e-3) / 1e9,
    }


def _union_ns(spans) -> int:
    """Total length of the union of (start, end) intervals."""
    busy, cur = 0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (cur[1] - cur[0] if cur is not None else 0)


def device_time_ms(fn, *args, n: int = 10) -> Optional[dict]:
    """Device time of ``fn(*args)`` from a profiler trace of ``n`` calls
    (after one warm-up call): ``busy_ms`` = union of the device's event
    intervals per call, ``events`` = {event name: ms per call}. None when
    the trace holds no accelerator plane (the CPU backend)."""
    import glob
    import tempfile

    from jax._src.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(n):
                jax.block_until_ready(fn(*args))
        paths = glob.glob(f"{d}/plugins/profile/*/*.xplane.pb")
        planes = [pl for pl in ProfileData.from_file(paths[0]).planes
                  if pl.name.startswith("/device:")]
        spans, by_name = [], {}
        for plane in planes:
            for line in plane.lines:
                for ev in line.events:
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                    by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                        + ev.duration_ns / n / 1e6)
    if not spans:
        return None
    return {"busy_ms": _union_ns(spans) / n / 1e6, "events": by_name}


@contextlib.contextmanager
def trace(logdir: str = "/tmp/slr_trace"):
    """jax.profiler trace context (TensorBoard-compatible output)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
