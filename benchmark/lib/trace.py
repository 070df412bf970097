"""The traced run's device timeline: the profiler over the window,
recording the device's activity and the benchmark's spans (no host
operators), reduced in memory to what the per-layer metrics and
`breakdown` read.

Spans: the benchmark's own `record_function` ranges, named "bench.<layer>"
(`span`), around its calls into the program's layers; the window itself
is "bench.window". From the trace:

- busy_s: the union of the device's activity intervals (kernels, copies,
  sets) inside the window;
- launches: device kernels inside the window (copies and sets apart);
- kernel_s: device seconds by kernel name;
- device_ops: the ten names that took the most device time;
- idle_gaps: the device's idle time inside the window by the innermost
  benchmark span open on the host at each gap's midpoint (the ten
  largest totals).
"""

from __future__ import annotations

import contextlib
import heapq
from collections import defaultdict

import torch

WINDOW = "bench.window"


@contextlib.contextmanager
def span(name: str, on: bool):
    """A benchmark span (`bench.<name>`) when tracing, else nothing."""
    if not on:
        yield
        return
    with torch.profiler.record_function(f"bench.{name}"):
        yield


def profiler():
    """A profiler of the device's activity (CUPTI: kernels, copies, sets)
    and of the benchmark's own spans alone: no per-operator host events,
    whose recording would cost the host more than the spans do. Falls
    back to every host operator where this torch lacks the scope filter
    (`spans_only` says which ran)."""
    from torch.autograd.profiler import profile

    class _Spans(profile):
        spans_only = True

        def _start_trace(self):
            from torch._C._profiler import RecordScope

            try:
                cfg = self.config(create_trace_id=False)
            except TypeError:
                cfg = self.config()
            try:
                torch.autograd._enable_profiler(
                    cfg, self.kineto_activities, {RecordScope.USER_SCOPE})
            except TypeError:
                type(self).spans_only = False
                torch.autograd._enable_profiler(cfg, self.kineto_activities)
            self.entered = True

    use = "cuda" if torch.cuda.is_available() else None
    if not hasattr(profile, "_start_trace"):
        p = profile(use_device=use, use_kineto=True)
        p.spans_only = False
        return p
    return _Spans(use_device=use, use_kineto=True)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict:
    """-> {"window_s", "busy_s", "launches", "kernel_s", "device_ops",
    "idle_gaps"} of the "bench.window" span of a finished profile."""
    events = prof.kineto_results.events()
    window = None
    spans, device, host = [], [], 0
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host += 1
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif name.startswith("bench."):
                spans.append((e.start_ns(), e.end_ns(), name[6:]))
        elif not (e.is_user_annotation() or name.startswith("bench.")):
            device.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = window
    kernel_s = defaultdict(float)
    launches = 0
    ivals = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        ivals.append((s, e))
        copy = name.startswith(("Memcpy", "Memset"))
        if not copy:
            launches += 1
        kernel_s[name] += (e - s) * 1e-9
    merged = _merge(ivals)
    busy = sum(e - s for s, e in merged) * 1e-9
    # idle gaps, labelled by the innermost benchmark span open at the gap
    gaps = []
    prev = w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans.sort()
    by_label = defaultdict(float)
    open_spans, k = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        while k < len(spans) and spans[k][0] <= mid:
            s, e, name = spans[k]
            heapq.heappush(open_spans, (-s, e, name))
            k += 1
        while open_spans and open_spans[0][1] < mid:
            heapq.heappop(open_spans)
        label = open_spans[0][2] if open_spans else "outside_spans"
        by_label[label] += (g1 - g0) * 1e-9
    top = lambda d: [[short(k), v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"spans_only": bool(getattr(prof, "spans_only", False)),
            "host_events": host,
            "window_s": (w1 - w0) * 1e-9, "busy_s": busy,
            "launches": launches, "kernel_s": dict(kernel_s),
            "device_ops": top(kernel_s), "idle_gaps": top(by_label)}


def short(name: str, width: int = 96) -> str:
    """A kernel's name cut to `width` characters (template arguments make
    some thousands long)."""
    return name if len(name) <= width else name[:width - 3] + "..."
