"""The traced window: torch.profiler over a run's requests, read into the
numbers the per-layer readers (metrics/) and the breakdown take.

Device busy time is the union of the device intervals (kernels, copies,
memsets) inside the window, as chip_smoke.py's profile phase reads it;
the window is the harness's own "portbench.window" span.  The events are
read raw from kineto (prof.profiler.kineto_results): the event tree that
prof.events() builds takes minutes over a prover step's host ops.
"""

from __future__ import annotations

import bisect
from collections import Counter
from dataclasses import dataclass, field

from portbench import costs

WINDOW_SPAN = "portbench.window"
REQUEST_SPAN = "portbench.request"
# host calls that hand the device work: a kernel, a graph or a copy
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")
TOP = 10


@dataclass
class TraceData:
    """What one traced window holds: its requests and their latencies on
    the host clock, its length and device busy time (seconds), its device events (start s, end s, name) in time order,
    the host calls that launched or copied (name -> count), the port's
    kernel launches by width from its counters, and the SM clock read at
    its end."""

    requests: int
    latencies_s: list
    window_s: float
    busy_s: float
    device: list
    host_calls: Counter
    launch_widths: dict
    sm_mhz: float
    kernels: tuple
    breakdown: dict = field(default_factory=dict)

    def kernel_of(self, name: str) -> str | None:
        """The port kernel a device event belongs to, or None."""
        for k in self.kernels:
            if f"{k}_kernel" in name:
                return k
        return None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def profiler():
    """torch.profiler over host ops and, with a card, device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else []))


def span(name: str):
    from torch.profiler import record_function

    return record_function(name)


def read(prof, latencies: list, launch_widths: dict, sm_mhz: float, kernels) -> TraceData:
    """The window's numbers and breakdown from a finished profile."""
    from torch.autograd import DeviceType

    dev, host, calls = [], [], Counter()
    w0 = w1 = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = e.start_ns() / 1e9, e.end_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            # a host span (record_function) is mirrored on the device's
            # timeline as an annotation: no work ran there
            if not (name.startswith("portbench.") or e.is_user_annotation()):
                dev.append((s, t, name))
        elif name == WINDOW_SPAN:
            w0, w1 = s, t
        elif name.startswith("cu"):
            if name in LAUNCH_CALLS or name.startswith(("cudaMemcpy", "cuMemcpy")):
                calls[name] += 1
        elif name != REQUEST_SPAN:
            host.append((s, t, name))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    dev = sorted((max(s, w0), min(t, w1), n) for s, t, n in dev if t > w0 and s < w1)
    busy = costs.busy_seconds((s, t) for s, t, _ in dev)
    td = TraceData(len(latencies), latencies, w1 - w0, busy, dev, calls, launch_widths, sm_mhz, tuple(kernels))
    td.breakdown = {"device_ops": _top_ops(dev), "idle_gaps": _idle_gaps(dev, host, w0, w1)}
    return td


def _top_ops(dev) -> list:
    by = Counter()
    for s, t, n in dev:
        by[n[:120]] += t - s
    return [[n, sec] for n, sec in by.most_common(TOP)]


def _idle_gaps(dev, host, w0: float, w1: float) -> list:
    """The longest stretches of the window with no device event, each named
    by the host op that overlaps it most (an aten op; "host Python, no
    torch op" where none covers a tenth of it)."""
    gaps, hi = [], w0
    for s, t, _ in dev:
        if s > hi:
            gaps.append((hi, s))
        hi = max(hi, t)
    if w1 > hi:
        gaps.append((hi, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host.sort()
    starts = [h[0] for h in host]
    longest = max((t - s for s, t, _ in host), default=0.0)
    out = []
    for g0, g1 in gaps:
        best, over = None, 0.0
        for s, t, n in host[bisect.bisect_left(starts, g0 - longest) : bisect.bisect_right(starts, g1)]:
            o = min(t, g1) - max(s, g0)
            if o > over:
                best, over = n, o
        label = best if best is not None and over >= 0.1 * (g1 - g0) else "host Python, no torch op"
        out.append([label[:120], g1 - g0])
    return out
