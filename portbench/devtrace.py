"""The traced slice: ``torch.profiler`` over a short steady part of the
window (device activity only), the port's ``obs`` spans and the
benchmark's own spans over the same part, reduced to what the per-layer
metrics and the breakdown read.

Host and device clocks are tied by a marker: after a synchronise the
host reads its clock and launches one short spin kernel, which is the
first device event of the slice.
"""
from __future__ import annotations

import time

import torch

def sync() -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


#: spin cycles of the marker kernel (a few microseconds)
MARKER_CYCLES = 1000


class Slice:
    """``with Slice() as s:`` profiles the block; then ``s.kernels`` holds
    (name, start_s, dur_s) on the host's clock, ``s.t0``/``s.t1`` the
    slice's host times, ``s.spans`` (name, start_s, end_s) of the port's
    ``obs`` spans and the benchmark's, innermost resolved later."""

    def __init__(self):
        self.kernels: list = []
        self.spans: list = []
        self.t0 = self.t1 = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        from repro_torch import obs
        torch.cuda.synchronize()
        obs.configure(enabled=True, t0=0.0)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        return self

    def span(self, name: str, t0: float, t1: float) -> None:
        self.spans.append((name, t0, t1))

    def __exit__(self, *exc):
        from repro_torch import obs
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        events = obs.tracer().buffer
        obs.configure(enabled=False)
        for ev in events:
            if ev.get("ph") == "X":
                s = ev["ts"] / 1e6
                self.spans.append((ev["name"], s, s + ev["dur"] / 1e6))
        raw = [(e.name(), e.start_ns(), e.duration_ns())
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        del self._prof
        if raw:
            first = min(r[1] for r in raw)
            # the marker starts a few microseconds after t0
            self.kernels = [(n, self.t0 + (s - first) / 1e9, d / 1e9)
                            for n, s, d in raw]
        return False

    # -- reductions ------------------------------------------------------

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list:
        """The union of the device's kernel intervals, merged."""
        out: list = []
        for _, s, d in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.t0), min(s + d, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_seconds(self, *patterns: str) -> float:
        """Summed device time of the kernels whose name holds any of
        ``patterns``."""
        return sum(d for n, _, d in self.kernels
                   if any(p in n for p in patterns))

    def top_ops(self, k: int = 10) -> list:
        total: dict = {}
        for n, _, d in self.kernels:
            total[n] = total.get(n, 0.0) + d
        return [[n[:160], s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time inside the slice, summed by the innermost span
        the host was in at each gap's middle."""
        edges = [self.t0] + [x for iv in self.busy_intervals()
                             for x in iv] + [self.t1]
        total: dict = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inside = [(e - s, n) for n, s, e in self.spans if s <= mid <= e]
            name = min(inside)[1] if inside else "host outside any span"
            total[name] = total.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:k]]
