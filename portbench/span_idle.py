"""Idle device time put down to the host code that was running: the
idle intervals of a traced slice (between ``Slice.t0`` and ``Slice.t1``,
outside the union of its kernel intervals) intersected with the union
of one span name's intervals.  A gap that crosses a span's edge counts
only its part inside; spans of one name that nest or overlap count once.

The program's spans share the host's ``perf_counter`` clock with the
slice's kernels (``devtrace.Slice``).  A gap lies inside a span when the
host was in that span while the card waited; where the host runs ahead
of the card, the gap falls in the span the host has reached, not in the
one that launched the kernels either side of it.
"""
from __future__ import annotations


def union(intervals) -> list:
    """Sorted disjoint [start, end] of the intervals' union (empty ones
    dropped)."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_seconds(sl, name: str) -> float:
    """Idle device seconds of slice ``sl`` inside ``name``'s spans."""
    edges = [sl.t0] + [x for iv in sl.busy_intervals() for x in iv] \
        + [sl.t1]
    idle = [[a, b] for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    spans = union((max(s, sl.t0), min(e, sl.t1))
                  for n, s, e in sl.spans if n == name)
    return overlap(idle, spans)


def share(ctx, name: str):
    """100 × :func:`idle_seconds` over the slice's window; 0.0 where the
    span never opened, None without a slice or kernels (as
    ``idle_share.*``)."""
    sl = ctx.slice
    if sl is None or not sl.kernels:
        return None
    return 100.0 * idle_seconds(sl, name) / sl.window_s
