"""Trace-file hygiene: validate ``repro_torch.obs`` JSONL traces (twin of
``repro.obs.hygiene``).  Checks:

* **JSONL integrity** — every line parses as one JSON object;
* **event schema** — required fields (``name``/``cat``/``ph``/``ts``/
  ``pid``/``tid``), ``ph`` within the admitted phases, complete ("X")
  spans carry a non-negative ``dur``, ``args`` (when present) is a dict;
* **closed-world taxonomy** — ``cat`` is one of
  :data:`repro_torch.obs.trace.CATEGORIES`;
* **span-type floor** (optional ``--min-span-types N``) — an end-to-end
  run traced its lifecycle, not one lonely event.

CLI::

    python -m repro_torch.obs.hygiene serve.jsonl solve.jsonl \\
        --min-span-types 4
"""
from __future__ import annotations

import os
import sys

from repro_torch.obs.trace import (CATEGORIES, PHASES, REQUIRED_FIELDS,
                                   read_events, span_types)


def validate_events(events: list[dict]) -> list[str]:
    """Schema problems of an in-memory event list (empty == clean)."""
    problems: list[str] = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = [f for f in REQUIRED_FIELDS if f not in ev]
        if missing:
            problems.append(f"event {i}: missing fields {missing}")
            continue
        if ev["cat"] not in CATEGORIES:
            problems.append(
                f"event {i} ({ev['name']}): unknown category "
                f"{ev['cat']!r} — taxonomy is {CATEGORIES}")
        if ev["ph"] not in PHASES:
            problems.append(
                f"event {i} ({ev['name']}): unknown phase {ev['ph']!r}")
        elif ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event {i} ({ev['name']}): X span needs dur >= 0, "
                    f"got {dur!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            problems.append(
                f"event {i} ({ev['name']}): bad ts {ev['ts']!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(
                f"event {i} ({ev['name']}): args must be an object")
    return problems


def validate_trace(path: str, *, min_span_types: int = 0) -> list[str]:
    """Validate one JSONL trace file; returns human-readable problems."""
    if not os.path.exists(path):
        return [f"{path}: missing"]
    try:
        events = read_events(path)
    except ValueError as e:
        return [str(e)]
    if not events:
        return [f"{path}: empty trace"]
    problems = validate_events(events)
    kinds = span_types(events)
    if len(kinds) < min_span_types:
        problems.append(
            f"{path}: only {len(kinds)} span type(s) {kinds}, "
            f"need >= {min_span_types}")
    return problems


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="validate repro_torch.obs JSONL trace files")
    ap.add_argument("traces", nargs="+")
    ap.add_argument("--min-span-types", type=int, default=0,
                    help="fail unless the trace has at least this many "
                         "distinct complete-span names")
    args = ap.parse_args(argv)
    bad = 0
    for path in args.traces:
        problems = validate_trace(path,
                                  min_span_types=args.min_span_types)
        if problems:
            bad += 1
            print(f"{path}: {len(problems)} problem(s)", file=sys.stderr)
            for p in problems:
                print(f"  - {p}", file=sys.stderr)
        else:
            events = read_events(path)
            print(f"{path}: clean ({len(events)} events, "
                  f"span_types={span_types(events)})")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
